#!/usr/bin/env python
"""Headline benchmark: pairwise interactions per second on one GPU.

Runs the flagship fused step (Pallas force kernel + integration, fp32,
transcendental-free) at N=65536 fully on the device and reports unordered
pairwise interactions per second, beside the device and the card's power
limit.  Without a GPU it exits non-zero and prints no result.

Baseline: the reference's best published throughput — N=10000, P=128 cores
on DAS-5 completes 100 steps in 11.23 s (PDF Table 3; BASELINE.md), i.e.
4.45e8 pair interactions/s for the ENTIRE 128-core cluster.  vs_baseline is
the single-GPU rate over that cluster-wide rate.

Prints exactly one JSON line:
  {"metric", "value", "unit", "vs_baseline", "device", "card"}
"""

import json
import sys
import time

N = 65536
STEPS = 100
REPEATS = 5
BASELINE_CLUSTER_RATE = 4.45e8  # reference best, whole 128-core cluster


def result(rate: float, device: dict, card: str) -> dict:
    """The benchmark's one output record."""
    return {
        "metric": "pairwise interactions/s (N=%d, fused fp32 Pallas step)"
                  % N,
        "value": rate,
        "unit": "pairs/s",
        "vs_baseline": rate / BASELINE_CLUSTER_RATE,
        "device": device,
        "card": card,
    }


def main() -> int:
    import jax
    import numpy as np

    from parallel_nbody_tpu.config import SimConfig
    from parallel_nbody_tpu.models.engine import run
    from parallel_nbody_tpu.state import random_state
    from parallel_nbody_tpu.utils import device_info
    from parallel_nbody_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info.device()
    if device["platform"] != "gpu":
        sys.stderr.write("bench.py measures a GPU; JAX found %s\n"
                         % device["platform"])
        return 1

    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="pallas")
    state = random_state(N, cfg, jax.random.PRNGKey(0))
    step = run.lower(cfg, state, STEPS).compile()
    out = jax.block_until_ready(step(state))

    rtime = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(out))
        rtime = min(rtime, time.perf_counter() - t0)

    if not np.isfinite(np.asarray(out.x)).all():
        sys.stderr.write("non-finite state\n")
        return 1
    pairs = N * (N - 1) // 2 * STEPS
    print(json.dumps(result(pairs / rtime, device, device_info.card_power())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
