"""Multi-chip dry-run: validate the FULL sharded training step on a virtual
N-device CPU mesh, without N real chips.

This is the automated analog of the reference's NP-grid correctness story
(every partitioning must reproduce the sequential oracle,
/root/reference/bin/run-tests.sh + bin/tests.sh): for both communication
strategies (all-gather and ppermute ring) the sharded fp64-trig run must be
byte-equal — at the reference's 3-decimal print contract — to the
single-device run over the same initial state.

The virtual CPU mesh needs ``jax.config.update("jax_platforms", "cpu")`` and
the device-count flag *before first device use*, so this lives in a module
that runs as a fresh child process (``python -m
parallel_nbody_tpu.parallel.dryrun N``) — the parent may already hold a GPU
backend.
"""

from __future__ import annotations

import os
import sys


def _force_cpu_platform(n_devices: int) -> None:
    """Point this process at an ``n_devices``-device virtual CPU platform
    WITHOUT initializing the backend.  Must run before JAX's first device
    use; safe before ``jax.distributed.initialize`` (multihost_smoke)."""
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=%d" % n_devices)
    os.environ["XLA_FLAGS"] = " ".join(flags)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def _force_cpu_devices(n_devices: int) -> None:
    """_force_cpu_platform + initialize the backend and verify the device
    count (single-process callers only)."""
    _force_cpu_platform(n_devices)

    import jax  # noqa: F811 — lazy import, cached; keeps module import inert
    backend = jax.default_backend()
    if backend != "cpu":
        raise RuntimeError(
            "dryrun requires the CPU platform but got %r (platform forcing "
            "must happen before first device use)" % backend)
    n = len(jax.devices())
    if n < n_devices:
        raise RuntimeError(
            "requested %d virtual CPU devices but got %d" % (n_devices, n))


def run_dryrun(n_devices: int, steps: int = 3) -> None:
    """Build an ``n_devices`` body mesh, jit the full sharded step with real
    PartitionSpec('bodies') shardings for BOTH comm paths, execute ``steps``
    steps on tiny shapes, and verify output equality with the single-device
    run (fp64 trig — the parity configuration)."""
    _force_cpu_devices(n_devices)

    import jax

    from ..config import SimConfig
    from ..models.engine import run
    from ..parallel.mesh import make_mesh, shard_state
    from ..parallel.sharded_step import make_sharded_run
    from ..state import init_state, pad_state, unpad_state
    from ..utils.output import format_state

    cfg = SimConfig(force_mode="trig", dtype="float64", kernel="xla")
    # Deliberately not a multiple of n_devices so padding is exercised.
    n = 16 * n_devices + 5
    state = init_state(n, cfg)

    expected = format_state(jax.device_get(run(cfg, state, steps)))

    mesh = make_mesh(n_devices)
    assert mesh.size == n_devices, (mesh.size, n_devices)

    for comm in ("allgather", "ring"):
        padded, n_real = pad_state(state, n_devices)
        padded = shard_state(padded, mesh)
        out = make_sharded_run(cfg, mesh, steps, comm)(padded)
        jax.block_until_ready(out)
        got = format_state(unpad_state(jax.device_get(out), n_real))
        if got != expected:
            raise RuntimeError(
                "sharded output (comm=%s, %d devices) diverged from the "
                "single-device run" % (comm, n_devices))

    # 2-D force-matrix decomposition over a (2, n/2) mesh when possible.
    modes = "allgather+ring"
    if n_devices % 2 == 0 and n_devices >= 4:
        from ..parallel.grid2d import (make_grid2d_run, make_mesh2d,
                                       shard_state_2d)
        mesh2d = make_mesh2d(2, n_devices // 2)
        padded, n_real = pad_state(state, n_devices)
        padded = shard_state_2d(padded, mesh2d)
        out = make_grid2d_run(cfg, mesh2d, steps)(padded)
        jax.block_until_ready(out)
        got = format_state(unpad_state(jax.device_get(out), n_real))
        if got != expected:
            raise RuntimeError(
                "grid2d output (2x%d mesh) diverged from the single-device "
                "run" % (n_devices // 2))
        modes += "+grid2d(2x%d)" % (n_devices // 2)

    print("dryrun_multichip ok: %d devices, comm=%s, %d bodies, "
          "%d steps, output matches single-device"
          % (n_devices, modes, n, steps))


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    n_devices = int(argv[1]) if len(argv) > 1 else 8
    run_dryrun(n_devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
