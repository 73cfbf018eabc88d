#!/usr/bin/env python
"""Smoke test of the N-body engine on one NVIDIA GPU, in one process.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # the sharded path on four cards only

Phases (one card):
  1. compile check — the Triton force kernel compiled at N=65536 and 2^20
     (bias on and off, bf16 storage, compensated accumulation), its
     memory_analysis(), and 256 sampled rows against a float64 oracle
     (tests/test_gpu_kernel.py);
  2. flagship run — ``65536 0 arena.ppm 20 --no-clamp --pallas --run-xps``
     through the CLI: CSV row printed, final state finite;
  3. rendering — ``16384 1 arena.ppm 50 --no-clamp --fast``: a frame lands
     in the PPM;
  4. large N — ``1048576 0 arena.ppm 2 --no-clamp --pallas``: final state
     finite;
  5. parity configuration — ``--dtype=float64`` trig at N=1000, 100 steps,
     diffed against tests/fixtures/seq_1000_100.out;
  6. kernel against XLA — engine.run, 20 fp32 steps, at N=16384, 65536 and
     2^20 with the Pallas kernel and with XLA's dense fast path.

``--four-cards``: N=2^20, 3 steps, under ``--comm=allgather``,
``--comm=ring`` and ``--mesh2d=2x2``, each against the one-card run of the
same state.

Every phase prints one line with the device and the card's name and power
limit.  Any failed phase makes the exit code non-zero.  Without a GPU the
script exits non-zero and prints no result.  The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP_N = 65536
RENDER_N = 16384
LARGE_N = 1 << 20
TIMING_NS = (16384, 65536, 1 << 20)
FOUR_CARDS_N = 1 << 20
WORK = os.path.join(REPO, ".chip_smoke")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "seq_1000_100.out")

# Phase 5: the card's libdevice trig differs from glibc's in the last ulps,
# and 100 steps of close encounters amplify that; a printed field may move
# by a few units of its last decimal (0.001).
PARITY_TOLERANCE = 0.01
# --four-cards: the sharded runs sum each row's forces in another order than
# the one-card run; over 3 fp32 steps every field stays within this share
# of its largest magnitude.
SHARDED_TOLERANCE = 1e-4


def result_line(device: dict) -> str:
    """The last line of stdout on success."""
    return json.dumps({"ok": True, "device": device})


def _cli(argv, env=None):
    """Run cli.main in-process; return (exit code, stdout text)."""
    from parallel_nbody_tpu import cli

    out = io.StringIO()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["nbody"] + [str(a) for a in argv])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, out.getvalue()


def _arena():
    from parallel_nbody_tpu.utils import ppm
    path = os.path.join(WORK, "arena.ppm")
    ppm.create(path, 1024, 768)
    return path


def _finite_checkpoint(path, n):
    import numpy as np
    with np.load(path) as z:
        arrays = [z[k] for k in ("x", "y", "xv", "yv", "xf", "yf")]
    assert all(a.shape == (n,) for a in arrays), [a.shape for a in arrays]
    assert all(np.isfinite(a).all() for a in arrays), "non-finite state"


def phase_compile():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_gpu_kernel as t

    parts = []
    for n, biased, accum, dtype in t.CASES:
        err, compiled = t.kernel_error(n, biased, accum, dtype)
        if (n, biased, accum, dtype) in ((65536, True, "plain", "float32"),
                                         (1 << 20, True, "plain",
                                          "float32")):
            print("  memory_analysis n=%d: %s"
                  % (n, compiled.memory_analysis()), flush=True)
        label = "n=%d %s %s %s err=%.3e" % (
            n, "biased" if biased else "unbiased", accum, dtype, err)
        print("  " + label, flush=True)
        assert err <= t.TOLERANCE[dtype], label
        parts.append("%.2e" % err)
    return "max rel err per case " + " ".join(parts)


def phase_flagship():
    ck = os.path.join(WORK, "flagship.npz")
    rc, out = _cli([FLAGSHIP_N, 0, _arena(), 20, "--no-clamp", "--pallas",
                    "--run-xps", "--checkpoint=" + ck])
    assert rc == 0, rc
    row = out.strip().splitlines()[-1]
    assert str(FLAGSHIP_N) in [f.strip() for f in row.split(",")], row
    _finite_checkpoint(ck, FLAGSHIP_N)
    return "csv " + row


def phase_render():
    import numpy as np

    from parallel_nbody_tpu.utils import ppm
    arena = _arena()
    log = os.path.join(WORK, "frames.log")
    if os.path.exists(log):
        os.remove(log)
    rc, out = _cli([RENDER_N, 1, arena, 50, "--no-clamp", "--fast"],
                   env={"NBODY_FRAME_LOG": log})
    assert rc == 0, rc
    assert len(out.splitlines()) == RENDER_N
    with open(log) as f:
        frames = sum(1 for _ in f)
    lit = int(np.count_nonzero(ppm.read_pixels(ppm.read_header(arena))))
    assert frames >= 1 and lit > 0, (frames, lit)
    return "%d frame(s), %d lit subpixels" % (frames, lit)


def phase_large_n():
    n = LARGE_N
    ck = os.path.join(WORK, "large.npz")
    t0 = time.perf_counter()
    rc, out = _cli([n, 0, _arena(), 2, "--no-clamp", "--pallas",
                    "--checkpoint=" + ck])
    assert rc == 0, rc
    assert out.count("\n") == n
    _finite_checkpoint(ck, n)
    return "%d bodies, 2 steps, %.1f s wall incl. compile" % (
        n, time.perf_counter() - t0)


def phase_parity():
    import jax
    import numpy as np
    try:
        rc, out = _cli([1000, 0, _arena(), 100, "--dtype=float64"])
    finally:
        jax.config.update("jax_enable_x64", False)
    assert rc == 0, rc
    with open(FIXTURE) as f:
        want = f.read()
    if out == want:
        return "byte-equal to %s" % os.path.basename(FIXTURE)
    got = np.array(out.split(), float).reshape(-1, 6)
    ref = np.array(want.split(), float).reshape(-1, 6)
    diff = np.abs(got - ref)
    lines = int(np.count_nonzero(diff.max(axis=1) > 0))
    detail = ("not byte-equal: %d of %d lines differ, largest printed "
              "difference %.3f (tolerance %.3f)"
              % (lines, ref.shape[0], diff.max(), PARITY_TOLERANCE))
    assert diff.max() <= PARITY_TOLERANCE, detail
    return detail


def phase_kernel_vs_xla():
    import jax

    from parallel_nbody_tpu.config import SimConfig
    from parallel_nbody_tpu.models.engine import run
    from parallel_nbody_tpu.state import init_state

    steps = 20
    parts = []
    for n in TIMING_NS:
        cfg = SimConfig(force_mode="fast", dtype="float32")
        st = init_state(n, cfg)
        for kernel in ("pallas", "xla"):
            c = run.lower(cfg.replace(kernel=kernel), st, steps).compile()
            if kernel == "xla" and n >= FLAGSHIP_N:
                print("  xla memory_analysis n=%d: %s"
                      % (n, c.memory_analysis()), flush=True)
            if n < LARGE_N:
                # At LARGE_N one run is tens of seconds: the compiled
                # executable is timed on its first run.
                jax.block_until_ready(c(st))
            t0 = time.perf_counter()
            jax.block_until_ready(c(st))
            secs = time.perf_counter() - t0
            rate = steps * n * (n - 1) / 2 / secs
            line = "n=%d %s %d steps %.4f s %.4e pairs/s" % (
                n, kernel, steps, secs, rate)
            print("  " + line, flush=True)
            parts.append("%s@%d=%.3es" % (kernel, n, secs))
    return " ".join(parts)


def four_cards(steps=3):
    """The sharded path on four devices against the one-device run."""
    import jax
    import numpy as np

    from parallel_nbody_tpu.config import SimConfig
    from parallel_nbody_tpu.models.engine import run
    from parallel_nbody_tpu.parallel.grid2d import (make_grid2d_run,
                                                    make_mesh2d,
                                                    shard_state_2d)
    from parallel_nbody_tpu.parallel.mesh import make_mesh, shard_state
    from parallel_nbody_tpu.parallel.sharded_step import make_sharded_run
    from parallel_nbody_tpu.state import init_state, pad_state, unpad_state

    n = FOUR_CARDS_N
    cfg = SimConfig(force_mode="fast", dtype="float32", kernel="pallas")
    st = init_state(n, cfg)
    ref = jax.device_get(run(cfg, st, steps))
    padded, n_real = pad_state(st, 4)
    parts = []
    for mode in ("allgather", "ring", "grid2d"):
        if mode == "grid2d":
            mesh = make_mesh2d(2, 2)
            fn = make_grid2d_run(cfg, mesh, steps)
            arg = shard_state_2d(padded, mesh)
        else:
            mesh = make_mesh(4)
            fn = make_sharded_run(cfg, mesh, steps, mode)
            arg = shard_state(padded, mesh)
        compiled = fn.lower(arg).compile()
        jax.block_until_ready(compiled(arg))
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(arg))
        secs = time.perf_counter() - t0
        out = unpad_state(jax.device_get(out), n_real)
        errs = {}
        for f in ("x", "y", "xv", "yv", "xf", "yf"):
            a = np.asarray(getattr(out, f), np.float64)
            b = np.asarray(getattr(ref, f), np.float64)
            errs[f] = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        worst = max(errs.values())
        line = "%s: %d steps %.4f s, max field rel diff %.3e (%s)" % (
            mode, steps, secs, worst,
            " ".join("%s=%.1e" % kv for kv in errs.items()))
        print("  " + line, flush=True)
        assert worst <= SHARDED_TOLERANCE, line
        parts.append("%s %.2e" % (mode, worst))
    return "n=%d vs one device: %s" % (n, ", ".join(parts))


def main(argv) -> int:
    args = argv[1:]
    if args not in ([], ["--four-cards"]):
        sys.stderr.write("usage: python chip_smoke.py [--four-cards]\n")
        return 2

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write("chip_smoke.py needs an NVIDIA GPU; JAX found %s\n"
                         % dev.platform)
        return 1

    from parallel_nbody_tpu.utils import device_info
    from parallel_nbody_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    device = device_info.device()
    card = device_info.card_power()
    print(card, flush=True)
    print("compile cache: %s" % cache, flush=True)
    os.makedirs(WORK, exist_ok=True)

    if args == ["--four-cards"]:
        if device["count"] < 4:
            sys.stderr.write("--four-cards needs 4 GPUs; JAX found %d\n"
                             % device["count"])
            return 1
        phases = [("four-cards", four_cards)]
    else:
        phases = [("1 compile check", phase_compile),
                  ("2 flagship run", phase_flagship),
                  ("3 rendering", phase_render),
                  ("4 large N", phase_large_n),
                  ("6 kernel against XLA", phase_kernel_vs_xla),
                  ("5 parity configuration", phase_parity)]

    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            detail, status = fn(), "ok"
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            detail, status = "see traceback on stderr", "FAILED"
            failed.append(name)
        print("phase %s: %s — %s [%.1f s; %s x%d; %s]"
              % (name, status, detail, time.perf_counter() - t0,
                 device["kind"], device["count"], card), flush=True)

    if failed:
        sys.stderr.write("failed phases: %s\n" % ", ".join(failed))
        return 1
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
