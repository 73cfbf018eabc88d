"""The dtype support envelope: float16 is REJECTED loudly everywhere, and
bfloat16 (the 16-bit storage mode) ships with pinned accuracy
characterization instead of silent hope.

Why float16 can never work here: the reference init law sets
mass = radius^3 with radius up to 1 + sqrt(xdim^2+ydim^2)/25 (~52.2 at the
default 1024x768 arena, nbody-seq.c:444-447), so mass reaches ~1.4e5 —
past float16's 65504 finite max for any N >= 8 — and the force kernel's
mass_i*mass_j product (~2e10, nbody-seq.c:92) overflows float16 at EVERY N.
A float16 run can therefore only print NaNs; pre-round-5 it did exactly
that with exit code 0.  These tests pin the loud-failure contract at all
three layers (CLI parse, SimConfig, init cast) plus the bfloat16 accuracy
envelope documented in docs/DESIGN.md.
"""

import numpy as np
import pytest

from parallel_nbody_tpu.config import SimConfig
from parallel_nbody_tpu.models.engine import run
from parallel_nbody_tpu.ops.forces import compute_forces_dense
from parallel_nbody_tpu.state import _checked_cast, init_state

from tests.test_cli import arena, run_cli  # noqa: F401  (fixture reuse)


# ---------------------------------------------------------------------------
# float16 rejection — every layer fails loudly, none prints NaN with rc=0.
# ---------------------------------------------------------------------------

def test_cli_rejects_float16_at_parse_time(arena):  # noqa: F811
    r = run_cli(["128", "0", arena, "3", "--dtype=float16", "--fast"])
    assert r.returncode == 1
    assert "float16 is unsupported" in r.stderr
    assert "bfloat16" in r.stderr  # points at the supported 16-bit mode
    assert "nan" not in r.stdout.lower()
    assert "Traceback" not in r.stderr


def test_cli_bad_dtype_message_no_longer_offers_float16(arena):  # noqa: F811
    r = run_cli(["16", "0", arena, "1", "--dtype=fp16"])
    assert r.returncode == 1
    assert "Bad --dtype" in r.stderr
    assert "float16" not in r.stderr.replace("bfloat16", "")


def test_simconfig_rejects_float16_and_unknown_dtypes():
    with pytest.raises(ValueError, match="float16.*unsupported|unsupported.*float16"):
        SimConfig(dtype="float16")
    with pytest.raises(ValueError, match="unsupported dtype"):
        SimConfig(dtype="int32")


def test_init_cast_guard_raises_on_overflow_not_nan():
    """Defense in depth below SimConfig: a finite fp64 init value that casts
    to inf must raise with the offending index/value, never flow onward."""
    src = np.array([1.0, 2.0, 1.4e5])
    with pytest.raises(ValueError, match=r"mass\[2\].*overflows.*float16"):
        _checked_cast(src, np.float16, "mass")
    # Non-finite SOURCE values pass through (they are not a cast overflow).
    inf_src = np.array([1.0, np.inf])
    out = _checked_cast(inf_src, np.float16, "mass")
    assert np.isinf(out[1])


# ---------------------------------------------------------------------------
# bfloat16 characterization — pinned tolerances vs the fp64 oracle.
# bf16 shares float32's exponent range (no overflow at the reference mass
# law) but has only 8 mantissa bits, so: state quantization ~eps*|x| (~4 px
# at x~1024), force-operator aggregate error ~2%, per-body errors larger
# where opposing pulls cancel.  Measured values (CPU, fast kernel):
# L2 rel error 0.026/0.022/0.014 at N=64/256/1024; 20-step max position
# delta 2.0 px.  Tolerances pin ~2x headroom over those.
# ---------------------------------------------------------------------------

CFG64 = SimConfig(force_mode="fast", dtype="float64")
CFGBF = CFG64.replace(dtype="bfloat16")


@pytest.mark.parametrize("n", [64, 256])
def test_bf16_force_operator_error_vs_fp64(n):
    s64 = init_state(n, CFG64)
    sbf = init_state(n, CFGBF)
    fx64, fy64 = compute_forces_dense(CFG64, s64.x, s64.y, s64.mass,
                                      s64.radius)
    fxb, fyb = compute_forces_dense(CFGBF, sbf.x, sbf.y, sbf.mass,
                                    sbf.radius)
    v64 = np.stack([np.asarray(fx64), np.asarray(fy64)])
    vbf = np.stack([np.asarray(fxb, np.float64), np.asarray(fyb, np.float64)])
    assert np.isfinite(vbf).all()
    l2_rel = np.linalg.norm(vbf - v64) / np.linalg.norm(v64)
    assert l2_rel < 0.05, l2_rel
    # Typical per-body error stays at the ~1% scale even though worst-case
    # bodies (near-cancelling pulls) can be much worse — that asymmetry IS
    # the bf16 envelope and is documented in docs/DESIGN.md.
    mag64 = np.hypot(v64[0], v64[1])
    rel = np.abs(np.hypot(vbf[0], vbf[1]) - mag64) / np.maximum(mag64, 1e-30)
    assert np.median(rel) < 0.03, np.median(rel)


def test_bf16_short_trajectory_stays_finite_and_close():
    n = 64
    e64 = run(CFG64, init_state(n, CFG64), 20)
    ebf = run(CFGBF, init_state(n, CFGBF), 20)
    xbf = np.asarray(ebf.x, np.float64)
    ybf = np.asarray(ebf.y, np.float64)
    assert np.isfinite(xbf).all() and np.isfinite(ybf).all()
    # One bf16 position quantum at arena scale is eps*1024 = 8; the observed
    # 20-step divergence (2.0 px) is representation-dominated, not dynamics.
    assert np.abs(xbf - np.asarray(e64.x)).max() < 8.0
    assert np.abs(ybf - np.asarray(e64.y)).max() < 8.0


def test_bf16_pallas_is_storage_format_with_fp32_compute():
    """The Pallas kernel treats sub-32-bit dtypes as STORAGE formats: inputs
    upcast to fp32 at the loads, partial sums accumulate in fp32, the result
    casts back once at the end (ops/pallas_step.py::_compute_dtype) — O(N)
    sums in 8 mantissa bits would swamp the force signal.  Pin: bf16-in
    forces == the fp32 kernel's result on the same quantized inputs, rounded
    once to bf16 — plain and compensated accumulation."""
    import jax.numpy as jnp

    from parallel_nbody_tpu.ops.pallas_step import (pallas_block_forces,
                                                    pallas_forces)

    n = 192
    cfgb = SimConfig(force_mode="fast", dtype="bfloat16", kernel="pallas")
    cfg32 = cfgb.replace(dtype="float32")
    sb = init_state(n, cfgb)
    args32 = [jnp.asarray(a, jnp.float32)
              for a in (sb.x, sb.y, sb.mass, sb.radius)]

    fxb, fyb = pallas_forces(cfgb, sb.x, sb.y, sb.mass, sb.radius)
    fx32, fy32 = pallas_forces(cfg32, *args32)
    assert fxb.dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(fx32.astype(jnp.bfloat16), np.float32),
                          np.asarray(fxb, np.float32))
    assert np.array_equal(np.asarray(fy32.astype(jnp.bfloat16), np.float32),
                          np.asarray(fyb, np.float32))

    sxb, syb = pallas_block_forces(
        cfgb, sb.x, sb.y, sb.mass, sb.radius, sb.x, sb.y, sb.mass, sb.radius,
        accum="compensated")
    sx32, sy32 = pallas_block_forces(cfg32, *args32, *args32,
                                     accum="compensated")
    assert sxb.dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(sx32.astype(jnp.bfloat16), np.float32),
                          np.asarray(sxb, np.float32))
    assert np.array_equal(np.asarray(sy32.astype(jnp.bfloat16), np.float32),
                          np.asarray(syb, np.float32))


def test_bf16_cli_runs_clean(arena):  # noqa: F811
    r = run_cli(["64", "0", arena, "3", "--dtype=bfloat16", "--fast"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "nan" not in r.stdout.lower()
    body_lines = [l for l in r.stdout.splitlines() if l and "=" not in l]
    assert len(body_lines) >= 64
