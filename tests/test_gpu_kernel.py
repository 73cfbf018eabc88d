"""The compiled Triton force kernel at real widths, against a float64 oracle.

These tests need an NVIDIA GPU and skip without one.  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernel.py

``chip_smoke.py`` runs the same cases in-process as its compile check.

Each case compiles the kernel for the card, runs it on N bodies, and
compares 256 sampled rows with NumPy's float64 direct sum over all N columns
(ops/reference.py): ``max|F - F_ref| / max|F_ref|``.  The tolerance is
2e-4 for float32: the kernel sums up to 2^20 fp32 terms per row, each
carrying an approximate rsqrt (a few ulp), and strong close-encounter terms
cancel in the sum, so the error relative to the largest force stays near
1e-5 with room to spare.  bfloat16 storage adds one rounding of the output
to an 8-bit mantissa, 2^-8 of the largest force.
"""

import functools

import numpy as np
import pytest

SAMPLED_ROWS = 256
TOLERANCE = {"float32": 2e-4, "bfloat16": 2.0 ** -8 + 2e-4}

# (n, biased, accum, dtype): glibc integer-pixel states (with coincident
# pairs) for the biased kernel, uniform random states for the unbiased one.
CASES = [
    (65536, True, "plain", "float32"),
    (65536, False, "plain", "float32"),
    (65536, True, "compensated", "float32"),
    (65536, False, "plain", "bfloat16"),
    (1 << 20, True, "plain", "float32"),
    (1 << 20, False, "plain", "float32"),
    (1 << 20, False, "compensated", "float32"),
    (1 << 20, True, "plain", "bfloat16"),
]


@functools.lru_cache(maxsize=4)
def _state(n, glibc):
    import jax

    from parallel_nbody_tpu.config import SimConfig
    from parallel_nbody_tpu.state import init_state, random_state

    cfg = SimConfig(force_mode="fast", dtype="float32")
    if glibc:
        return init_state(n, cfg)
    return random_state(n, cfg, jax.random.PRNGKey(n))


def kernel_error(n, biased, accum, dtype):
    """Compile the kernel for (n, biased, accum, dtype), run it, and return
    (relative error against the float64 oracle, compiled executable)."""
    import jax

    from parallel_nbody_tpu.config import SimConfig
    from parallel_nbody_tpu.ops.pallas_step import (any_coincident,
                                                    pallas_forces)
    from parallel_nbody_tpu.ops.reference import (relative_error,
                                                  sampled_forces)

    st = _state(n, biased)
    # The unbiased kernel is only correct without coincident pairs; the
    # biased one is checked on a state that has them.
    assert bool(any_coincident(st.x, st.y, st.mass)) == biased
    cfg = SimConfig(force_mode="fast", dtype=dtype)
    args = [a.astype(dtype) for a in (st.x, st.y, st.mass, st.radius)]
    fn = jax.jit(functools.partial(pallas_forces, cfg, biased=biased,
                                   accum=accum))
    compiled = fn.lower(*args).compile()
    fx, fy = compiled(*args)
    rows = np.sort(np.random.default_rng(n).choice(n, SAMPLED_ROWS,
                                                   replace=False))
    want = sampled_forces(cfg.gravity, *(np.asarray(a, np.float32)
                                         for a in args), rows)
    got = (np.asarray(fx, np.float32)[rows], np.asarray(fy, np.float32)[rows])
    return relative_error(got, want), compiled


@pytest.mark.gpu
@pytest.mark.parametrize("n, biased, accum, dtype", CASES)
def test_compiled_kernel_matches_fp64_reference(gpu, n, biased, accum,
                                                dtype):
    err, _ = kernel_error(n, biased, accum, dtype)
    assert err <= TOLERANCE[dtype], err
