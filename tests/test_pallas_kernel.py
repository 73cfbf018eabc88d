"""Pallas force-kernel tests (Triton kernel, interpreted on the CPU).

The compiled kernel is checked at real widths on the GPU by
tests/test_gpu_kernel.py.  Here the interpreter runs the same kernel body:
against the dense XLA fast path over odd sizes, exact block multiples and
several blocks; with row/column global offsets; with coincident pairs and
the bias on and off; with bf16 storage; through the sharded paths; plus the
wrapper's shapes, padding and choice of interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_nbody_tpu.config import SimConfig
from parallel_nbody_tpu.ops import pallas_step
from parallel_nbody_tpu.ops.forces import (_forces_fast_block,
                                           compute_forces_dense)
from parallel_nbody_tpu.ops.pallas_step import (BLOCK_I, BLOCK_J,
                                                pallas_block_forces,
                                                pallas_forces)
from parallel_nbody_tpu.state import pad_state, random_state

CFG = SimConfig(force_mode="fast", dtype="float32")


def _forces(st, **kw):
    return pallas_forces(CFG, st.x, st.y, st.mass, st.radius, **kw)


def _assert_close(got, want, rtol=2e-3, atol=1e-2):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _block_oracle(cfg, sti, stj, gi0, gj0):
    return _forces_fast_block(cfg, sti.x, sti.y, sti.mass, stj.x, stj.y,
                              stj.mass, sti.radius, stj.radius, gi0, gj0)


@pytest.mark.parametrize("n", [
    97,               # odd: pads rows and columns
    BLOCK_I,          # exactly one block
    4 * BLOCK_I,      # exact multiple, several blocks
    5 * BLOCK_J + 13,  # several blocks plus a ragged tail
])
def test_matches_dense_fast_path(n):
    st = random_state(n, CFG, jax.random.PRNGKey(0))
    xf, yf = _forces(st)
    xf_d, yf_d = compute_forces_dense(CFG, st.x, st.y, st.mass, st.radius)
    _assert_close(xf, xf_d)
    _assert_close(yf, yf_d)


def test_padding_bodies_get_and_exert_zero_force():
    st = random_state(100, CFG, jax.random.PRNGKey(1))
    padded, n = pad_state(st, 128)
    xf, yf = _forces(padded)
    assert np.isfinite(np.asarray(xf)).all()
    np.testing.assert_array_equal(np.asarray(xf)[n:], 0.0)
    np.testing.assert_array_equal(np.asarray(yf)[n:], 0.0)
    # Real bodies unaffected by padding: compare against unpadded dense.
    xf_d, _ = compute_forces_dense(CFG, st.x, st.y, st.mass, st.radius)
    _assert_close(np.asarray(xf)[:n], xf_d)


def test_awkward_sizes_pad_internally():
    # 96 is not a block multiple; the kernel pads to whole blocks with inert
    # bodies (it must NOT shrink the block) and must still be correct.
    st = random_state(96, CFG, jax.random.PRNGKey(2))
    xf, yf = _forces(st)
    assert xf.shape == (96,)
    xf_d, yf_d = compute_forces_dense(CFG, st.x, st.y, st.mass, st.radius)
    _assert_close(xf, xf_d)
    _assert_close(yf, yf_d)


@pytest.mark.parametrize("m, k", [
    (512, 512),   # square, several row blocks and column tiles
    (384, 640),   # rectangular
    (256, 1000),  # awkward column count
    (96, 160),    # neither a block multiple
    (200, 520),   # both axes awkward
])
def test_rectangular_block_matches_dense(m, k):
    sti = random_state(m, CFG, jax.random.PRNGKey(4))
    stj = random_state(k, CFG, jax.random.PRNGKey(5))
    xf, yf = pallas_block_forces(
        CFG, sti.x, sti.y, sti.mass, sti.radius,
        stj.x, stj.y, stj.mass, stj.radius, row_g0=0, col_g0=k)
    assert xf.shape == (m,) and yf.shape == (m,)
    xf_d, yf_d = _block_oracle(CFG, sti, stj, 0, k)
    _assert_close(xf, xf_d)
    _assert_close(yf, yf_d)


def test_momentum_conservation():
    st = random_state(256, CFG, jax.random.PRNGKey(3))
    xf, _ = _forces(st)
    # One-sided evaluation still conserves total momentum to fp32 round-off.
    total = abs(float(np.sum(np.asarray(xf, np.float64))))
    scale = float(np.abs(np.asarray(xf)).max())
    assert total < 1e-3 * scale


def _coincident_positions(n, key, pairs):
    st = random_state(n, CFG, jax.random.PRNGKey(key))
    x, y = st.x, st.y
    for a, b in pairs:
        x = x.at[b].set(x[a])
        y = y.at[b].set(y[a])
    return st._replace(x=x, y=y)


@pytest.mark.parametrize("rows, row_g0, col_g0", [
    ((150, 260), 150, 0),      # row block inside the columns, overlap tiles
    ((0, 70), 0, 0),           # row block at the start
    ((230, 300), 230, 0),      # row block at the end, ragged
    ((40, 140), 1040, 1000),   # offsets shifted together: same pairs
])
def test_global_offsets_with_coincident_pairs(rows, row_g0, col_g0):
    """row_g0/col_g0 place the blocks in global index space: the overlap
    segment, self-pairs and coincident-pair signs all follow from them."""
    st = _coincident_positions(300, 1, [(10, 200), (45, 160), (151, 152)])
    sl = slice(*rows)
    sti = st._replace(**{f: getattr(st, f)[sl] for f in
                         ("x", "y", "mass", "radius")})
    got = pallas_block_forces(CFG, sti.x, sti.y, sti.mass, sti.radius,
                              st.x, st.y, st.mass, st.radius,
                              row_g0=row_g0, col_g0=col_g0, biased=True)
    want = _block_oracle(CFG, sti, st, row_g0 - col_g0, 0)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])


@pytest.mark.parametrize("biased, coincident, agrees", [
    (True, True, True),     # the bias reproduces the reference kick
    (True, False, True),    # the bias is harmless without coincidences
    (False, False, True),   # the unbiased kernel on a clean state
    (False, True, False),   # ... is wrong on a coincident one (contract)
])
def test_coincident_bias_on_and_off(biased, coincident, agrees):
    pairs = [(3, 130), (64, 65)] if coincident else []
    st = _coincident_positions(200, 2, pairs)
    xf, yf = _forces(st, biased=biased)
    xf_d, yf_d = compute_forces_dense(CFG, st.x, st.y, st.mass, st.radius)
    ok = np.allclose(np.asarray(xf), np.asarray(xf_d), rtol=2e-3, atol=1e-2)
    assert ok == agrees
    _assert_close(yf, yf_d)


def test_bf16_storage_computes_in_fp32():
    """bf16 is storage only: the kernel on bf16 inputs equals the fp32
    kernel on the same (bf16-rounded) values, and returns bf16."""
    st = random_state(300, CFG, jax.random.PRNGKey(6))
    b16 = [a.astype(jnp.bfloat16) for a in (st.x, st.y, st.mass, st.radius)]
    f32 = [a.astype(jnp.float32) for a in b16]
    cfg16 = CFG.replace(dtype="bfloat16")
    xb, yb = pallas_forces(cfg16, *b16)
    x32, y32 = pallas_forces(CFG, *f32)
    assert xb.dtype == jnp.bfloat16
    _assert_close(np.asarray(xb, np.float32), x32.astype(jnp.bfloat16)
                  .astype(jnp.float32), rtol=1e-2, atol=1e-2)
    _assert_close(np.asarray(yb, np.float32), y32.astype(jnp.bfloat16)
                  .astype(jnp.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_output_shape_and_dtype(dtype):
    cfg = CFG.replace(dtype=dtype)
    st = random_state(70, cfg, jax.random.PRNGKey(7))
    xf, yf = pallas_block_forces(cfg, st.x[:33], st.y[:33], st.mass[:33],
                                 st.radius[:33], st.x, st.y, st.mass,
                                 st.radius)
    assert xf.shape == (33,) and yf.shape == (33,)
    assert xf.dtype == jnp.dtype(dtype) and yf.dtype == jnp.dtype(dtype)
    assert np.isfinite(np.asarray(xf, np.float32)).all()


@pytest.mark.parametrize("backend, expect", [
    ("cpu", True), ("gpu", False), ("metal", ValueError)])
def test_interpret_mode_from_platform(monkeypatch, backend, expect):
    monkeypatch.setattr(pallas_step.jax, "default_backend", lambda: backend)
    if expect is ValueError:
        with pytest.raises(ValueError, match="gpu and cpu"):
            pallas_step.interpret_mode()
    else:
        assert pallas_step.interpret_mode() is expect


# ---------------------------------------------------------------------------
# Composition with the sharded paths (virtual CPU mesh, interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 203])
@pytest.mark.parametrize("path", ["allgather", "ring", "grid2d"])
def test_sharded_pallas_matches_dense(path, n):
    from parallel_nbody_tpu.models.engine import run
    from parallel_nbody_tpu.parallel.grid2d import (make_grid2d_run,
                                                    make_mesh2d,
                                                    shard_state_2d)
    from parallel_nbody_tpu.parallel.mesh import make_mesh, shard_state
    from parallel_nbody_tpu.parallel.sharded_step import make_sharded_run
    from parallel_nbody_tpu.state import init_state, unpad_state

    cfg = CFG.replace(kernel="pallas")
    steps = 3
    st = init_state(n, cfg)
    padded, n_real = pad_state(st, 4)
    if path == "grid2d":
        mesh = make_mesh2d(2, 2)
        out = make_grid2d_run(cfg, mesh, steps)(shard_state_2d(padded, mesh))
    else:
        mesh = make_mesh(4)
        out = make_sharded_run(cfg, mesh, steps, path)(
            shard_state(padded, mesh))
    out = unpad_state(jax.device_get(out), n_real)

    ref = run(cfg.replace(kernel="xla"), init_state(n, cfg), steps)
    _assert_close(out.x, ref.x, rtol=1e-4, atol=1e-3)
    _assert_close(out.y, ref.y, rtol=1e-4, atol=1e-3)
    _assert_close(out.xv, ref.xv, rtol=1e-3, atol=1e-3)


def test_row_chunks_with_row_g0_match_square():
    """Row-chunked calls over a shared column set, with TRACED row_g0
    offsets and the biased kernel.  A wrong/omitted row_g0 misplaces the
    overlap segment and hands every body a spurious self-kick — this pins
    chunked == square, with a coincident pair split across row chunks."""
    from jax import lax

    n, row_chunk = 256, 64
    st = _coincident_positions(n, 1, [(3, 130)])
    x, y = st.x, st.y

    want_x, want_y = pallas_forces(CFG, x, y, st.mass, st.radius,
                                   biased=True)

    @jax.jit
    def rows(r0):
        xi = lax.dynamic_slice_in_dim(x, r0, row_chunk)
        yi = lax.dynamic_slice_in_dim(y, r0, row_chunk)
        mi = lax.dynamic_slice_in_dim(st.mass, r0, row_chunk)
        ri = lax.dynamic_slice_in_dim(st.radius, r0, row_chunk)
        return pallas_block_forces(
            CFG, xi, yi, mi, ri, x, y, st.mass, st.radius,
            row_g0=r0, col_g0=0, biased=True)

    got_x = jnp.concatenate([rows(c)[0] for c in range(0, n, row_chunk)])
    got_y = jnp.concatenate([rows(c)[1] for c in range(0, n, row_chunk)])
    np.testing.assert_array_equal(np.asarray(got_x), np.asarray(want_x))
    np.testing.assert_array_equal(np.asarray(got_y), np.asarray(want_y))
