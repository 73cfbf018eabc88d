"""Pallas force kernel through Triton — the hot O(N^2) loop on the GPU.

This replaces the reference's compute_forces (nbody-seq.c:79-109 /
nbody-par.c:285-359, where OpenMP shared the pair loop across cores) with the
shared-memory tiling of Nyland, Harris & Prins (arXiv 0707.0438):

  - The grid is 1-D over row blocks of ``BLOCK_I`` bodies; blocks run in
    parallel on the SMs and carry nothing from one to the next.
  - Inside a program a ``fori_loop`` walks column tiles of ``BLOCK_J``
    bodies.  Each column tile is loaded once and reused by all ``BLOCK_I``
    rows of the program from registers.
  - The x/y sums are (BLOCK_I, BLOCK_J) accumulators carried by the loop and
    reduced along the column axis once, after the loop.
  - One rsqrt per pair:
        scale = m_j * rsqrt(forced^2 * dsqr)
    which equals m_j / (forced * |d|); the row factor G * m_i is applied once
    per row AFTER the column reduction.
  - Zero-mass padding needs no masks: far-away padding overflows
    forced^2*dsqr to +inf and rsqrt(inf) == 0; the m_j factor and the
    G*m_i row factor keep everything else at zero.
  - Softening ``max(dsqr, (r_i+r_j)^2)`` exactly as in the reference.

Coincident-pair semantics (nbody-seq.c:91-106; see ops/forces.py): two
DISTINCT bodies at the same position must feel ``force * (1, 0)`` with sign
``sign(gj - gi)`` by GLOBAL body index, while true self-pairs stay at zero.
The kernel implements this with a dx bias, applied per column segment:

  dx' = dx + bias, so at a coincident pair |d'| = |bias| and the
  contribution m_j * dx' / (forced * |d'|) collapses to
  m_j * sign(bias) / forced — the reference kick, |bias| cancelling.

  - column tiles ENTIRELY BELOW the row block's global index range: every
    gj < gi, so bias = -C, a compile-time scalar constant (C = 2^-26;
    C^2 << (r_i+r_j)^2 keeps softening exact, and C perturbs non-coincident
    dx by at most ~1 ulp).
  - column tiles ENTIRELY ABOVE: bias = +C.
  - the OVERLAPPING tiles: per-pair bias = (gj - gi) * 2^-50 computed from
    block-relative indices (exact for any N: the scale is a power of two and
    the indices are < 2^24, so bias differences never round — no sign
    flips).  Self-pairs get bias == 0 -> dx' == 0 -> zero contribution.

The segment bounds are traced integers; the three loops have dynamic trip
counts, so only real overlap tiles pay the per-pair index arithmetic.
models/engine.step gates the whole bias machinery at RUNTIME: an exact
O(N log N) duplicate-position test (``any_coincident``) selects
``biased=False`` for every step with no coincident distinct bodies.
The eps in ``rsqrt(forced^2*dsqr + eps)`` only de-NaNs two measure-zero
corners: all-zero padding products and a real pair whose dx happens to equal
the bias exactly (contribution becomes 0 instead of NaN).

The kernel is rectangular (row block x column block), so the same code path
serves the single-device square case, the sharded all-gather case (local rows
x gathered columns), the ppermute ring case (local rows x visiting block) and
grid2d's cells.  ``row_g0``/``col_g0`` carry each block's global starting
body index.  One-sided accumulation (each row block sums over ALL columns)
follows the reference's cross-rank redundancy model (nbody-par.c:302-308).

The kernel is compiled by Triton on the GPU and run by the Pallas
interpreter on the CPU (the test platform); any other platform is an error.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Block sizes and launch parameters, chosen by a sweep on an H100 (PERF.md):
# 32 x 64 with 8 warps is within noise of the fastest configuration at
# N = 65536, and keeps each (BLOCK_I, BLOCK_J) accumulator at 8 registers a
# thread, far from the spills that make 64 x 128 or 128 x 128 tiles ten
# times slower.  At N = 16384 it launches 512 programs for the card's 132
# SMs.
BLOCK_I = 32
BLOCK_J = 64
NUM_WARPS = 8
NUM_STAGES = 2

# De-NaN floor, added (not max-ed: the add fuses into the multiply chain)
# to forced^2 * dsqr.  Real coincident pairs have forced >= 4 (radius >= 1)
# and biased dsqr >= C^2, putting their rsqrt argument >= 16 * 2^-100 —
# far above eps, so the kick magnitude is unaffected.
_EPS = 1e-36
_EPS64 = 1e-200

# Constant dx bias for non-overlapping column segments (sign = segment side)
# and per-pair bias scale for overlapping tiles (powers of two => exact).
_CBIAS = 2.0 ** -26
_CBIAS64 = 2.0 ** -40
_PBIAS = 2.0 ** -50
_PBIAS64 = 2.0 ** -80

# Far-outside-the-arena position for padding bodies (matches state.pad_state):
# dsqr against any real body overflows forced^2*dsqr toward +inf in fp32, so
# rsqrt gives 0; padding-vs-padding pairs hit the eps floor with zero mass.
_FAR = 1e9


def _consts(dtype):
    if jnp.dtype(dtype) == jnp.float64:
        return _CBIAS64, _PBIAS64, _EPS64
    return _CBIAS, _PBIAS, _EPS


def interpret_mode() -> bool:
    """Whether Pallas kernels run interpreted on the default backend.

    The CPU has no Pallas compiler, so kernels are interpreted there (the
    test platform); on the GPU they are compiled by Triton.  There is no
    silent fallback for any other platform."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise ValueError("the Pallas force kernel supports the gpu and cpu "
                     "backends, not %r" % backend)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pad(a, size: int, fill: float):
    """Pad a 1-D body array up to ``size`` entries."""
    n = a.shape[0]
    if n == size:
        return a
    return jnp.concatenate([a, jnp.full((size - n,), fill, a.dtype)])


def _pad_block(x, y, m, r, size: int):
    """Pad one body block (positions far away, zero mass/radius) so padding
    bodies neither feel nor exert force — the internal analog of
    state.pad_state, applied per call so any N maps onto whole blocks."""
    return (_pad(x, size, _FAR), _pad(y, size, _FAR),
            _pad(m, size, 0.0), _pad(r, size, 0.0))


def _kahan_add(acc, comp, val):
    """One Kahan (compensated summation) step: fold ``val`` into the running
    sum ``acc`` carrying the rounding error in ``comp`` (true sum = acc -
    comp).  XLA and Triton never reassociate floating-point adds, so the
    error term is not folded away."""
    y = val - comp
    t = acc + y
    comp = (t - acc) - y
    return t, comp


def _compute_dtype(dtype):
    """In-kernel compute type: sub-32-bit inputs compute in float32.

    bfloat16 is a STORAGE format here (halves the bytes each column tile
    loads), never an accumulation type: summing O(N) force partials in an
    8-bit mantissa would swamp the signal.  fp32/fp64 pass through
    unchanged (astype to the same dtype is a no-op)."""
    return jnp.float32 if jnp.dtype(dtype).itemsize < 4 else dtype


def _segment_bounds(r0_rel, block_i: int, block_j: int, n_tiles: int):
    """Split ``n_tiles`` column tiles into (below, overlap, above) segments
    relative to a row block whose index range, relative to the column
    block's start, is [r0_rel, r0_rel + block_i).  Returns traced (j1, j2):
    tiles [0, j1) lie entirely below the row range, [j1, j2) overlap it,
    [j2, n_tiles) lie entirely above."""
    j1 = jnp.clip(jnp.floor_divide(r0_rel, block_j), 0, n_tiles)
    j2 = jnp.clip(jnp.floor_divide(r0_rel + block_i + block_j - 1, block_j),
                  j1, n_tiles)
    return j1, j2


def _force_kernel(off_ref, xi_ref, yi_ref, mi_ref, ri_ref,
                  xj_ref, yj_ref, mj_ref, rj_ref, xf_ref, yf_ref,
                  *, block_i: int, block_j: int, n_cols: int,
                  gravity: float, biased: bool, accum: str):
    cdt = _compute_dtype(xi_ref.dtype)
    cbias, pbias, eps = _consts(cdt)
    compensated = accum == "compensated"

    xi = xi_ref[...].astype(cdt)[:, None]
    yi = yi_ref[...].astype(cdt)[:, None]
    ri = ri_ref[...].astype(cdt)[:, None]
    # Row indices relative to the column block's global start.
    r0_rel = off_ref[0] + pl.program_id(0) * block_i
    irel = r0_rel + lax.broadcasted_iota(jnp.int32, (block_i, 1), 0)

    def pair_tile(t, acc, bias_of):
        c0 = pl.multiple_of(t * block_j, block_j)
        cols = pl.ds(c0, block_j)
        xj = xj_ref[cols].astype(cdt)[None, :]
        yj = yj_ref[cols].astype(cdt)[None, :]
        mj = mj_ref[cols].astype(cdt)[None, :]
        rj = rj_ref[cols].astype(cdt)[None, :]
        dx = xj - xi
        if bias_of is not None:
            dx = dx + bias_of(c0)
        dy = yj - yi
        dsqr = dx * dx + dy * dy
        mind = ri + rj
        forced = jnp.maximum(dsqr, mind * mind)
        scale = mj * lax.rsqrt(forced * forced * dsqr + eps)
        if not compensated:
            acc_x, acc_y = acc
            return acc_x + scale * dx, acc_y + scale * dy
        acc_x, comp_x, acc_y, comp_y = acc
        acc_x, comp_x = _kahan_add(acc_x, comp_x, scale * dx)
        acc_y, comp_y = _kahan_add(acc_y, comp_y, scale * dy)
        return acc_x, comp_x, acc_y, comp_y

    def overlap_bias(c0):
        # Per-pair bias from block-relative indices: exact at any N.
        jrel = c0 + lax.broadcasted_iota(jnp.int32, (1, block_j), 1)
        return (jrel - irel).astype(cdt) * pbias

    def seg(lo, hi, bias_of, acc):
        return lax.fori_loop(
            lo, hi, lambda t, a: pair_tile(t, a, bias_of), acc)

    zero = jnp.zeros((block_i, block_j), cdt)
    acc = (zero,) * (4 if compensated else 2)
    n_tiles = n_cols // block_j
    if biased:
        j1, j2 = _segment_bounds(r0_rel, block_i, block_j, n_tiles)
        acc = seg(0, j1, lambda c0: jnp.asarray(-cbias, cdt), acc)
        acc = seg(j1, j2, overlap_bias, acc)
        acc = seg(j2, n_tiles, lambda c0: jnp.asarray(cbias, cdt), acc)
    else:
        acc = seg(0, n_tiles, None, acc)

    if compensated:
        fx = jnp.sum(acc[0], axis=1) - jnp.sum(acc[1], axis=1)
        fy = jnp.sum(acc[2], axis=1) - jnp.sum(acc[3], axis=1)
    else:
        fx = jnp.sum(acc[0], axis=1)
        fy = jnp.sum(acc[1], axis=1)
    # Row factor G * m_i applied once after the reduction.
    gmi = mi_ref[...].astype(cdt) * gravity
    xf_ref[...] = fx * gmi
    yf_ref[...] = fy * gmi


def pallas_block_forces(cfg, xi, yi, mi, ri, xj, yj, mj, rj, *,
                        row_g0=0, col_g0=0, biased: bool = True,
                        accum: str = "plain"):
    """Force of every body in block J on every body in block I (one-sided,
    fast mode).  Block I of size M, block J of size K, any sizes: both are
    padded internally with inert far-away bodies to whole blocks.
    ``row_g0``/``col_g0`` are the blocks' global starting body indices
    (traced or static)."""
    m = xi.shape[0]
    m_pad = _round_up(m, BLOCK_I)
    k_pad = _round_up(xj.shape[0], BLOCK_J)
    xi, yi, mi, ri = _pad_block(xi, yi, mi, ri, m_pad)
    xj, yj, mj, rj = _pad_block(xj, yj, mj, rj, k_pad)
    dtype = xi.dtype
    # Forces come back in the COMPUTE dtype (fp32 for bf16 inputs — see
    # _compute_dtype) and are cast to the run dtype outside the kernel.
    cdt = _compute_dtype(dtype)
    off = jnp.reshape(jnp.asarray(row_g0, jnp.int32)
                      - jnp.asarray(col_g0, jnp.int32), (1,))

    kernel = functools.partial(
        _force_kernel, block_i=BLOCK_I, block_j=BLOCK_J, n_cols=k_pad,
        gravity=float(cfg.gravity), biased=biased, accum=accum)
    whole = pl.BlockSpec()
    rows = pl.BlockSpec((BLOCK_I,), lambda i: (i,))
    xf, yf = pl.pallas_call(
        kernel,
        grid=(m_pad // BLOCK_I,),
        in_specs=[whole] + [rows] * 4 + [whole] * 4,
        out_specs=(rows, rows),
        out_shape=(jax.ShapeDtypeStruct((m_pad,), cdt),
                   jax.ShapeDtypeStruct((m_pad,), cdt)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
        interpret=interpret_mode(),
        name="nbody_forces",
    )(off, xi, yi, mi, ri, xj, yj, mj, rj)
    return xf[:m].astype(dtype), yf[:m].astype(dtype)


def pallas_forces(cfg, x, y, mass, radius, *, biased: bool = True,
                  accum: str = "plain"):
    """Total pairwise forces (square case) via the Pallas kernel."""
    return pallas_block_forces(cfg, x, y, mass, radius, x, y, mass, radius,
                               biased=biased, accum=accum)


def any_coincident(x, y, mass):
    """True iff two DISTINCT massive bodies share a position exactly.

    The cheap (O(N log N), vs the O(N^2) force kernel) runtime test behind
    the biased/unbiased kernel dispatch in models/engine.step: coincident
    pairs need the reference's atan2(0,0) kick (nbody-seq.c:91-106), which
    the biased kernel prices with extra per-pair work — steps without such
    pairs (in practice all but the first few of a glibc integer-pixel init)
    take the cheaper unbiased kernel instead.

    Exact, no false negatives: a 3-key lexicographic sort puts equal
    positions adjacent and groups them by mass, so zero-mass padding (which
    all sits at the same far coordinate) never splits or fakes a real pair.
    Signed zeros are normalized first (``+ 0.0`` maps -0.0 to +0.0): the
    kernel's dx/dy arithmetic treats -0.0 and +0.0 as coincident, but
    lax.sort's total order separates them — without the normalization a
    third body sorting between them could hide a genuinely coincident pair.
    """
    xs, ys, ms = lax.sort((x + 0.0, y + 0.0, mass), num_keys=3)
    dup = (xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1]) & (ms[:-1] > 0)
    return jnp.any(dup)


def any_coincident_tagged(x, y, mass, gid):
    """True iff two bodies with DIFFERENT global ids share a position.

    Generalizes ``any_coincident`` for block collections that may contain
    MULTIPLE COPIES of the same body — a ring shard testing own+visiting
    blocks sees itself twice at ring step 0, and grid2d row/col groups
    overlap — where plain duplicate detection would always fire.  Sorting
    carries the global id as a tie-break key, so copies of one body land
    adjacent (equal gid, ignored) while a genuine coincident pair of
    distinct bodies shows adjacent entries with differing gids.  Signed
    zeros are normalized as in ``any_coincident``.
    """
    xs, ys, gs, ms = lax.sort((x + 0.0, y + 0.0, gid, mass), num_keys=3)
    # BOTH masses must be positive: with gid (not mass) as the tie-break
    # key, a massive body can sort before a massless one at an equal
    # position, so checking only ms[:-1] would let zero-mass padding fake a
    # pair with a real body sharing its coordinates.
    dup = ((xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1])
           & (gs[1:] != gs[:-1]) & (ms[:-1] > 0) & (ms[1:] > 0))
    return jnp.any(dup)


def forces_coincident_dispatch(x, y, mass, call):
    """Runtime biased/unbiased kernel dispatch (shared by models/engine.step
    and the sharded all-gather path): run ``call(biased: bool)`` — which must
    close over its inputs and return (xf, yf) — with the biased kernel only
    when ``any_coincident(x, y, mass)`` holds."""
    return lax.cond(any_coincident(x, y, mass),
                    lambda _: call(True), lambda _: call(False), None)
