"""Pairwise gravitational forces (dense XLA formulation).

Physics contract (reference: nbody/nbody-seq.c:79-109, identical per-pair math
in nbody/nbody-par.c:338-359):

  for each unordered pair (i, j), i < j:
      dx     = x[j] - x[i]
      dy     = y[j] - y[i]
      angle  = atan2(dy, dx)
      dsqr   = dx^2 + dy^2
      forced = max(dsqr, (r_i + r_j)^2)         # plummer-less softening
      force  = m_i * m_j * G / forced
      fx     = force * cos(angle)               # trig decomposition — parity-
      fy     = force * sin(angle)               # sensitive (NOT dx/|d|)
      F[i] += (fx, fy);  F[j] -= (fx, fy)       # Newton's 3rd law

Coincident-pair semantics (parity-critical corner): two DISTINCT bodies at
the same position give ``angle = atan2(0, 0) = 0``, so the reference exerts a
real separating kick ``force * (1, 0)`` — the smaller-index body gets ``+x``,
the larger ``-x`` (nbody-seq.c:91,97-106).  Such pairs occur in real runs:
the glibc init places bodies on integer pixels (``rand() % xdim``), so at
N=4096 the initial state already contains 15 coincident pairs.  Every path
here reproduces this as ``fx += sign(gj - gi) * force`` where g are GLOBAL
body indices; self-pairs (gi == gj) and zero-mass padding stay at zero.
(Note: the reference's own MPI binary gets this wrong for pairs split across
ranks — both owners apply ``+x`` (nbody-par.c:338-353 with intra_world=false)
— which would break its seq-vs-par golden diff; we match the sequential
oracle, which also keeps output invariant under re-sharding.)

The dense op materializes the (N, N) pair matrix once per step — the right
shape for XLA fusion on a single device at small/medium N.  The Pallas kernel
in ops/pallas_step.py tiles the same computation in registers, and
parallel/sharded_step.py shards the row axis over a device mesh.

``mode="trig"`` keeps the reference's transcendental decomposition and the
upper-triangle ± accumulation (pair values computed once, exactly like the C
loop).  ``mode="fast"`` is the speed path: algebraically equal
``force * dx * rsqrt(dsqr)``, full (i != j) matrix so each row sums
independently (the same redundancy model the reference's MPI version uses for
cross-rank pairs, nbody-par.c:302-308).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..config import SimConfig

# Clamp for the softened denominator.  Real bodies always have
# (r_i + r_j)^2 >= 4 (radius >= 1, nbody-seq.c:444), so this only guards
# zero-mass padding bodies from producing 0/0 = NaN.
_DENOM_FLOOR = 1e-30


def pair_forces_trig(cfg: SimConfig, x, y, mass, radius):
    """Upper-triangle pair force matrix with the reference's trig math.

    Returns (fx, fy) where entry [i, j] (i < j) is the force of j on i along
    +x/+y; entries with i >= j are zero.  Coincident pairs need no special
    case here: atan2(0, 0) == 0 gives fx = force, fy = 0 exactly as in the
    reference, and the ± triangle accumulation applies the correct signs.
    """
    dx = x[None, :] - x[:, None]
    dy = y[None, :] - y[:, None]
    angle = jnp.arctan2(dy, dx)
    dsqr = dx * dx + dy * dy
    mind = radius[:, None] + radius[None, :]
    forced = jnp.maximum(jnp.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    force = mass[:, None] * mass[None, :] * cfg.gravity / forced
    fx = force * jnp.cos(angle)
    fy = force * jnp.sin(angle)
    n = x.shape[0]
    rows = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    upper = rows < cols
    zero = jnp.zeros((), x.dtype)
    return jnp.where(upper, fx, zero), jnp.where(upper, fy, zero)


def _sequential_row_sum(s):
    """Left-to-right sequential row sums of a 2-D matrix (shape (N, N) ->
    (N,)), replicating the C program's per-body accumulation order exactly.

    The reference walks pairs lexicographically, so body k's force receives
    contributions in column order j = 0..N-1 (first ``-= fx[j,k]`` for j < k,
    then ``+= fx[k,j]`` for j > k; nbody-seq.c:87-106).  A tree reduction
    (jnp.sum) computes the same value up to rounding, but at large N the
    different rounding shows in the 3-decimal print (measured boundary:
    1 field of 60,000 at N=10000x100, on the CPU).  lax.scan is
    sequential by semantics, closing the gap at any N.
    """
    def add(acc, col):
        return acc + col, None

    total, _ = lax.scan(add, jnp.zeros(s.shape[0], s.dtype), s.T)
    return total


def compute_forces_dense(cfg: SimConfig, x, y, mass, radius):
    """Total force on every body, dense O(N^2).

    Returns (xf, yf) with shape (N,).
    """
    if cfg.force_mode == "trig":
        fx, fy = pair_forces_trig(cfg, x, y, mass, radius)
        # Pair value computed once per (i<j), applied +/- to both owners —
        # mirrors the C accumulation (nbody-seq.c:103-106).  The signed
        # matrix fx - fx.T is exact (entries are fx[i,j], -fx[j,i], or 0);
        # the sequential row sum then replicates the C loop's accumulation
        # ORDER bit-for-bit, not just its value.
        xf = _sequential_row_sum(fx - fx.T)
        yf = _sequential_row_sum(fy - fy.T)
        return xf, yf
    return _forces_fast_block(cfg, x, y, mass, x, y, mass, radius, radius,
                              0, 0)


def _pair_sign(dtype, ni, nj, gi0, gj0, gids):
    """sign(gj - gi) over the (ni, nj) pair block — 0 exactly on self-pairs.

    Global ids come either from contiguous offsets ``gi0``/``gj0`` (traced
    or static) or, when ``gids=(gi_vec, gj_vec)`` is given, from explicit
    per-body id vectors (the grid2d col group is STRIDED, one chunk per mesh
    row, so offsets cannot describe it)."""
    if gids is not None:
        gi_v, gj_v = gids
        return jnp.sign(gj_v[None, :] - gi_v[:, None]).astype(dtype)
    gi = gi0 + lax.broadcasted_iota(jnp.int32, (ni, nj), 0)
    gj = gj0 + lax.broadcasted_iota(jnp.int32, (ni, nj), 1)
    return jnp.sign(gj - gi).astype(dtype)


def _forces_fast_block(cfg, xi, yi, mi, xj, yj, mj, ri, rj, gi0, gj0,
                       gids=None):
    """Fast-path force of every body in block J on every body in block I.

    One-sided accumulation (each row block computes its own forces over all
    columns), i.e. the cross-block redundancy model of nbody-par.c:302-308.
    ``gi0``/``gj0`` are the blocks' GLOBAL starting body indices (traced or
    static): self-pairs are wherever gi0+i == gj0+j, and coincident distinct
    pairs get the reference's sign(gj - gi) * force kick along +x (see module
    docstring).  ``gids`` overrides the contiguous ids (see _pair_sign).
    """
    dtype = xi.dtype
    dx = xj[None, :] - xi[:, None]
    dy = yj[None, :] - yi[:, None]
    dsqr = dx * dx + dy * dy
    mind = ri[:, None] + rj[None, :]
    forced = jnp.maximum(jnp.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    base = mi[:, None] * mj[None, :] * cfg.gravity / forced
    # Direction = unit vector of (dx, dy): cos(atan2(dy,dx)) == dx * rsqrt(dsqr).
    inv_r = jnp.where(dsqr > 0, lax.rsqrt(jnp.maximum(dsqr, _DENOM_FLOOR)),
                      jnp.zeros((), dtype))
    scale = base * inv_r
    # Coincident pairs: scale * dx == 0 there, so add the atan2(0,0)-limit
    # kick.  sign(gj - gi) is 0 exactly on self-pairs, masking them for free;
    # zero-mass padding keeps base == 0.
    ni, nj = dx.shape
    sgn = _pair_sign(dtype, ni, nj, gi0, gj0, gids)
    coin = dsqr == 0
    zero = jnp.zeros((), dtype)
    fx = scale * dx + jnp.where(coin, base * sgn, zero)
    return jnp.sum(fx, axis=1), jnp.sum(scale * dy, axis=1)


def _trig_cross_block(cfg, xi, yi, mi, ri, xj, yj, mj, rj, gi0, gj0,
                      force_mask=None, gids=None):
    """One-sided trig force of column block J on row block I (cross-block
    pairs of the sharded decomposition; nbody-par.c:302-308 analog).

    Applies the reference's coincident semantics by GLOBAL index (the
    reference's own par binary diverges from seq here; we follow seq — see
    module docstring).  ``force_mask`` (bool, (ni, nj)) optionally zeroes
    pair forces (used to drop own-block columns handled by the triangle);
    ``gids`` overrides the contiguous global ids (see _pair_sign).
    """
    dtype = xi.dtype
    zero = jnp.zeros((), dtype)
    dx = xj[None, :] - xi[:, None]
    dy = yj[None, :] - yi[:, None]
    angle = jnp.arctan2(dy, dx)
    dsqr = dx * dx + dy * dy
    mind = ri[:, None] + rj[None, :]
    forced = jnp.maximum(jnp.maximum(dsqr, mind * mind), _DENOM_FLOOR)
    force = mi[:, None] * mj[None, :] * cfg.gravity / forced
    if force_mask is not None:
        force = jnp.where(force_mask, zero, force)
    ni, nj = dx.shape
    sgn = _pair_sign(dtype, ni, nj, gi0, gj0, gids)
    coin = dsqr == 0  # includes self-pairs; sgn == 0 there
    fx = jnp.where(coin, force * sgn, force * jnp.cos(angle))
    fy = jnp.where(coin, zero, force * jnp.sin(angle))
    return jnp.sum(fx, axis=1), jnp.sum(fy, axis=1)


def forces_block_vs_full(cfg: SimConfig, x_blk, y_blk, m_blk, r_blk,
                         x_full, y_full, m_full, r_full, blk_offset):
    """Force on an owned body block from ALL bodies (gathered full arrays).

    This is the sharded analog of nbody-par.c:285-359: the owned block's
    internal pairs use the once-per-pair triangle accumulation (parity with
    the sequential program), while owned-vs-remote pairs are one-sided.
    ``blk_offset`` (traced) is the block's global starting index.

    In "fast" mode the whole thing is a single one-sided pass (self-pairs
    and coincident pairs handled by global index inside _forces_fast_block).
    """
    shard = x_blk.shape[0]
    n = x_full.shape[0]

    if cfg.force_mode == "trig":
        cols = lax.broadcasted_iota(jnp.int32, (shard, n), 1)
        own = (cols >= blk_offset) & (cols < blk_offset + shard)
        xf, yf = _trig_cross_block(cfg, x_blk, y_blk, m_blk, r_blk,
                                   x_full, y_full, m_full, r_full,
                                   blk_offset, 0, force_mask=own)
        fx, fy = pair_forces_trig(cfg, x_blk, y_blk, m_blk, r_blk)
        return (xf + jnp.sum(fx, axis=1) - jnp.sum(fx, axis=0),
                yf + jnp.sum(fy, axis=1) - jnp.sum(fy, axis=0))

    return _forces_fast_block(cfg, x_blk, y_blk, m_blk,
                              x_full, y_full, m_full, r_blk, r_full,
                              blk_offset, 0)


def forces_on_block(cfg: SimConfig, xi, yi, mi, ri, xj, yj, mj, rj,
                    same_block: bool, gi0=0, gj0=0):
    """Public block-on-block force (used by the sharded and ring paths).

    ``gi0``/``gj0``: global starting indices of the two blocks (needed for
    self-pair masking and coincident-pair signs when the blocks overlap or
    contain coincident bodies).
    """
    if cfg.force_mode == "trig" and same_block:
        fx, fy = pair_forces_trig(cfg, xi, yi, mi, ri)
        return jnp.sum(fx, axis=1) - jnp.sum(fx, axis=0), \
               jnp.sum(fy, axis=1) - jnp.sum(fy, axis=0)
    if cfg.force_mode == "trig":
        return _trig_cross_block(cfg, xi, yi, mi, ri, xj, yj, mj, rj,
                                 gi0, gj0)
    return _forces_fast_block(cfg, xi, yi, mi, xj, yj, mj, ri, rj, gi0, gj0)
