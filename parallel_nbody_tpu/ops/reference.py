"""Plain NumPy float64 reference for the fast-mode force law.

Independent of the JAX code under test: a direct double-precision sum over
every column for a chosen set of rows, with the reference's coincident-pair
rule (two distinct bodies at one position kick each other along +-x by
global index, nbody-seq.c:91-106).  Used to check compiled force kernels at
real widths, where the full O(N^2) oracle would be too slow on the host.
"""

from __future__ import annotations

import numpy as np


def sampled_forces(gravity: float, x, y, mass, radius, rows,
                   col_chunk: int = 1 << 16):
    """Float64 force on bodies ``rows`` from all bodies.

    Returns (fx, fy), each of shape (len(rows),)."""
    x, y, mass, radius = (np.asarray(a, np.float64)
                          for a in (x, y, mass, radius))
    rows = np.asarray(rows)
    xi, yi, mi, ri = (a[rows][:, None] for a in (x, y, mass, radius))
    gi = rows[:, None]
    fx = np.zeros(rows.shape[0])
    fy = np.zeros(rows.shape[0])
    for c0 in range(0, x.shape[0], col_chunk):
        cols = slice(c0, c0 + col_chunk)
        dx = x[None, cols] - xi
        dy = y[None, cols] - yi
        dsqr = dx * dx + dy * dy
        mind = ri + radius[None, cols]
        forced = np.maximum(dsqr, mind * mind)
        force = gravity * mi * mass[None, cols] / forced
        dist = np.sqrt(dsqr)
        with np.errstate(divide="ignore", invalid="ignore"):
            ux = np.where(dsqr > 0, dx / dist, 0.0)
            uy = np.where(dsqr > 0, dy / dist, 0.0)
        gj = np.arange(c0, c0 + dx.shape[1])[None, :]
        ux = ux + np.where(dsqr == 0, np.sign(gj - gi), 0.0)
        fx += np.sum(force * ux, axis=1)
        fy += np.sum(force * uy, axis=1)
    return fx, fy


def relative_error(got, want) -> float:
    """max |got - want| / max |want| over both components."""
    got = np.concatenate([np.asarray(g, np.float64).ravel() for g in got])
    want = np.concatenate([np.asarray(w, np.float64).ravel() for w in want])
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
