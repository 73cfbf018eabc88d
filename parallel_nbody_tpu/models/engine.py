"""Single-device simulation engine.

The reference's hot loop (nbody-seq.c:457-472) is
``clear_forces -> compute_forces -> compute_velocities -> compute_positions``
with a buffer flip.  Here the whole loop runs on-device under one ``jit`` via
``lax.scan`` / ``lax.fori_loop`` (no host round-trips between steps); the
functional state update replaces the flip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SimConfig
from ..ops.forces import compute_forces_dense
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State


def step(cfg: SimConfig, state: State) -> State:
    """One simulation step (force -> velocity -> position)."""
    if cfg.kernel == "pallas":
        from ..ops.pallas_step import (forces_coincident_dispatch,
                                       pallas_forces)

        # Coincident-pair dispatch: the dx-bias machinery that reproduces
        # the reference's atan2(0,0) kick (nbody-seq.c:91-106) adds per-pair
        # work to the O(N^2) inner loop.  An exact O(N log N)
        # duplicate-position test selects the biased kernel only on steps
        # that actually contain coincident distinct bodies — the first
        # step(s) of a glibc integer-pixel init — so every other step runs
        # the cheaper kernel with identical results.
        xf, yf = forces_coincident_dispatch(
            state.x, state.y, state.mass,
            lambda biased: pallas_forces(
                cfg, state.x, state.y, state.mass, state.radius,
                biased=biased, accum=cfg.accum))
    else:
        xf, yf = compute_forces_dense(cfg, state.x, state.y, state.mass,
                                      state.radius)
    xv, yv = compute_velocities(cfg, state.xv, state.yv, xf, yf, state.mass)
    x, y, xv, yv = compute_positions(cfg, state.x, state.y, xv, yv,
                                     mass=state.mass)
    return State(x, y, xv, yv, xf, yf, state.mass, state.radius)


@functools.partial(jax.jit, static_argnums=(0, 2))
def run(cfg: SimConfig, state: State, steps: int) -> State:
    """Run ``steps`` simulation steps fully on device."""

    def body(_, s):
        return step(cfg, s)

    return lax.fori_loop(0, steps, body, state)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def run_trajectory(cfg: SimConfig, state: State, steps: int,
                   record_every: int = 1):
    """Run ``steps`` steps, recording (x, y) every ``record_every`` steps.

    Returns (final_state, xs, ys) where xs/ys have shape
    (steps // record_every, N).  Used for animation / analysis.
    """

    def body(s, _):
        def inner(_, s2):
            return step(cfg, s2)

        s = lax.fori_loop(0, record_every, inner, s)
        return s, (s.x, s.y)

    final, (xs, ys) = lax.scan(body, state, None, length=steps // record_every)
    return final, xs, ys


def total_energy(cfg: SimConfig, state: State) -> jnp.ndarray:
    """Diagnostic: kinetic + (softened) potential energy.

    The reference has no energy accounting; this supports the long-run drift
    regression (SURVEY.md §4, BASELINE.json config 3).  Uses the same softened
    denominator as the force law (potential consistent with
    F = -G m_i m_j / max(d^2, mind^2) along the pair axis).
    """
    ke = 0.5 * jnp.sum(state.mass * (state.xv**2 + state.yv**2))
    dx = state.x[None, :] - state.x[:, None]
    dy = state.y[None, :] - state.y[:, None]
    dsqr = dx * dx + dy * dy
    mind = state.radius[:, None] + state.radius[None, :]
    d = jnp.sqrt(jnp.maximum(jnp.maximum(dsqr, mind * mind), 1e-30))
    n = state.n
    rows = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    pair_pe = jnp.where(rows < cols,
                        -cfg.gravity * state.mass[:, None]
                        * state.mass[None, :] / d,
                        jnp.zeros((), state.x.dtype))
    return ke + jnp.sum(pair_pe)
