"""Simulation state as a functional SoA pytree.

The reference stores bodies as a double-buffered array-of-structs
(``struct bodyType`` with ``x[2]/y[2]``, nbody/nbody-seq.c:30-50) and flips an
``old`` bit each step.  Here: structure-of-arrays ``jnp`` vectors in an
immutable pytree — functional updates make the buffer flip disappear, and
1-D SoA vectors map directly onto the force kernel's row and column tiles.

Forces are carried in the state even though they are recomputed every step,
because the reference's output contract prints the final step's forces
(nbody/nbody-seq.c:356-365).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .config import SEED, SimConfig
from .utils import glibc_rand


class State(NamedTuple):
    """SoA body state.  All arrays have shape ``(N,)`` (or ``(shard,)`` under
    shard_map) and a common float dtype."""

    x: jnp.ndarray
    y: jnp.ndarray
    xv: jnp.ndarray
    yv: jnp.ndarray
    xf: jnp.ndarray
    yf: jnp.ndarray
    mass: jnp.ndarray
    radius: jnp.ndarray

    @property
    def n(self) -> int:
        return self.x.shape[0]


def _checked_cast(arr: np.ndarray, dtype, name: str) -> np.ndarray:
    """Cast a finite float64 init array to the run dtype, failing LOUDLY if
    the cast overflows to inf (a run whose inputs are already non-finite can
    only print NaNs with exit code 0 — the silent-garbage failure mode the
    dtype envelope exists to prevent)."""
    with np.errstate(over="ignore"):  # the inf IS the signal; raise below
        out = np.asarray(arr, dtype=np.float64).astype(dtype)
    bad = ~np.isfinite(out.astype(np.float64)) & np.isfinite(arr)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            "initial %s[%d] = %r overflows dtype %s (finite max %r); this "
            "dtype cannot represent the reference init law at this N/arena "
            "— use a wider dtype" % (name, i, float(arr[i]), np.dtype(dtype),
                                     float(np.finfo(dtype).max)))
    return out


def init_state(n: int, cfg: SimConfig, seed: int = SEED) -> State:
    """Reference-parity initialization (glibc rand replica; see
    utils/glibc_rand.py and nbody/nbody-seq.c:440-449)."""
    x, y, xv, yv, mass, radius = glibc_rand.nbody_init_arrays(
        n, cfg.xdim, cfg.ydim, seed
    )
    dtype = jnp.dtype(cfg.dtype)
    mass = _checked_cast(mass, dtype, "mass")
    radius = _checked_cast(radius, dtype, "radius")
    zeros = np.zeros(n, dtype=np.float64)
    return State(
        x=jnp.asarray(x, dtype),
        y=jnp.asarray(y, dtype),
        xv=jnp.asarray(xv, dtype),
        yv=jnp.asarray(yv, dtype),
        xf=jnp.asarray(zeros, dtype),
        yf=jnp.asarray(zeros, dtype),
        mass=jnp.asarray(mass, dtype),
        radius=jnp.asarray(radius, dtype),
    )


def random_state(n: int, cfg: SimConfig, key) -> State:
    """Fast non-parity initialization with ``jax.random`` (for benchmarks and
    large-N runs where glibc parity is irrelevant)."""
    import jax

    dtype = jnp.dtype(cfg.dtype)
    kx, ky, kvx, kvy = jax.random.split(key, 4)
    x = jax.random.uniform(kx, (n,), dtype, 0.0, cfg.xdim)
    y = jax.random.uniform(ky, (n,), dtype, 0.0, cfg.ydim)
    xv = jax.random.uniform(kvx, (n,), dtype, -5.0, 5.0)
    yv = jax.random.uniform(kvy, (n,), dtype, -5.0, 5.0)
    b = jnp.arange(n, dtype=dtype)
    diag = jnp.sqrt(jnp.asarray(cfg.xdim**2 + cfg.ydim**2, dtype))
    radius = 1.0 + ((b * b + 1.0) * diag) / (25.0 * (n * n + 1.0))
    mass = radius**3
    zeros = jnp.zeros(n, dtype)
    return State(x, y, xv, yv, zeros, zeros, mass, radius)


def pad_state(state: State, multiple: int) -> tuple[State, int]:
    """Pad the body axis up to a multiple (for sharding / tiling).

    Padding bodies get zero mass (so they exert no force), zero velocity, and
    positions far outside the arena so softening never couples them to real
    bodies.  Returns (padded_state, original_n).
    """
    n = state.n
    rem = (-n) % multiple
    if rem == 0:
        return state, n
    dtype = state.x.dtype

    def pad(a, fill):
        return jnp.concatenate([a, jnp.full((rem,), fill, dtype)])

    far = jnp.asarray(1e9, dtype)
    return (
        State(
            x=pad(state.x, far),
            y=pad(state.y, far),
            xv=pad(state.xv, 0.0),
            yv=pad(state.yv, 0.0),
            xf=pad(state.xf, 0.0),
            yf=pad(state.yf, 0.0),
            mass=pad(state.mass, 0.0),
            radius=pad(state.radius, 0.0),
        ),
        n,
    )


def unpad_state(state: State, n: int) -> State:
    if state.n == n:
        return state
    return State(*(a[:n] for a in state))
