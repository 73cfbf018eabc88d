"""Physics-invariant property tests — correctness depth the reference's
golden-diff strategy lacks (SURVEY.md §4: "add what the reference lacks").

The force law F_ij = G·m_i·m_j·(r_j - r_i)/ (max(d², (R_i+R_j)²)·d) must be:
translation-invariant, equivariant under axis swap, antisymmetric
(Newton's 3rd), and mass-scaling bilinear.  Checked for the dense trig and
fast paths and the Pallas kernel (interpret mode).
"""

import jax
import numpy as np
import pytest

from parallel_nbody_tpu.config import SimConfig
from parallel_nbody_tpu.ops.forces import (compute_forces_dense,
                                           pair_forces_trig)
from parallel_nbody_tpu.ops.pallas_step import pallas_forces
from parallel_nbody_tpu.state import random_state

F64 = SimConfig(force_mode="trig", dtype="float64")
FAST = SimConfig(force_mode="fast", dtype="float64")


def _forces(cfg, st, dx=0.0, dy=0.0, swap=False):
    x, y = st.x + dx, st.y + dy
    if swap:
        x, y = y, x
    if cfg.kernel == "pallas":
        return pallas_forces(cfg, x, y, st.mass, st.radius)
    return compute_forces_dense(cfg, x, y, st.mass, st.radius)


CFGS = [F64, FAST, FAST.replace(kernel="pallas", dtype="float32")]
IDS = ["trig", "fast", "pallas"]


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_translation_invariance(cfg):
    st = random_state(64, cfg, jax.random.PRNGKey(0))
    xf0, yf0 = _forces(cfg, st)
    xf1, yf1 = _forces(cfg, st, dx=37.5, dy=-12.25)
    tol = 1e-9 if cfg.dtype == "float64" else 2e-3
    np.testing.assert_allclose(np.asarray(xf1), np.asarray(xf0),
                               rtol=tol, atol=tol * 100)
    np.testing.assert_allclose(np.asarray(yf1), np.asarray(yf0),
                               rtol=tol, atol=tol * 100)


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_axis_swap_equivariance(cfg):
    # Swapping x<->y coordinates must swap the force components exactly
    # (the math treats the axes symmetrically).
    st = random_state(64, cfg, jax.random.PRNGKey(1))
    xf, yf = _forces(cfg, st)
    xf_s, yf_s = _forces(cfg, st, swap=True)
    tol = 1e-9 if cfg.dtype == "float64" else 2e-3
    np.testing.assert_allclose(np.asarray(xf_s), np.asarray(yf),
                               rtol=tol, atol=tol * 100)
    np.testing.assert_allclose(np.asarray(yf_s), np.asarray(xf),
                               rtol=tol, atol=tol * 100)


def test_pair_matrix_newton_third_law():
    # The trig pair matrix is strictly upper-triangular; total momentum
    # change is exactly zero by construction (fx applied +/-).
    st = random_state(48, F64, jax.random.PRNGKey(2))
    fx, fy = pair_forces_trig(F64, st.x, st.y, st.mass, st.radius)
    fx = np.asarray(fx)
    assert np.count_nonzero(np.tril(fx)) == 0
    xf, yf = compute_forces_dense(F64, st.x, st.y, st.mass, st.radius)
    assert abs(float(np.sum(np.asarray(xf)))) < 1e-9 * np.abs(xf).max()
    assert abs(float(np.sum(np.asarray(yf)))) < 1e-9 * np.abs(yf).max()


@pytest.mark.parametrize("cfg", [F64, FAST], ids=["trig", "fast"])
def test_mass_bilinearity(cfg):
    # Scaling every mass by c scales every force by c^2 (F ~ m_i * m_j).
    st = random_state(32, cfg, jax.random.PRNGKey(3))
    xf, yf = compute_forces_dense(cfg, st.x, st.y, st.mass, st.radius)
    xf2, yf2 = compute_forces_dense(cfg, st.x, st.y, 3.0 * st.mass,
                                    st.radius)
    np.testing.assert_allclose(np.asarray(xf2), 9.0 * np.asarray(xf),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(yf2), 9.0 * np.asarray(yf),
                               rtol=1e-12)


def test_two_body_central_force_direction():
    # Two bodies attract along the line joining them, toward each other.
    import jax.numpy as jnp
    from parallel_nbody_tpu.state import State
    x = jnp.array([100.0, 200.0])
    y = jnp.array([100.0, 150.0])
    m = jnp.array([5.0, 7.0])
    r = jnp.array([1.0, 1.0])
    xf, yf = compute_forces_dense(F64, x, y, m, r)
    # Body 0 pulled toward body 1 (+x, +y); body 1 the reverse.
    assert xf[0] > 0 and yf[0] > 0
    assert xf[1] < 0 and yf[1] < 0
    # Direction parallel to the separation vector.
    assert np.isclose(float(yf[0] / xf[0]), 50.0 / 100.0, rtol=1e-12)
