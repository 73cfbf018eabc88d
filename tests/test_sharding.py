"""Sharding-grid invariance — the JAX analog of the reference's NP-grid
differential tests (bin/run-tests.sh: every NP in 1..8 must byte-match the
sequential oracle).  Here: 1/2/4/8-way body shards on a virtual CPU mesh must
produce output identical to the single-device fp64 run (and hence to the
golden fixtures).
"""

import os

import numpy as np
import pytest

import jax

from parallel_nbody_tpu.config import SimConfig
from parallel_nbody_tpu.models.engine import run
from parallel_nbody_tpu.parallel.mesh import make_mesh, shard_state
from parallel_nbody_tpu.parallel.sharded_step import make_sharded_run
from parallel_nbody_tpu.state import init_state, pad_state, unpad_state
from parallel_nbody_tpu.utils.output import format_state

CFG = SimConfig(xdim=1024, ydim=768, force_mode="trig", dtype="float64")
STEPS = 100
N = 97  # prime, so every shard count > 1 exercises pad_state remainders


def _run_sharded(n_dev, comm, cfg=CFG, n=N, steps=STEPS):
    mesh = make_mesh(n_dev)
    # Guard against vacuously-green runs on a truncated mesh (the round-1
    # failure mode): the mesh must really have n_dev devices.
    assert mesh.size == n_dev, (mesh.size, n_dev)
    st = init_state(n, cfg)
    padded, n_real = pad_state(st, n_dev)
    padded = shard_state(padded, mesh)
    out = make_sharded_run(cfg, mesh, steps, comm)(padded)
    return unpad_state(jax.device_get(out), n_real)


@pytest.fixture(scope="module")
def seq_output():
    return format_state(run(CFG, init_state(N, CFG), STEPS))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_allgather_invariance(n_dev, seq_output):
    out = _run_sharded(n_dev, "allgather")
    assert format_state(out) == seq_output


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_ring_invariance(n_dev, seq_output):
    out = _run_sharded(n_dev, "ring")
    assert format_state(out) == seq_output


def test_sharded_matches_golden_fixture():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "128_MY_REF_OUTPUT")
    out = _run_sharded(8, "allgather", n=128, steps=1000)
    assert format_state(out) == open(path).read()


def test_fast_mode_sharded_close_to_seq():
    cfg = CFG.replace(force_mode="fast")
    seq = run(cfg, init_state(N, cfg), STEPS)
    out = _run_sharded(4, "ring", cfg=cfg)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(seq.x),
                               rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.yv), np.asarray(seq.yv),
                               rtol=1e-9, atol=1e-7)


def test_make_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="9-device mesh"):
        make_mesh(9)


def test_padding_bodies_stay_inert():
    mesh = make_mesh(8)
    st = init_state(10, CFG)  # pads 10 -> 16
    padded, n_real = pad_state(st, 8)
    padded = shard_state(padded, mesh)
    out = jax.device_get(make_sharded_run(CFG, mesh, 50, "allgather")(padded))
    assert n_real == 10
    np.testing.assert_array_equal(np.asarray(out.mass[n_real:]), 0.0)
    np.testing.assert_array_equal(np.asarray(out.xv[n_real:]), 0.0)
    # Padding must stay PARKED far outside the arena (state.py pad_state
    # invariant): without the mass-gated freeze in compute_positions the
    # wall clamp would drag it to the (xdim-1, ydim-1) corner on step 1,
    # where it can alias a really-bounced body in the coincidence detectors.
    np.testing.assert_array_equal(np.asarray(out.x[n_real:]), 1e9)
    np.testing.assert_array_equal(np.asarray(out.y[n_real:]), 1e9)


@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_padding_stays_parked_sharded(comm):
    mesh = make_mesh(4)
    st = init_state(10, CFG)  # pads 10 -> 12
    padded, n_real = pad_state(st, 4)
    padded = shard_state(padded, mesh)
    out = jax.device_get(make_sharded_run(CFG, mesh, 20, comm)(padded))
    np.testing.assert_array_equal(np.asarray(out.x[n_real:]), 1e9)
    np.testing.assert_array_equal(np.asarray(out.y[n_real:]), 1e9)


def test_padding_stays_parked_grid2d():
    from parallel_nbody_tpu.parallel.grid2d import (make_grid2d_run,
                                                    make_mesh2d,
                                                    shard_state_2d)
    mesh = make_mesh2d(2, 4)
    st = init_state(10, CFG)  # pads 10 -> 16
    padded, n_real = pad_state(st, 8)
    padded = shard_state_2d(padded, mesh)
    out = jax.device_get(make_grid2d_run(CFG, mesh, 20)(padded))
    np.testing.assert_array_equal(np.asarray(out.x[n_real:]), 1e9)
    np.testing.assert_array_equal(np.asarray(out.y[n_real:]), 1e9)


def test_oversubscribed_mesh_empty_shards_exact(seq_output_small):
    """More shards than bodies is legal, not an error: pad_state rounds N=4
    up to the 8-device shard multiple, the surplus shards own only parked
    padding bodies, and the result still byte-matches the single-device
    fp64 run (byte-verified against the reference binary itself at this
    config during round-5 probing).  Guards the claim in bin/fuzz_gen.py
    that the generator's devices<=N cap is conservatism, not a CLI limit."""
    for comm in ("allgather", "ring"):
        out = _run_sharded(8, comm, n=4, steps=STEPS)
        assert format_state(out) == seq_output_small, comm


def test_oversubscribed_grid2d_exact(seq_output_small):
    """Grid2d analog: a 2x4 grid over N=4 leaves whole row/col groups with
    nothing but padding; output must stay exact."""
    from parallel_nbody_tpu.parallel.grid2d import (make_grid2d_run,
                                                    make_mesh2d,
                                                    shard_state_2d)
    mesh = make_mesh2d(2, 4)
    st = init_state(4, CFG)
    padded, n_real = pad_state(st, 8)
    padded = shard_state_2d(padded, mesh)
    out = jax.device_get(make_grid2d_run(CFG, mesh, STEPS)(padded))
    assert format_state(unpad_state(out, n_real)) == seq_output_small


@pytest.fixture(scope="module")
def seq_output_small():
    return format_state(run(CFG, init_state(4, CFG), STEPS))


def test_device_grid_covers_all_devices_once():
    """device_grid must be a permutation of the requested devices in the
    requested shape."""
    from parallel_nbody_tpu.parallel.mesh import device_grid
    devs = jax.devices()[:6]
    grid = device_grid((2, 3), devs)
    assert grid.shape == (2, 3)
    assert {d.id for d in grid.ravel()} == {d.id for d in devs}


@pytest.mark.parametrize("shape", [(4,), (2, 2), (2, 4), (8,)])
def test_device_grid_keeps_id_order(shape):
    """Devices joined all to all (NVLink) need no topology-aware placement:
    the grid is the caller's list, in order, reshaped — also for a list
    that is not sorted by id."""
    import math

    from parallel_nbody_tpu.parallel.mesh import device_grid
    devs = jax.devices()[:math.prod(shape)][::-1]
    grid = device_grid(shape, devs)
    assert grid.shape == shape
    assert [d.id for d in grid.ravel()] == [d.id for d in devs]
