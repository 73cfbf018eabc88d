"""2-D interaction-matrix decomposition (parallel/grid2d.py): every mesh
shape must reproduce the single-device output — the same re-partitioning
invariance the reference demands of its NP grid, extended to the 2-D
force-matrix scheme the reference never had."""

import jax
import numpy as np
import pytest

from parallel_nbody_tpu.config import SimConfig
from parallel_nbody_tpu.models.engine import run
from parallel_nbody_tpu.parallel.grid2d import (make_grid2d_run, make_mesh2d,
                                                shard_state_2d)
from parallel_nbody_tpu.state import init_state, pad_state, unpad_state
from parallel_nbody_tpu.utils.output import format_state

CFG = SimConfig(xdim=1024, ydim=768, force_mode="trig", dtype="float64")
STEPS = 100
N = 100  # not a multiple of 8 -> exercises padding


def _run_grid2d(pr, pc, cfg=CFG, n=N, steps=STEPS):
    mesh = make_mesh2d(pr, pc)
    assert mesh.shape["rows"] == pr and mesh.shape["cols"] == pc
    st = init_state(n, cfg)
    padded, n_real = pad_state(st, pr * pc)
    padded = shard_state_2d(padded, mesh)
    out = make_grid2d_run(cfg, mesh, steps)(padded)
    return unpad_state(jax.device_get(out), n_real)


@pytest.fixture(scope="module")
def seq_output():
    return format_state(run(CFG, init_state(N, CFG), STEPS))


@pytest.mark.parametrize("pr, pc", [(1, 1), (2, 2), (2, 4), (4, 2),
                                    (8, 1), (1, 8)])
def test_grid2d_invariance(pr, pc, seq_output):
    assert format_state(_run_grid2d(pr, pc)) == seq_output


def test_grid2d_fast_mode_close_to_seq():
    cfg = CFG.replace(force_mode="fast")
    seq = run(cfg, init_state(N, cfg), STEPS)
    out = _run_grid2d(2, 4, cfg=cfg)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(seq.x),
                               rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.yv), np.asarray(seq.yv),
                               rtol=1e-9, atol=1e-7)


def test_grid2d_pallas_close_to_seq():
    cfg = SimConfig(xdim=1024, ydim=768, force_mode="fast", dtype="float32",
                    kernel="pallas")
    seq = run(cfg.replace(kernel="xla"), init_state(64, cfg), 5)
    out = _run_grid2d(2, 2, cfg=cfg, n=64, steps=5)
    np.testing.assert_allclose(np.asarray(out.x), np.asarray(seq.x),
                               rtol=1e-4, atol=1e-3)


def test_mesh2d_strict():
    with pytest.raises(ValueError, match="3x4"):
        make_mesh2d(3, 4)


@pytest.mark.slow
def test_grid2d_matches_grader_oracle():
    # The instructor's 100000-step oracle (bin/REF_OUTPUT) reproduced
    # through the 2-D decomposition.
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "REF_OUTPUT")
    out = _run_grid2d(2, 4, n=32, steps=100000)
    assert format_state(out) == open(path).read()
