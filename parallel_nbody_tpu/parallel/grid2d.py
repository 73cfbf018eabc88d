"""2-D interaction-matrix decomposition over a (rows, cols) device mesh.

The reference (and this repo's 1-D paths) decompose the BODY axis: every
chip owns N/P bodies and per-step communication moves O(N) positions
(all-gather) or O(N) cumulative ring traffic.  The classic force-matrix
decomposition (Plimpton 1995) shards the N x N interaction matrix over a
2-D processor grid instead — mapped here onto a device mesh
``Mesh((Pr, Pc), ("rows", "cols"))``:

  - bodies are block-sharded over all P = Pr*Pc chips (PartitionSpec over
    the combined ("rows", "cols") axes — chip (r, c) owns block r*Pc + c);
  - per step, chip (r, c) all-gathers its ROW GROUP over the "cols" axis
    (the contiguous N/Pr bodies of row-block r) and its COL GROUP over the
    "rows" axis (the strided N/Pc bodies whose block index = c mod Pc);
  - it computes the (N/Pr x N/Pc) partial force block one-sidedly, masking
    true self-pairs by global body index;
  - a psum over "cols" reduces partial forces into the total force on the
    row group, from which the chip slices its own N/P bodies and integrates.

Per-step comm per chip: O(N/Pr) + O(N/Pc) gathered positions + an O(N/Pr)
psum — O(N/sqrt(P)) for a square mesh, vs O(N) for the 1-D all-gather.
This is the scaling path for large P where the 1-D gather saturates the
interconnect.

Compute per chip is (N/Pr)(N/Pc) = N^2/P pairs — identical to the 1-D
schemes; only the communication volume changes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..ops.integrate import compute_positions, compute_velocities
from ..state import State
from .mesh import device_grid, shard_state

ROW_AXIS = "rows"
COL_AXIS = "cols"

_SPEC = P((ROW_AXIS, COL_AXIS))


def make_mesh2d(pr: int, pc: int, devices=None) -> Mesh:
    """(pr, pc) mesh over ("rows", "cols").  Strict about device counts
    (same policy as mesh.make_mesh)."""
    if devices is None:
        devices = jax.devices()
    need = pr * pc
    if need > len(devices):
        raise ValueError(
            "requested a %dx%d mesh (%d devices) but only %d device(s) are "
            "available" % (pr, pc, need, len(devices)))
    return Mesh(device_grid((pr, pc), devices[:need]), (ROW_AXIS, COL_AXIS))


def body_sharding_2d(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, _SPEC)


def _block_forces_masked(cfg, xi, yi, mi, ri, xj, yj, mj, rj, gid_i, gid_j):
    """One-sided force of col set J on row set I with true self-pairs
    (same global body) masked by id.  Thin wrapper over the shared per-pair
    physics in ops/forces.py (trig and fast, including the coincident-pair
    ``sign(gj - gi) * force`` kick) — the col group is STRIDED, so the
    explicit ``gids`` vectors replace contiguous block offsets."""
    from ..ops.forces import _forces_fast_block, _trig_cross_block

    if cfg.force_mode == "trig":
        return _trig_cross_block(cfg, xi, yi, mi, ri, xj, yj, mj, rj,
                                 0, 0, gids=(gid_i, gid_j))
    return _forces_fast_block(cfg, xi, yi, mi, xj, yj, mj, ri, rj,
                              0, 0, gids=(gid_i, gid_j))


def _grid2d_run_local(cfg: SimConfig, steps: int,
                      x, y, xv, yv, xf, yf, m, r):
    """Per-device program for the 2-D decomposition."""
    blk = x.shape[0]                       # N/P bodies owned
    pr = lax.axis_size(ROW_AXIS)
    pc = lax.axis_size(COL_AXIS)
    my_r = lax.axis_index(ROW_AXIS)
    my_c = lax.axis_index(COL_AXIS)

    # Global ids of the row group (contiguous) and col group (strided).
    row_n = blk * pc
    gid_row = my_r * row_n + jnp.arange(row_n, dtype=jnp.int32)
    rr = jnp.arange(pr, dtype=jnp.int32)
    gid_col = ((rr[:, None] * pc + my_c) * blk
               + jnp.arange(blk, dtype=jnp.int32)[None, :]).reshape(-1)

    # Masses/radii never change: gather the groups once (the Bcast analog).
    m_row = lax.all_gather(m, COL_AXIS, tiled=True)
    r_row = lax.all_gather(r, COL_AXIS, tiled=True)
    m_col = lax.all_gather(m, ROW_AXIS, tiled=True)
    r_col = lax.all_gather(r, ROW_AXIS, tiled=True)

    def body(_, carry):
        x, y, xv, yv, xf, yf = carry
        # Per-step positional exchange: O(N/Pr) + O(N/Pc) per chip.
        x_row = lax.all_gather(x, COL_AXIS, tiled=True)
        y_row = lax.all_gather(y, COL_AXIS, tiled=True)
        x_col = lax.all_gather(x, ROW_AXIS, tiled=True)
        y_col = lax.all_gather(y, ROW_AXIS, tiled=True)

        if cfg.kernel == "pallas":
            # The kernel handles self-pairs and coincident pairs via global
            # indices, but its offsets describe CONTIGUOUS blocks — the col
            # group is strided (one blk-sized chunk per mesh row), so call
            # the kernel once per contiguous chunk and accumulate.  The
            # coincident-pair bias is gated per
            # step by the gid-tagged duplicate test over row+col groups
            # (copies of one body appearing in both groups are ignored) —
            # the grid2d analog of the allgather path's runtime dispatch.
            from ..ops.pallas_step import (any_coincident_tagged,
                                           pallas_block_forces)

            def cell_forces(biased):
                fx = jnp.zeros_like(x_row)
                fy = jnp.zeros_like(y_row)
                for rr_c in range(pr):
                    sl = slice(rr_c * blk, (rr_c + 1) * blk)
                    dfx, dfy = pallas_block_forces(
                        cfg, x_row, y_row, m_row, r_row,
                        x_col[sl], y_col[sl], m_col[sl], r_col[sl],
                        row_g0=my_r * row_n,
                        col_g0=(rr_c * pc + my_c) * blk,
                        accum=cfg.accum, biased=biased)
                    fx = fx + dfx
                    fy = fy + dfy
                return fx, fy

            flag = any_coincident_tagged(
                jnp.concatenate([x_row, x_col]),
                jnp.concatenate([y_row, y_col]),
                jnp.concatenate([m_row, m_col]),
                jnp.concatenate([gid_row, gid_col]))
            fx, fy = lax.cond(flag, lambda _: cell_forces(True),
                              lambda _: cell_forces(False), None)
        else:
            fx, fy = _block_forces_masked(
                cfg, x_row, y_row, m_row, r_row, x_col, y_col, m_col, r_col,
                gid_row, gid_col)

        # Total force on the row group; replicated over the cols axis.
        fx = lax.psum(fx, COL_AXIS)
        fy = lax.psum(fy, COL_AXIS)
        # Our own bodies are the my_c-th block of the row group.
        xf = lax.dynamic_slice_in_dim(fx, my_c * blk, blk)
        yf = lax.dynamic_slice_in_dim(fy, my_c * blk, blk)

        xv, yv = compute_velocities(cfg, xv, yv, xf, yf, m)
        x, y, xv, yv = compute_positions(cfg, x, y, xv, yv, mass=m)
        return x, y, xv, yv, xf, yf

    x, y, xv, yv, xf, yf = lax.fori_loop(
        0, steps, body, (x, y, xv, yv, xf, yf))
    return x, y, xv, yv, xf, yf, m, r


def make_grid2d_run(cfg: SimConfig, mesh: Mesh, steps: int):
    """Jitted 2-D-decomposed runner: State (body-sharded over the flattened
    (rows, cols) axes, padded to pr*pc) -> State after ``steps`` steps."""
    local = functools.partial(_grid2d_run_local, cfg, steps)
    sharded = shard_map(local, mesh=mesh,
                        in_specs=(_SPEC,) * 8, out_specs=(_SPEC,) * 8,
                        check_vma=cfg.kernel != "pallas")

    @jax.jit
    def run_sharded(state: State) -> State:
        return State(*sharded(*state))

    return run_sharded


def shard_state_2d(state: State, mesh: Mesh) -> State:
    """Place the state body-sharded over the flattened 2-D mesh."""
    return shard_state(state, mesh, sharding=body_sharding_2d(mesh))
