"""Multi-device / multi-host parallel layer (the reference's MPI layer):
1-D body-axis sharding with all-gather or ppermute-ring comm
(sharded_step), 2-D force-matrix decomposition (grid2d), mesh helpers,
distributed launch (multihost), and the virtual-mesh dryrun gate."""

from .grid2d import make_grid2d_run, make_mesh2d, shard_state_2d
from .mesh import BODY_AXIS, body_sharding, make_mesh, shard_state
from .sharded_step import make_sharded_run, make_sharded_step

__all__ = [
    "BODY_AXIS", "body_sharding", "make_mesh", "shard_state",
    "make_sharded_run", "make_sharded_step",
    "make_mesh2d", "make_grid2d_run", "shard_state_2d",
]
