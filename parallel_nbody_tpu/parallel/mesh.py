"""Device mesh construction and sharding helpers.

The reference's process topology (MPI ranks launched by prun, block body
decomposition via get_recvcounts/get_displacements/get_bounds,
nbody-par.c:225-263) becomes a 1-D ``jax.sharding.Mesh`` over the body axis.
The remainder-handling recvcounts logic disappears: the body axis is padded to
a shard multiple (``state.pad_state``) so every device owns an equal block —
the XLA-friendly equivalent of variable counts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BODY_AXIS = "bodies"


def device_grid(shape: tuple[int, ...], devices) -> np.ndarray:
    """Arrange ``devices`` into ``shape`` in id order.

    The GPUs of one machine are joined all to all by NVLink, so every
    placement costs the same and the mesh follows the algorithm alone."""
    return np.asarray(list(devices)).reshape(shape)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the body axis (devices in id order)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            # The reference's launcher actually allocates the ranks it
            # reports (prun, bin/tests.sh:38); silently truncating here would
            # let callers claim parallelism that never ran.
            raise ValueError(
                "requested a %d-device mesh but only %d device(s) are "
                "available (backend=%s); on a single-host CPU run set "
                "--xla_force_host_platform_device_count" %
                (n_devices, len(devices), jax.default_backend()))
        devices = devices[:n_devices]
    return Mesh(device_grid((len(devices),), devices), (BODY_AXIS,))


def body_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BODY_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(state, mesh: Mesh, sharding: NamedSharding | None = None):
    """Place every state array body-sharded on the mesh (the Bcast+scatter
    analog; requires state.n % mesh size == 0 — use pad_state first).
    ``sharding`` overrides the default 1-D body sharding (grid2d passes its
    flattened 2-D spec).

    Works on a multi-process (multi-host) mesh too: every process holds the
    identical full host state (deterministic init — the Bcast analog), and
    each contributes only its addressable shards to the global array."""
    sh = body_sharding(mesh) if sharding is None else sharding
    if jax.process_count() > 1:
        def make_global(a):
            a_np = np.asarray(a)
            return jax.make_array_from_callback(
                a_np.shape, sh, lambda idx, a_np=a_np: a_np[idx])
        return jax.tree.map(make_global, state)
    return jax.tree.map(lambda a: jax.device_put(a, sh), state)
