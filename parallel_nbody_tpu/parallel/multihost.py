"""Multi-node launch support (the prun/mpirun analog).

The reference launches MPI ranks with DAS-5's ``prun`` (bin/tests.sh:38).
On one machine a single Python process drives all of its GPUs: the CLI's
``--devices``/``--mesh2d`` meshes span every local device and XLA runs the
collectives over NCCL.  Only a launch across several machines needs one
process per machine, joined into one runtime by ``jax.distributed``:

    COORDINATOR_ADDRESS=host0:1234 NBODY_NUM_PROCESSES=2 NBODY_PROCESS_ID=0 \
        python -m parallel_nbody_tpu.cli 1048576 0 arena.ppm 100 --no-clamp

(and ``NBODY_PROCESS_ID=1`` on the second machine).  The CLI calls
``initialize()`` when ``COORDINATOR_ADDRESS`` is set, and fails if the
process cannot join.
"""

from __future__ import annotations

import os

import jax


def multi_node_launch() -> bool:
    """True when an explicit multi-node coordinator is configured."""
    return "COORDINATOR_ADDRESS" in os.environ


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the global distributed runtime.  Arguments default to the
    ``COORDINATOR_ADDRESS``, ``NBODY_NUM_PROCESSES`` and ``NBODY_PROCESS_ID``
    environment variables (bin/multihost-cli.sh):

        initialize("host0:1234", num_processes=2, process_id=host_index)
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NBODY_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NBODY_NUM_PROCESSES"])
    if process_id is None and "NBODY_PROCESS_ID" in os.environ:
        process_id = int(os.environ["NBODY_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def topology() -> dict:
    """Cluster topology for experiment CSV labeling (the PRUN env-scrape
    analog, nbody-par.c:441-517)."""
    return {
        "processes": jax.process_count(),
        "process_id": jax.process_index(),
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
    }
