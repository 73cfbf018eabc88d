"""parallel_nbody_tpu — a GPU N-body simulation engine in JAX.

A ground-up rebuild of jfdev001/parallel-nbody (an MPI+OpenMP direct O(N^2)
2-D gravitational simulator in C) as an idiomatic JAX/XLA/Pallas framework:

  - ``config`` / ``state``     — frozen physics config, SoA pytree state
  - ``ops``                    — force / integration ops (dense XLA + a
                                 Pallas Triton kernel)
  - ``models.engine``          — jitted on-device step loop
  - ``parallel``               — mesh sharding, all-gather / ppermute-ring /
                                 2-D force-matrix multi-device steps, and
                                 multi-host launch (the MPI layer)
  - ``utils``                  — glibc-rand parity init, PPM I/O, rendering,
                                 output contract, checkpointing, timing

The reference's exact trajectory semantics are preserved: the parity path
(float64, ``force_mode="trig"``) reproduces the golden outputs
``tests/128_MY_REF_OUTPUT`` and ``bin/REF_OUTPUT`` byte-for-byte.
"""

from .config import (DELTA_T, FRICTION, GRAVITY, MAXBODIES, SEED, SimConfig)
from .state import State, init_state, pad_state, random_state, unpad_state

__version__ = "0.1.0"

__all__ = [
    "SimConfig", "State", "init_state", "random_state", "pad_state",
    "unpad_state", "GRAVITY", "FRICTION", "DELTA_T", "MAXBODIES", "SEED",
]
