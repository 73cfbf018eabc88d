"""Simulation configuration.

The reference hard-codes its physics constants as C preprocessor defines
(nbody/nbody-seq.c:22-27).  Here they live in a frozen dataclass that is
hashable, so it can be passed as a static argument through ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

# Reference constants (nbody/nbody-seq.c:22-27).  BOUNCE=-0.9 is defined in the
# reference but never used — the wall bounce is a plain velocity negation.
GRAVITY = 1.1
FRICTION = 0.01
MAXBODIES = 10000
DELTA_T = 0.025 / 5000
SEED = 27102015

ForceMode = Literal["trig", "fast"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters.

    Attributes:
      xdim, ydim: arena dimensions (taken from the P6 PPM header in the
        reference, nbody/nbody-seq.c:431).
      gravity / friction / dt: physics constants.
      force_mode: ``"trig"`` reproduces the reference's transcendental force
        decomposition ``force * cos(atan2(dy, dx))`` bit-for-bit semantics
        (nbody/nbody-seq.c:91-98) — required for golden-output parity.
        ``"fast"`` uses the algebraically equal ``force * dx * rsqrt(dsqr)``,
        the speed path (no transcendentals).
      dtype: element type for device computation.  Parity runs use float64 on
        CPU; GPU runs default to float32.
      kernel: ``"xla"`` uses the dense XLA formulation; ``"pallas"`` tiles
        the interaction matrix with the hand-written Triton kernel
        (ops/pallas_step.py), interpreted on the CPU.
      accum: ``"plain"`` (default) sums force partials directly;
        ``"compensated"`` Kahan-compensates the Pallas kernel's per-pair
        accumulation — the "fp64-emulated accumulation" option of BASELINE
        config 3.  Pallas kernel only; the xla/trig paths use fp64 on CPU
        where compensation is moot.
    """

    xdim: int = 1024
    ydim: int = 768
    gravity: float = GRAVITY
    friction: float = FRICTION
    dt: float = DELTA_T
    force_mode: ForceMode = "trig"
    dtype: str = "float64"
    kernel: Literal["xla", "pallas"] = "xla"
    accum: Literal["plain", "compensated"] = "plain"

    def __post_init__(self):
        if self.kernel == "pallas" and self.force_mode == "trig":
            raise ValueError(
                "kernel='pallas' implements only force_mode='fast' (the "
                "transcendental-free path); the trig parity decomposition "
                "(nbody-seq.c:91-98) requires kernel='xla'")
        if self.dtype == "float16":
            raise ValueError(
                "dtype='float16' is unsupported: the reference mass law "
                "mass = radius^3 (nbody-seq.c:444-447) exceeds float16's "
                "65504 max for any N >= 8 at the default arena, and the "
                "force kernel's mass_i*mass_j product overflows it at every "
                "N — use 'bfloat16' for 16-bit runs (same exponent range as "
                "float32; see docs/DESIGN.md, dtype support matrix)")
        if self.dtype not in ("bfloat16", "float32", "float64"):
            raise ValueError(
                "unsupported dtype %r (expected bfloat16, float32 or "
                "float64)" % (self.dtype,))

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
