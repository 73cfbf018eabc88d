"""Record an animation: run the simulation on device, rasterize frames with
the on-device renderer, and write a numbered P6 PPM sequence.

The reference renders into ONE mmapped PPM on a wall-clock cadence
(nbody-seq.c:467-471) — lossy, timing-dependent.  This example uses the
deterministic trajectory recorder (models/engine.run_trajectory) instead:
every frame is an exact simulation state, so the sequence is reproducible.

    python examples/animate.py [N] [steps] [record_every] [outdir]

Convert to a video with e.g. ffmpeg -i frames/frame_%04d.ppm out.mp4.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from parallel_nbody_tpu.config import SimConfig
from parallel_nbody_tpu.models.engine import run_trajectory
from parallel_nbody_tpu.ops.render import render_frame
from parallel_nbody_tpu.state import init_state
from parallel_nbody_tpu.utils import ppm


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
    every = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    outdir = sys.argv[4] if len(sys.argv) > 4 else "frames"

    cfg = SimConfig(force_mode="fast",
                    dtype="float32" if jax.default_backend() != "cpu"
                    else "float64")
    state = init_state(n, cfg)
    final, xs, ys = run_trajectory(cfg, state, steps, record_every=every)

    os.makedirs(outdir, exist_ok=True)
    for i in range(xs.shape[0]):
        frame = render_frame(cfg, xs[i], ys[i], state.radius, n)
        path = os.path.join(outdir, "frame_%04d.ppm" % i)
        ppm.create(path, cfg.xdim, cfg.ydim,
                   np.asarray(jax.device_get(frame)))
    print("wrote %d frames (%dx%d) to %s/"
          % (xs.shape[0], cfg.xdim, cfg.ydim, outdir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
