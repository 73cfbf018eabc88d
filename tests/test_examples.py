"""The examples must stay runnable (they are user-facing documentation)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_animate_writes_frame_sequence(tmp_path):
    outdir = str(tmp_path / "frames")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "animate.py"),
         "32", "30", "10", outdir],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    frames = sorted(os.listdir(outdir))
    # run_trajectory records steps/every states.
    assert frames == ["frame_%04d.ppm" % i for i in range(3)], frames
    from parallel_nbody_tpu.utils import ppm
    head = ppm.read_header(os.path.join(outdir, frames[0]))
    assert (head.xdim, head.ydim) == (1024, 768)
    assert ppm.read_pixels(head).any(), "frame should contain rendered bodies"
