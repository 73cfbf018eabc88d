"""bench.py contract tests.

The benchmark measures a GPU and nothing else: on any other platform it
exits non-zero and prints no result, so a CPU rate can never be recorded
under the device metric's name.  Every result names the device it ran on.
"""

import json
import os
import subprocess
import sys

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_cpu_and_prints_no_result(capsys):
    assert bench.main() != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "GPU" in captured.err


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_result_names_device_and_card():
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1}
    rec = bench.result(4.45e11, device, "NVIDIA H100 80GB HBM3, 700.00 W")
    line = json.loads(json.dumps(rec))
    assert line["device"] == device
    assert line["card"].endswith("W")
    assert line["unit"] == "pairs/s"
    assert abs(line["vs_baseline"] - 1000.0) < 1e-9
    assert "N=65536" in line["metric"]
