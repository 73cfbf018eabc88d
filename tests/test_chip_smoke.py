"""chip_smoke.py's contract where there is no GPU: it refuses to run,
exits non-zero and prints no result; its last line on success is one JSON
object naming the device."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"]])
def test_refuses_non_gpu_device(capsys, argv):
    assert chip_smoke.main(argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs an NVIDIA GPU" in captured.err


def test_rejects_unknown_arguments(capsys):
    assert chip_smoke.main(["chip_smoke.py", "--phase=1"]) == 2
    assert capsys.readouterr().out == ""


def test_result_line_is_the_contract_json():
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1}
    line = chip_smoke.result_line(device)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": device}


def test_script_alone_exits_nonzero_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
