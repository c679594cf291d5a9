"""On the card: a short run of each cell through the command, untraced
and traced, correct, with the device's fields."""

import json
import subprocess
import sys

import pytest

from portbench import bench

CELLS = [w["name"] for w in bench.load()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "4000000007", "--seconds", "2", "--trace", str(trace)],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["breakdown"]["device_ops"]
