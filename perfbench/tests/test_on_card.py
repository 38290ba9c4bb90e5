"""Each cell once on the card, with a short window, through the benchmark's
own command (skips without a CUDA device)."""
import json
import subprocess
import sys

import pytest

from perfbench import harness

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed", "4000000007",
                           "--seconds", "12", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
