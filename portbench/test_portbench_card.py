"""On a CUDA card: one short run of every cell through the command, its
result line's shape. Skips without a card (decided inside the test).

    python3 -m pytest portbench/test_portbench_card.py -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2200000999", "--seconds", "5", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    else:
        assert "setup_s" in line["metrics"]
