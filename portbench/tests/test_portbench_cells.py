"""Each cell's loop on the CPU at a tiny size, through the functions that
``run.py`` calls, and ``run.py`` itself without a card."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "trace"])
@pytest.mark.parametrize("workload", tiny.workloads())
def test_cell_on_cpu(workload, trace):
    cell = tiny.cell(workload, trace=trace)
    result = harness.run(cell, 0.0)
    assert set(result) == KEYS | ({"breakdown"} if trace else set())
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(cell.limits)
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(result)


def test_run_needs_a_card():
    if not tiny.no_card():
        pytest.skip("a card is present: run.py runs there")
    r = subprocess.run([sys.executable, str(harness.ROOT / "run.py"), "--workload",
                        tiny.workloads(held=False)[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and r.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.workloads(held=False))
def test_run_on_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, str(harness.ROOT / "run.py"), "--workload", workload,
                        "--seed", str(2**31 + 3), "--seconds", "5", "--trace", "0"],
                       capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
