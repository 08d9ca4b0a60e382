"""On the card: each cell of BENCHMARK.json runs once, briefly, each way, and its line is whole and correct.

    python -m pytest portbench/tests/test_card.py -q -m cuda
"""
import json
import subprocess
import sys

import pytest

from portbench import common

CELLS = [w["name"] for w in common.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, workload, trace):
    import torch

    spec = common.find_cell(workload)
    if torch.cuda.device_count() < spec["workload"]["chips"]:
        pytest.skip(f"needs {spec['workload']['chips']} cards")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 101),
                          "--seconds", "3", "--trace", str(trace)], cwd=common.ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in (spec["per_layer"] if trace else spec["end_to_end"])}
    assert set(line["metrics"]) <= names and line["metrics"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
