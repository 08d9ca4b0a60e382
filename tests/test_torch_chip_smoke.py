"""chip_smoke.py, as far as a machine without a CUDA device can hold it.

The script itself needs the card; here its contract without one is checked
(exit code, no result line), that it imports nothing of JAX, and the small
pure functions it computes bounds and agreement with.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

from dct_autoencoder_torch import kernels as tk  # noqa: E402


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("there is a CUDA device: the script would run in full")
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True, text=True, cwd=REPO, timeout=300
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and "needs a CUDA device" in run.stderr


def test_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "flax", "optax", "dct_autoencoder_tpu"}, mods


def test_kernel_table_names_every_counter_and_source():
    counters = [row[4] for row in chip_smoke.KERNEL_TABLE]
    assert sorted(counters) == sorted(tk.launch_counts())
    assert set(chip_smoke.SERVING_KERNELS) <= set(counters)
    for _, _, source, replaces, _, _ in chip_smoke.KERNEL_TABLE:
        assert os.path.isfile(os.path.join(REPO, source)), source
        path, line = replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert "_kernel(" in f.readlines()[int(line) - 1], replaces


@pytest.mark.parametrize(
    "nbytes,flops,dtype,want",
    [
        (3.35e9, 0.0, torch.bfloat16, (1.0, "bytes")),
        (0.0, 989e9, torch.bfloat16, (1.0, "operations")),
        (3.35e9, 67e9 * 2, torch.float32, (2.0, "operations")),
    ],
)
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, flops, dtype, want):
    ms, by = chip_smoke.bound(nbytes, flops, dtype)
    assert by == want[1] and ms == pytest.approx(want[0])


def test_code_agreement_counts_missing_tokens_as_disagreeing():
    tok = lambda c, h, w, data: {"c": c, "h": h, "w": w, "data": data}
    a = [{"codes": [tok(0, 0, 0, [1, 2]), tok(1, 0, 0, [3, 4])]}]
    b = [{"codes": [tok(0, 0, 0, [1, 9]), tok(2, 0, 0, [3, 4])]}]
    assert chip_smoke.code_agreement(a, a) == 1.0
    assert chip_smoke.code_agreement(a, b) == pytest.approx(1 / 6)
    json.dumps(a)  # records are JSON-able, as the script prints them
