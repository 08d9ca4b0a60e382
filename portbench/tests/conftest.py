"""Tests of the benchmark's harness and yardstick, on the CPU at small sizes.

    python -m pytest portbench/tests -q            # here: the card's tests skip
    python -m pytest portbench/tests -q -m cuda    # on the card

Tests that need the card are marked `cuda` and decide inside a fixture.
"""

import pytest
import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
