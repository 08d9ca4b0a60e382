"""The port's test files share one fixture: one intra-op thread for torch.

Import it into a test module (``from torch_threads import one_cpu_thread``)
and it applies to every test there.  The port's test models are tiny, and
under the suite's parallel workers a full-width torch thread pool in each
worker puts more threads than cores on the machine, which slows each small
op many times over.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One intra-op thread for the port while the module's tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
