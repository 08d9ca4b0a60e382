"""The port's two-process check, as tests/test_multihost.py runs the JAX
package's: two real OS processes form a gloo group over localhost, each runs
the sharded train step on its rows of one global batch and a data-parallel
encode of its rows (dct_autoencoder_torch/parallel/multiproc_check.py);
then the two processes as the two stages of a GPipe pipeline over the whole
batch (2 microbatches), the same step and a pipelined encode of every row.

Tolerances (the worker's, as JAX's): loss rtol 2e-4 and grad_norm rtol 2e-3
against the single-process step, token ids equal.  The sharded step itself
is held to the JAX package's step in tests/test_torch_parallel_ranks.py.
"""
import numpy as np

from dct_autoencoder_torch.parallel.multiproc_check import run_two_process_check
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


def test_two_process_full_train_step_and_encode(tmp_path):
    res = run_two_process_check(str(tmp_path), timeout=150, device="cpu")
    for pid, out in enumerate(res["outputs"]):
        assert f"proc {pid} full-step ok" in out
        assert "identical" in out
        assert f"encode rows {2 * pid}:{2 * pid + 2} identical" in out
    assert np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])


def test_two_process_pipeline_step_and_encode(tmp_path):
    res = run_two_process_check(str(tmp_path), timeout=150, device="cpu", pipeline_microbatches=2)
    for pid, out in enumerate(res["outputs"]):
        assert f"proc {pid} full-step ok" in out
        assert "pipelined encode rows 0:4 identical" in out
    assert np.isfinite(res["loss"]) and np.isfinite(res["grad_norm"])
