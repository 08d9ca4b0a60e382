"""Checkpoints, resume and train() under a pipeline (parallel/pipeline.py),
over a gloo group of 4 CPU processes (the rank program of
tests/test_torch_parallel.py, spawned once for the file).

Scenarios, on tests/test_model.py's tiny config (2 + 2 layers: one a stage):
  * pp2 x dp2 with accumulation 2, against JAX's single-device step with
    accumulation 2 and the port's single-process one (the tolerances of
    tests/test_torch_pipeline_train.py);
  * pp2 x dp2 after a step: rank 0 writes the gathered weights with
    save_pretrained; the single-device port loads them and gives the
    pipelined forward's token ids (features within 1e-5), and the JAX
    package loads the same weights;
  * pp2 x dp2 with ZeRO-1: step, save train_state.pt, step again; a second
    staged model loads the file and steps: the same metrics and parameters,
    bit for bit, as the continued run;
  * train() with sequence parallelism, pp2 (dp2 x pp2) and accumulation 2
    (JAX's tests/test_train.py::test_train_loop_sequence_parallel_and_pipeline)
    on two batches of three 32 x 32 images (three rows: the grids' forward
    pads them to the microbatches), with image grids every step and
    a final checkpoint: finite losses, the module whole again on return, the
    grids and the checkpoint written, and the first step's loss within rtol 1e-4 of the port's
    single-process step on the same batch padded as train() pads it (8 rows:
    accumulation x data ranks x microbatches).
"""
import os

import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_torch.models.patchnorm import apply_patchnorm
from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_torch.train import loop as tloop
from test_torch_parallel import Ranks, payload_of, port_case
from test_torch_parallel_ranks import jax_step, port_step
from test_torch_pipeline_train import assert_step_matches

WORLD = [[0, 1, 2, 3]]
SCENARIOS = [
    dict(name="pp2_dp2_accum2", groups=WORLD, n_model=2, pp=2, accum=2),
    dict(name="pp2_dp2_checkpoint", groups=WORLD, n_model=2, pp=2, kind="checkpoint"),
    dict(name="pp2_dp2_zero1_resume", groups=WORLD, n_model=2, pp=2, zero1=True, kind="resume"),
    dict(name="train_sp_pp2_accum2", groups=WORLD, n_model=2, pp=2, sp=True, accum=2, kind="train"),
]


def columns(proc, n_batches=2, n_images=3, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ds = [proc.preprocess(rng.uniform(0.1, 0.9, size=(3, 32, 32)).astype(np.float32)) for _ in range(n_images)]
        out.append({k: [d[k] for d in ds] for k in ds[0]})
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    model, batch = port_case(rows_multiple=8)
    _, proc = torch_model_and_processor(model.config, dtype=torch.float32, sample_patches_beta=0.0, device="cpu")
    cols = columns(proc)
    ranks = Ranks(tmp_path_factory.mktemp("ranks"), payload_of({"lfq": model}, batch, SCENARIOS, columns=cols), world=4)
    # the single-process step on train()'s first batch, padded as train() pads it
    first = next(proc.iter_batches(iter(cols[:1]), batch_size=None))
    first = pm.pad_batch_rows(tloop.prepare_train_batch(first)[0], 2 * 2 * 2)
    m = TorchAE(model.config, dtype=torch.float32, device="cpu")
    m.module.load_state_dict(model.module.state_dict())
    tx = tloop.make_optimizer(1e-3, len(cols))
    state = tloop.TrainState.create(m.module, tx)
    _, metrics = tloop.make_train_step(m.module, tx, accum_steps=2)(state, model.patchnorm, first)
    batch = tloop.prepare_train_batch(batch)[0]
    accum_refs = (jax_step(model, batch, 2), port_step(model, batch, 2))
    ranks.wait()
    return model, batch, ranks, float(metrics["loss"]), accum_refs


def test_pipelined_step_with_accumulation_matches_jax(case):
    _, _, ranks, _, (jax_metrics, port_ref) = case
    assert_step_matches(ranks.result("pp2_dp2_accum2"), jax_metrics, port_ref, "pp2_dp2_accum2")


def test_pipelined_checkpoint_loads_in_the_single_device_port_and_jax(case):
    model, batch, ranks, _, _ = case
    got = ranks.result("pp2_dp2_checkpoint")
    path = f"{ranks.tmp}/ckpt_pp2_dp2_checkpoint"
    loaded = TorchAE.from_pretrained(path, dtype=torch.float32, device="cpu")
    loaded.patchnorm = model.patchnorm
    for k, v in got["params"].items():
        assert torch.equal(loaded.module.state_dict()[k], v), k
    with torch.no_grad():
        out = loaded.module(batch.replace(patches=apply_patchnorm(model.patchnorm, batch)), training=False)
    assert torch.equal(out["codes"], got["forward"]["codes"])
    np.testing.assert_allclose(out["dct_patches"].patches.numpy(), got["forward"]["patches"].numpy(), atol=1e-5)

    import jax

    from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
    from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE

    jm = JaxAE.from_pretrained(path)
    jflat = {JaxAE._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    want = jax_arrays_from_state_dict(got["params"], model.config)
    assert jflat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)


def test_pipelined_zero1_resume_equals_the_continued_run(case):
    """(step, save, load, step) == (step, step), bit for bit: train_state.pt
    holds the single-device state and loads back into the stages and slices."""
    model, _, ranks, _, _ = case
    got = ranks.result("pp2_dp2_zero1_resume")
    (cont, cont_params), (resumed, resumed_params) = got["cont"], got["resumed"]
    assert cont == resumed
    assert list(cont_params) == list(resumed_params)
    for k, v in cont_params.items():
        assert torch.equal(v, resumed_params[k]), k
    file = torch.load(f"{ranks.tmp}/ck_pp2_dp2_zero1_resume/train_state.pt", weights_only=True)
    single = TorchAE(model.config, dtype=torch.float32, device="cpu").module
    assert list(file["params"]) == list(single.state_dict())
    n_params = len(list(single.parameters()))
    assert file["opt_state"]["param_groups"][0]["params"] == list(range(n_params))
    assert sorted(file["opt_state"]["state"]) == list(range(n_params))


def test_train_with_sequence_parallel_pipeline_and_accumulation(case):
    model, _, ranks, first_loss, _ = case
    got = ranks.result("train_sp_pp2_accum2")
    losses = [d["loss"] for d in got["logs"] if "loss" in d]
    assert len(losses) == 2 and all(np.isfinite(losses)), got["logs"]
    np.testing.assert_allclose(losses[0], first_loss, rtol=1e-4)
    assert not got["staged"]
    assert list(got["params"]) == list(model.module.state_dict())
    assert any(not torch.equal(v, model.module.state_dict()[k]) for k, v in got["params"].items())
    # its image grids (a pipelined forward of the raw batch on every rank) and final checkpoint
    run = f"{ranks.tmp}/train_train_sp_pp2_accum2"
    assert os.path.isfile(f"{run}/train_image_000000.png") and os.path.isfile(f"{run}/train_image_000001.png")
    saved = TorchAE.from_pretrained(f"{run}/model", dtype=torch.float32, device="cpu").module.state_dict()
    for k, v in got["params"].items():
        assert torch.equal(saved[k], v), k
