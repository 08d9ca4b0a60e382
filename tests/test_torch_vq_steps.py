"""VQ train steps in the port against the JAX package, and the codebook
surgery inside the step, in fp32 on the CPU.

Model and inputs as in tests/test_torch_vq_train.py: the tiny VQ config of
tests/test_model.py, JAX's parameters and vq_stats carried into the port,
gumbel noise set to zero in both packages where steps are compared.

Tolerances: two train steps (accumulation 1 and 2, k-means off): metrics
rtol 1e-3, parameters as tests/test_torch_train.py::test_train_steps_match_jax,
statistics atol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from test_model import make_batch, tiny_config
from test_torch_model import to_torch_batch
from test_torch_train import (
    TorchConfig,
    _assert_params_close,
    jax_model_and_processor,
    jloop,
    tloop,
    torch_model_and_processor,
)
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_vq_train import no_gumbel, vq_case, vq_port_of  # noqa: F401  (fixture)


@pytest.mark.parametrize("accum", [1, 2])
def test_vq_train_steps_match_jax(accum, no_gumbel):
    """Two steps, k-means off: metrics, parameters and statistics."""
    jm, _, batch = vq_case(3)
    tm = vq_port_of(jm)
    tb = to_torch_batch(batch)
    kw = dict(learning_rate=1e-3, max_iters=100, warmup_steps=0)
    vq = dict(accum_steps=accum, vq_kmeans_init=False)
    jtx = jloop.make_optimizer(**kw)
    jstate = jloop.TrainState.create(jm.params, jtx, jm.vq_stats)
    jstep = jax.jit(jloop.make_train_step(jm.module, jtx, **vq))
    ttx = tloop.make_optimizer(**kw)
    tstate = tloop.TrainState.create(tm.module, ttx)
    tstep = tloop.make_train_step(tm.module, ttx, **vq)
    lr_sum = 0.0
    for i in range(2):
        jstate, jmet = jstep(jstate, jm.patchnorm, batch)
        tstate, tmet = tstep(tstate, tm.patchnorm, tb)
        lr_sum += ttx.schedule(i)
        assert tmet.keys() == jmet.keys()
        for k in jmet:
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-3, err_msg=f"step {i} {k}")
        _assert_params_close(tm, jstate.params, lr_sum, f"step {i}")
        for k, v in jstate.vq_stats["vq_model"].items():
            np.testing.assert_allclose(tstate.vq_stats[k].numpy(), np.asarray(v), atol=1e-4, err_msg=f"step {i} {k}")
    assert tstate.vq_replaced is None and tstate.step == 2


# ---------------------------------------------------------------- surgery in the step


def test_kmeans_and_expiry_in_the_train_step():
    """Learning rate 0, so only the surgery moves the codebook: k-means at
    step 0 rewrites every row and zeroes its Adam moments; expiry at step 1
    (every 2) replaces the rows it reports, resets their usage to 15 and
    zeroes their moments, and leaves the other rows."""
    cfg = TorchConfig.from_dict(tiny_config("vq").to_dict())
    model, proc = torch_model_and_processor(cfg, sample_patches_beta=0.0, seed=0, device="cpu")
    jproc = jax_model_and_processor(tiny_config("vq"), sample_patches_beta=0.0)[1]
    tb = to_torch_batch(make_batch(jproc, np.random.default_rng(4), n_images=4))
    model.patchnorm, _ = dt.models.patchnorm.calibrate_patchnorm_batch(model.patchnorm, tb)
    tx = tloop.make_optimizer(learning_rate=0.0, max_iters=100, warmup_steps=0)
    state = tloop.TrainState.create(model.module, tx)
    step = tloop.make_train_step(model.module, tx, vq_expire_every=2, vq_expire_threshold=15.0)
    vq = model.module.vq_model
    cb0 = vq.codebook.detach().clone()

    state, m = step(state, model.patchnorm, tb)
    cb1 = vq.codebook.detach().clone()
    assert bool(state.vq_replaced.all()) and not torch.allclose(cb0, cb1) and np.isfinite(m["loss"].item())
    moments = state.adamw.state[vq.codebook]
    assert moments["exp_avg"].abs().max() == 0 and moments["exp_avg_sq"].abs().max() == 0

    state, _ = step(state, model.patchnorm, tb)
    dead = state.vq_replaced
    cb2 = vq.codebook.detach()
    assert dead is not None and dead.any() and (~dead).any(), "test premise: some codes dead, some alive"
    assert torch.equal(cb2[~dead], cb1[~dead]) and not torch.allclose(cb2[dead], cb1[dead])
    assert bool((vq.cluster_size[dead] == 15.0).all())
    assert moments["exp_avg"][dead].abs().max() == 0 and moments["exp_avg_sq"][dead].abs().max() == 0
    assert moments["exp_avg_sq"][~dead].abs().max() > 0


def test_surgery_does_nothing_on_an_all_padded_window():
    """Accumulation 2 over rows whose second half is padding: the surgery's
    window (the last micro-batch) has no valid token, so k-means does not
    run and the codebook moves by the update alone."""
    jm, _, batch = vq_case(5)
    tm = vq_port_of(jm)
    tb = to_torch_batch(batch)
    padded = tloop.pad_batch_rows(tb, 2 * tb.patches.shape[0])
    tx = tloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0)
    state = tloop.TrainState.create(tm.module, tx)
    cb0 = tm.module.vq_model.codebook.detach().clone()
    state, _ = tloop.make_train_step(tm.module, tx, accum_steps=2, vq_expire_every=1)(state, tm.patchnorm, padded)
    assert state.vq_replaced is None and torch.equal(tm.module.vq_model.codebook, cb0)
    # the function itself, in both modes
    vq = tm.module.vq_model
    z = torch.randn(2, 8, 4, 16)
    before = {k: v.clone() for k, v in vq.state_dict().items()}
    out = tloop._vq_codebook_surgery(vq, state.adamw, z, torch.zeros(2, 8, dtype=torch.bool), 0, 0, True, 15.0, 1)
    assert out is None and all(torch.equal(before[k], v) for k, v in vq.state_dict().items())
