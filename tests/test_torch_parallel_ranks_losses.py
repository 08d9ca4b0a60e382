"""The pixel loss and VQ over data parallelism, in a gloo group of 4 CPU
processes, against the JAX package's single-device step and the port's
single-process step (the rank program and the helpers are those of
tests/test_torch_parallel.py; a second file so that each stays well under a
minute: each JAX reference here is another jitted step).

Scenarios, each on two dp2 groups side by side unless said:
  * the RGB pixel loss at dp2: each rank's rows own their global image
    slots, and its per-image mean is weighted by its slots' share;
  * VQ at dp2 (gumbel noise zero in both packages and k-means off, as
    tests/test_torch_vq_steps.py compares steps with JAX): the affine
    statistics, the EMA code usage and the commitment losses over the
    global batch;
  * VQ at dp2 with the port's own gumbel draws, k-means init at step 0 and
    dead-code expiry at step 1 (below a usage of 40), against the port's
    single process: each
    rank's rows get the noise one process draws for them, and the surgery
    gathers the projections of the whole batch;
  * the standalone EMA codebook step at dp4 with the data group (JAX:
    sync_axis) against the global step, the port's and JAX's.

Tolerances: loss rtol 1e-4 and grad_norm rtol 1e-3 against JAX; parameters
as tests/test_torch_parallel.py::assert_params_close; VQ statistics atol
1e-5 (after k-means and expiry 1e-4, and the rows the surgery replaced
equal); the EMA codebook's cluster sizes rtol 1e-5 and embeddings atol 1e-5
(JAX's test: rtol 1e-4, atol 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models import vq as tvq
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_tpu.models import vq as jvq
from dct_autoencoder_tpu.train import loop as jloop
from test_torch_parallel import (
    Ranks,
    assert_params_close,
    jax_batch,
    jax_module_and_params,
    jax_patchnorm,
    payload_of,
    port_case,
)

WORLD = [[0, 1, 2, 3]]
PAIRS = [[0, 1], [2, 3]]
MAX_IMAGES = 16
SCENARIOS = [
    dict(name="dp2_pixel", groups=PAIRS, pixel=True),
    dict(name="dp2_vq", groups=PAIRS, model="vq", no_gumbel=True),
    dict(name="dp2_vq_surgery", groups=PAIRS, model="vq", kmeans=True, expire_every=2, expire_threshold=40.0, steps=2),
    dict(name="dp4_ema_codebook", groups=WORLD, kind="ema"),
]
LR = 1e-3


def port_steps(model, batch, steps=1, grid_sizes=None, **kw):
    m = TorchAE(model.config, dtype=torch.float32, device="cpu")
    m.module.load_state_dict(model.module.state_dict())
    tx = tloop.make_optimizer(LR, 10, warmup_steps=0)
    state = tloop.TrainState.create(m.module, tx)
    step = tloop.make_train_step(m.module, tx, use_pixel_loss=grid_sizes is not None, **kw)
    for _ in range(steps):
        state, metrics = step(state, model.patchnorm, batch, grid_sizes)
    return {k: float(v) for k, v in metrics.items()}, m.module.state_dict(), state.vq_replaced


def jax_step(model, batch, use_pixel_loss=False):
    module, params, vq_stats = jax_module_and_params(model)
    tx = jloop.make_optimizer(learning_rate=LR, max_iters=10, warmup_steps=0)
    step = jax.jit(jloop.make_train_step(module, tx, use_pixel_loss=use_pixel_loss, vq_kmeans_init=False))
    clip = (model.config.max_patch_h, model.config.max_patch_w)
    jb, grid = jloop.prepare_train_batch(jax_batch(batch), MAX_IMAGES if use_pixel_loss else 0, clip)
    _, metrics = step(jloop.TrainState.create(params, tx, vq_stats), jax_patchnorm(model.patchnorm), jb, grid)
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    lfq, raw = port_case()
    vq, _ = port_case("vq")
    clip = (lfq.config.max_patch_h, lfq.config.max_patch_w)
    batch, grid_sizes = tloop.prepare_train_batch(raw, MAX_IMAGES, clip)
    ranks = Ranks(
        tmp_path_factory.mktemp("ranks"), payload_of({"lfq": lfq, "vq": vq}, raw, SCENARIOS, grid_sizes), world=4
    )
    refs = {
        "jax_pixel": jax_step(lfq, raw, use_pixel_loss=True),
        "port_pixel": port_steps(lfq, batch, grid_sizes=grid_sizes),
        "port_surgery": port_steps(vq, batch, steps=2, vq_kmeans_init=True, vq_expire_every=2, vq_expire_threshold=40.0),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
        mp.setattr(tvq, "_gumbel", lambda shape, generator, device: torch.zeros(shape, device=device))
        refs["jax_vq"] = jax_step(vq, raw)
        refs["port_vq"] = port_steps(vq, batch, vq_kmeans_init=False)
    ranks.wait()
    return {"lfq": lfq, "vq": vq}, ranks, refs


@pytest.mark.parametrize("name,model,jax_ref,port_ref", [
    ("dp2_pixel", "lfq", "jax_pixel", "port_pixel"),
    ("dp2_vq", "vq", "jax_vq", "port_vq"),
])
def test_data_parallel_step_matches_jax_and_the_single_process_step(case, name, model, jax_ref, port_ref):
    models, ranks, refs = case
    got = ranks.result(name)
    metrics = got["metrics"][0]
    np.testing.assert_allclose(metrics["loss"], refs[jax_ref]["loss"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"], refs[jax_ref]["grad_norm"], rtol=1e-3)
    if name == "dp2_pixel":
        np.testing.assert_allclose(metrics["pixel_loss"], refs[jax_ref]["pixel_loss"], rtol=1e-4)
    port_metrics, port_params, _ = refs[port_ref]
    for k in port_metrics:
        np.testing.assert_allclose(metrics[k], port_metrics[k], rtol=1e-4, err_msg=k)
    params = {k: v for k, v in port_params.items() if not tvq_stat(k)}
    assert_params_close(got["params"], params, LR, what=name)
    for k, v in port_params.items():
        if tvq_stat(k):
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def tvq_stat(key: str) -> bool:
    from dct_autoencoder_torch.models.convert import is_vq_stat

    return is_vq_stat(key)


def test_vq_surgery_and_gumbel_draws_match_the_single_process_step(case):
    """Two VQ steps at dp2 with the port's gumbel draws, k-means init at step 0
    and expiry at step 1: the same codes replaced, and the codebook, the
    statistics and every parameter as one process gets them."""
    _, ranks, refs = case
    got = ranks.result("dp2_vq_surgery")
    want_metrics, want_params, want_replaced = refs["port_surgery"]
    np.testing.assert_allclose(got["metrics"][-1]["loss"], want_metrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"][-1]["grad_norm"], want_metrics["grad_norm"], rtol=1e-3)
    assert want_replaced is not None and bool(want_replaced.any())
    assert torch.equal(got["replaced"], want_replaced)
    params = {k: v for k, v in want_params.items() if not tvq_stat(k)}
    assert_params_close(got["params"], params, 2 * LR, atol=1e-4, what="vq surgery")
    for k, v in want_params.items():
        if tvq_stat(k):
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=1e-4, err_msg=k)


def test_ema_codebook_sync_equals_the_global_update(case):
    """ema_codebook_update over each rank's quarter of the rows with the data
    group equals the update over all rows: the port's, and JAX's."""
    _, ranks, _ = case
    got = ranks.result("dp4_ema_codebook")
    state = tvq.EMACodebookState(**got["state"])
    want = tvq.ema_codebook_update(state, got["x"], got["valid"])
    jstate = jvq.EMACodebookState(**{k: jnp.asarray(v.numpy()) for k, v in got["state"].items()})
    jwant = jvq.ema_codebook_update(jstate, jnp.asarray(got["x"].numpy()), jnp.asarray(got["valid"].numpy()))
    for k, v in dataclasses.asdict(want).items():
        tol = dict(rtol=1e-5) if k == "cluster_size" else dict(atol=1e-5)
        np.testing.assert_allclose(got["new"][k].numpy(), v.numpy(), **tol, err_msg=k)
        np.testing.assert_allclose(got["new"][k].numpy(), np.asarray(getattr(jwant, k)), rtol=1e-4, atol=1e-5, err_msg=k)
