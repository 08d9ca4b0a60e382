"""The port's LFQ training path against the JAX package, in fp32 on the CPU.

Models: the tiny config of tests/test_model.py ('block' mask, LFQ with
projections, JAX's default attention), the tiny 'bias'-mode config of
tests/test_torch_model.py (no LFQ projections; JAX runs its Pallas attention,
forward and backward, in interpret mode) and the trained checkpoint
docs/calibrated_run_r3b/model.  JAX parameters are carried into the port
with models/convert.py and gradients carried back with its reverse map.
Batches are packed by the JAX extractor from seeded numpy images and handed
to both packages.

Tolerances:
  * codes equal (a bit may differ only where JAX's pre-sign value is within
    1e-4 of 0, as in tests/test_torch_model.py);
  * LFQ training forward: ids exact; quantized output, commit loss and
    distances rtol 1e-5 (atol 1e-5); gradient w.r.t. the input atol 1e-5;
  * patchnorm calibration state atol 1e-6;
  * every loss of step_autoencoder rtol 1e-4; the gradient of each parameter
    atol 2e-3 x that tensor's largest entry in JAX (fp32 sums in another
    order, amplified by the entropy loss's softmax at temperature 0.01),
    plus 1e-6 x the largest entry of any tensor: the gradient of a key
    bias is 0 in exact arithmetic (a softmax ignores a constant added to
    every key's logit), so both packages hold only rounding noise there;
  * the learning-rate schedule against optax atol 1e-7 x the peak rate;
  * parameters after 3 optimizer steps atol 1e-5 at learning rate 1e-4.
    Adam's first updates are g / (|g| + 1e-8): where a gradient entry is
    within rounding of 0 the two packages may step in different directions,
    so up to 0.2 % of the model's entries (and of one tensor the larger of
    2 entries and 1 %) may differ by up to 2 x the learning rates applied
    so far.  A key bias, whose whole gradient is rounding noise (see
    above), is held to that last bound only;
  * `clip_by_global_norm` is written as optax writes it (g / norm x limit,
    untouched below the limit), not as torch.nn.utils.clip_grad_norm_.
"""
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict, state_dict_from_jax_npz
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_torch.models.lfq import LFQ as TorchLFQ
from dct_autoencoder_torch.models.patchnorm import PatchNormState as TorchPatchNorm
from dct_autoencoder_torch.models.patchnorm import calibrate_patchnorm_batch as torch_calibrate
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_torch.train import losses as tlosses
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_model_and_processor
from dct_autoencoder_tpu.models.lfq import LFQ as JaxLFQ
from dct_autoencoder_tpu.models.patchnorm import calibrate_patchnorm_batch as jax_calibrate
from dct_autoencoder_tpu.train import loop as jloop
from dct_autoencoder_tpu.train import losses as jlosses
from test_model import make_batch, tiny_config
from test_torch_model import R3B, assert_codes_match, jax_pre_sign, packed_batch, tiny_bias_config, to_torch_batch
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

GRAD_REL_ATOL = 2e-3
LOSS_KEYS = ("entropy_loss", "rec_loss", "commit_loss", "rec_loss_unnormalized", "perplexity")


def flat(tree) -> dict:
    return {JaxAE._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_patchnorm(pn) -> TorchPatchNorm:
    return TorchPatchNorm(**{k: torch.from_numpy(np.array(getattr(pn, k))) for k in ("n", "median", "b")})


def port_of(jm) -> TorchAE:
    """The port's model with the JAX model's parameters and patchnorm (fp32, CPU)."""
    tcfg = TorchConfig.from_dict(jm.config.to_dict())
    tm = TorchAE(tcfg, dtype=torch.float32, device="cpu")
    tm.module.load_state_dict(state_dict_from_jax_npz(flat(jm.params), tcfg))
    tm.patchnorm = torch_patchnorm(jm.patchnorm)
    return tm


def make_case(which):
    """(JAX model, JAX packed batch): a fresh pair, patchnorm calibrated."""
    if which == "r3b":
        jm = JaxAE.from_pretrained(R3B, dtype=jnp.float32)
        batch = packed_batch(jm.config, [(56, 70), (84, 84), (70, 98), (112, 56), (60, 75)], 256, beta=0.02)
        return jm, batch
    if which == "tiny_block":
        jm, proc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)
        batch = make_batch(proc, np.random.default_rng(0), n_images=4)
    else:
        jm = JaxAE(tiny_bias_config(), dtype=jnp.float32, seed=3)
        batch = packed_batch(jm.config, [(32, 40), (48, 48), (24, 64), (40, 40)], 96)
    jm.patchnorm, _ = jax_calibrate(jm.patchnorm, batch)
    return jm, batch


# ---------------------------------------------------------------- LFQ


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("dim", [24, 40])
def test_lfq_training_forward_matches_jax(dim, with_mask):
    """dim 24 = 4 codebooks x 6 bits (no projections); dim 40 has projections."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, 7, dim)).astype(np.float32)
    mask = rng.random((2, 7)) > 0.3 if with_mask else None
    w_out = rng.standard_normal((2, 7, dim)).astype(np.float32)
    w_dist = (rng.standard_normal((2, 7, 4, 64)) * 0.01).astype(np.float32)

    jl = JaxLFQ(dim=dim, codebook_size=64, num_codebooks=4)
    jmask = None if mask is None else jnp.asarray(mask)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jmask, True).get("params", {})

    def jloss(x):
        q, ids, commit, dist = jl.apply({"params": params}, x, jmask, True)
        return jnp.sum(q * w_out) + commit + jnp.sum(dist * w_dist), (q, ids, commit, dist)

    (_, (jq, jids, jcommit, jdist)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    tl = TorchLFQ(dim, 64, 4)
    assert tl.has_projections == (dim == 40)
    if tl.has_projections:
        sd = {k.replace("/", ".").replace("kernel", "weight"): torch.from_numpy(np.array(v)) for k, v in flat(params).items()}
        tl.load_state_dict({k: (v.T.contiguous() if k.endswith("weight") else v) for k, v in sd.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    q, ids, commit, dist = tl(tx, mask=None if mask is None else torch.from_numpy(mask), training=True)
    (torch.sum(q * torch.from_numpy(w_out)) + commit + torch.sum(dist * torch.from_numpy(w_dist))).backward()

    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-5)
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(jdist), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-5)

    # the eval path: same quantized values and ids, no losses
    with torch.no_grad():
        q_eval, ids_eval, commit_eval, dist_eval = tl(tx)
    np.testing.assert_array_equal(ids_eval.numpy(), ids.numpy())
    np.testing.assert_allclose(q_eval.numpy(), q.detach().numpy(), atol=1e-6)
    assert commit_eval.item() == 0.0 and dist_eval.item() == 0.0


# ---------------------------------------------------------------- patchnorm


def test_patchnorm_calibration_matches_jax():
    """State after two successive batches; the second has an even count per bucket."""
    jm, proc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)
    rng = np.random.default_rng(5)
    batches = [make_batch(proc, rng, n_images=3), make_batch(proc, rng, n_images=4)]
    js = jm.patchnorm
    ts = TorchPatchNorm.create(3, 8, 8, jm.config.patch_dim)
    for b in batches:
        js, jout = jax_calibrate(js, b)
        ts, tout = torch_calibrate(ts, to_torch_batch(b))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        for name in ("n", "median", "b"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=1e-6)
    assert ts.n.max().item() == 7


def test_patchnorm_even_count_takes_lower_middle():
    """Four images, one bucket: the batch median is the second smallest value."""
    vals = np.array([3.0, -1.0, 2.0, 7.0], np.float32)
    patches = torch.from_numpy(np.tile(vals[:, None, None], (1, 1, 2)))  # (4 rows, 1 token, pz 2)
    z = torch.zeros((4, 1), dtype=torch.int32)
    from dct_autoencoder_torch.patches.container import DCTPatches

    batch = DCTPatches(
        patches=patches, key_pad_mask=torch.zeros((4, 1), dtype=torch.bool), batched_image_ids=z,
        patch_channels=z, patch_positions=torch.zeros((4, 1, 2), dtype=torch.int32),
    )
    state, _ = torch_calibrate(TorchPatchNorm.create(1, 1, 1, 2), batch)
    assert state.n.item() == 4
    np.testing.assert_allclose(state.median.numpy().ravel(), [2.0, 2.0])
    np.testing.assert_allclose(state.b.numpy().ravel(), [(1 + 3 + 0 + 5) / 4] * 2)


# ---------------------------------------------------------------- losses and gradients


def jax_losses_and_grads(jm, batch):
    nb = jm.normalize_(batch)

    def f(params):
        losses = jlosses.step_autoencoder(jm.module, params, jm.patchnorm, batch, nb, training=True)
        return jlosses.weighted_total(losses), losses

    (total, losses), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jm.params)
    return float(total), losses, flat(grads)


def port_losses_and_grads(tm, tb):
    nb = tm.normalize_(tb)
    losses = tlosses.step_autoencoder(tm.module, tm.patchnorm, tb, nb, training=True)
    total = tlosses.weighted_total(losses)
    tm.module.zero_grad()
    total.backward()
    grads = {k: p.grad for k, p in tm.module.named_parameters()}
    return total.item(), losses, jax_arrays_from_state_dict(grads, tm.config)


@pytest.mark.parametrize("which", ["tiny_block", "tiny_bias", "r3b"])
def test_step_autoencoder_losses_and_gradients_match_jax(which):
    jm, batch = make_case(which)
    tm = port_of(jm)
    jtotal, jl, jg = jax_losses_and_grads(jm, batch)
    ttotal, tl, tg = port_losses_and_grads(tm, to_torch_batch(batch))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ttotal, jtotal, rtol=1e-4)
    valid = ~np.asarray(batch.key_pad_mask)
    assert_codes_match(
        tl["codes"].numpy(), np.asarray(jl["codes"]), jax_pre_sign(jm, jm.normalize_(batch)),
        tm.module.vq_model.codebook_dim, valid,
    )
    np.testing.assert_allclose(
        tl["rec_patches"].detach().numpy()[valid], np.asarray(jl["rec_patches"])[valid], atol=1e-3
    )
    assert tg.keys() == jg.keys()
    floor = 1e-6 * max(np.abs(g).max() for g in jg.values())
    for k, want in jg.items():
        np.testing.assert_allclose(tg[k], want, atol=GRAD_REL_ATOL * np.abs(want).max() + floor, rtol=0, err_msg=k)
    assert sum(float(np.abs(g).max() > 0) for g in tg.values()) > 0.9 * len(tg)


def test_step_autoencoder_eval_has_no_entropy_loss():
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tb = to_torch_batch(batch)
    with torch.no_grad():
        losses = tlosses.step_autoencoder(tm.module, tm.patchnorm, tb, tm.normalize_(tb), training=False)
    want = jlosses.step_autoencoder(jm.module, jm.params, jm.patchnorm, batch, jm.normalize_(batch), training=False)
    assert losses["entropy_loss"].item() == 0.0 and losses["commit_loss"].item() == 0.0
    np.testing.assert_allclose(losses["rec_loss"].item(), float(want["rec_loss"]), rtol=1e-4)


def test_masked_l1_and_weighted_total_match_jax():
    pred, target = torch.ones((1, 4, 3)) * 2.0, torch.zeros((1, 4, 3))
    mask = torch.tensor([[True, True, False, False]])
    assert tlosses.masked_l1(pred, target, mask).item() == pytest.approx(2.0)
    assert tlosses.masked_l1(pred, target, torch.zeros_like(mask)).item() == 0.0
    assert tlosses.DEFAULT_LOSS_WEIGHTS == jlosses.DEFAULT_LOSS_WEIGHTS
    vals = {"rec_loss": 1.5, "commit_loss": 0.5, "entropy_loss": -2.0, "perplexity": 9.0}
    for kwargs in (
        {},
        dict(loss_weights={"rec_loss": 1.0, "commit_loss": 1.0}, warmup_dict={"commit_loss": 10}, global_step=4.0),
        dict(loss_weights={"entropy_loss": 0.0}),
    ):
        want = float(jlosses.weighted_total({k: jnp.asarray(v) for k, v in vals.items()}, **kwargs))
        got = tlosses.weighted_total({k: torch.tensor(v) for k, v in vals.items()}, **kwargs).item()
        assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------- optimizer and step


def _assert_params_close(tm, jparams, lr_sum, what):
    got, want = jax_arrays_from_state_dict(tm.module.state_dict(), tm.config), flat(jparams)
    assert got.keys() == want.keys()
    n_off = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        off = int((diff > 1e-5).sum())
        if not k.endswith("k_proj/bias"):
            n_off += off
            assert off <= max(2, 0.01 * diff.size), f"{what} {k}: {off} of {diff.size} entries differ by more than 1e-5"
        assert diff.max() <= 2 * lr_sum + 1e-5, f"{what} {k}: max diff {diff.max()}"
    assert n_off <= 2e-3 * sum(v.size for v in want.values()), f"{what}: {n_off} entries differ by more than 1e-5"


# ---------------------------------------------------------------- fp32 masters, dropout, remat


def test_bf16_compute_keeps_fp32_masters():
    """Products run in bf16, parameters and their gradients stay fp32."""
    cfg = TorchConfig.from_dict(tiny_bias_config().to_dict())
    tm = TorchAE(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in tm.module.parameters())
    jm, batch = make_case("tiny_bias")
    tb = to_torch_batch(batch)
    tm.patchnorm = torch_patchnorm(jm.patchnorm)
    out = tm.module(tm.normalize_(tb), training=True)
    assert out["dct_patches"].patches.dtype == torch.bfloat16
    losses = tlosses.step_autoencoder(tm.module, tm.patchnorm, tb, tm.normalize_(tb))
    tlosses.weighted_total(losses).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in tm.module.parameters())
    # serving gives the numbers of weights stored in bf16
    with torch.no_grad():
        lin = tm.module.encoder.layers[0].fc1
        x = torch.randn(3, lin.in_features).bfloat16()
        want = torch.nn.functional.linear(x, lin.weight.bfloat16(), lin.bias.bfloat16())
        assert torch.equal(lin(x), want)


def test_remat_gives_the_same_gradients():
    jm, batch = make_case("tiny_block")
    tb = to_torch_batch(batch)
    grads = []
    for remat in (False, True):
        tm = port_of(jm)
        for stack in (tm.module.encoder, tm.module.decoder):
            stack.remat = remat
        grads.append(port_losses_and_grads(tm, tb)[2])
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k], grads[0][k], atol=1e-7, rtol=1e-6)


def test_dropout_draws_from_the_generator():
    jcfg = tiny_config()
    jcfg.encoder_config.dropout = 0.5
    cfg = TorchConfig.from_dict(jcfg.to_dict())
    tm = TorchAE(cfg, dtype=torch.float32, device="cpu", seed=2)
    _, batch = make_case("tiny_block")
    tb = to_torch_batch(batch)
    run = lambda seed, training=True: tm.module(
        tb, training=training, generator=torch.Generator().manual_seed(seed)
    )["dct_patches"].patches.detach()
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))
    assert torch.equal(run(0, training=False), run(1, training=False))
    tm.module.encoder.remat = True
    with pytest.raises(ValueError, match="default generator"):
        tm.module(tb, training=True, generator=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- calibration phase and the loop


def _port_setup(seed=0, beta=0.0):
    cfg = TorchConfig.from_dict(tiny_config().to_dict())
    model, proc = torch_model_and_processor(cfg, sample_patches_beta=beta, seed=seed, device="cpu")
    proc.rng = random.Random(seed)
    return model, proc


def _stream(proc, n_pulls, seed=1, n_images=4, poison_at=None):
    rng = np.random.default_rng(seed)
    for i in range(n_pulls):
        ims = [rng.uniform(0.1, 0.9, size=(3, 32, 32)).astype(np.float32) for _ in range(n_images)]
        ds = proc.preprocess_many(ims)
        if i == poison_at:
            ds[0]["patches"] = ds[0]["patches"] * np.nan
        yield {k: [d[k] for d in ds] for k in ds[0]}


@pytest.fixture
def deterministic():
    """Bit-identical CPU runs: scatter-adds in a fixed order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------- the loop's host machinery


# ---------------------------------------------------------------- the reverse parameter map


@pytest.mark.parametrize("fault", ["extra_key", "missing_key", "bad_shape"])
def test_reverse_map_refuses_mismatch(fault):
    model, _ = _port_setup()
    sd = dict(model.module.state_dict())
    if fault == "extra_key":
        sd["encoder.layers.9.fc1.weight"] = sd["encoder.layers.0.fc1.weight"]
    elif fault == "missing_key":
        del sd["decoder.layers.1.layer_norm2.weight"]
    else:
        sd["proj_out_linear.weight"] = sd["proj_out_linear.weight"][:, :-1]
    with pytest.raises((KeyError, ValueError)):
        jax_arrays_from_state_dict(sd, model.config)


def test_reverse_map_round_trips_r3b():
    cfg = TorchConfig.from_json_file(os.path.join(R3B, "config.json"))
    with np.load(os.path.join(R3B, "params.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    back = jax_arrays_from_state_dict(state_dict_from_jax_npz(arrays, cfg), cfg)
    assert back.keys() == arrays.keys()
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)


# ---------------------------------------------------------------- attention dropout


def _dropout_config(rate: float) -> TorchConfig:
    """tests/test_model.py::test_dropout_active_in_training's config: MLP dropout 0.5, attention dropout `rate`."""
    cfg = TorchConfig.from_dict(tiny_config("lfq").to_dict())
    cfg.encoder_config.dropout = 0.5
    cfg.encoder_config.attention_dropout = rate
    return cfg


@pytest.mark.parametrize("where", ["make_train_step", "train", "training_forward"])
def test_attention_dropout_is_refused_by_name(where):
    """Once refused, attention dropout now trains on every training path, as
    JAX's XLA attention drops the softmax weights: the numbers are finite,
    the rate takes effect (they move against the same path at rate 0), and
    serving ignores the rate."""
    def run(rate):
        model, proc = torch_model_and_processor(_dropout_config(rate), sample_patches_beta=0.0, seed=3, device="cpu")
        proc.rng = random.Random(0)
        if where == "make_train_step":
            batch = tloop.prepare_train_batch(next(proc.iter_batches(_stream(proc, 1), batch_size=None)))[0]
            tx = tloop.make_optimizer()
            step = tloop.make_train_step(model.module, tx)
            _, metrics = step(tloop.TrainState.create(model.module, tx), model.patchnorm, batch)
            return torch.stack([metrics["loss"], metrics["grad_norm"]]), None
        if where == "train":
            logs = []
            tloop.train(model, proc, _stream(proc, 1), batch_size=None, max_iters=1, log_every=1, prefetch_batches=0,
                        log=logs.append)
            assert len(logs) == 1
            return torch.tensor([logs[0]["loss"], logs[0]["grad_norm"]]), None
        batch = model.normalize_(next(proc.iter_batches(_stream(proc, 1), batch_size=None)))
        with torch.no_grad():
            out = model.module(batch, training=True, generator=torch.Generator().manual_seed(0))
            return out["dct_patches"].patches, model.forward(batch)["dct_patches"].patches

    (dropped, served), (undropped, served_at_0) = run(0.3), run(0.0)
    assert torch.isfinite(dropped).all()
    assert not torch.allclose(dropped, undropped, atol=1e-6)
    if served is not None:
        assert torch.equal(served, served_at_0)  # serving never reads the rate
