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
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict, state_dict_from_jax_npz
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_torch.models.lfq import LFQ as TorchLFQ
from dct_autoencoder_torch.models.patchnorm import PatchNormState as TorchPatchNorm
from dct_autoencoder_torch.models.patchnorm import calibrate_patchnorm_batch as torch_calibrate
from dct_autoencoder_torch.train import checkpoint as tckpt
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


@pytest.mark.parametrize("max_iters,warmup", [(40, 8), (10000, 200), (5, 200), (30, 0), (1, 200)])
def test_learning_rate_schedule_matches_optax(max_iters, warmup):
    """make_optimizer's schedule, its clamps on warmup_steps and decay_steps included."""
    lr = 3e-4
    tx = tloop.make_optimizer(lr, max_iters, warmup)
    w = min(warmup, max(max_iters - 1, 0))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, w, max(max_iters, w + 1), 0.0)
    steps = list(range(0, min(max_iters, 400) + 5))
    got = np.array([tx.schedule(i) for i in steps])
    want = np.array([float(sched(i)) for i in steps])
    np.testing.assert_allclose(got, want, atol=1e-7 * lr, rtol=1e-5)
    if w > 0:
        assert got[0] == 0.0


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


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    """Parameters, losses and the pre-clip grad norm over 3 steps (warmup 2: rates 0, 5e-5, 1e-4)."""
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tb = to_torch_batch(batch)
    kw = dict(learning_rate=1e-4, max_iters=100, warmup_steps=2)

    jtx = jloop.make_optimizer(**kw)
    jstate = jloop.TrainState.create(jm.params, jtx)
    jstep = jax.jit(jloop.make_train_step(jm.module, jtx, accum_steps=accum))
    ttx = tloop.make_optimizer(**kw)
    tstate = tloop.TrainState.create(tm.module, ttx)
    tstep = tloop.make_train_step(tm.module, ttx, accum_steps=accum)

    lr_sum = 0.0
    for i in range(3):
        jstate, jmet = jstep(jstate, jm.patchnorm, batch)
        tstate, tmet = tstep(tstate, tm.patchnorm, tb)
        lr_sum += ttx.schedule(i)
        assert tmet.keys() == jmet.keys()
        for k in jmet:
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-3, err_msg=f"step {i} {k}")
        _assert_params_close(tm, jstate.params, lr_sum, f"step {i}")
    assert tstate.step == int(jstate.step) == 3


def test_clip_scales_like_optax():
    """A gradient above the limit is scaled to the limit; grad_norm reports the norm before."""
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tx = tloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0, grad_clip=1e-3)
    state = tloop.TrainState.create(tm.module, tx)
    seen = {}
    orig = state.adamw.step
    state.adamw.step = lambda: seen.update(norm=torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in tm.module.parameters()]))) or orig()
    _, met = tloop.make_train_step(tm.module, tx)(state, tm.patchnorm, to_torch_batch(batch))
    assert met["grad_norm"].item() > 1e-3
    assert seen["norm"].item() == pytest.approx(1e-3, rel=1e-4)


def test_train_step_reduces_loss():
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tx = tloop.make_optimizer(learning_rate=3e-3, max_iters=100, warmup_steps=0)
    state = tloop.TrainState.create(tm.module, tx)
    step = tloop.make_train_step(tm.module, tx)
    tb = to_torch_batch(batch)
    losses = []
    for _ in range(12):
        state, metrics = step(state, tm.patchnorm, tb)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert state.step == 12


def test_accumulation_pads_and_weights_by_tokens():
    """Uneven token counts per micro-batch: the token-mean losses of accum=2 equal accum=1."""
    jm, _ = make_case("tiny_block")
    proc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    rng = np.random.default_rng(0)
    ims = [rng.uniform(0.1, 0.9, size=(3, s, s)).astype(np.float32) for s in (32, 16, 16, 32, 16)]
    ds = [proc.preprocess(im) for im in ims]
    batch = next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]), batch_size=None))
    tb = to_torch_batch(batch)
    assert tb.patches.shape[0] == 4
    tok = (~tb.key_pad_mask).sum(dim=1)
    assert tok[:2].sum() != tok[2:].sum()
    mets = {}
    for accum in (1, 2):
        tm = port_of(jm)
        tx = tloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0)
        _, mets[accum] = tloop.make_train_step(tm.module, tx, accum_steps=accum)(
            tloop.TrainState.create(tm.module, tx), tm.patchnorm, tb
        )
    for k in ("rec_loss", "rec_loss_unnormalized", "commit_loss"):
        np.testing.assert_allclose(mets[2][k].item(), mets[1][k].item(), rtol=1e-5, err_msg=k)
    padded = tloop.pad_batch_rows(tb, 3)
    assert padded.patches.shape[0] == 6 and padded.key_pad_mask[4:].all() and not padded.key_pad_mask[:4].all()
    with pytest.raises(ValueError, match="accum_steps"):
        tm = port_of(jm)
        tx = tloop.make_optimizer()
        tloop.make_train_step(tm.module, tx, accum_steps=3)(tloop.TrainState.create(tm.module, tx), tm.patchnorm, tb)


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


def test_train_patch_norm_phase():
    model, proc = _port_setup(beta=0.05)
    proc.max_seq_len = 64
    logs = []
    state = tloop.train_patch_norm(model, proc, _stream(proc, 3), steps=3, batch_size=None, log=logs.append)
    assert state.n.max().item() > 0 and model.patchnorm is state
    assert len(logs) == 3
    assert proc.sample_patches_beta == 0.05 and proc.max_seq_len == 64
    # restored after a failure inside the phase as well
    with pytest.raises(ZeroDivisionError):
        tloop.train_patch_norm(model, proc, _stream(proc, 1), log=lambda _: 1 / 0, batch_size=None)
    assert proc.sample_patches_beta == 0.05 and proc.max_seq_len == 64


def test_train_writes_a_checkpoint_the_jax_package_loads(tmp_path):
    """A few steps of train(); the saved model gives the same codes in both packages."""
    model, proc = _port_setup()
    tloop.train_patch_norm(model, proc, _stream(proc, 2), steps=2, batch_size=None, log=lambda _: None)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    logs = []
    model, state = tloop.train(
        model, proc, _stream(proc, 5, seed=2), batch_size=None, learning_rate=1e-3, max_iters=4, log_every=1,
        save_every=2, keep_checkpoints=True, out_dir=str(tmp_path), log=logs.append,
    )
    assert state.step == 4
    assert [m["step"] for m in logs] == [0, 1, 2, 3] and all(np.isfinite(m["loss"]) for m in logs)
    assert any(not torch.equal(before[k], v) for k, v in model.module.state_dict().items())
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000002", "model", "train_state.pt"]
    assert sorted(os.listdir(tmp_path / "model")) == ["config.json", "params.npz", "patchnorm.npz"]

    jm = JaxAE.from_pretrained(str(tmp_path / "model"), dtype=jnp.float32)
    want = flat(jm.params)
    got = jax_arrays_from_state_dict(model.module.state_dict(), model.config)
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    np.testing.assert_array_equal(np.asarray(jm.patchnorm.median), model.patchnorm.median.numpy())

    jproc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    batch = make_batch(jproc, np.random.default_rng(9), n_images=3)
    jcodes = np.asarray(jm.forward(jm.normalize_(batch), training=False)["codes"])
    tb = to_torch_batch(batch)
    tcodes = model.forward(model.normalize_(tb))["codes"].numpy()
    valid = ~np.asarray(batch.key_pad_mask)
    # equal; a bit may differ only where JAX's pre-sign value is within 1e-4 of 0
    assert_codes_match(tcodes, jcodes, jax_pre_sign(jm, jm.normalize_(batch)), model.module.vq_model.codebook_dim, valid)
    reloaded = TorchAE.from_pretrained(str(tmp_path / "model"), device="cpu")
    np.testing.assert_array_equal(reloaded.forward(reloaded.normalize_(tb))["codes"].numpy(), tcodes)


@pytest.fixture
def deterministic():
    """Bit-identical CPU runs: scatter-adds in a fixed order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_resume_is_exact(tmp_path, deterministic):
    """train 4 == train 2 + resume 2, bit for bit: parameters, moments and step."""
    kw = dict(batch_size=None, learning_rate=1e-3, log_every=1, log=lambda _: None)

    def fresh():
        model, proc = _port_setup(seed=3)
        model.patchnorm = TorchPatchNorm.create(3, 8, 8, model.config.patch_dim)
        return model, proc

    pulls = list(_stream(_port_setup()[1], 4, seed=4))
    m4, p4 = fresh()
    m4, s4 = tloop.train(m4, p4, iter(pulls), max_iters=4, **kw)

    m2, p2 = fresh()
    # max_iters counts total steps: the schedule must be the 4-step one in both legs
    tx = tloop.make_optimizer(1e-3, 4)
    state = tloop.TrainState.create(m2.module, tx)
    step = tloop.make_train_step(m2.module, tx)
    for pull in pulls[:2]:
        batch = next(p2.iter_batches(iter([pull]), batch_size=None))
        state, _ = step(state, m2.patchnorm, tloop.prepare_train_batch(batch)[0])
    tckpt.save_train_state(str(tmp_path), state, m2.patchnorm)
    assert tckpt.has_train_state(str(tmp_path)) and not tckpt.has_train_state(str(tmp_path / "nowhere"))

    m3, p3 = _port_setup(seed=7)  # other weights: the checkpoint must replace them
    logs = []
    m3, s3 = tloop.train(m3, p3, iter(pulls[2:]), max_iters=4, resume_path=str(tmp_path), **{**kw, "log": logs.append})
    assert logs[0] == {"resumed_from": str(tmp_path), "step": 2}
    assert s3.step == s4.step == 4
    for (k, a), b in zip(m4.module.state_dict().items(), m3.module.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = s4.adamw.state_dict()["state"], s3.adamw.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) and torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])


@pytest.mark.parametrize("policy", ["abort", "restore"])
def test_nan_policy(policy, tmp_path):
    """A poisoned batch: 'abort' stops there; 'restore' rolls back to the last save and goes on."""
    model, proc = _port_setup()
    logs = []
    _, state = tloop.train(
        model, proc, _stream(proc, 6, poison_at=3), batch_size=None, max_iters=6, log_every=1, save_every=2,
        nan_policy=policy, out_dir=str(tmp_path), log=logs.append,
    )
    errors = [m for m in logs if "error" in m]
    warnings = [m for m in logs if "warning" in m]
    if policy == "abort":
        assert errors == [{"step": 3, "error": "NAN LOSS: aborting"}] and state.step == 4
    else:
        assert not errors and len(warnings) == 1 and "restored last checkpoint (step 3)" in warnings[0]["warning"]
        assert state.step == 5 and all(torch.isfinite(p).all() for p in model.module.parameters())


def test_restore_without_a_checkpoint_aborts():
    model, proc = _port_setup()
    logs = []
    tloop.train(model, proc, _stream(proc, 3, poison_at=0), batch_size=None, max_iters=3, log_every=1,
                nan_policy="restore", log=logs.append)
    assert len(logs) == 1 and "needs a checkpoint" in logs[0]["error"]


def test_zero_batches_is_reported():
    model, proc = _port_setup()
    logs = []
    tloop.train(model, proc, iter([]), log=logs.append)
    assert len(logs) == 1 and "ZERO batches" in logs[0]["error"]


def _write_cfg(tmp_path, cfg) -> str:
    path = str(tmp_path / "cfg.json")
    cfg.to_json_file(path)
    return path


def _cli(tmp_path, cfg=None, **flags):
    from dct_autoencoder_torch.train import cli

    return cli.main(
        preprocessed_dataset_path_or_url=str(tmp_path / "none"), model_config_path=_write_cfg(tmp_path, cfg or tiny_config()),
        should_save=False, device="cpu", **flags,
    )


# what is still not ported: refused by name, in train() and in the CLI
REFUSED = {
    "n_model_parallel": lambda m, p, t: tloop.train(m, p, iter([]), n_model_parallel=2),
    "pipeline_microbatches": lambda m, p, t: tloop.train(m, p, iter([]), pipeline_microbatches=2),
    "zero1": lambda m, p, t: tloop.train(m, p, iter([]), zero1=True),
    "cli_n_model_parallel": lambda m, p, t: _cli(t, n_model_parallel=2),
    "cli_pipeline_microbatches": lambda m, p, t: _cli(t, pipeline_microbatches=2),
    "cli_sequence_parallel": lambda m, p, t: _cli(t, sequence_parallel=True),
    "cli_zero1": lambda m, p, t: _cli(t, zero1=True),
    "cli_vq_config": lambda m, p, t: _cli(t, cfg=tiny_config("vq"), vq_expire_every=10),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_train_refuses_what_is_not_ported(what, tmp_path):
    model, proc = _port_setup()
    name = what.removeprefix("cli_").replace("_config", "")
    with pytest.raises(NotImplementedError, match=name):
        REFUSED[what](model, proc, tmp_path)


@pytest.mark.parametrize("what", ["dynamic_hparams", "vq"])
def test_make_functions_refuse_what_is_not_ported(what):
    """dynamic_hparams is make_train_step's (JAX's train() has no such argument: its sweep builds the step)."""
    model, _ = _port_setup()
    with pytest.raises(NotImplementedError, match=what):
        if what == "vq":
            TorchAE(TorchConfig.from_dict(tiny_config("vq").to_dict()), device="cpu")
        else:
            tloop.make_train_step(model.module, tloop.make_optimizer(), dynamic_hparams=True)


# ---------------------------------------------------------------- the loop's host machinery


def test_train_loop_with_pixel_loss_and_8bit_moments():
    model, proc = _port_setup()
    logs = []
    _, state = tloop.train(
        model, proc, _stream(proc, 3, seed=11, n_images=3), batch_size=None, max_iters=3, learning_rate=1e-4,
        use_pixel_loss=True, pixel_loss_max_images=8, opt_8bit=True, log_every=1, save_every=0, log=logs.append,
    )
    from dct_autoencoder_torch.train.opt8bit import AdamW8bit

    assert isinstance(state.adamw, AdamW8bit) and state.adamw.param_groups[0]["count"] == 3
    px = [d["pixel_loss"] for d in logs if "pixel_loss" in d]
    assert len(px) == 3 and all(np.isfinite(px)), logs


def test_train_loop_with_prefetch_equals_without(tmp_path):
    """Batches made on the prefetch thread train exactly as batches made inline."""
    runs = {}
    for n in (0, 2):
        model, proc = _port_setup(seed=5)
        logs = []
        tloop.train(model, proc, iter(list(_stream(_port_setup()[1], 3, seed=21, n_images=3))), batch_size=None,
                    max_iters=3, learning_rate=1e-4, prefetch_batches=n, log_every=1, save_every=0, log=logs.append)
        runs[n] = [d["loss"] for d in logs]
        assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())
    assert len(runs[2]) == 3 and runs[2] == runs[0]


def test_prefetch_worker_error_reaches_the_loop():
    model, proc = _port_setup()

    def broken():
        yield from _stream(proc, 1)
        raise OSError("shard vanished")

    with pytest.raises(OSError, match="vanished"):
        tloop.train(model, proc, broken(), batch_size=None, max_iters=5, prefetch_batches=2, log=lambda _: None)
    assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())


def _jax_grid_pixel_mse(jm, jproc, batch) -> float:
    """The JAX loop's image-grid metric (its train/loop.py, log_images_every) on a JAX model."""
    out = jm.forward(jm.normalize_(batch), training=False)
    rec = jm.inv_normalize_(out["dct_patches"]).replace(patch_sizes=batch.patch_sizes, original_sizes=batch.original_sizes)
    recs, origs = jproc.postprocess(rec), jproc.postprocess(batch)
    return float(np.mean([np.mean((np.clip(r, 0, 1) - o) ** 2) for r, o in zip(recs, origs)]))


def test_image_grid_logging_matches_jax(tmp_path):
    """train(log_images_every=1) writes a grid a step; the logged RGB pixel
    MSE of a batch equals the JAX loop's on the same weights (rtol 1e-3:
    fp32 IDCTs and forwards summed in other orders)."""
    from dct_autoencoder_torch.train.loop import _log_image_grid

    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    jproc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    tproc = torch_model_and_processor(TorchConfig.from_dict(tiny_config().to_dict()), sample_patches_beta=0.0,
                                      device="cpu")[1]
    logs = []
    _log_image_grid(tm, tproc, to_torch_batch(batch), 7, 2, str(tmp_path), logs.append)
    assert logs[0]["step"] == 7 and os.path.exists(tmp_path / "train_image_000007.png")
    np.testing.assert_allclose(logs[0]["pixel_loss"], _jax_grid_pixel_mse(jm, jproc, batch), rtol=1e-3)

    model, proc = _port_setup()
    out_dir = tmp_path / "run"
    logs = []
    tloop.train(model, proc, _stream(proc, 2, seed=9, n_images=3), batch_size=None, max_iters=2,
                log_images_every=1, n_log_images=2, save_every=0, out_dir=str(out_dir), log=logs.append)
    assert sorted(f for f in os.listdir(out_dir) if f.startswith("train_image_")) == [
        "train_image_000000.png", "train_image_000001.png"]
    assert all(np.isfinite(d["pixel_loss"]) for d in logs if "pixel_loss" in d)


def test_rss_watchdog_checkpoints_and_raises(tmp_path):
    """rss_limit_gb below any process's RSS: a resumable checkpoint after at
    least one step, then RssLimitExceeded; off by default (0)."""
    model, proc = _port_setup()
    logs = []
    with pytest.raises(tloop.RssLimitExceeded) as e:
        tloop.train(model, proc, _stream(proc, 5, n_images=3), batch_size=None, max_iters=5, rss_limit_gb=0.001,
                    log_every=1, save_every=0, out_dir=str(tmp_path), log=logs.append)
    assert e.value.step >= 1 and e.value.out_dir == str(tmp_path)
    assert tckpt.has_train_state(str(tmp_path))
    assert any("checkpointed" in str(d.get("warning", "")) for d in logs)
    assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())
    assert tloop._rss_gb() > 0 and tloop._auto_rss_limit_gb() > 0
    import inspect

    assert inspect.signature(tloop.train).parameters["rss_limit_gb"].default == 0.0


def test_stall_watchdog_fires_on_wedged_step():
    """No step completes within stall_timeout_s after the first: on_stall
    fires from the watchdog thread."""
    model, proc = _port_setup()
    fired = threading.Event()

    def batches():
        yield from _stream(proc, 2, n_images=3)
        while not fired.wait(0.1):  # the stream blocks: no step completes
            pass

    tloop.train(model, proc, batches(), batch_size=2, max_iters=10, prefetch_batches=0, stall_timeout_s=1.0,
                on_stall=fired.set, log=lambda _: None)
    assert fired.is_set(), "stall watchdog never fired"


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
    """JAX drops attention weights in training on its XLA path; the port's
    attention is the kernel, so every training path refuses the rate rather
    than train another function."""
    model, proc = torch_model_and_processor(_dropout_config(0.3), sample_patches_beta=0.0, device="cpu")
    with pytest.raises(NotImplementedError, match="attention_dropout"):
        if where == "make_train_step":
            tloop.make_train_step(model.module, tloop.make_optimizer())
        elif where == "train":
            tloop.train(model, proc, _stream(proc, 1), batch_size=None, max_iters=1)
        else:
            batch = next(proc.iter_batches(_stream(proc, 1), batch_size=None))
            model.module(model.normalize_(batch), training=True, generator=torch.Generator().manual_seed(0))


def test_attention_dropout_zero_trains_and_serves_as_before():
    """With attention_dropout 0 the same config trains (MLP dropout from the
    generator) and serving ignores dropout, as in JAX."""
    model, proc = torch_model_and_processor(_dropout_config(0.0), sample_patches_beta=0.0, device="cpu")
    proc.rng = random.Random(0)
    logs = []
    model, state = tloop.train(model, proc, _stream(proc, 3), batch_size=None, max_iters=3, log_every=1, log=logs.append)
    assert state.step == 3 and all(np.isfinite(m["loss"]) for m in logs)
    served = _dropout_config(0.3)  # serving (training=False) never reads the rate
    model, proc = torch_model_and_processor(served, sample_patches_beta=0.0, device="cpu")
    batch = model.normalize_(next(proc.iter_batches(_stream(proc, 1), batch_size=None)))
    assert torch.equal(model.forward(batch)["codes"], model.forward(batch)["codes"])
