"""VQ training in the port (the model's VQ forward, the losses and
gradients, the moments of replaced codes) against the JAX package, in fp32
on the CPU.  Train steps and the codebook surgery in the step are in
tests/test_torch_vq_steps.py; checkpoints, resume, the CLI and serving in
tests/test_torch_vq_checkpoint.py; the sweep and dynamic_hparams in
tests/test_torch_sweep.py.

Model: tests/test_model.py::tiny_config("vq") (4 codebooks x 64 codes of
dim 16, built with the reference's VQ settings), JAX's parameters and
vq_stats carried into the port by models/convert.py; batches packed by the
JAX extractor from seeded numpy images.  Gumbel noise is set to zero in
both packages where a training step is compared (jax.random.gumbel is
monkeypatched here), so both take the argmin.

Tolerances:
  * ids equal, except where JAX's best two distances (float64, from JAX's
    projections and its affine codebook) differ by at most 1e-5 relative;
  * losses rtol 1e-4 and each parameter's gradient atol 2e-3 x its largest
    entry, as tests/test_torch_train.py::test_step_autoencoder_losses_and_gradients_match_jax;
    the new statistics and vq_z atol 1e-5;
  * moment zeroing: equal to JAX's on the same moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch.models.vq as tvq
from dct_autoencoder_torch.models.convert import load_jax_arrays
from test_model import make_batch, tiny_config
from test_torch_model import to_torch_batch
from test_torch_train import (
    GRAD_REL_ATOL,
    LOSS_KEYS,
    TorchAE,
    TorchConfig,
    flat,
    jax_arrays_from_state_dict,
    jax_calibrate,
    jax_model_and_processor,
    jlosses,
    jloop,
    tlosses,
    tloop,
    torch_patchnorm,
)
from test_torch_vq import one_cpu_thread  # noqa: F401  (fixture)

@pytest.fixture
def no_gumbel(monkeypatch):
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tvq, "_gumbel", lambda shape, generator, device: torch.zeros(shape, device=device))


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def vq_case(seed=0, n_images=4):
    jm, proc = jax_model_and_processor(tiny_config("vq"), sample_patches_beta=0.0)
    batch = make_batch(proc, np.random.default_rng(seed), n_images=n_images)
    jm.patchnorm, _ = jax_calibrate(jm.patchnorm, batch)
    return jm, proc, batch


def vq_port_of(jm, params=None, vq_stats=None) -> TorchAE:
    tcfg = TorchConfig.from_dict(jm.config.to_dict())
    tm = TorchAE(tcfg, dtype=torch.float32, device="cpu")
    load_jax_arrays(tm.module, flat(params or jm.params), tcfg, flat(vq_stats or jm.vq_stats))
    tm.patchnorm = torch_patchnorm(jm.patchnorm)
    return tm


def jax_normed_codebook(params, stats) -> np.ndarray:
    cb = np.asarray(params["vq_model"]["codebook"], np.float64)
    s = {k: np.asarray(v, np.float64) for k, v in stats["vq_model"].items()}
    return (cb - s["codebook_mean"]) / np.sqrt(s["codebook_variance"] + 1e-5) * np.sqrt(s["batch_variance"] + 1e-5) + s["batch_mean"]


def assert_vq_codes_match(got, want, jz, normed_cb, valid, margin=1e-5):
    """Codes equal; a code may differ only where JAX's best two distances are
    within `margin` of each other (relative), on at most 1 % of the ids."""
    diff = (got != want) & valid[..., None]
    if not diff.any():
        return
    z = np.asarray(jz, np.float64)
    d = np.sort(((z[..., None, :] - normed_cb) ** 2).sum(-1), axis=-1)
    near = (d[..., 1] - d[..., 0]) <= margin * np.maximum(d[..., -1], 1.0)
    assert not (diff & ~near).any(), "a code differs where JAX's best two distances are far apart"
    assert diff.sum() <= 0.01 * diff[valid].size


def _jax_eval(jm, batch):
    """JAX's eval forward: (codes, vq_z, decoded patches)."""
    out = jm.forward(jm.normalize_(batch), training=False)
    return np.asarray(out["codes"]), np.asarray(out["vq_z"]), np.asarray(out["dct_patches"].patches)


# ---------------------------------------------------------------- forward, losses, gradients


def test_vq_model_builds_with_the_reference_settings():
    cfg = TorchConfig.from_dict(tiny_config("vq").to_dict())
    vq = TorchAE(cfg, device="cpu").module.vq_model
    assert isinstance(vq, tvq.VectorQuantize)
    assert (vq.heads, vq.codebook_size, vq.codebook_dim) == (4, 64, 16)
    assert vq.sample_codebook_temp == 20.0 and vq.affine_param and vq.kmeans_init
    assert vq.threshold_ema_dead_code == 15.0 and not vq.ema_update and not vq.separate_codebook_per_head
    assert set(vq.stats()) == {"batch_mean", "batch_variance", "codebook_mean", "codebook_variance", "cluster_size"}


def test_vq_eval_forward_matches_jax():
    jm, _, batch = vq_case(1)
    tm = vq_port_of(jm)
    tb = to_torch_batch(batch)
    jcodes, jz, want = _jax_eval(jm, batch)
    out = tm.forward(tm.normalize_(tb))
    valid = ~np.asarray(batch.key_pad_mask)
    assert_vq_codes_match(out["codes"].numpy(), jcodes, jz, jax_normed_codebook(jm.params, jm.vq_stats), valid)
    same = (out["codes"].numpy() == jcodes).all(-1) & valid
    np.testing.assert_allclose(out["dct_patches"].patches.numpy()[same], want[same], atol=1e-3)
    # decoding the codes gives the eval forward's patches
    dec = tm.decode_from_codes(out["codes"], **{k: getattr(tb, k) for k in (
        "key_pad_mask", "batched_image_ids", "patch_channels", "patch_positions")})
    torch.testing.assert_close(dec.patches[torch.from_numpy(valid)], out["dct_patches"].patches[torch.from_numpy(valid)])


def test_vq_step_losses_and_gradients_match_jax(no_gumbel):
    """One training forward with the statistics updating, and the gradient
    of every parameter, through the affine statistics too."""
    jm, _, batch = vq_case(2)
    tm = vq_port_of(jm)
    nb = jm.normalize_(batch)

    def f(params):
        losses = jlosses.step_autoencoder(jm.module, params, jm.patchnorm, batch, nb, training=True,
                                          rng=jax.random.PRNGKey(0), vq_stats=jm.vq_stats)
        return jlosses.weighted_total({k: v for k, v in losses.items() if k not in ("vq_stats", "vq_z")}), losses

    (jtotal, jl), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(jm.params)
    tb = to_torch_batch(batch)
    tl = tlosses.step_autoencoder(tm.module, tm.patchnorm, tb, tm.normalize_(tb), training=True,
                                  vq_generator=torch.Generator().manual_seed(0), update_vq_stats=True)
    stats, vq_z = tm.module.vq_stats(), tl.pop("vq_z")
    ttotal = tlosses.weighted_total(tl)
    ttotal.backward()
    assert tl["entropy_loss"].item() == float(jl["entropy_loss"]) == 0.0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ttotal.item(), float(jtotal), rtol=1e-4)
    np.testing.assert_array_equal(tl["codes"].numpy(), np.asarray(jl["codes"]))
    np.testing.assert_allclose(vq_z.numpy(), np.asarray(jl["vq_z"]), atol=1e-5)
    assert not vq_z.requires_grad and not any(v.requires_grad for v in stats.values())
    for k, v in jl["vq_stats"]["vq_model"].items():
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)
    tg = jax_arrays_from_state_dict({k: p.grad for k, p in tm.module.named_parameters()}, tm.config)
    jg = flat(jg)
    assert tg.keys() == jg.keys() and "vq_model/codebook" in jg
    floor = 1e-6 * max(np.abs(g).max() for g in jg.values())
    for k, want in jg.items():
        np.testing.assert_allclose(tg[k], want, atol=GRAD_REL_ATOL * np.abs(want).max() + floor, rtol=0, err_msg=k)


@pytest.mark.parametrize("opt_8bit", [False, True], ids=["adamw", "adamw8bit"])
def test_zero_codebook_moments_matches_jax(opt_8bit):
    """fp32 AdamW: the replaced rows of both moments are zeroed, as JAX zeroes
    them.  8-bit moments: JAX finds the moments by the codebook's shape and
    its 8-bit blocks have another, so it zeroes nothing; nor does the port."""
    jm, _, batch = vq_case(6)
    tm = vq_port_of(jm)
    tb = to_torch_batch(batch)
    # JAX's optimizer state with seeded values in every float leaf
    jtx = jloop.make_optimizer(learning_rate=1e-3, max_iters=10, warmup_steps=0, opt_8bit=opt_8bit)
    rng = np.random.default_rng(6)
    fill = lambda x: jnp.asarray(rng.random(x.shape).astype(np.float32)) if x.dtype == jnp.float32 else x  # noqa: E731
    opt_state = jax.tree_util.tree_map(fill, jax.jit(jtx.init)(jm.params))
    cb_shape = jm.params["vq_model"]["codebook"].shape
    replaced = rng.random(cb_shape[:-1]) < 0.3
    jzeroed = jloop._zero_codebook_moments(opt_state, jnp.asarray(replaced), cb_shape)

    ttx = tloop.make_optimizer(learning_rate=1e-3, max_iters=10, warmup_steps=0, opt_8bit=opt_8bit)
    tstate = tloop.TrainState.create(tm.module, ttx)
    tstate, _ = tloop.make_train_step(tm.module, ttx, vq_kmeans_init=False)(tstate, tm.patchnorm, tb)
    cb = tm.module.vq_model.codebook
    before = {k: v.clone() for k, v in tstate.adamw.state[cb].items() if isinstance(v, torch.Tensor)}
    leaves = lambda tree: jax.tree_util.tree_flatten_with_path(tree)[0]  # noqa: E731
    if not opt_8bit:
        (mu,) = [v for p, v in leaves(opt_state) if "codebook" in str(p) and "mu" in str(p)]
        (nu,) = [v for p, v in leaves(opt_state) if "codebook" in str(p) and "nu" in str(p)]
        st = tstate.adamw.state[cb]
        st["exp_avg"].copy_(torch.from_numpy(np.array(mu)))
        st["exp_avg_sq"].copy_(torch.from_numpy(np.array(nu)))
        tloop._zero_codebook_moments(tstate.adamw, cb, torch.from_numpy(replaced))
        (zmu,) = [v for p, v in leaves(jzeroed) if "codebook" in str(p) and "mu" in str(p)]
        (znu,) = [v for p, v in leaves(jzeroed) if "codebook" in str(p) and "nu" in str(p)]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(zmu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), np.asarray(znu))
        assert (np.asarray(zmu)[replaced] == 0).all() and np.abs(np.asarray(zmu)[~replaced]).max() > 0
    else:
        assert not any("codebook" in str(p) and tuple(v.shape) == tuple(cb_shape) for p, v in leaves(opt_state))
        for (p, a), (_, b) in zip(leaves(opt_state), leaves(jzeroed)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
        tloop._zero_codebook_moments(tstate.adamw, cb, torch.from_numpy(replaced))
        after = tstate.adamw.state[cb]
        assert before and all(torch.equal(before[k], after[k]) for k in before)
