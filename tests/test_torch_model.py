"""The port's model against the JAX DCTAutoencoder, in fp32 on the CPU.

Fixtures: the trained checkpoint docs/calibrated_run_r3b/model (LFQ 8x1024
with projections, 4+4 layers, hidden 256, head dim 32, 'block' mask), loaded
into the port through models/convert.py, and a tiny random model in 'bias'
mode without LFQ projections whose JAX parameters are converted the same way.
The tiny model runs JAX's Pallas attention (interpret mode): in 'bias' mode
JAX's XLA attention gives padded queries a +1 bias on image-0 keys where the
kernel gives them none, and since padded keys take part in every softmax in
that mode, the two JAX paths differ from the second layer on.  The port
follows the kernel.
Packed batches are built by the JAX extractor from seeded numpy images and
handed to both models.

Tolerances:
  * codes exactly equal.  Should a bit ever flip, only bits whose JAX
    pre-sign value lies within 1e-4 of 0 may differ (fp32 sums in another
    order move the pre-sign values by a few 1e-6);
  * decoded patches atol 1e-3;
  * decode_from_codes on identical codes atol 1e-4.
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
from dct_autoencoder_torch.models.convert import expected_shapes, state_dict_from_jax_npz
from dct_autoencoder_torch.patches.container import DCTPatches as TorchPatches
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.models.config import DCTAutoencoderConfig, TransformerConfig
from dct_autoencoder_tpu.patches.extractor import DCTAutoencoderFeatureExtractor

R3B = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "calibrated_run_r3b", "model")
PRE_SIGN_SLACK = 1e-4


def to_torch_batch(b) -> TorchPatches:
    """A JAX DCTPatches batch as the port's DCTPatches (CPU tensors)."""
    t = lambda a: torch.from_numpy(np.array(a))
    return TorchPatches(
        patches=t(b.patches),
        key_pad_mask=t(b.key_pad_mask),
        batched_image_ids=t(b.batched_image_ids),
        patch_channels=t(b.patch_channels),
        patch_positions=t(b.patch_positions),
        patch_sizes=b.patch_sizes,
        original_sizes=b.original_sizes,
    )


def packed_batch(cfg, sizes, max_seq_len, seed=0, beta=0.0):
    """Seeded images -> JAX-extracted, JAX-packed batch."""
    proc = DCTAutoencoderFeatureExtractor(
        channels=3, patch_size=cfg.patch_size, sample_patches_beta=beta,
        max_patch_h=cfg.max_patch_h, max_patch_w=cfg.max_patch_w,
        max_seq_len=max_seq_len, rng=random.Random(seed),
    )
    rng = np.random.default_rng(seed)
    ims = [rng.uniform(0.05, 0.95, size=(3, h, w)).astype(np.float32) for h, w in sizes]
    ds = [proc.preprocess(im) for im in ims]
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    return next(proc.iter_batches(iter([cols]), batch_size=None))


def jax_pre_sign(jm, nb) -> np.ndarray:
    """The JAX model's LFQ input before the sign, (b, s, codebook_dims)."""
    _, st = jm.module.apply(
        {"params": jm.params, "vq_stats": jm.vq_stats}, nb, training=False,
        method="encode", capture_intermediates=True,
    )
    inter = st["intermediates"]
    if "project_in" in inter["vq_model"]:
        return np.asarray(inter["vq_model"]["project_in"]["__call__"][0])
    return np.asarray(inter["encoder"]["__call__"][0])


def assert_codes_match(got, want, pre, codebook_dim, valid, slack=PRE_SIGN_SLACK):
    """Codes equal; a flipped bit is allowed only where |pre-sign| <= slack."""
    if np.array_equal(got[valid], want[valid]):
        return
    shifts = np.arange(codebook_dim - 1, -1, -1)
    bits = lambda c: (c[..., None] >> shifts) & 1
    flipped = (bits(got) != bits(want))[valid].reshape(-1)
    near_zero = np.abs(pre.reshape(*got.shape, codebook_dim))[valid].reshape(-1) <= slack
    assert (near_zero | ~flipped).all(), "a bit flipped whose pre-sign value is far from 0"


def tiny_bias_config() -> DCTAutoencoderConfig:
    tc = TransformerConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2)
    return DCTAutoencoderConfig(
        patch_size=8, max_patch_h=8, max_patch_w=8, vq_codebook_size=256, vq_num_codebooks=8,
        encoder_config=tc, decoder_config=tc, attn_mask_mode="bias", attention_impl="pallas",
    )


@pytest.fixture(scope="module")
def r3b_models():
    jm = JaxAE.from_pretrained(R3B, dtype=jnp.float32)
    tm = TorchAE.from_pretrained(R3B, dtype=torch.float32, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def tiny_models():
    cfg = tiny_bias_config()
    jm = JaxAE(cfg, dtype=jnp.float32, seed=3)
    flat = {JaxAE._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    tcfg = TorchConfig.from_dict(cfg.to_dict())
    tm = TorchAE(tcfg, dtype=torch.float32, device="cpu")
    tm.module.load_state_dict(state_dict_from_jax_npz(flat, tcfg))
    return jm, tm


def test_converter_consumes_every_r3b_key():
    cfg = TorchConfig.from_json_file(os.path.join(R3B, "config.json"))
    with np.load(os.path.join(R3B, "params.npz")) as f:
        n_keys = len(f.files)
    sd = state_dict_from_jax_npz(os.path.join(R3B, "params.npz"), cfg)
    assert len(sd) == n_keys == len(expected_shapes(cfg))
    TorchAE(cfg, device="cpu").module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("fault", ["extra_key", "missing_key", "bad_shape"])
def test_converter_refuses_mismatch(fault):
    cfg = TorchConfig.from_json_file(os.path.join(R3B, "config.json"))
    with np.load(os.path.join(R3B, "params.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    if fault == "extra_key":
        arrays["encoder/layers_9/fc1/kernel"] = arrays["encoder/layers_0/fc1/kernel"]
    elif fault == "missing_key":
        del arrays["decoder/layers_3/layer_norm2/scale"]
    else:
        arrays["proj_out_linear/kernel"] = arrays["proj_out_linear/kernel"][:, :-1]
    with pytest.raises((KeyError, ValueError)):
        state_dict_from_jax_npz(arrays, cfg)


def _forward_both(jm, tm, b):
    nb = jm.normalize_(b)
    jo = jm.forward(nb, training=False)
    tb = tm.normalize_(to_torch_batch(b))
    np.testing.assert_allclose(tb.patches.numpy(), np.asarray(nb.patches), atol=1e-5)
    to = tm.forward(tb)
    return nb, jo, tb, to


@pytest.mark.parametrize("which", ["r3b", "tiny_bias"])
def test_model_matches_jax(which, request):
    if which == "r3b":
        jm, tm = request.getfixturevalue("r3b_models")
        b = packed_batch(jm.config, [(56, 70), (84, 84), (70, 98), (112, 56), (60, 75)], 256, beta=0.02)
    else:
        jm, tm = request.getfixturevalue("tiny_models")
        b = packed_batch(jm.config, [(32, 40), (48, 48), (24, 64), (40, 40)], 96)
    nb, jo, tb, to = _forward_both(jm, tm, b)
    valid = ~np.asarray(b.key_pad_mask)
    assert_codes_match(
        to["codes"].numpy(), np.asarray(jo["codes"]), jax_pre_sign(jm, nb),
        tm.module.vq_model.codebook_dim, valid,
    )
    np.testing.assert_allclose(
        to["dct_patches"].patches.numpy()[valid], np.asarray(jo["dct_patches"].patches)[valid], atol=1e-3
    )


def test_decode_from_codes_matches_jax(r3b_models):
    jm, tm = r3b_models
    b = packed_batch(jm.config, [(70, 70), (98, 84), (56, 112)], 256, seed=1, beta=0.02)
    codes = np.array(jm.forward(jm.normalize_(b), training=False)["codes"])
    meta = dict(
        key_pad_mask=b.key_pad_mask, batched_image_ids=b.batched_image_ids,
        patch_channels=b.patch_channels, patch_positions=b.patch_positions,
    )
    want = np.asarray(jm.decode_from_codes(jnp.asarray(codes), attn_mask=None, **meta).patches)
    tb = to_torch_batch(b)
    got = tm.decode_from_codes(
        torch.from_numpy(codes), key_pad_mask=tb.key_pad_mask, batched_image_ids=tb.batched_image_ids,
        patch_channels=tb.patch_channels, patch_positions=tb.patch_positions,
    ).patches.numpy()
    valid = ~np.asarray(b.key_pad_mask)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4)


def test_lfq_indices_roundtrip(r3b_models):
    """indices_to_codes(ids) re-quantizes to the same ids (MSB-first, strict sign)."""
    _, tm = r3b_models
    lfq = tm.module.vq_model
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 1024, size=(2, 5, 8)))
    bits = lfq.indices_to_codes(ids, project_out=False)
    back = ((bits.reshape(2, 5, 8, 10) > 0).long() * lfq.bit_mask).sum(-1)
    assert torch.equal(back, ids)
