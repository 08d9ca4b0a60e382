"""The port's weight-only int8 serving form against the JAX package, on the CPU.

`DCTPipeline.from_pretrained` follows the int8 gate's record as JAX does:
docs/calibrated_run_r3b/model's `int8_serving.json` passes, so both packages
serve the committed sibling docs/calibrated_run_r3b/model-int8-wo.

Tolerances: token ids equal; `Int8Dense` against JAX's `Int8Dense` in fp32
atol 1e-5 x the largest output (the same dequantized weights, fp32 sums in
another order), in bf16 one bf16 ulp of the largest output (both sum in fp32
and round once; the port adds the bias rounded to bf16, as its `Dense` does,
where JAX adds it in fp32).
"""
import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.models import quant as tquant
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict, state_dict_from_jax_npz
from dct_autoencoder_torch.models.transformer import Dense
from dct_autoencoder_tpu.models import quant as jquant
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_model_and_processor
from dct_autoencoder_tpu.models.patchnorm import calibrate_patchnorm_batch as jax_calibrate
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from test_model import make_batch, tiny_config
from test_torch_model import R3B, assert_codes_match, jax_pre_sign, to_torch_batch
from test_torch_train import flat

INT8_SIBLING = os.path.join(os.path.dirname(R3B), "model-int8-wo")


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.05, 0.95, size=(3, h, w)).astype(np.float32) for h, w in [(112, 140), (98, 98), (84, 126)]]


def _int8_layers(module) -> int:
    return sum(isinstance(m, tquant.Int8Dense) for m in module.modules())


@pytest.mark.parametrize("prefer_int8", ["auto", "never"])
def test_from_pretrained_gives_jax_token_ids(prefer_int8):
    """The same call in both packages serves the same weights and gives the
    same token ids: the int8 sibling by default, the float model with 'never'."""
    jpipe = JaxPipeline.from_pretrained(R3B, dtype=jnp.float32, prefer_int8=prefer_int8)
    tpipe = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu", prefer_int8=prefer_int8)
    int8 = prefer_int8 == "auto"
    assert jpipe.model.config.encoder_config.quantize_int8 is int8
    assert tpipe.model.config.encoder_config.quantize_int8 is int8
    # 4 + 4 layers of 6 projections each; patch embed and proj_out stay float
    assert _int8_layers(tpipe.model.module) == (48 if int8 else 0)
    ims = _images()
    jpipe.processor.rng, tpipe.processor.rng = random.Random(2), random.Random(2)
    jr, tr = jpipe.encode(ims), tpipe.encode(ims)
    assert sum(len(r["codes"]) for r in tr) > 0
    for a, b in zip(jr, tr):
        assert tuple(a["size"]) == tuple(b["size"])
        ca = {(d["c"], d["h"], d["w"]): d["data"] for d in a["codes"]}
        cb = {(d["c"], d["h"], d["w"]): d["data"] for d in b["codes"]}
        assert ca == cb


def test_int8_sibling_serves_other_codes_than_the_float_model():
    """The repair matters: the two forms disagree on some codes of these images."""
    ims = _images(seed=1)
    codes = []
    for prefer in ("auto", "never"):
        pipe = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu", prefer_int8=prefer)
        pipe.processor.rng = random.Random(3)
        codes.append([d["data"] for r in pipe.encode(ims) for d in r["codes"]])
    assert len(codes[0]) == len(codes[1]) and codes[0] != codes[1]


def test_prefer_int8_always_needs_a_passing_record(capsys):
    pipe = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu", prefer_int8="always")
    assert _int8_layers(pipe.model.module) == 48
    assert "serving int8 form (gated: flip ratio" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="no passing int8 gate record"):
        dt.DCTPipeline.from_pretrained(INT8_SIBLING, dtype=torch.float32, device="cpu", prefer_int8="always")
    with pytest.raises(ValueError, match="prefer_int8"):
        dt.DCTPipeline.from_pretrained(R3B, device="cpu", prefer_int8="sometimes")


def _copy_checkpoint(root, with_sibling: bool) -> str:
    """r3b's float checkpoint (with its gate record) under root/run/model, and
    with `with_sibling` the int8 sibling beside it; returns the model path."""
    run = os.path.join(root, "run")
    shutil.copytree(R3B, os.path.join(run, "model"))
    if with_sibling:
        shutil.copytree(INT8_SIBLING, os.path.join(run, "model-int8-wo"))
    return os.path.join(run, "model")


def test_int8_sibling_is_loaded_from_the_copied_tree(tmp_path, capsys):
    """The record's absolute pointer names the original tree; a copy serves
    the sibling beside it, found by the relative pointer."""
    model = _copy_checkpoint(str(tmp_path), with_sibling=True)
    pipe = dt.DCTPipeline.from_pretrained(model, dtype=torch.float32, device="cpu")
    loaded = capsys.readouterr().out.strip().rsplit(": ", 1)[-1]
    assert os.path.realpath(loaded) == os.path.realpath(os.path.join(tmp_path, "run", "model-int8-wo"))
    assert _int8_layers(pipe.model.module) == 48


def test_int8_pointer_outside_the_copied_tree_is_not_followed(tmp_path):
    """Without a sibling in the copy, the absolute pointer to the original tree
    is refused: 'auto' serves the float model, 'always' raises."""
    model = _copy_checkpoint(str(tmp_path), with_sibling=False)
    pipe = dt.DCTPipeline.from_pretrained(model, dtype=torch.float32, device="cpu")
    assert not pipe.model.config.encoder_config.quantize_int8 and _int8_layers(pipe.model.module) == 0
    with pytest.raises(FileNotFoundError, match="no passing int8 gate record"):
        dt.DCTPipeline.from_pretrained(model, dtype=torch.float32, device="cpu", prefer_int8="always")


def test_int8_dense_dequantizes_once():
    """The dequantized weight is kept in the compute type and made again only
    when the int8 weights or scales change."""
    layer = tquant.Int8Dense(8, 4, dtype=torch.bfloat16)
    with torch.no_grad():
        layer.kernel_q.copy_(torch.arange(32, dtype=torch.int8).reshape(8, 4))
    w = layer.weight()
    assert w.dtype == torch.bfloat16 and w.shape == (4, 8)
    assert layer.weight() is w
    layer(torch.ones(2, 8))
    assert layer.weight() is w
    with torch.no_grad():
        layer.kernel_scale.mul_(2.0)
    w2 = layer.weight()
    assert w2 is not w and torch.equal(w2.float(), 2.0 * w.float())


@pytest.mark.parametrize("group_size", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_matches_jax(group_size, dtype):
    rng = np.random.default_rng(group_size)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32) * 0.1
    b = rng.standard_normal((48,)).astype(np.float32) * 0.01
    q, scale = jquant._quantize_weight(w, group_size)
    params = {"params": {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(scale), "bias": jnp.asarray(b)}}
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jquant.Int8Dense(48, dtype=jdtype, group_size=group_size).apply(params, jnp.asarray(x)), np.float32)
    layer = tquant.Int8Dense(32, 48, dtype=tdtype, group_size=group_size)
    layer.load_state_dict({"kernel_q": torch.from_numpy(q), "kernel_scale": torch.from_numpy(scale), "bias": torch.from_numpy(b)})
    got = layer(torch.from_numpy(x))
    assert got.dtype == tdtype
    top = np.abs(want).max()
    tol = 1e-5 * top if dtype == "float32" else 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0)


def test_dynamic_mode_is_refused_by_name():
    """The 'dynamic' mode is ported now (tests/test_torch_quant.py): a config
    asking for it builds dynamic Int8Dense layers, and a mode that neither
    package has is refused by name."""
    cfg = TorchConfig.from_dict(tiny_config().to_dict())
    cfg.encoder_config.quantize_int8 = True
    cfg.encoder_config.quantize_int8_mode = "dynamic"
    layers = [m for m in TorchAE(cfg, device="cpu").module.modules() if isinstance(m, tquant.Int8Dense)]
    assert len(layers) == 12 and all(m.mode == "dynamic" for m in layers)
    cfg.encoder_config.quantize_int8_mode = "int4"
    with pytest.raises(ValueError, match="int4"):
        TorchAE(cfg, device="cpu")


@pytest.mark.parametrize("bf16_layers,group_size", [((), 0), ((0,), 0), ((1,), 16)])
def test_quantized_model_matches_jax(bf16_layers, group_size):
    """JAX's quantize_model_for_serving, carried into the port: same layers
    kept float, same codes and decoded patches; the reverse map gives back the
    JAX arrays, int8 kernels included."""
    jm, proc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)
    batch = make_batch(proc, np.random.default_rng(4), n_images=4)
    jm.patchnorm, _ = jax_calibrate(jm.patchnorm, batch)
    qm = jquant.quantize_model_for_serving(
        jm, encoder_bf16_layers=bf16_layers, decoder_bf16_layers=bf16_layers, group_size=group_size
    )
    tcfg = TorchConfig.from_dict(qm.config.to_dict())
    tm = TorchAE(tcfg, dtype=torch.float32, device="cpu")
    arrays = flat(qm.params)
    tm.module.load_state_dict(state_dict_from_jax_npz(arrays, tcfg))
    for stack in (tm.module.encoder, tm.module.decoder):
        for i, layer in enumerate(stack.layers):
            assert isinstance(layer.fc1, Dense if i in bf16_layers else tquant.Int8Dense)
    back = jax_arrays_from_state_dict(tm.module.state_dict(), tcfg)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k

    nb = qm.normalize_(batch)
    want = qm.forward(nb)
    with torch.no_grad():
        got = tm.module(to_torch_batch(nb))
    valid = ~np.asarray(nb.key_pad_mask)
    assert_codes_match(got["codes"].numpy(), np.asarray(want["codes"]), jax_pre_sign(qm, nb), tm.module.vq_model.codebook_dim, valid)
    np.testing.assert_allclose(
        got["dct_patches"].patches.detach().numpy()[valid], np.asarray(want["dct_patches"].patches)[valid], atol=2e-4
    )
