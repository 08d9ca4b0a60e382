"""The port's weight tools against the JAX package's, in fp32 on the CPU.

tools/copy_clip_into.py (the CLIP warm start) and
tools/convert_reference_weights.py (the reference-checkpoint converter) read
attributes only, so the same stand-in goes through both packages' tools:
`clip_vision_standin` (CLIP's vision tower from plain torch.nn modules with
HF's names), a random-init `transformers.CLIPVisionModel` written by
save_pretrained for the two `main`s (skipped without `transformers`), and
`reference_standin` (the reference model's attribute layout) for the
converter, whose tests need no `transformers`.

Tolerances:
  * parameters, patchnorm and configs equal, bit for bit;
  * the converted models' token ids on one packed batch equal (JAX runs
    its Pallas attention in interpret mode: in 'bias' mode its XLA path
    gives padded queries a bias that the kernel, and the port, do not);
    decoded patches atol 1e-3, as tests/test_torch_model.py holds them.
"""
import dataclasses
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from torch import nn

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict, state_dict_from_jax_npz
from dct_autoencoder_torch.tools import convert_reference_weights as tcr
from dct_autoencoder_torch.tools import copy_clip_into as tcc
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.models.config import DCTAutoencoderConfig, TransformerConfig
from dct_autoencoder_tpu.tools import convert_reference_weights as jcr
from dct_autoencoder_tpu.tools import copy_clip_into as jcc
from test_torch_model import R3B, packed_batch, to_torch_batch
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

HIDDEN, INTERMEDIATE, HEADS = 64, 128, 4


def jax_config(projections: bool = True) -> DCTAutoencoderConfig:
    """2 + 2 layers, hidden 64, 4 heads, p = 4, 8 x 8 patches (as
    tests/test_reference_parity.py); LFQ 4 x 64 codes (24 bits, projected
    from 64) or 4 x 65536 (64 bits, no projections)."""
    tc = TransformerConfig(hidden_size=HIDDEN, intermediate_size=INTERMEDIATE, num_hidden_layers=2,
                           num_attention_heads=HEADS)
    return DCTAutoencoderConfig(
        patch_size=4, max_patch_h=8, max_patch_w=8, vq_codebook_size=64 if projections else 65536,
        vq_num_codebooks=4, encoder_config=tc, decoder_config=tc,
    )


def port_config(cfg: DCTAutoencoderConfig) -> TorchConfig:
    return TorchConfig.from_dict(cfg.to_dict())


def jax_flat(params) -> dict:
    return {JaxAE._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def port_flat(model: TorchAE) -> dict:
    return jax_arrays_from_state_dict(model.module.state_dict(), model.config)


def assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def port_model_from_jax_init(cfg, device="cpu") -> TorchAE:
    """The port's model holding the initial parameters of JAX's model of the
    same config (seed 0), so that leaves a tool does not touch agree too."""
    model = TorchAE(cfg, device=device)
    jax_init = JaxAE(DCTAutoencoderConfig.from_dict(cfg.to_dict())).params
    model.module.load_state_dict(state_dict_from_jax_npz(jax_flat(jax_init), cfg))
    return model


def assert_same_checkpoint(a: str, b: str) -> None:
    for name in ("params.npz", "patchnorm.npz"):
        with np.load(os.path.join(a, name)) as fa, np.load(os.path.join(b, name)) as fb:
            assert_same_arrays({k: fa[k] for k in fa.files}, {k: fb[k] for k in fb.files})
    with open(os.path.join(a, "config.json")) as fa, open(os.path.join(b, "config.json")) as fb:
        assert json.load(fa) == json.load(fb)


# ------------------------------------------------------------------ CLIP warm start


def test_transplant_matches_jax():
    cfg = jax_config()
    clip = tcc.clip_vision_standin(HIDDEN, INTERMEDIATE, 5, seed=1)
    init = jax_flat(JaxAE(cfg).params)
    want = jax_flat(jcc.transplant(JaxAE(cfg), clip).params)
    tm = port_model_from_jax_init(port_config(cfg))
    got = port_flat(tcc.transplant(tm, clip))
    assert_same_arrays(got, want)
    layer = re.compile(r"^(encoder|decoder)/layers_\d+/")
    for k in init:  # the other leaves are untouched, the layers' all replaced
        assert np.array_equal(got[k], init[k]) == (layer.match(k) is None), k
    # CLIP layers [0, 2) went to the encoder, [2, 4) to the decoder
    src = clip.vision_model.encoder.layers
    assert torch.equal(tm.module.encoder.layers[1].fc1.weight, src[1].mlp.fc1.weight)
    assert torch.equal(tm.module.decoder.layers[0].self_attn.out_proj.bias, src[2].self_attn.out_proj.bias)
    assert torch.equal(tm.module.decoder.layers[1].layer_norm2.weight, src[3].layer_norm2.weight)


@pytest.mark.parametrize("fault", ["too_few_layers", "other_width"])
def test_transplant_refuses_by_name(fault):
    tm = TorchAE(port_config(jax_config()), device="cpu")
    if fault == "too_few_layers":
        clip, match = tcc.clip_vision_standin(HIDDEN, INTERMEDIATE, 3), "CLIP has 3 layers; need 4"
    else:
        clip, match = tcc.clip_vision_standin(HIDDEN, 96, 4), "encoder.layers.0.fc1.weight"
    with pytest.raises(ValueError, match=re.escape(match)):
        tcc.transplant(tm, clip)


def test_main_of_both_tools_write_the_same_checkpoint(tmp_path, monkeypatch):
    transformers = pytest.importorskip("transformers")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        clip = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
            hidden_size=HIDDEN, intermediate_size=INTERMEDIATE, num_hidden_layers=4, num_attention_heads=HEADS,
            image_size=32, patch_size=4,
        ))
    clip.save_pretrained(str(tmp_path / "clip"))
    cfg = jax_config()
    cfg.to_json_file(str(tmp_path / "config.json"))
    jcc.main(str(tmp_path / "config.json"), str(tmp_path / "clip"), str(tmp_path / "jax"))
    # JAX's main builds its model from seed 0; the port's gets the same initial parameters
    monkeypatch.setattr(tcc, "DCTAutoencoder", lambda config, device: port_model_from_jax_init(config, device))
    tcc.main(str(tmp_path / "config.json"), str(tmp_path / "clip"), str(tmp_path / "torch"), device="cpu")
    assert_same_checkpoint(str(tmp_path / "torch"), str(tmp_path / "jax"))
    back = TorchAE.from_pretrained(str(tmp_path / "torch"), device="cpu")
    assert torch.equal(back.module.decoder.layers[1].fc2.weight, clip.vision_model.encoder.layers[3].mlp.fc2.weight)


def test_main_without_transformers_raises_by_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import transformers -> ImportError
    with pytest.raises(SystemExit, match="transformers"):
        tcc.main(device="cpu")


# ------------------------------------------------------------------ reference converter


@pytest.mark.parametrize("projections", [True, False])
def test_convert_matches_jax(projections):
    ref = tcr.reference_standin(port_config(jax_config(projections)), seed=2)
    jm = jcr.convert(ref)
    tm = tcr.convert(ref, device="cpu")
    assert tm.device.type == "cpu" and tm.config.attn_mask_mode == "bias"
    assert_same_arrays(port_flat(tm), jax_flat(jm.params))
    assert ("vq_model/project_in/kernel" in jax_flat(jm.params)) == projections
    for name in ("n", "median", "b"):
        np.testing.assert_array_equal(getattr(tm.patchnorm, name).numpy(), np.asarray(getattr(jm.patchnorm, name)))
    assert tm.config.to_dict() == port_config(jm.config).to_dict()
    assert dataclasses.asdict(jcr.config_from_reference(ref.config)) == dataclasses.asdict(jm.config)


def test_standin_of_a_port_model_converts_back_to_it():
    """`reference_standin(state_dict=...)` (which chip_smoke.py converts at
    r3b's widths) holds a checkpoint's tensors; `convert` gives them back."""
    tm = TorchAE.from_pretrained(R3B, device="cpu")
    ref = tcr.reference_standin(tm.config, state_dict=tm.module.state_dict(), patchnorm=tm.patchnorm)
    back = tcr.convert(ref, device="cpu")
    assert back.config.attn_mask_mode == "bias"
    assert dataclasses.replace(back.config, attn_mask_mode="block").to_dict() == tm.config.to_dict()
    assert_same_arrays(port_flat(back), port_flat(tm))
    for name in ("n", "median", "b"):
        assert torch.equal(getattr(back.patchnorm, name), getattr(tm.patchnorm, name))


def test_converted_models_give_equal_tokens():
    ref = tcr.reference_standin(port_config(jax_config()), seed=3)
    converted = jcr.convert(ref)
    jm = JaxAE(dataclasses.replace(converted.config, attention_impl="pallas"), params=converted.params,
               patchnorm=converted.patchnorm)
    tm = tcr.convert(ref, device="cpu")
    b = packed_batch(jm.config, [(32, 32), (28, 36), (24, 20)], 192)
    nb = jm.normalize_(b)
    jo = jm.forward(nb, training=False)
    tb = tm.normalize_(to_torch_batch(b))
    np.testing.assert_allclose(tb.patches.numpy(), np.asarray(nb.patches), atol=1e-5)
    to = tm.forward(tb)
    valid = ~np.asarray(b.key_pad_mask)
    assert valid.sum() > 100 and (~valid).any()  # padded queries take part in 'bias' mode
    np.testing.assert_array_equal(to["codes"].numpy()[valid], np.asarray(jo["codes"])[valid])
    np.testing.assert_allclose(
        to["dct_patches"].patches.numpy()[valid], np.asarray(jo["dct_patches"].patches)[valid], atol=1e-3
    )


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_convert_refuses_by_name(fault):
    ref = tcr.reference_standin(port_config(jax_config()), seed=4)
    if fault == "missing":
        ref.decoder.layers[1].self_attn.k_proj.bias = None
        match = "unconverted params: ['decoder.layers.1.self_attn.k_proj.bias']"
    elif fault == "extra":
        ref.config.encoder_config.num_hidden_layers = 1
        match = "unexpected params: ['encoder.layers.1."
    else:
        ref.proj_out[1] = nn.Linear(HIDDEN, 15, bias=False)
        match = "proj_out_linear.weight: (16, 64) vs (15, 64)"
    with pytest.raises(ValueError, match=re.escape(match)):
        tcr.convert(ref, device="cpu")
