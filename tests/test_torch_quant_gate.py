"""The port's int8 gate (tools/quantize_checkpoint.py) and its noise floor
(tools/int8_study.py) against the JAX package, on the CPU.

A tiny JAX model made from a seed (tests/test_torch_quant.py) is saved as a
checkpoint; both packages' tools gate copies of it on the same seeded
validation images.

Tolerances: records with JAX's keys and the same verdict, agreement and flip
counts equal, PSNR within 1e-3 dB; ``_noise_equiv_model``'s perturbed
kernels bit-identical to JAX's for the same seed.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
from dct_autoencoder_torch.tools import int8_study as tstudy
from dct_autoencoder_torch.tools import quantize_checkpoint as tqc
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from dct_autoencoder_tpu.tools import int8_study as jstudy
from dct_autoencoder_tpu.tools import quantize_checkpoint as jqc
from test_torch_quant import _jax_model
from test_torch_train import flat


def test_noise_equiv_model_matches_jax(tmp_path):
    """The same seed perturbs the same kernels by the same amounts: the port
    walks the tree in the order of JAX's loaded checkpoint (11 layers, so
    layers_10 sorts before layers_2), skipping the same layers."""
    jm, _ = _jax_model(layers=11)
    path = str(tmp_path / "model")
    jm.save_pretrained(path)
    jl = JaxAE.from_pretrained(path)
    tm = TorchAE.from_pretrained(path, device="cpu")
    for seed, skip in ((1, ()), (2, (0, 1))):
        want = flat(jstudy._noise_equiv_model(jl, seed, skip_layers=skip).params)
        noisy = tstudy._noise_equiv_model(tm, seed, skip_layers=skip)
        got = jax_arrays_from_state_dict(noisy.module.state_dict(), noisy.config)
        base = flat(jl.params)
        changed = [k for k in want if not np.array_equal(want[k], base[k])]
        assert len(changed) == 2 * 6 * (11 - len(skip))  # every kernel of the unskipped layers
        for k, v in want.items():
            assert np.array_equal(got[k], v), k
        assert noisy.patchnorm is tm.patchnorm


def _validation_dirs(root, rng):
    """Three seeded 64 x 64 PNGs (the JAX tool reads only image files and
    resizes them to 448) and the same images after that resize as .npy."""
    png, npy = os.path.join(root, "png"), os.path.join(root, "npy")
    os.makedirs(png)
    os.makedirs(npy)
    for i in range(3):
        arr = (rng.uniform(0.1, 0.9, (64, 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(png, f"{i}.png"))
        resized = Image.fromarray(arr).resize((448, 448), Image.BICUBIC)
        np.save(os.path.join(npy, f"{i}.npy"), np.asarray(resized, np.float32).transpose(2, 0, 1) / 255.0)
    return png, npy


GATES = [
    dict(gate_mode="absolute"),
    dict(gate_mode="relative", gate_noise_seeds=2),
]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g["gate_mode"])
def test_quantize_checkpoint_gate_matches_jax(gate, tmp_path):
    """Both tools, run on copies of one checkpoint with the same images,
    write records with the same keys, the same verdict and the same counts;
    the port reads the images as PNG or as .npy alike."""
    jm, _ = _jax_model(seed=5)
    rng = np.random.default_rng(5)
    png, npy = _validation_dirs(str(tmp_path), rng)
    records = {}
    runs = [("jax", jqc.main, png), ("port_npy", tqc.main, npy)]
    if gate["gate_mode"] == "absolute":
        runs.append(("port_png", tqc.main, png))
    for name, tool, images in runs:
        src = str(tmp_path / name / "model")
        jm.save_pretrained(src)
        kw = dict(validate_images=images, gate=True, **gate)
        if tool is tqc.main:
            kw["device"] = "cpu"
        tool(src, str(tmp_path / name / "model-int8"), **kw)
        with open(os.path.join(src, "int8_serving.json")) as f:
            records[name] = json.load(f)
        with open(os.path.join(tmp_path, name, "model-int8", "int8_gate.json")) as f:
            assert json.load(f) == records[name]
    want = records["jax"]
    assert want["mode"] == "dynamic" and want["bf16_layers"] == [0, 1]
    for name in records.keys() - {"jax"}:
        got = records[name]
        assert set(got) == set(want), name
        assert got["int8_model_rel"] == want["int8_model_rel"] == os.path.join("..", "model-int8")
        for k, v in want.items():
            if k in ("source_model", "int8_model"):
                continue
            if k.startswith("psnr_") and k != "psnr_tolerance" and k != "psnr_ok":
                assert abs(got[k] - v) <= 1e-3, (name, k, got[k], v)
            else:
                assert got[k] == v, (name, k, got[k], v)


def test_gate_verdict_decides_what_from_pretrained_serves(tmp_path):
    """A passing record flips the port's from_pretrained to the int8 form; a
    failing one keeps the float model, and prefer_int8='always' then raises."""
    jm, _ = _jax_model(seed=5)
    png, _ = _validation_dirs(str(tmp_path), np.random.default_rng(6))
    src, q8 = str(tmp_path / "model"), str(tmp_path / "model-int8")
    jm.save_pretrained(src)
    tqc.main(src, q8, validate_images=png, gate=True, gate_threshold=0.0, device="cpu")
    pipe = dt.DCTPipeline.from_pretrained(src, dtype=torch.float32, device="cpu")
    assert pipe.model.config.encoder_config.quantize_int8
    assert pipe.model.config.encoder_config.quantize_int8_mode == "dynamic"
    assert not dt.DCTPipeline.from_pretrained(src, dtype=torch.float32, device="cpu", prefer_int8="never").model.config.encoder_config.quantize_int8
    tqc.main(src, q8, validate_images=png, gate=True, gate_threshold=1.01, device="cpu")
    assert not dt.DCTPipeline.from_pretrained(src, dtype=torch.float32, device="cpu").model.config.encoder_config.quantize_int8
    with pytest.raises(FileNotFoundError, match="no passing int8 gate record"):
        dt.DCTPipeline.from_pretrained(src, dtype=torch.float32, device="cpu", prefer_int8="always")
    # the JAX package reads the port's record the same way
    assert not JaxPipeline.from_pretrained(src, dtype=jnp.float32).model.config.encoder_config.quantize_int8


def test_quantize_checkpoint_cli_flags(tmp_path):
    """The command line takes the JAX tool's flags and defaults."""
    args = tqc.parse_args(["--model_path", "m", "--out_path", "o"])
    assert (args.validate_images, args.group_size, args.mode, args.bf16_layers, args.gate) == ("", 0, None, "", False)
    assert (args.gate_threshold, args.gate_mode, args.flip_ratio_max, args.psnr_tolerance, args.gate_noise_seeds) == (
        0.999, "absolute", 1.25, 0.05, 2
    )
    jm, _ = _jax_model()
    src = str(tmp_path / "model")
    jm.save_pretrained(src)
    tqc.cli(["--model_path", src, "--out_path", str(tmp_path / "q"), "--mode", "weight_only", "--device", "cpu"])
    loaded = TorchAE.from_pretrained(str(tmp_path / "q"), device="cpu")
    assert loaded.config.encoder_config.quantize_int8_mode == "weight_only"
    assert loaded.config.decoder_config.quantize_int8
