"""The port's int8 serving (both modes, the quantizer, int8 checkpoints) against the JAX package, on the CPU.

Weights are made by the JAX package from a seed (tests/test_model.py's
tiny_config widths) and carried into the port through models/convert.py;
images are made with numpy from a seed.

Tolerances:
  * ``_quantize_weight``: kernel_q and kernel_scale bit-identical;
  * ``Int8Dense(mode="dynamic")``: 1e-6 x the largest output in fp32 (the
    int32 sums are exact on both sides and the scales are applied in the same
    order; with groups the sum across groups may run in another order); in
    bf16 one bf16 ulp of the largest output (both round the same fp32 value
    once, which may sit on either side of a rounding boundary);
  * ``quantize_model_for_serving`` (weight_only, dynamic, bf16 layers, group
    size): the int8 arrays bit-identical; the token ids equal, except that a
    bit may flip where JAX's LFQ input before the sign lies within a slack of
    0: 1e-4 in weight_only (tests/test_torch_model.py: fp32 sums in another
    order) and 1e-2 in dynamic, where such an ulp-level difference in a
    layer's input can move one activation to the next int8 step and the
    layer's output by x_scale * |w|, ~1e-3 (the first seed hit one bit at a
    pre-sign value of -9.0e-4 in the group case; the layer alone is bit-equal
    to JAX's on equal inputs, test_int8_dense_dynamic_matches_jax);
  * a checkpoint the port saves in int8 form: the JAX package loads every
    array of it, and its token ids equal those of JAX's own int8 model.

The gate tool and its noise floor are in tests/test_torch_quant_gate.py.
"""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models import quant as tquant
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
from dct_autoencoder_tpu.models import quant as jquant
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_model_and_processor
from dct_autoencoder_tpu.models.patchnorm import calibrate_patchnorm_batch as jax_calibrate
from test_model import make_batch, tiny_config
from test_torch_model import PRE_SIGN_SLACK, assert_codes_match, jax_pre_sign, to_torch_batch
from test_torch_train import flat, port_of


def _config(layers=2):
    cfg = tiny_config("lfq")
    for stack in (cfg.encoder_config, cfg.decoder_config):
        stack.num_hidden_layers = layers
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(layers=2, seed=4):
    """A calibrated random JAX model and a packed batch of 4 seeded 32 x 32 images
    (shared by the tests, none of which changes it)."""
    jm, proc = jax_model_and_processor(_config(layers), sample_patches_beta=0.0)
    batch = make_batch(proc, np.random.default_rng(seed), n_images=4)
    jm.patchnorm, _ = jax_calibrate(jm.patchnorm, batch)
    return jm, batch


DYNAMIC_PRE_SIGN_SLACK = 1e-2


def _port_codes(tm, nb) -> np.ndarray:
    with torch.no_grad():
        return tm.module(to_torch_batch(nb))["codes"].numpy()


def _assert_ids_match(tq, jq, nb, codes):
    """The port's int8 model's ids against JAX's int8 model's on the same batch (see the slacks above)."""
    mode = tq.config.encoder_config.quantize_int8_mode
    slack = DYNAMIC_PRE_SIGN_SLACK if mode == "dynamic" else PRE_SIGN_SLACK
    want = np.asarray(jq.forward(nb, training=False)["codes"])
    valid = ~np.asarray(nb.key_pad_mask)
    if not np.array_equal(codes[valid], want[valid]):
        assert_codes_match(codes, want, jax_pre_sign(jq, nb), tq.module.vq_model.codebook_dim, valid, slack)


@pytest.mark.parametrize("group_size", [0, 32])
def test_quantize_weight_is_bit_identical(group_size):
    rng = np.random.default_rng(group_size)
    w = rng.standard_normal((64, 96)).astype(np.float32) * 0.05
    w[:, 7] = 0.0  # an all-zero channel takes scale 1, as in JAX
    q_t, s_t = tquant._quantize_weight(w, group_size)
    q_j, s_j = jquant._quantize_weight(w, group_size)
    assert q_t.dtype == np.int8 and s_t.dtype == np.float32
    assert q_t.shape == (64, 96) and s_t.shape == ((64 // group_size, 96) if group_size else (96,))
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(s_t, s_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group_size", [0, 32])
def test_int8_dense_dynamic_matches_jax(group_size, dtype):
    rng = np.random.default_rng(7 + group_size)
    x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    x[0, 3] = 0.0  # a zero token: its scale is 1e-8 / 127 on both sides
    w = rng.standard_normal((64, 48)).astype(np.float32) * 0.1
    b = rng.standard_normal((48,)).astype(np.float32) * 0.01
    q, scale = jquant._quantize_weight(w, group_size)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    params = {"params": {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(scale), "bias": jnp.asarray(b)}}
    jx = jnp.asarray(x).astype(jdtype)
    want = np.asarray(
        jquant.Int8Dense(48, dtype=jdtype, mode="dynamic", group_size=group_size).apply(params, jx), np.float32
    )
    layer = tquant.Int8Dense(64, 48, dtype=tdtype, group_size=group_size, mode="dynamic")
    layer.load_state_dict({"kernel_q": torch.from_numpy(q), "kernel_scale": torch.from_numpy(scale), "bias": torch.from_numpy(b)})
    calls = tquant.INT_MM_CALLS
    got = layer(torch.from_numpy(x).to(tdtype))
    assert tquant.INT_MM_CALLS - calls == (64 // group_size if group_size else 1)  # one int8 product a group
    assert got.dtype == tdtype and got.shape == (3, 20, 48)
    top = np.abs(want).max()
    tol = 1e-6 * top if dtype == "float32" else 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=tol, rtol=0)


def test_int8_matmul_is_exact():
    """The int8 product the dynamic mode runs: exact int32 sums of any shape
    (the card's shape rules are met by zero padding, which adds nothing)."""
    g = torch.Generator().manual_seed(0)
    for m, k, n in [(5, 24, 7), (40, 64, 48), (1, 3, 1)]:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        got = tquant.int8_matmul(a, b.t().contiguous())
        assert got.dtype == torch.int32 and torch.equal(got, a.int() @ b.int())


CASES = [
    dict(mode="weight_only", layers=2),
    dict(mode="dynamic", layers=2),
    dict(mode="dynamic", layers=3, bf16_layers=(0, 1)),
    dict(mode="dynamic", layers=2, group_size=16),
    dict(mode="weight_only", layers=2, group_size=16),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_quantize_model_for_serving_matches_jax(case):
    """The port quantizes its own float weights into the same int8 arrays as
    JAX's quantize_model_for_serving, and its int8 model gives the same token ids."""
    jm, batch = _jax_model(case["layers"])
    tm = port_of(jm)
    kw = dict(
        mode=case["mode"], encoder_bf16_layers=case.get("bf16_layers", ()),
        decoder_bf16_layers=case.get("bf16_layers", ()), group_size=case.get("group_size", 0),
    )
    jq = jquant.quantize_model_for_serving(jm, **kw)
    tq = tquant.quantize_model_for_serving(tm, **kw)
    assert tq.config.to_dict() == TorchConfig.from_dict(jq.config.to_dict()).to_dict()
    want = flat(jq.params)
    got = jax_arrays_from_state_dict(tq.module.state_dict(), tq.config)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    n_int8 = sum(isinstance(m, tquant.Int8Dense) for m in tq.module.modules())
    assert n_int8 == 2 * 6 * (case["layers"] - len(case.get("bf16_layers", ())))
    assert all(m.mode == case["mode"] for m in tq.module.modules() if isinstance(m, tquant.Int8Dense))
    nb = jq.normalize_(batch)
    calls = tquant.INT_MM_CALLS
    got_codes = _port_codes(tq, nb)
    assert (tquant.INT_MM_CALLS > calls) == (case["mode"] == "dynamic")
    _assert_ids_match(tq, jq, nb, got_codes)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_port_saved_int8_checkpoint_loads_in_jax(mode, tmp_path):
    """A checkpoint the port writes in int8 form is the JAX package's: every
    array loads into JAX's int8 model, whose token ids are those of JAX's own
    quantize_model_for_serving."""
    jm, batch = _jax_model()
    kw = dict(mode=mode, group_size=16 if mode == "dynamic" else 0)
    tq = tquant.quantize_model_for_serving(port_of(jm), **kw)
    jq = jquant.quantize_model_for_serving(jm, **kw)
    path = str(tmp_path / "model-int8")
    tq.save_pretrained(path)
    loaded = JaxAE.from_pretrained(path)
    assert loaded.config.encoder_config.quantize_int8 and loaded.config.encoder_config.quantize_int8_mode == mode
    saved = dict(np.load(os.path.join(path, "params.npz")))
    got = flat(loaded.params)
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert np.array_equal(got[k], v) and np.asarray(got[k]).dtype == v.dtype, k
    nb = loaded.normalize_(batch)
    np.testing.assert_array_equal(
        np.asarray(loaded.forward(nb, training=False)["codes"]), np.asarray(jq.forward(nb, training=False)["codes"])
    )
    _assert_ids_match(tq, loaded, nb, _port_codes(tq, nb))
