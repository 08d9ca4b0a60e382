"""Attention dropout in the port against the JAX package, in fp32 on the CPU.

The port's kernels draw the keep bits from a Philox4x32-10 stream keyed by a
seed (csrc/attn_dropout.cuh); ``attention_dropout_keep_mask`` is that stream
in plain PyTorch, and the plain versions, which the CPU runs, use it.  JAX
drops the softmax weights with flax's ``nn.Dropout`` on its XLA attention
path, which calls ``jax.random.bernoulli`` once a layer, in order.  To feed
both one mask, these tests hand JAX the port's masks by patching
``jax.random.bernoulli`` (inside the test only) to return them in turn.

Tolerances: the stream equals the Random123 known-answer vectors and a
Python-integer Philox exactly; the kept share of 10^6 draws lies within 4
sigma of 1 - rate; forward outputs atol 1e-5, gradients atol 1e-4 x that
tensor's largest entry in JAX plus 1e-6 x the largest entry of any tensor
(fp32 sums in another order; the gradient of a key bias is 0 in exact
arithmetic, so both packages hold only rounding noise there).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from dct_autoencoder_torch.kernels import attention as tatt
from dct_autoencoder_torch.models import ar as tar
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.config import TransformerConfig as TorchTransformerConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict, state_dict_from_jax_npz
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_tpu.models import ar as jar
from dct_autoencoder_tpu.models.config import TransformerConfig as JaxTransformerConfig
from dct_autoencoder_tpu.models.transformer import AttentionContext
from test_model import tiny_config
from test_torch_ar import _GRID, _TRANSFORMER, make_data, packed_ids
from test_torch_ar import flat as ar_flat
from test_torch_kernels import _t, make_inputs
from test_torch_train import flat, make_case, port_of, to_torch_batch

U32 = 0xFFFFFFFF


def philox_ints(counter, key):
    """Philox4x32-10 in Python integers: the reference for the tensor twin."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & U32, (p0 >> 32) ^ c[3] ^ k[1], p0 & U32]
        k = [(k[0] + 0x9E3779B9) & U32, (k[1] + 0xBB67AE85) & U32]
    return c


# ---------------------------------------------------------------- the stream


@pytest.mark.parametrize(
    "counter,key,want",
    [  # Random123's kat_vectors for philox4x32-10
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((U32, U32, U32, U32), (U32, U32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_twin_gives_the_known_answers(counter, key, want):
    got = tatt.philox4x32_10([torch.tensor([c]) for c in counter], [torch.tensor([k]) for k in key])
    assert tuple(int(w) for w in got) == want
    assert tuple(philox_ints(counter, key)) == want


def test_philox_twin_equals_python_integers():
    rng = np.random.default_rng(0)
    counters = rng.integers(0, 2**32, (64, 4), dtype=np.uint64).astype(np.int64)
    keys = rng.integers(0, 2**32, (64, 2), dtype=np.uint64).astype(np.int64)
    got = tatt.philox4x32_10([torch.from_numpy(counters[:, i]) for i in range(4)],
                             [torch.from_numpy(keys[:, i]) for i in range(2)])
    got = torch.stack(got, dim=1).numpy()
    want = np.array([philox_ints(c.tolist(), k.tolist()) for c, k in zip(counters, keys)], dtype=np.int64)
    np.testing.assert_array_equal(got, want)


def test_keep_mask_is_the_documented_function_of_the_stream():
    """Pair (q, k) takes word (q >> 3 & 1) * 2 + (k >> 3 & 1) of the counter
    (row0 + r, head0 + j, g(q), g(k)), g(i) = (i >> 4) * 8 + (i & 7)."""
    seed, rate, b, h, s, row0, head0 = (7 << 40) + 12345, 0.3, 2, 2, 37, 5, 9
    mask = tatt.attention_dropout_keep_mask(seed, rate, b, h, s, row0, head0)
    threshold = round(rate * 2**32)
    g = lambda i: (i >> 4) * 8 + (i & 7)
    rng = np.random.default_rng(1)
    for r, j, q, k in rng.integers(0, [b, h, s, s], (200, 4)):
        words = philox_ints((row0 + int(r), head0 + int(j), g(int(q)), g(int(k))), (seed & U32, seed >> 32))
        assert bool(mask[r, j, q, k]) == (words[((q >> 3) & 1) * 2 + ((k >> 3) & 1)] >= threshold)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_mask_reproduces_itself_and_keeps_one_minus_rate(rate):
    seed = torch.tensor([123456789], dtype=torch.int64)
    mask = tatt.attention_dropout_keep_mask(seed, rate, 1, 16, 256)  # 2^20 draws
    assert torch.equal(mask, tatt.attention_dropout_keep_mask(seed, rate, 1, 16, 256))
    assert not torch.equal(mask, tatt.attention_dropout_keep_mask(seed + 1, rate, 1, 16, 256))
    share, n = mask.float().mean().item(), mask.numel()
    assert abs(share - (1 - rate)) <= 4 * math.sqrt(rate * (1 - rate) / n)


def test_keep_mask_blocks_follow_rows_heads_and_positions():
    """A rank's rows and heads (row0, head0) draw their block of the whole
    batch's mask, and a shorter sequence the leading block of a longer one."""
    whole = tatt.attention_dropout_keep_mask(99, 0.2, 4, 6, 70)
    assert torch.equal(tatt.attention_dropout_keep_mask(99, 0.2, 2, 3, 70, row0=2, head0=3), whole[2:, 3:])
    assert torch.equal(tatt.attention_dropout_keep_mask(99, 0.2, 4, 6, 33), whole[:, :, :33, :33])


def test_rate_and_seed_are_checked():
    seed = torch.tensor([1], dtype=torch.int64)
    with pytest.raises(ValueError, match="rate"):
        tatt.AttentionDropout(1.0, seed)
    with pytest.raises(ValueError, match="seed"):
        tatt.AttentionDropout(0.1, seed.int())
    q = torch.zeros(1, 1, 4, 16)
    ids = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="seed"):
        tatt.packed_flash_attention(q, q, q, ids, ids.bool(), 1.0, dropout_rate=0.1)


# ---------------------------------------------------------------- against JAX


class FeedMasks:
    """jax.random.bernoulli that returns the given masks in turn (what flax's
    nn.Dropout draws once a layer), checking each call's shape and keep
    probability."""

    def __init__(self, masks, keep_prob):
        self.masks, self.keep_prob, self.calls = list(masks), keep_prob, 0

    def __call__(self, key, p=0.5, shape=None):
        mask = self.masks[self.calls]
        self.calls += 1
        assert tuple(shape) == tuple(mask.shape) and abs(float(p) - self.keep_prob) < 1e-12
        return jnp.asarray(mask.numpy())


def seeds_of(generator_seed: int, n: int):
    """The seeds n layers draw, in order, from a CPU generator seeded so."""
    g = torch.Generator().manual_seed(generator_seed)
    return [tatt.draw_dropout_seed(g, "cpu") for _ in range(n)]


def assert_grads_close(got: dict, want: dict, rel=1e-4):
    top = max(np.abs(w).max() for w in want.values())
    assert sorted(got) == sorted(want)
    for name in want:
        atol = rel * np.abs(want[name]).max() + 1e-6 * top
        np.testing.assert_allclose(got[name], want[name], atol=atol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_one_attention_call_matches_jax_xla_dropout(monkeypatch, causal):
    """JAX's XLA attention (einsum, the packing bias, softmax, nn.Dropout,
    einsum) against packed_flash_attention with the same mask: o on valid
    queries and the gradients of sum(o^2) over them."""
    rate, b, h, s, d = 0.3, 2, 3, 40, 16
    q, k, v, ids, pad = make_inputs(b=b, h=h, s=s, d=d, seed=5)
    scale = d**-0.5
    seed = torch.tensor([987654321], dtype=torch.int64)
    mask = tatt.attention_dropout_keep_mask(seed, rate, b, h, s)
    valid = jnp.asarray(~pad)[:, None, :, None]
    ctx = AttentionContext(jnp.asarray(ids), jnp.asarray(pad), causal=causal)
    feed = FeedMasks([mask], 1 - rate)
    monkeypatch.setattr(jax.random, "bernoulli", feed)

    def jax_loss(q, k, v):
        logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale + ctx.xla_bias()
        weights = jax.nn.softmax(logits, axis=-1)
        weights = nn.Dropout(rate).apply({}, weights, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        o = jnp.einsum("bhqk,bhkd->bhqd", weights, v)
        return jnp.sum(jnp.where(valid, o, 0.0) ** 2), o

    (_, o_jax), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    assert feed.calls == 1

    tq, tk_, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    o = tatt.packed_flash_attention(tq, tk_, tv, *_t(ids, pad), scale, causal=causal, dropout_rate=rate, seed=seed)
    (o[torch.from_numpy(~pad)[:, None, :, None].expand_as(o)] ** 2).sum().backward()
    keep = np.broadcast_to(~pad[:, None, :, None], o.shape)
    np.testing.assert_allclose(o.detach().numpy()[keep], np.asarray(o_jax)[keep], atol=1e-5)
    assert_grads_close({"q": tq.grad.numpy(), "k": tk_.grad.numpy(), "v": tv.grad.numpy()},
                       {"q": np.asarray(grads[0]), "k": np.asarray(grads[1]), "v": np.asarray(grads[2])})
    # the rate takes effect: without dropout o moves
    o_plain = tatt.packed_flash_attention(*_t(q, k, v, ids, pad), scale, causal=causal)
    assert (o_plain - o.detach()).abs().max().item() > 0.1


def test_autoencoder_training_forward_matches_jax(monkeypatch):
    """The tiny autoencoder (tests/test_model.py::tiny_config, JAX's XLA
    attention, 'block' mode) with attention dropout 0.3 and MLP dropout 0:
    codes, the training forward's patches and the gradients of the sum of
    their squares, one mask a layer of the encoder fed to both; the decoder
    never drops."""
    rate = 0.3
    jm, batch = make_case("tiny_block")
    jm.config.encoder_config.attention_dropout = rate
    jm.config.attention_impl = "xla"
    jm.module = type(jm.module)(jm.config, dtype=jnp.float32)
    tm = port_of(jm)
    assert tm.config.encoder_config.attention_dropout == rate
    tb = to_torch_batch(batch)
    nb_t = tm.normalize_(tb)
    b, s = tb.patches.shape[:2]
    h, n_layers = jm.config.encoder_config.num_attention_heads, jm.config.encoder_config.num_hidden_layers
    masks = [tatt.attention_dropout_keep_mask(sd, rate, b, h, s) for sd in seeds_of(3, n_layers)]
    feed = FeedMasks(masks, 1 - rate)
    monkeypatch.setattr(jax.random, "bernoulli", feed)
    nb = jm.normalize_(batch)
    valid = ~np.asarray(batch.key_pad_mask)

    def jax_loss(params):
        out = jm.module.apply({"params": params}, nb, training=True, rngs={"dropout": jax.random.PRNGKey(0)})
        rec = out["dct_patches"].patches
        return jnp.sum(jnp.where(jnp.asarray(valid)[..., None], rec, 0.0) ** 2), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jm.params)
    assert feed.calls == n_layers  # flax drew once a layer, while the step was traced

    out = tm.module(nb_t, training=True, generator=torch.Generator().manual_seed(3))
    rec = out["dct_patches"].patches
    (rec[torch.from_numpy(valid)] ** 2).sum().backward()
    np.testing.assert_array_equal(out["codes"].numpy()[valid], np.asarray(jout["codes"])[valid])
    np.testing.assert_allclose(rec.detach().numpy()[valid], np.asarray(jout["dct_patches"].patches)[valid], atol=1e-5)
    got = jax_arrays_from_state_dict({k: p.grad for k, p in tm.module.named_parameters()}, tm.config)
    assert_grads_close(got, flat(jgrads))
    # the same forward without the rate differs: the masks took effect
    tm.config.encoder_config.attention_dropout = 0.0
    for layer in tm.module.encoder.layers:
        layer.attention_dropout = 0.0
    with torch.no_grad():
        undropped = tm.module(nb_t, training=True, generator=torch.Generator().manual_seed(3))["dct_patches"].patches
    assert (undropped - rec.detach()).abs().max().item() > 1e-3


def test_ar_teacher_forced_logits_match_jax(monkeypatch):
    """The tiny AR model (head dim 16, causal, packed rows) with attention
    dropout 0.3: teacher-forced logits and the gradients of the sum of their
    squares on valid tokens, one mask a layer fed to both."""
    rate = 0.3
    tcfg = dict(_TRANSFORMER, attention_dropout=rate)
    jcfg = jar.ARConfig(**_GRID, transformer=JaxTransformerConfig(**tcfg), attention_impl="xla")
    codes, chans, poss, pad = make_data(1, b=2, s=24)
    ids = packed_ids(2, 24)
    jin = [*map(jnp.asarray, (codes, chans, poss, pad))]
    params = jar.ARTokenModel(jcfg).init(jax.random.PRNGKey(0), *jin, training=False)["params"]
    model = tar.ARTokenModel(tar.ARConfig(**_GRID, transformer=TorchTransformerConfig(**tcfg)))
    model.load_state_dict(state_dict_from_jax_npz(ar_flat(params), model.config))

    n_layers, h = _TRANSFORMER["num_hidden_layers"], _TRANSFORMER["num_attention_heads"]
    feed = FeedMasks([tatt.attention_dropout_keep_mask(sd, rate, 2, h, 24) for sd in seeds_of(4, n_layers)], 1 - rate)
    monkeypatch.setattr(jax.random, "bernoulli", feed)
    valid = jnp.asarray(~pad)[..., None, None]

    def jax_loss(p):
        logits = jar.ARTokenModel(jcfg).apply({"params": p}, *jin, image_ids=jnp.asarray(ids), training=True,
                                              rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(jnp.where(valid, logits, 0.0) ** 2), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    assert feed.calls == n_layers

    logits = model(*_t(codes, chans, poss, pad), image_ids=_t(ids)[0], training=True,
                   generator=torch.Generator().manual_seed(4))
    (logits[torch.from_numpy(~pad)] ** 2).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy()[~pad], np.asarray(want)[~pad], atol=1e-5)
    got = jax_arrays_from_state_dict({k: p.grad for k, p in model.named_parameters()}, model.config)
    assert_grads_close(got, ar_flat(jgrads))


def test_remat_redraws_the_seeds_it_drew():
    """Under remat a recomputed layer draws its seed again from the default
    generator, whose state checkpoint restores: the gradients are those of
    the forward that ran (as for MLP dropout, tests/test_torch_train.py);
    remat with an explicit generator raises by name."""
    cfg = TorchConfig.from_dict(tiny_config().to_dict())
    cfg.encoder_config.attention_dropout = 0.3
    _, proc = torch_model_and_processor(cfg, sample_patches_beta=0.0, device="cpu")
    rng = np.random.default_rng(0)
    ds = proc.preprocess_many([rng.uniform(0.1, 0.9, size=(3, 32, 32)).astype(np.float32) for _ in range(3)])
    tb = next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]), batch_size=None))
    grads = []
    for remat in (False, True):
        tm = TorchAE(cfg, dtype=torch.float32, device="cpu", seed=2)
        tm.module.encoder.remat = remat
        torch.manual_seed(5)
        (tm.module(tb, training=True)["dct_patches"].patches ** 2).sum().backward()
        grads.append({k: p.grad.clone() for k, p in tm.module.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="default generator"):
        tm.module(tb, training=True, generator=torch.Generator().manual_seed(0))
