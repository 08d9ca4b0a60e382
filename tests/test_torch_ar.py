"""The port's autoregressive token model against the JAX package, in fp32 on the CPU.

Small models (2 layers, hidden 64, 4 heads of 16; 4 codebooks of 32).  The
weights are made from a seed by the JAX package's init, carried into the
port with models/convert.py, and carried back by its reverse map.  Inputs
are numpy arrays made from a seed and handed to both packages.  On the CPU
the port's full-sequence attention runs the plain version of the causal
kernels; the JAX model runs its default attention there.

Tolerances:
  * teacher-forced logits and decode_step logits atol 1e-4 on valid tokens
    (fp32 sums in another order);
  * ar_loss rtol 1e-5; the gradient of each parameter atol 2e-3 x that
    tensor's largest entry in JAX plus 1e-6 x the largest entry of any
    tensor, as tests/test_torch_train.py holds the tokenizer's gradients
    (the gradient of a key bias is 0 in exact arithmetic);
  * greedy samples equal JAX's exactly; at temperature 1 the port's
    samplers are held to each other (the two packages' random streams
    differ), bit for bit;
  * checkpoints that cross between the packages give logits within 1e-4.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models import ar as tar
from dct_autoencoder_torch.models.config import TransformerConfig as TorchTransformerConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict, state_dict_from_jax_npz
from dct_autoencoder_torch.models.transformer import KVCache
from dct_autoencoder_torch.tools import train_ar_example as texample
from dct_autoencoder_tpu.models import ar as jar
from dct_autoencoder_tpu.models.config import TransformerConfig as JaxTransformerConfig
from dct_autoencoder_tpu.tools.train_ar_example import records_to_arrays as jax_records_to_arrays
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

GRAD_REL_ATOL = 2e-3
CODEBOOK, C = 32, 4
_TRANSFORMER = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4)
_GRID = dict(codebook_size=CODEBOOK, num_codebooks=C, image_channels=3, max_patch_h=8, max_patch_w=8)


def jax_config():
    return jar.ARConfig(**_GRID, transformer=JaxTransformerConfig(**_TRANSFORMER))


def torch_config():
    return tar.ARConfig(**_GRID, transformer=TorchTransformerConfig(**_TRANSFORMER))


def make_data(seed, b=2, s=24, n_pad=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, CODEBOOK, (b, s, C)).astype(np.int32)
    chans = rng.integers(0, 3, (b, s)).astype(np.int32)
    poss = rng.integers(0, 8, (b, s, 2)).astype(np.int32)
    pad = np.zeros((b, s), bool)
    if n_pad:
        pad[:, -n_pad:] = True
    return codes, chans, poss, pad


def flat(tree) -> dict:
    return {jar._ar_path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_pair(seed=0):
    """(JAX config, JAX params, the port's model with the same weights)."""
    jcfg = jax_config()
    codes, chans, poss, pad = map(jnp.asarray, make_data(0, b=1))
    params = jar.ARTokenModel(jcfg).init(jax.random.PRNGKey(seed), codes, chans, poss, pad, training=False)["params"]
    tcfg = torch_config()
    model = tar.ARTokenModel(tcfg)
    model.load_state_dict(state_dict_from_jax_npz(flat(params), tcfg))
    return jcfg, params, model


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def gen(seed):
    return torch.Generator().manual_seed(seed)


def packed_ids(b, s):
    """Two or three images a row, sorted ids."""
    ids = np.zeros((b, s), np.int32)
    ids[:, s // 3 :] = 1
    ids[1:, 2 * s // 3 :] = 2
    return ids


# ---------------------------------------------------------------- config and parameters


def test_config_json_is_the_jax_package_s():
    assert torch_config().to_dict() == dataclasses.asdict(jax_config())
    assert tar.ARConfig.from_dict(torch_config().to_dict()) == torch_config()
    assert tar.ARConfig().to_dict() == dataclasses.asdict(jar.ARConfig())


def test_parameter_map_is_total_both_ways():
    _, params, model = make_pair()
    jflat = flat(params)
    back = jax_arrays_from_state_dict(model.state_dict(), model.config)
    assert sorted(back) == sorted(jflat)
    for k in jflat:
        np.testing.assert_array_equal(back[k], jflat[k])
    # the embedding tables keep their layout; only Dense kernels are transposed
    assert model.code_embed.shape == (C, CODEBOOK, 64) and model.head.weight.shape == (C * CODEBOOK, 64)
    assert model.head.bias is None and "head/bias" not in jflat
    with pytest.raises(KeyError):
        state_dict_from_jax_npz({k: v for k, v in jflat.items() if k != "bos"}, model.config)
    with pytest.raises(KeyError):
        state_dict_from_jax_npz({**jflat, "extra/kernel": np.zeros((2, 2), np.float32)}, model.config)
    with pytest.raises(ValueError):
        state_dict_from_jax_npz({**jflat, "code_embed": jflat["code_embed"][:, :-1]}, model.config)


# ---------------------------------------------------------------- forward, loss, gradients


@pytest.mark.parametrize("packed", [False, True], ids=["single", "packed"])
def test_teacher_forced_logits_match_jax(packed):
    jcfg, params, model = make_pair()
    codes, chans, poss, pad = make_data(1, b=2, s=24)
    ids = packed_ids(2, 24) if packed else None
    want = jar.ARTokenModel(jcfg).apply(
        {"params": params}, *map(jnp.asarray, (codes, chans, poss, pad)),
        image_ids=None if ids is None else jnp.asarray(ids), training=False,
    )
    with torch.no_grad():
        got = model(*_t(codes, chans, poss, pad), image_ids=None if ids is None else _t(ids)[0], training=False)
    assert got.shape == (2, 24, C, CODEBOOK) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[~pad], np.asarray(want)[~pad], atol=1e-4)


def test_packed_rows_do_not_leak_across_images():
    """The first token of a later image takes BOS: changing all of image 0 leaves image 1's logits."""
    _, _, model = make_pair()
    codes, chans, poss, pad = make_data(2, b=1, s=16, n_pad=0)
    ids = np.concatenate([np.zeros(8), np.ones(8)]).astype(np.int32)[None]
    codes2 = codes.copy()
    codes2[0, :8] = (codes[0, :8] + 7) % CODEBOOK
    with torch.no_grad():
        l1 = model(*_t(codes, chans, poss, pad, ids), training=False)
        l2 = model(*_t(codes2, chans, poss, pad, ids), training=False)
    np.testing.assert_allclose(l1.numpy()[0, 8:], l2.numpy()[0, 8:], atol=1e-5)
    assert np.abs(l1.numpy()[0, 1:8] - l2.numpy()[0, 1:8]).max() > 1e-3


@pytest.mark.parametrize("packed", [False, True], ids=["single", "packed"])
def test_loss_and_every_gradient_match_jax(packed):
    jcfg, params, model = make_pair(seed=1)
    codes, chans, poss, pad = make_data(3, b=2, s=24)
    ids = packed_ids(2, 24) if packed else None
    jmodel = jar.ARTokenModel(jcfg)
    jargs = list(map(jnp.asarray, (codes, chans, poss, pad)))

    def loss_fn(p):
        logits = jmodel.apply(
            {"params": p}, *jargs, image_ids=None if ids is None else jnp.asarray(ids), training=True
        )
        return jar.ar_loss(logits, jargs[0], ~jargs[3])

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    tcodes, tchans, tposs, tpad = _t(codes, chans, poss, pad)
    logits = model(tcodes, tchans, tposs, tpad, image_ids=None if ids is None else _t(ids)[0], training=True)
    loss = tar.ar_loss(logits, tcodes, ~tpad)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)

    got = jax_arrays_from_state_dict({k: p.grad for k, p in model.named_parameters()}, model.config)
    want = flat(want_grads)
    assert sorted(got) == sorted(want)
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=GRAD_REL_ATOL * np.abs(w).max() + floor, rtol=0, err_msg=k)


def test_ar_loss_counts_valid_tokens_only():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 6, C, CODEBOOK)).astype(np.float32)
    codes = rng.integers(0, CODEBOOK, (2, 6, C)).astype(np.int32)
    valid = rng.random((2, 6)) > 0.4
    want = jar.ar_loss(*map(jnp.asarray, (logits, codes, valid)))
    got = tar.ar_loss(*_t(logits, codes, valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = tar.ar_loss(*_t(logits, codes, np.zeros((2, 6), bool)))
    assert float(none) == 0.0


# ---------------------------------------------------------------- the KV-cached step


def test_decode_step_logits_match_jax_step_by_step():
    jcfg, params, model = make_pair(seed=2)
    s = 10
    codes, chans, poss, _ = make_data(5, b=2, s=s, n_pad=0)
    jmodel = jar.ARTokenModel(jcfg, decode_cache=s)
    cache = KVCache(model.config.transformer, 2, s, torch.float32, "cpu")
    jcache = None
    with torch.no_grad():
        full = model(*_t(codes, chans, poss, np.zeros((2, s), bool)), training=False).numpy()
    for t in range(s):
        prev = codes[:, t - 1 : t] if t else np.zeros((2, 1, C), np.int32)
        variables = {"params": params} if jcache is None else {"params": params, "cache": jcache}
        want, new_vars = jmodel.apply(
            variables, jnp.asarray(prev), jnp.asarray(chans[:, t : t + 1]), jnp.asarray(poss[:, t : t + 1]),
            jnp.asarray(t), method="decode_step", mutable=["cache"],
        )
        jcache = new_vars["cache"]
        with torch.no_grad():
            got = model.decode_step(*_t(prev, chans[:, t : t + 1], poss[:, t : t + 1]), torch.tensor(t), cache)
        assert got.shape == (2, C, CODEBOOK)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"step {t}")
        # the cached path against the full-sequence (kernel) path of the same sequence
        np.testing.assert_allclose(got.numpy(), full[:, t], atol=1e-4, err_msg=f"step {t} vs forward")
    assert int(cache.idx) == s


def test_decode_step_takes_one_token_at_a_time():
    _, _, model = make_pair()
    cache = KVCache(model.config.transformer, 1, 4, torch.float32, "cpu")
    two = torch.zeros((1, 2, C), dtype=torch.long)
    with pytest.raises(ValueError):
        model.decode_step(two, torch.zeros((1, 2), dtype=torch.long), torch.zeros((1, 2, 2), dtype=torch.long),
                          torch.tensor(0), cache)


# ---------------------------------------------------------------- samplers


def test_greedy_samplers_give_jax_s_codes():
    jcfg, params, model = make_pair(seed=3)
    _, chans, poss, _ = make_data(6, b=1, s=12, n_pad=0)
    want = np.asarray(
        jar.sample_codes_scan(jcfg, params, jnp.asarray(chans), jnp.asarray(poss), jax.random.PRNGKey(0), temperature=0.0)
    )
    for sampler in (tar.sample_codes, tar.sample_codes_cached, tar.sample_codes_scan):
        got = sampler(model, chans, poss, None, temperature=0.0)
        assert got.shape == (1, 12, C) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=sampler.__name__)
    batched = tar.sample_codes_scan_batched(model, chans, poss, None, temperature=0.0)
    np.testing.assert_array_equal(batched.numpy(), want)


def test_samplers_agree_bit_for_bit_under_one_generator():
    _, _, model = make_pair(seed=4)
    _, chans, poss, _ = make_data(7, b=1, s=12, n_pad=0)
    full = tar.sample_codes(model, chans, poss, gen(9), temperature=1.0).numpy()
    cached = tar.sample_codes_cached(model, chans, poss, gen(9), temperature=1.0).numpy()
    scanned = tar.sample_codes_scan(model, chans, poss, gen(9), temperature=1.0).numpy()
    np.testing.assert_array_equal(full, cached)
    np.testing.assert_array_equal(cached, scanned)
    assert (full >= 0).all() and (full < CODEBOOK).all()
    other = tar.sample_codes_scan(model, chans, poss, gen(10), temperature=1.0).numpy()
    assert (other != scanned).any()
    greedy = tar.sample_codes_scan(model, chans, poss, None, temperature=0.0).numpy()
    assert (greedy != scanned).any()


def test_sampling_needs_an_explicit_generator():
    _, _, model = make_pair()
    _, chans, poss, _ = make_data(7, b=1, s=4, n_pad=0)
    for sampler in (tar.sample_codes, tar.sample_codes_cached, tar.sample_codes_scan, tar.sample_codes_scan_batched):
        with pytest.raises(ValueError):
            sampler(model, chans, poss, None, temperature=1.0)


def test_batched_rows_equal_the_single_row_sampler():
    _, _, model = make_pair(seed=5)
    _, chans, poss, _ = make_data(8, b=3, s=10, n_pad=0)
    batched = tar.sample_codes_scan_batched(model, chans, poss, gen(7), temperature=1.0).numpy()
    assert batched.shape == (3, 10, C)
    for i in range(3):
        single = tar.sample_codes_scan(model, chans[i : i + 1], poss[i : i + 1], tar.fold_in(gen(7), i), temperature=1.0)
        np.testing.assert_array_equal(batched[i], single.numpy()[0], err_msg=f"row {i}")
    assert (batched[0] != batched[1]).any()


def test_batched_row_does_not_depend_on_its_batch():
    """Explicit per-row generators: a request's draw is the same in another batch composition."""
    _, _, model = make_pair(seed=5)
    _, chans, poss, _ = make_data(9, b=3, s=8, n_pad=0)
    full = tar.sample_codes_scan_batched(
        model, chans, poss, None, generators=[gen(100), gen(101), gen(102)]
    ).numpy()
    order = [1, 2, 0]
    other = tar.sample_codes_scan_batched(
        model, chans[order], poss[order], None, generators=[gen(101), gen(999), gen(998)]
    ).numpy()
    np.testing.assert_array_equal(other[0], full[1])


def test_prefix_forcing_returns_the_prefix_and_samples_the_rest():
    _, _, model = make_pair(seed=6)
    _, chans, poss, _ = make_data(10, b=1, s=12, n_pad=0)
    uncond = tar.sample_codes_scan(model, chans, poss, gen(9)).numpy()
    prefix = (uncond + 7) % CODEBOOK
    cond = tar.sample_codes_scan(model, chans, poss, gen(9), prefix_codes=prefix, prefix_len=5).numpy()
    np.testing.assert_array_equal(cond[0, :5], prefix[0, :5])
    assert not np.array_equal(cond[0, 5:], uncond[0, 5:]), "the continuation ignored the forced prefix"
    zero = tar.sample_codes_scan(model, chans, poss, gen(9), prefix_codes=prefix, prefix_len=0).numpy()
    np.testing.assert_array_equal(zero, uncond)
    whole = tar.sample_codes_scan(model, chans, poss, gen(9), prefix_codes=prefix, prefix_len=12).numpy()
    np.testing.assert_array_equal(whole, prefix)
    # per-row prefix lengths in the batched sampler
    chans3, poss3 = np.repeat(chans, 3, 0), np.repeat(poss, 3, 0)
    rows = tar.sample_codes_scan_batched(
        model, chans3, poss3, gen(1), prefix_codes=np.repeat(prefix, 3, 0), prefix_lens=np.array([0, 5, 12])
    ).numpy()
    np.testing.assert_array_equal(rows[1, :5], prefix[0, :5])
    np.testing.assert_array_equal(rows[2], prefix[0])


@pytest.fixture
def empty_runner_cache():
    saved = dict(tar._SCAN_RUNNERS)
    tar._SCAN_RUNNERS.clear()
    yield tar._SCAN_RUNNERS
    tar._SCAN_RUNNERS.clear()
    tar._SCAN_RUNNERS.update(saved)


def test_scan_runner_is_reused(empty_runner_cache):
    _, _, model = make_pair()
    _, chans, poss, _ = make_data(2, b=1, s=8, n_pad=0)
    a = tar.sample_codes_scan(model, chans, poss, gen(1))
    b = tar.sample_codes_scan(model, chans, poss, gen(2))
    assert a.shape == b.shape and len(empty_runner_cache) == 1
    r1 = tar._scan_runner(model, 8, 1.0, 1)
    assert r1 is tar._scan_runner(model, 8, 1.0, 1)
    # float jitter in the temperature must not mint a new runner
    assert r1 is tar._scan_runner(model, 8, 1.0 + 1e-9, 1)
    assert len(empty_runner_cache) == 1
    # another temperature, length, batch or model is another program
    others = [tar._scan_runner(model, 8, 0.0, 1), tar._scan_runner(model, 9, 1.0, 1), tar._scan_runner(model, 8, 1.0, 2)]
    others.append(tar._scan_runner(make_pair()[2], 8, 1.0, 1))
    assert len({id(r) for r in [r1, *others]}) == 5 and len(empty_runner_cache) == 5
    # a re-used runner starts from an empty cache: same generator, same codes
    np.testing.assert_array_equal(tar.sample_codes_scan(model, chans, poss, gen(1)).numpy(), a.numpy())


def test_scan_runner_cache_is_bounded(empty_runner_cache):
    _, _, model = make_pair()
    limit = tar._SCAN_RUNNERS_MAX
    assert limit == jar._SCAN_RUNNERS_MAX == 8
    for k in range(limit + 3):
        tar._scan_runner(model, 8, 0.5 + 0.01 * k, 1)
    assert len(empty_runner_cache) == limit
    tar._scan_runner(model, 8, 0.5 + 0.01 * (limit + 2), 1)  # the newest survives
    assert len(empty_runner_cache) == limit
    # a hit refreshes the LRU order: the oldest survivor outlives the next insertion
    oldest = next(iter(empty_runner_cache))
    tar._scan_runner(model, oldest[1], oldest[2], oldest[3])
    tar._scan_runner(model, 8, 0.99, 1)
    assert oldest in empty_runner_cache and len(empty_runner_cache) == limit


def test_canonical_layout_equals_jax():
    for n, kw in [(40, {}), (192, {}), (30, dict(patch_h=4, patch_w=6)), (17, dict(channel_importances=(2.0, 1.0, 3.0)))]:
        want = jar.canonical_layout(jax_config(), n, **kw)
        got = tar.canonical_layout(torch_config(), n, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tar.canonical_layout(torch_config(), 8 * 8 * 3 + 1)


# ---------------------------------------------------------------- checkpoints


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    jcfg, params, model = make_pair(seed=7)
    path = str(tmp_path / "ar")
    tar.save_ar_model(path, model)
    assert sorted(os.listdir(path)) == ["ar_config.json", "ar_params.npz"]
    cfg2, params2 = jar.load_ar_model(path)
    assert cfg2 == jcfg
    for (p1, a), (p2, b) in zip(
        jax.tree_util.tree_flatten_with_path(params)[0], jax.tree_util.tree_flatten_with_path(params2)[0]
    ):
        assert p1 == p2
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    codes, chans, poss, pad = make_data(11, b=1, s=12, n_pad=0)
    want = jar.ARTokenModel(cfg2).apply({"params": params2}, *map(jnp.asarray, (codes, chans, poss, pad)), training=False)
    with torch.no_grad():
        got = model(*_t(codes, chans, poss, pad), training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    jcfg, params, model = make_pair(seed=8)
    path = str(tmp_path / "ar")
    jar.save_ar_model(path, jcfg, params)
    loaded = tar.load_ar_model(path, device="cpu")
    assert loaded.config == model.config and loaded.device.type == "cpu"
    assert all(p.requires_grad and p.dtype == torch.float32 for p in loaded.parameters())
    for (k1, a), (k2, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert k1 == k2 and torch.equal(a, b), k1
    codes, chans, poss, pad = make_data(12, b=1, s=12, n_pad=0)
    want = jar.ARTokenModel(jcfg).apply({"params": params}, *map(jnp.asarray, (codes, chans, poss, pad)), training=False)
    with torch.no_grad():
        got = loaded(*_t(codes, chans, poss, pad), training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # and through the port's own save
    tar.save_ar_model(str(tmp_path / "again"), loaded)
    again = tar.load_ar_model(str(tmp_path / "again"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), again.state_dict().values()))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("there is a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tar.build_ar_model(torch_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tar.load_ar_model("nowhere")


# ---------------------------------------------------------------- the example


def test_records_to_arrays_equals_jax():
    rng = np.random.default_rng(13)
    records = [
        {"codes": [dict(c=int(rng.integers(3)), h=int(rng.integers(8)), w=int(rng.integers(8)),
                        data=[int(v) for v in rng.integers(0, CODEBOOK, C)]) for _ in range(n)]}
        for n in (5, 9, 3)
    ]
    for got, want in zip(texample.records_to_arrays(records, 7), jax_records_to_arrays(records, 7)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_ar_optimizer_is_optax_adamw_under_warmup_cosine():
    import optax

    steps, lr = 40, 3e-4
    tx = texample.make_ar_optimizer(lr, steps)
    sched = optax.warmup_cosine_decay_schedule(0, lr, 20, max(steps, 21))
    for i in range(steps + 5):
        assert tx.schedule(i) == pytest.approx(float(sched(i)), abs=1e-7 * lr)
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) * 10 for _ in range(4)]  # norm > 5: nothing clips
    otx = optax.adamw(sched)
    params, state = jnp.asarray(w0), None
    state = otx.init(params)
    lin = torch.nn.Linear(3, 5, bias=False)
    lin.weight.data = torch.from_numpy(w0.copy())
    adamw = tx.init(lin)
    for i, g in enumerate(grads):
        updates, state = otx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        for group in adamw.param_groups:
            group["lr"] = tx.schedule(i)
        lin.weight.grad = torch.from_numpy(g.copy())
        adamw.step()
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(params), atol=1e-7, rtol=1e-6)


def test_ar_example_end_to_end(tmp_path):
    """tokenize -> AR train -> save -> sample -> decode, on a tiny tokenizer and three 32 x 32 images."""
    from dct_autoencoder_torch.models.config import DCTAutoencoderConfig
    from dct_autoencoder_torch.pipeline import DCTPipeline
    from test_model import tiny_config

    tok_cfg = DCTAutoencoderConfig.from_dict(tiny_config("lfq").to_dict())
    pipe = DCTPipeline.from_config(tok_cfg, sample_patches_beta=0.0, dtype=torch.float32, device="cpu")
    mp = str(tmp_path / "tok")
    pipe.model.save_pretrained(mp)
    rng = np.random.default_rng(4)
    arrays = [(rng.uniform(0.1, 0.9, (32, 32, 3)) * 255).astype(np.uint8) for _ in range(3)]
    images = [a.astype(np.float32).transpose(2, 0, 1) / 255.0 for a in arrays]
    out = str(tmp_path / "out_ar")

    logs = []
    result = texample.train_ar(
        pipe, images, steps=25, batch_size=4, max_len=32, hidden=64, layers=2, out=out, seed=0, log=logs.append
    )
    losses = result["losses"]
    assert len(losses) == 25 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    with open(os.path.join(out, "ar_metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 20]
    img = result["image"]
    assert img.shape == (3, 32, 32) and np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    n = len(result["sampled_record"]["codes"])
    assert n == min(len(result["records"][0]["codes"]), 32)
    assert all(0 <= v < tok_cfg.vq_codebook_size for tok in result["sampled_record"]["codes"] for v in tok["data"])
    # the checkpoint it wrote loads in both packages and gives the trained model's logits
    loaded = tar.load_ar_model(os.path.join(out, "ar_model"), device="cpu")
    jcfg, jparams = jar.load_ar_model(os.path.join(out, "ar_model"))
    codes, chans, poss, pad = texample.records_to_arrays(result["records"][:2], 32)
    with torch.no_grad():
        a = result["model"](*_t(codes, chans, poss, pad), training=False).numpy()
        b = loaded(*_t(codes, chans, poss, pad), training=False).numpy()
    np.testing.assert_array_equal(a, b)
    want = jar.ARTokenModel(jcfg).apply({"params": jparams}, *map(jnp.asarray, (codes, chans, poss, pad)), training=False)
    np.testing.assert_allclose(a[~pad], np.asarray(want)[~pad], atol=1e-4)

    # main(): the same loop from a directory of PNGs, and the PNG it writes
    if importlib.util.find_spec("PIL") is None:
        return  # no Pillow: only the directory reader and the PNG go unchecked
    import PIL.Image as PIL

    img_dir = str(tmp_path / "imgs")
    os.makedirs(img_dir)
    for i, a in enumerate(arrays):
        PIL.fromarray(a).save(os.path.join(img_dir, f"{i}.png"))
    out2 = str(tmp_path / "out_main")
    losses2 = texample.main(
        model_path=mp, image_dir=img_dir, steps=25, batch_size=4, max_len=32, hidden=64, layers=2, out=out2,
        seed=0, device="cpu",
    )
    # main() tokenizes at the example's beta 0.02, so its records are not the ones above
    assert len(losses2) == 25 and all(np.isfinite(losses2)) and losses2[-1] < losses2[0]
    assert os.path.exists(os.path.join(out2, "ar_sample.png"))
    assert os.path.exists(os.path.join(out2, "ar_model", "ar_params.npz"))
