"""The port's VectorQuantize and its EMA codebook (models/vq.py) against
the JAX package's models/vq.py, in fp32 on the CPU.  The codebook surgery
(k-means, expiry) is in tests/test_torch_vq_surgery.py.

Inputs are made from seeded numpy arrays; JAX's parameters and statistics
are carried into the port under the same names.

Tolerances:
  * ids equal, except on tokens where JAX's own best two distances differ
    by at most ID_MARGIN (relative to the distances' scale): there the two
    packages' fp32 sums in another order may pick the other code.  Those
    tokens are counted and held to at most 1 % of the valid tokens;
  * outputs, losses, statistics and gradients rtol 1e-5 / atol 1e-5 (the
    variance of the codebook atol 1e-6).
Gumbel noise is set to zero in both packages where the training forward is
compared (jax.random.gumbel is monkeypatched here, the JAX package does not
change).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch.models.vq as tvq
import dct_autoencoder_tpu.models.vq as jvq

ID_MARGIN = 1e-5
MAX_NEAR_TIE_SHARE = 0.01

CASES = {
    "shared": dict(),
    "per_head": dict(separate_codebook_per_head=True),
    "cosine": dict(use_cosine_sim=True, orthogonal_reg_weight=0.5),
    "ema": dict(ema_update=True, ema_decay=0.5),
}


def _kwargs(which, affine=True):
    return dict(codebook_size=64, heads=4, codebook_dim=8, affine_param=affine, threshold_ema_dead_code=2.0, **CASES[which])


def _inputs(seed=0, b=2, n=24, dim=32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, dim)) * 1.5).astype(np.float32)
    mask = rng.random((b, n)) > 0.25
    return x, mask


def _jax_and_port(which, x, affine=True):
    kw = _kwargs(which, affine)
    jv = jvq.VectorQuantize(dim=x.shape[-1], **kw)
    variables = jv.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    tv = tvq.VectorQuantize(x.shape[-1], **kw)
    sd = {}
    for path, a in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        key, t = ".".join(str(p.key) for p in path), torch.from_numpy(np.array(a))
        if key.endswith(".kernel"):
            key, t = key[: -len("kernel")] + "weight", t.T.contiguous()
        sd[key] = t
    for k, a in variables.get("vq_stats", {}).items():
        sd[k] = torch.from_numpy(np.array(a))
    tv.load_state_dict(sd)
    return jv, variables, tv


def assert_ids_match(got, want, dists, valid):
    """Ids equal except where JAX's best two distances are within ID_MARGIN."""
    got, want = np.asarray(got), np.asarray(want)
    diff = (got != want) & valid[..., None]
    if not diff.any():
        return
    d = np.sort(np.asarray(dists), axis=-1)
    gap = (d[..., 1] - d[..., 0]) / np.maximum(np.abs(d).max(axis=-1), 1.0)
    near = gap <= ID_MARGIN
    assert not (diff & ~near).any(), "an id differs where JAX's best two distances are far apart"
    assert diff.sum() <= MAX_NEAR_TIE_SHARE * valid.sum() * got.shape[-1], f"{diff.sum()} ids differ at near ties"


def _jax_dists(jv, variables, x):
    """JAX's own distances of z to its normed codebook (for the near-tie test)."""

    def f(mdl, x):
        z = mdl.project_in(x).reshape(*x.shape[:2], mdl.heads, mdl.codebook_dim)
        if mdl.use_cosine_sim:
            z = z / (jnp.linalg.norm(z, axis=-1, keepdims=True) + 1e-8)
        cb = mdl._normed_codebook()
        if cb.ndim == 3:
            return jnp.sum(z * z, -1, keepdims=True) + jnp.sum(cb * cb, -1)[None, None] - 2 * jnp.einsum("bnhd,hzd->bnhz", z, cb)
        return jvq._euclidean_sq_dist(z, cb)

    return np.asarray(nn_apply(jv, variables, f, jnp.asarray(x)))


def nn_apply(module, variables, fn, *args):
    from flax import linen as nn

    return nn.apply(fn, module)(variables, *args)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One intra-op thread for the port: these models are tiny, and under
    the suite's parallel workers more threads than cores slow each small
    op many times over.  The other VQ test files and the sweep's import
    this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_gumbel(monkeypatch):
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tvq, "_gumbel", lambda shape, generator, device: torch.zeros(shape, device=device))


@pytest.mark.parametrize("which", ["shared", "per_head", "cosine", "ema"])
def test_eval_forward_matches_jax(which):
    x, mask = _inputs(1)
    jv, variables, tv = _jax_and_port(which, x)
    out, idx, loss, z = jv.apply(variables, jnp.asarray(x), jnp.asarray(mask), training=False)
    with torch.no_grad():
        tout, tidx, tloss, tz = tv(torch.from_numpy(x), torch.from_numpy(mask))
    assert_ids_match(tidx.numpy(), idx, _jax_dists(jv, variables, x), mask)
    same = (tidx.numpy() == np.asarray(idx)).all(axis=-1)
    np.testing.assert_allclose(tout.numpy()[same], np.asarray(out)[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(z), rtol=1e-5, atol=1e-5)
    assert tloss.item() == float(loss) == 0.0
    # decoding the ids gives the eval output (the port's and JAX's indices_to_codes)
    with torch.no_grad():
        np.testing.assert_allclose(tv.indices_to_codes(tidx).numpy(), tout.numpy(), atol=1e-6)
    jdec = jv.apply(variables, jnp.asarray(tidx.numpy()), method="indices_to_codes")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jdec), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["shared", "per_head", "cosine", "ema"])
def test_training_forward_stats_and_gradients_match_jax(which, no_gumbel):
    """The forward with the statistics updating (JAX: mutable=['vq_stats']):
    quantized output, ids, loss, z, every statistic, and the gradients of
    x and of every parameter, which flow through the affine statistics."""
    x, mask = _inputs(2)
    jv, variables, tv = _jax_and_port(which, x)
    w = np.random.default_rng(3).standard_normal((2, 24, 32)).astype(np.float32)

    def jloss(params, x):
        (q, idx, loss, z), new = jv.apply(
            {**variables, "params": params}, x, jnp.asarray(mask), training=True, rng=jax.random.PRNGKey(5),
            mutable=["vq_stats"],
        )
        return jnp.sum(q * w) + loss, (q, idx, loss, z, new["vq_stats"])

    (_, (q, idx, loss, z, stats)), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x)
    )
    tx = torch.from_numpy(x).requires_grad_(True)
    tq, tidx, tloss, tz = tv(tx, torch.from_numpy(mask), training=True, generator=torch.Generator().manual_seed(5),
                             update_stats=True)
    (torch.sum(tq * torch.from_numpy(w)) + tloss).backward()

    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(q), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(z), rtol=1e-5, atol=1e-5)
    assert set(stats) == set(tv.stats())
    for k, v in stats.items():
        atol = 1e-6 if k == "codebook_variance" else 1e-5
        np.testing.assert_allclose(tv.stats()[k].numpy(), np.asarray(v), rtol=1e-5, atol=atol, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    got = dict(tv.named_parameters())
    for path, g in jax.tree_util.tree_flatten_with_path(gp)[0]:
        key = ".".join(str(p.key) for p in path)
        want = np.asarray(g)
        if key.endswith(".kernel"):
            key, want = key[: -len("kernel")] + "weight", want.T
        np.testing.assert_allclose(got[key].grad.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=key)
    if which != "ema":
        assert np.abs(got["codebook"].grad.numpy()).max() > 0


def test_gradient_flows_through_the_affine_statistics(no_gumbel):
    """The codebook loss alone ((sg(z) - quantized)^2): with the statistics
    updating (JAX: mutable apply), the encoder's projection gets gradient
    through batch_mean and batch_variance, and the codebook's gradient
    differs from the one with the statistics frozen; with them frozen the
    projection gets none."""
    x, mask = _inputs(4)
    _, _, tv = _jax_and_port("shared", x)
    tv.commitment_weight = 0.0
    grads = []
    for update in (True, False):
        tv.zero_grad(set_to_none=True)
        _, _, loss, _ = tv(torch.from_numpy(x), torch.from_numpy(mask), training=True, update_stats=update)
        loss.backward()
        grads.append((tv.codebook.grad.clone(), tv.project_in.weight.grad))
    (cb_upd, pin_upd), (cb_frozen, pin_frozen) = grads
    assert pin_upd is not None and pin_upd.abs().max() > 0
    assert pin_frozen is None or pin_frozen.abs().max() == 0
    assert not torch.allclose(cb_upd, cb_frozen)


def test_gumbel_sampling_draws_from_the_generator():
    x, mask = _inputs(5)
    tv = tvq.VectorQuantize(32, 64, heads=4, codebook_dim=8, sample_codebook_temp=20.0)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    ids = lambda g: tv(tx, tm, training=True, generator=g)[1]  # noqa: E731
    with torch.no_grad():
        a, b, a2 = ids(torch.Generator().manual_seed(1)), ids(torch.Generator().manual_seed(2)), ids(torch.Generator().manual_seed(1))
        det = ids(None)
        ev = tv(tx, tm, training=False, generator=torch.Generator().manual_seed(1))[1]
    assert not torch.equal(a, b), "gumbel sampling is dead: identical ids from two generators"
    assert torch.equal(a, a2)
    assert torch.equal(det, ev) and not torch.equal(a, det)  # no generator, or eval: the argmin


@pytest.mark.parametrize("sep", [False, True])
def test_distances_in_token_chunks_give_the_same_ids(sep, monkeypatch):
    x, _ = _inputs(6, n=50)
    tv = tvq.VectorQuantize(32, 64, heads=4, codebook_dim=8, separate_codebook_per_head=sep, sample_codebook_temp=20.0)
    z = tv.project_in(torch.from_numpy(x)).reshape(2, 50, 4, 8).detach()
    cb = tv.codebook.detach()
    whole = tvq.choose_codes(z, cb)
    monkeypatch.setattr(tvq, "_CHUNK_ELEMENTS", 7 * 4 * 64)  # 7 tokens of 4 heads x 64 codes a chunk
    assert torch.equal(tvq.choose_codes(z, cb), whole)
    d = tvq.euclidean_sq_dist(z, cb) if not sep else torch.stack(
        [tvq.euclidean_sq_dist(z[:, :, i], cb[i]) for i in range(4)], dim=2)
    assert torch.equal(whole, torch.argmin(d, dim=-1))


def test_ties_go_to_the_first_index():
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    z = torch.tensor([[[[1.0, 0.0]], [[0.5, 0.5]]]])  # (1, 2, 1, 2): an exact tie, then a three-way one
    assert tvq.choose_codes(z, cb).reshape(-1).tolist() == [0, 0]


# ---------------------------------------------------------------- EMA codebook


def test_ema_codebook_update_matches_jax():
    rng = np.random.default_rng(7)
    flat = rng.standard_normal((40, 8)).astype(np.float32)
    valid = rng.random(40) > 0.2
    js = jvq.EMACodebookState.create(16, 8, jax.random.PRNGKey(1))
    ts = tvq.EMACodebookState(*(torch.from_numpy(np.array(getattr(js, k))) for k in ("embed", "cluster_size", "embed_avg")))
    for _ in range(3):
        js = jvq.ema_codebook_update(js, jnp.asarray(flat), jnp.asarray(valid), decay=0.6)
        ts = tvq.ema_codebook_update(ts, torch.from_numpy(flat), torch.from_numpy(valid), decay=0.6)
        for k in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=1e-5, atol=1e-5, err_msg=k)


def test_ema_mode_trains_the_codebook_without_gradients():
    """Counterpart of the JAX package's test of the same name: the embed moves
    toward the data and the quantization error falls."""
    x = torch.from_numpy((np.random.default_rng(5).standard_normal((4, 32, 16)) * 2.0).astype(np.float32))
    tv = tvq.VectorQuantize(16, 32, heads=2, codebook_dim=8, ema_update=True, ema_decay=0.5)
    assert "codebook" not in dict(tv.named_parameters())

    def qerr():
        z = tv.project_in(x).reshape(-1, 8)
        return tvq.euclidean_sq_dist(z, tv.embed).min(dim=-1).values.mean().item()

    with torch.no_grad():
        e0 = qerr()
        for _ in range(20):
            tv(x, training=True, update_stats=True)
        assert qerr() < e0
        out, idx, _, _ = tv(x)
        torch.testing.assert_close(tv.indices_to_codes(idx), out)
