"""The port's codebook surgery (models/vq.py: k-means init, dead-code
expiry, the standalone EMA-codebook expiry) against the JAX package's
models/vq.py, in fp32 on the CPU, and on the port's own draws.

Random draws are each package's own; the tests against JAX hand JAX's
draws, made here from the same key as JAX's functions make them, to the
port's arithmetic.  Inputs are made from seeded numpy arrays.

Tolerances:
  * k-means given JAX's draws: the means atol 1e-4 (sums by index_add_ in
    another order than JAX's one-hot product), the bins exact;
  * expiry given JAX's draws: exact (the EMA statistics rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch.models.vq as tvq
import dct_autoencoder_tpu.models.vq as jvq
from test_torch_vq import one_cpu_thread  # noqa: F401  (fixture)


# ---------------------------------------------------------------- surgery, given JAX's draws


def _jax_choice(key, valid, m):
    v = jnp.asarray(valid.reshape(-1), jnp.float32)
    return np.array(jax.random.choice(key, v.shape[0], (m,), p=v / jnp.maximum(v.sum(), 1.0)))


def _surgery_inputs(sep, seed=11, b=2, n=40, h=2, zsize=16):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, n, h, 8)).astype(np.float32)
    mask = rng.random((b, n)) > 0.3
    cb = rng.standard_normal((h, zsize, 8) if sep else (zsize, 8)).astype(np.float32)
    cs = rng.uniform(0, 30, size=cb.shape[:-1]).astype(np.float32)
    return z, mask, cb, cs


def _jax_kmeans_draws(key, z, mask, cb_shape):
    b, n, h, _ = z.shape
    m = tvq.kmeans_pool_size(z.shape, cb_shape)
    if len(cb_shape) == 2:
        valid = np.broadcast_to(mask[..., None], (b, n, h))
        return tvq.KMeansDraws(torch.from_numpy(_jax_choice(key, valid, m)),
                               torch.from_numpy(np.array(jax.random.permutation(key, m)[: cb_shape[0]])))
    keys = jax.random.split(key, h)
    pools = [_jax_choice(k, mask, m) for k in keys]
    perms = [np.asarray(jax.random.permutation(k, m)[: cb_shape[1]]) for k in keys]
    return tvq.KMeansDraws(torch.from_numpy(np.stack(pools)), torch.from_numpy(np.stack(perms)))


def _jax_expiry_draws(key, z, mask, cb_shape):
    b, n, h, _ = z.shape
    if len(cb_shape) == 2:
        return torch.from_numpy(_jax_choice(key, np.broadcast_to(mask[..., None], (b, n, h)), cb_shape[0]))
    return torch.from_numpy(np.stack([_jax_choice(k, mask, cb_shape[1]) for k in jax.random.split(key, h)]))


@pytest.mark.parametrize("return_bins", [False, True])
@pytest.mark.parametrize("sep", [False, True])
def test_kmeans_init_from_batch_matches_jax_given_its_draws(sep, return_bins):
    z, mask, cb, _ = _surgery_inputs(sep)
    key = jax.random.PRNGKey(3)
    want = jvq.kmeans_init_from_batch(jnp.asarray(cb), jnp.asarray(z), jnp.asarray(mask), key, return_bins=return_bins)
    draws = _jax_kmeans_draws(key, z, mask, cb.shape)
    got = tvq.kmeans_init_from_batch(torch.from_numpy(cb), torch.from_numpy(z), torch.from_numpy(mask), draws,
                                     return_bins=return_bins)
    if return_bins:
        (got, got_bins), (want, want_bins) = got, want
        np.testing.assert_array_equal(got_bins.numpy(), np.asarray(want_bins))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("sep", [False, True])
def test_expire_dead_codes_params_matches_jax_given_its_draws(sep):
    z, mask, cb, cs = _surgery_inputs(sep, seed=12)
    key = jax.random.PRNGKey(4)
    want_cb, want_cs = jvq.expire_dead_codes_params(jnp.asarray(cb), jnp.asarray(cs), jnp.asarray(z), jnp.asarray(mask),
                                                    key, 15.0)
    got_cb, got_cs = tvq.expire_dead_codes_params(torch.from_numpy(cb), torch.from_numpy(cs), torch.from_numpy(z),
                                                  _jax_expiry_draws(key, z, mask, cb.shape), 15.0)
    np.testing.assert_array_equal(got_cb.numpy(), np.asarray(want_cb))
    np.testing.assert_array_equal(got_cs.numpy(), np.asarray(want_cs))


@pytest.mark.parametrize("sep", [False, True])
def test_expire_dead_codes_ema_stats_matches_jax_given_its_draws(sep):
    z, mask, cb, cs = _surgery_inputs(sep, seed=13)
    rng = np.random.default_rng(14)
    stats = {"embed": cb, "embed_avg": rng.standard_normal(cb.shape).astype(np.float32),
             "ema_cluster_size": rng.uniform(0, 30, size=cs.shape).astype(np.float32), "cluster_size": cs,
             "batch_mean": np.zeros(8, np.float32)}
    key = jax.random.PRNGKey(5)
    want = jvq.expire_dead_codes_ema_stats({k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(z),
                                           jnp.asarray(mask), key, 15.0)
    got = tvq.expire_dead_codes_ema_stats({k: torch.from_numpy(v) for k, v in stats.items()}, torch.from_numpy(z),
                                          _jax_expiry_draws(key, z, mask, cb.shape), 15.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


def test_standalone_kmeans_and_expiry_match_jax_given_its_draws():
    rng = np.random.default_rng(15)
    flat = rng.standard_normal((300, 8)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want, want_bins = jvq.kmeans_init_codebook(jnp.asarray(flat), 24, key, return_bins=True)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 300)[:24]))
    got, got_bins = tvq.kmeans_init_codebook(torch.from_numpy(flat), 24, perm, return_bins=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got_bins.numpy(), np.asarray(want_bins))

    js = jvq.EMACodebookState.create(24, 8, jax.random.PRNGKey(7))
    js = jvq.EMACodebookState(js.embed, jnp.asarray(rng.uniform(0, 4, 24).astype(np.float32)), js.embed_avg)
    ts = tvq.EMACodebookState(*(torch.from_numpy(np.array(getattr(js, k))) for k in ("embed", "cluster_size", "embed_avg")))
    want = jvq.expire_dead_codes(js, jnp.asarray(flat), key, threshold=2.0)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (24,), 0, 300)))
    got = tvq.expire_dead_codes(ts, torch.from_numpy(flat), idx, threshold=2.0)
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)


# ---------------------------------------------------------------- surgery, the port's own draws


@pytest.mark.parametrize("sep", [False, True])
def test_kmeans_from_its_own_draw_lowers_the_distortion(sep):
    z, mask, cb, _ = _surgery_inputs(sep, seed=16, n=80)
    tz, tm, tcb = torch.from_numpy(z), torch.from_numpy(mask), torch.from_numpy(cb)
    draws = tvq.draw_kmeans(tz, tm, tcb.shape, torch.Generator().manual_seed(0))
    means = tvq.kmeans_init_from_batch(tcb, tz, tm, draws)
    assert means.shape == tcb.shape and torch.isfinite(means).all()

    def distortion(c):
        zs = tz[tm]  # (k, h, d)
        per_head = c if c.ndim == 3 else c.expand(zs.shape[1], *c.shape)
        return sum(tvq.euclidean_sq_dist(zs[:, i], per_head[i]).min(dim=-1).values.mean() for i in range(zs.shape[1]))

    assert distortion(means) < distortion(tcb)
    # the pool holds valid projections only
    valid_flat = (tm[..., None].expand(*tm.shape, z.shape[2]) if not sep else tm).reshape(-1)
    assert bool(valid_flat[draws.pool.reshape(-1)].all())


@pytest.mark.parametrize("sep", [False, True])
def test_expiry_replaces_only_dead_rows_with_valid_samples(sep):
    z, mask, cb, cs = _surgery_inputs(sep, seed=17)
    tz, tm = torch.from_numpy(z), torch.from_numpy(mask)
    idx = tvq.draw_expiry(tz, tm, cb.shape, torch.Generator().manual_seed(1))
    new_cb, new_cs = tvq.expire_dead_codes_params(torch.from_numpy(cb), torch.from_numpy(cs), tz, idx, 15.0)
    dead = cs < 15.0
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(new_cb.numpy()[~dead], cb[~dead])
    np.testing.assert_array_equal(new_cs.numpy()[~dead], cs[~dead])
    assert (new_cs.numpy()[dead] == 15.0).all()
    valid_rows = {tuple(r) for r in z[mask].reshape(-1, 8)}
    got = new_cb.numpy()[dead]
    assert all(tuple(r) in valid_rows for r in got.reshape(-1, 8))
    if sep:  # a head's replacements come from that head's projections
        for i in range(cb.shape[0]):
            rows = {tuple(r) for r in z[:, :, i][mask]}
            assert all(tuple(r) in rows for r in new_cb.numpy()[i][dead[i]])
