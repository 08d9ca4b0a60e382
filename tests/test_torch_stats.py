"""The port's ops/stats.py against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  Tolerances: rtol 1e-5 on values
(atol 1e-6 where a value may be 0); on the gradient of the entropy loss
w.r.t. the affinities rtol 1e-4 plus atol 1e-5 x the largest gradient entry
(a softmax at temperature 0.01 in fp32 on both sides: entries many orders
below the largest carry the rounding of the large ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.ops import stats as ts
from dct_autoencoder_tpu.ops import stats as js
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


@pytest.mark.parametrize("dim", [None, 0])
@pytest.mark.parametrize("mask_kind", ["mixed", "all_zero"])
def test_masked_mean_matches_jax(dim, mask_kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4, 5)).astype(np.float32)
    m = rng.random((3, 7)) > 0.4 if mask_kind == "mixed" else np.zeros((3, 7), bool)
    want = np.asarray(js.masked_mean(jnp.asarray(x), jnp.asarray(m), dim=dim))
    got = ts.masked_mean(torch.from_numpy(x), torch.from_numpy(m), dim=dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if mask_kind == "all_zero":
        assert np.isfinite(got).all() and (got == 0).all()


def test_mult_along_first_dims_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    m = rng.standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ts.mult_along_first_dims(torch.from_numpy(x), torch.from_numpy(m)).numpy(),
        np.asarray(js.mult_along_first_dims(jnp.asarray(x), jnp.asarray(m))),
    )


@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_entropy_loss_value_and_gradient_match_jax(scale):
    """scale 1.0 gives nearly one-hot rows at temperature 0.01, scale 0.02 soft ones."""
    rng = np.random.default_rng(2)
    aff = (rng.standard_normal((2, 9, 3, 16)) * scale).astype(np.float32)
    mask = rng.random((2, 9)) > 0.3
    want, want_grad = jax.value_and_grad(js.compute_entropy_loss)(jnp.asarray(aff), jnp.asarray(mask))
    t = torch.from_numpy(aff).requires_grad_(True)
    got = ts.compute_entropy_loss(t, torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(t.grad.numpy(), want_grad, rtol=1e-4, atol=1e-5 * np.abs(want_grad).max())
    # padded tokens get no gradient
    assert (t.grad.numpy()[~mask] == 0).all()
    # without autograd the value is the same
    with torch.no_grad():
        assert ts.compute_entropy_loss(t, torch.from_numpy(mask)).item() == pytest.approx(got.item(), rel=1e-6)


def test_entropy_loss_all_padding_is_finite():
    aff = torch.randn(1, 4, 2, 8, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(1, 4, dtype=torch.bool)
    want = float(js.compute_entropy_loss(jnp.asarray(aff.numpy()), jnp.asarray(mask.numpy())))
    got = ts.compute_entropy_loss(aff, mask).item()
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_null", [False, True])
def test_perplexity_matches_jax(with_null):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 64, size=(2, 11, 4))
    if with_null:
        codes[rng.random(codes.shape) > 0.6] = -1
    want = float(js.calculate_perplexity(jnp.asarray(codes), 64))
    got = ts.calculate_perplexity(torch.from_numpy(codes), 64).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got >= 1.0


def test_perplexity_of_no_codes_is_one():
    codes = torch.full((2, 3), -1)
    assert ts.calculate_perplexity(codes, 16).item() == 1.0


def test_decay_fn_and_psnr_match_jax():
    fj, ft = js.get_decay_fn(2.0, 0.5, 10), ts.get_decay_fn(2.0, 0.5, 10)
    assert [fj(i) for i in range(13)] == [ft(i) for i in range(13)]
    rng = np.random.default_rng(4)
    a, b = rng.random((3, 8, 8)), rng.random((3, 8, 8)) * 1.2 - 0.1
    assert ts.psnr(a, b) == js.psnr(a, b)
    assert ts.psnr(a, a) == 120.0
