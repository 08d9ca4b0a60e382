"""Parity of the PyTorch port's colour space and DCT with the JAX package.

Inputs are made with numpy from a seed and fed to both packages on the CPU.
Tolerance: atol 2e-4 on every output (fp32 on both sides; the DCT's DC
coefficient at these sizes is about 25, so this is ~1e-5 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.ops import colorspace as tcs
from dct_autoencoder_torch.ops import dct as tdct
from dct_autoencoder_tpu.ops import colorspace as jcs
from dct_autoencoder_tpu.ops import dct as jdct
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

ATOL = 2e-4
SHAPES = [(40, 56), (43, 61)]


def _rgb(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, size=(2, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("fn", ["rgb_to_ipt", "ipt_to_rgb"])
def test_colorspace_matches_jax(fn, hw):
    x = _rgb(*hw)
    if fn == "ipt_to_rgb":
        x = np.array(jcs.rgb_to_ipt(jnp.asarray(x)))
    want = np.asarray(getattr(jcs, fn)(jnp.asarray(x)))
    got = getattr(tcs, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("fn", ["dct2", "idct2"])
def test_dct_matches_jax(fn, hw):
    x = np.array(jcs.rgb_to_ipt(jnp.asarray(_rgb(*hw, seed=1))))
    if fn == "idct2":
        x = np.array(jdct.dct2(jnp.asarray(x)))
    want = np.asarray(getattr(jdct, fn)(jnp.asarray(x)))
    got = getattr(tdct, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [14, 43, 448])
def test_dct_matrix_matches_jax(n):
    """Built in float64 and cast: the fp32 matrices are bit-identical."""
    np.testing.assert_array_equal(tdct.dct_matrix(n).numpy(), jdct.dct_matrix(n, np.float32))


def test_colour_constants_match_jax():
    np.testing.assert_array_equal(tcs.RGB2LMS, jcs._RGB2LMS)
    np.testing.assert_array_equal(tcs.M_IPT, jcs._M_IPT)
    np.testing.assert_array_equal(tcs.IPT2LMS, jcs._IPT2LMS)
    np.testing.assert_array_equal(tcs.LMS2RGB, jcs._LMS2RGB)
    assert tcs.IPT_GAMMA == jcs.IPT_GAMMA


def test_dct_roundtrip_is_identity():
    x = torch.from_numpy(_rgb(43, 61, seed=2))
    np.testing.assert_allclose(tdct.idct2(tdct.dct2(x)).numpy(), x.numpy(), atol=1e-5)
