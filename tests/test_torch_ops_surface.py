"""The port's numeric leftovers against the JAX package's ops on seeded inputs.

Mirrors tests/test_ops.py for ops/stats.py (pad_sequence, ema_update_2d),
ops/colorspace.py (LMS and YCbCr), ops/dct.py (dct1d, idct1d,
block_dct_basis), ops/zigzag.py and ops/masks.py.

Tolerances: float32 results within 1e-5 of JAX's (absolute, on values of
order 1); the float64 block basis within 1e-12; zigzag orders, masks and
integer results exactly equal.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from dct_autoencoder_torch.ops import colorspace as tc
from dct_autoencoder_torch.ops import dct as tdct
from dct_autoencoder_torch.ops import masks as tm
from dct_autoencoder_torch.ops import stats as ts
from dct_autoencoder_torch.ops import zigzag as tz
from dct_autoencoder_tpu.ops import colorspace as jc
from dct_autoencoder_tpu.ops import dct as jdct
from dct_autoencoder_tpu.ops import masks as jm
from dct_autoencoder_tpu.ops import stats as js

# the JAX package's ops/__init__ exports the function zigzag under the module's name
jz = importlib.import_module("dct_autoencoder_tpu.ops.zigzag")

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("fn", ["rgb_to_lms", "lms_to_rgb", "rgb_to_ycbcr", "ycbcr_to_rgb"])
def test_colorspace_matches_jax(fn):
    x = _rng(3).uniform(0.0, 1.0, size=(2, 3, 16, 12)).astype(np.float32)
    got = getattr(tc, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jc, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_ycbcr_and_lms_round_trips():
    """tests/test_ops.py:60 for the port, and LMS both ways."""
    x = torch.from_numpy(_rng(4).uniform(0.0, 1.0, size=(3, 8, 8)).astype(np.float32))
    np.testing.assert_allclose(tc.ycbcr_to_rgb(tc.rgb_to_ycbcr(x)).numpy(), x.numpy(), atol=ATOL)
    np.testing.assert_allclose(tc.lms_to_rgb(tc.rgb_to_lms(x)).numpy(), x.numpy(), atol=ATOL)


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_dct1d_idct1d_match_jax_and_scipy(axis):
    x = _rng(5).standard_normal((6, 14, 9)).astype(np.float32)
    got = tdct.dct1d(torch.from_numpy(x), axis).numpy()
    np.testing.assert_allclose(got, np.asarray(jdct.dct1d(jnp.asarray(x), axis)), atol=ATOL)
    np.testing.assert_allclose(got, scipy.fft.dct(x, axis=axis, norm="ortho"), atol=ATOL)
    back = tdct.idct1d(torch.from_numpy(got), axis).numpy()
    np.testing.assert_allclose(back, np.asarray(jdct.idct1d(jnp.asarray(got), axis)), atol=ATOL)
    np.testing.assert_allclose(back, x, atol=ATOL)


@pytest.mark.parametrize("p", [8, 14])
def test_block_dct_basis_matches_jax_and_dct2(p):
    """tests/test_ops.py:43: the Kronecker basis maps a flattened block to its 2-D DCT."""
    got = tdct.block_dct_basis(p, torch.float64).numpy()
    np.testing.assert_allclose(got, jdct.block_dct_basis(p, np.float64), atol=1e-12)
    x = _rng(2).standard_normal((p, p)).astype(np.float32)
    basis = tdct.block_dct_basis(p)
    out = (basis @ torch.from_numpy(x).reshape(-1)).reshape(p, p).numpy()
    np.testing.assert_allclose(out, scipy.fft.dctn(x, norm="ortho"), atol=1e-4)


@pytest.mark.parametrize("h,w", [(3, 3), (7, 5), (4, 9), (14, 14)])
def test_zigzag_orders_equal_jax(h, w):
    np.testing.assert_array_equal(tz.zigzag(h, w), jz.zigzag(h, w))
    if (h, w) == (3, 3):  # tests/test_ops.py:67
        np.testing.assert_array_equal(tz.zigzag(3, 3), [[0, 1, 5], [2, 4, 6], [3, 7, 8]])


def test_zigzag_flatten_matches_jax_and_round_trips():
    """tests/test_ops.py:73, and the flattened order equal to JAX's bit for bit."""
    x = _rng(5).standard_normal((2, 3, 7, 5)).astype(np.float32)
    flat = tz.flatten_zigzag(torch.from_numpy(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jz.flatten_zigzag(jnp.asarray(x))))
    np.testing.assert_array_equal(tz.unflatten_zigzag(flat, 7, 5).numpy(), x)
    np.testing.assert_array_equal(flat.numpy()[..., 0], x[..., 0, 0])
    zf = tz.ZigzagFlattener(7, 5)
    np.testing.assert_array_equal(zf.unflatten(zf.flatten(torch.from_numpy(x))).numpy(), x)
    with pytest.raises(ValueError):
        zf.flatten(torch.zeros(7, 6))


@pytest.mark.parametrize(
    "name,args",
    [
        ("get_upper_left_tri_p", ((3, 8, 8), 0.5)),
        ("get_upper_left_tri_p", ((2, 5, 9), 0.3)),
        ("get_upper_left_tri_p_w_channel_preferences", ((3, 8, 8), 0.3, (8, 1, 1))),
        ("get_upper_left_tri", ((3, 8, 8), 3)),
        ("get_upper_left_tri", ((6, 4), 1)),
        ("get_circular_mask", ((3, 8, 8), 0.5)),
        ("get_circular_mask", ((7, 10), 0.25)),
        ("get_square_dct_basis", (4,)),
        ("gkern", (16,)),
        ("gkern", (9, 2.0)),
    ],
)
def test_masks_equal_jax(name, args):
    """tests/test_ops.py:128: every mask and basis equal to JAX's exactly."""
    got, want = getattr(tm, name)(*args), getattr(jm, name)(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_fft_amp_phase_and_inverse_match_jax():
    """tests/test_ops.py:162."""
    x = _rng(7).standard_normal((2, 8, 8)).astype(np.float32)
    amp, ph = tm.fft_amp_phase(torch.from_numpy(x))
    jamp, jph = jm.fft_amp_phase(jnp.asarray(x))
    np.testing.assert_allclose(amp.numpy(), np.asarray(jamp), atol=ATOL)
    # the phase is compared through cos and sin: +-pi are the same angle
    for f in (np.cos, np.sin):
        np.testing.assert_allclose(f(ph.numpy()), f(np.asarray(jph)), atol=ATOL)
    back = tm.inverse_fft(amp, ph).numpy()
    np.testing.assert_allclose(back, np.asarray(jm.inverse_fft(jamp, jph)), atol=ATOL)
    np.testing.assert_allclose(back, x, atol=ATOL)


def test_pad_sequence_and_ema_match_jax():
    """tests/test_ops.py:171."""
    seqs = [_rng(8).standard_normal((2, 3)).astype(np.float32), _rng(9).standard_normal((4, 3)).astype(np.float32)]
    got = ts.pad_sequence(seqs, 5)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.pad_sequence(seqs, 5)))
    ints = [np.arange(3, dtype=np.int32), np.arange(1, dtype=np.int32)]
    np.testing.assert_array_equal(ts.pad_sequence(ints, 4).numpy(), np.asarray(js.pad_sequence(ints, 4)))
    with pytest.raises(ValueError):
        ts.pad_sequence(seqs, 3)

    old = _rng(10).standard_normal((2, 6, 5)).astype(np.float32)
    new = _rng(11).standard_normal((2, 3, 4)).astype(np.float32)
    old_t = torch.from_numpy(old.copy())
    got = ts.ema_update_2d(old_t, torch.from_numpy(new), alpha=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(js.ema_update_2d(jnp.asarray(old), jnp.asarray(new), 0.3)), atol=ATOL)
    np.testing.assert_array_equal(old_t.numpy(), old)  # functional, as in JAX
    upd = ts.ema_update_2d(torch.zeros(4, 4), torch.ones(2, 2), alpha=0.5).numpy()
    np.testing.assert_allclose(upd[:2, :2], 0.5)
    np.testing.assert_allclose(upd[2:, 2:], 0.0)


def test_new_modules_import_no_jax():
    """The tools and numerics of this slice import nothing of JAX or the JAX package."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import dct_autoencoder_torch.ops.zigzag, dct_autoencoder_torch.ops.masks, dct_autoencoder_torch.patches.native\n"
        "from dct_autoencoder_torch.tools import eval, prepare_autoregressive_dataset, decode_gif, diagnose, testpipe\n"
        "from dct_autoencoder_torch.tools import test_colorspaces, ab_report, nu_codebook_study, int8_study\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'dct_autoencoder_tpu'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, env={**os.environ, "PYTHONPATH": repo}, timeout=120)
