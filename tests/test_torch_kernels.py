"""Each kernel's plain PyTorch version against the JAX kernel on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_kernels.py runs
them.  The port's CUDA kernels cannot run here; on a CPU tensor every
wrapper runs its plain version, which is what these tests hold against
JAX.  (tests/test_torch_cuda.py holds the kernels against the plain
versions on the card.)

Tolerances: attention in fp32 atol 2e-5 on outputs and on lse (as
tests/test_kernels.py); padded queries give exactly 0 in 'block' mode.  The
DCT kernels atol 2e-4 (as tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch import kernels as tk
from dct_autoencoder_torch.kernels import attention as tatt
from dct_autoencoder_torch.kernels import dct_patchify as tdp
from dct_autoencoder_torch.kernels import idct_unpatchify as tid
from dct_autoencoder_tpu.kernels import attention as jatt
from dct_autoencoder_tpu.kernels.dct_patchify import fused_ipt_dct_patchify
from dct_autoencoder_tpu.kernels.idct_unpatchify import fused_idct_unpatchify_rgb
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


def make_inputs(b=2, h=4, s=128, d=32, n_img=3, seed=0):
    """Same recipe as tests/test_kernels.py::make_inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    ids = np.sort(rng.integers(0, n_img, size=(b, s))).astype(np.int32)
    lengths = rng.integers(s // 2, s, size=(b,))
    pad = np.arange(s)[None, :] >= lengths[:, None]
    return q, k, v, ids, pad


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s,d", [(128, 32), (173, 64)])
def test_attention_plain_matches_jax(mode, s, d):
    q, k, v, ids, pad = make_inputs(s=s, d=d, seed=s)
    scale = d**-0.5
    q_ids = np.where(pad, -2, ids).astype(np.int32)
    kv_ids = np.where(pad, -1, ids).astype(np.int32)
    o_j, lse_j = jatt._flash_attention_fwd_impl(
        *map(jnp.asarray, (q, k, v, q_ids, kv_ids)), scale, mode, False, True
    )
    o_t, lse_t = tatt.attention_fwd_plain(*_t(q, k, v, q_ids, kv_ids), scale, mode)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-5, rtol=1e-6)
    padded = o_t.numpy().transpose(0, 2, 1, 3)[pad]
    if mode == "block":
        assert (padded == 0).all()
    else:
        # bias mode: a padded query attends to every key, as in JAX
        assert np.abs(padded).max() > 0


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_packed_flash_attention_matches_jax(mode):
    """The public wrapper on CPU tensors (ids + padding in, o out)."""
    q, k, v, ids, pad = make_inputs(seed=5)
    scale = 32**-0.5
    want = np.asarray(
        jatt.packed_flash_attention(*map(jnp.asarray, (q, k, v, ids, pad)), scale, mode=mode, interpret=True)
    )
    tk.reset_launch_counts()
    got = tatt.packed_flash_attention(*_t(q, k, v, ids, pad), scale, mode=mode).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the CPU path never counts as a kernel launch
    assert tk.launch_counts()["attention"] == 0


def test_attention_block_structure():
    """A token's output depends only on tokens of its own image."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=96, d=32, n_img=2, seed=1)
    scale = 32**-0.5
    base = tatt.packed_flash_attention(*_t(q, k, v, ids, pad), scale).numpy()
    img1 = (ids[0] == 1) & ~pad[0]
    v2 = v.copy()
    v2[:, :, img1] += 100.0
    moved = tatt.packed_flash_attention(*_t(q, k, v2, ids, pad), scale).numpy()
    img0 = (ids[0] == 0) & ~pad[0]
    np.testing.assert_allclose(base[0][:, img0], moved[0][:, img0], atol=1e-5)
    assert np.abs(base[0][:, img1] - moved[0][:, img1]).max() > 1


def test_attention_causal_not_ported():
    """causal=True is computed, not refused (tests/test_torch_attention_causal.py
    holds it against JAX): the first row of an image sees only itself."""
    q, k, v, ids, pad = _t(*make_inputs(b=1, h=1, s=8, d=32))
    out = tatt.packed_flash_attention(q, k, v, ids, pad, 1.0, causal=True)
    torch.testing.assert_close(out[0, 0, 0], v[0, 0, 0])
    assert not torch.equal(out, tatt.packed_flash_attention(q, k, v, ids, pad, 1.0))


def _planes_from_tokens(tokens, ch, cw, p):
    b = tokens.shape[0]
    return (
        tokens.reshape(b, ch // p, cw // p, 3, p, p).transpose(0, 3, 1, 4, 2, 5).reshape(b, 3, ch, cw)
    )


@pytest.mark.parametrize("hw,crop", [((40, 56), (40, 56)), ((43, 61), (40, 56))])
def test_dct_patchify_plain_matches_jax(hw, crop):
    rng = np.random.default_rng(hw[0])
    x = rng.uniform(0.05, 0.95, size=(2, 3, *hw)).astype(np.float32)
    want = np.asarray(fused_ipt_dct_patchify(jnp.asarray(x), 8, *crop, interpret=True))
    tk.reset_launch_counts()
    got = tdp.fused_ipt_dct_patchify(torch.from_numpy(x), 8, *crop).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_array_equal(got, tdp.fused_ipt_dct_patchify_plain(torch.from_numpy(x), 8, *crop).numpy())
    assert tk.launch_counts()["dct_patchify"] == 0


@pytest.mark.parametrize("out_hw", [(40, 56), (43, 61)])
def test_idct_unpatchify_plain_matches_jax(out_hw):
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((2, 3, 40, 56)) * 0.2).astype(np.float32)
    want = np.asarray(fused_idct_unpatchify_rgb(jnp.asarray(y), *out_hw, interpret=True))
    tk.reset_launch_counts()
    got = tid.fused_idct_unpatchify_rgb(torch.from_numpy(y), *out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert tk.launch_counts()["idct_unpatchify"] == 0


def test_dct_kernels_are_inverses():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0.1, 0.9, size=(1, 3, 40, 56)).astype(np.float32))
    tokens = tdp.fused_ipt_dct_patchify_plain(x, 8, 40, 56).numpy()
    planes = torch.from_numpy(_planes_from_tokens(tokens, 40, 56, 8))
    back = tid.fused_idct_unpatchify_rgb_plain(planes, 40, 56)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=2e-3)


@pytest.mark.parametrize("wrapper", ["attention", "dct_patchify", "idct_unpatchify"])
def test_wrappers_refuse_other_devices(wrapper):
    """A tensor that is neither on the CPU nor on CUDA is refused, never run plain."""
    meta = torch.empty((1, 3, 16, 16), device="meta")
    with pytest.raises(ValueError):
        if wrapper == "attention":
            q = torch.empty((1, 1, 4, 32), device="meta")
            ids = torch.zeros((1, 4), dtype=torch.int32, device="meta")
            tatt.attention_fwd(q, q, q, ids, ids, 1.0)
        elif wrapper == "dct_patchify":
            tdp.fused_ipt_dct_patchify(meta, 8, 16, 16)
        else:
            tid.fused_idct_unpatchify_rgb(meta, 16, 16)
