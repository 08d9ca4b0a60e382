"""Every head dim 1 <= d <= 128 in the port's attention, on the CPU.

The kernels are compiled for d = 16, 32, 64 and 128.  The tensor-core
kernels read rows of d in place where a row is whole 16-byte chunks (their
loads zero-fill the rest; tests/test_torch_attention_fwd_tf32x3.py holds the
rule, the card tests the bits); elsewhere the ``*_cuda`` wrappers pad q, k,
v (and o, do) with zero columns up to the next instantiation and cut the
results back.  Both compute what padding computes.  Here the padding is held to the unpadded plain
version (it is exact: zero columns add nothing to q.k and a padded v column
only makes an o column that is cut off), and the plain version, which the
CPU runs, to the JAX package's Pallas attention in interpret mode at head
dims the JAX tests and tools use (16 in its AR tests; 24 and 48 from
``tools/train_ar_example.py``'s ``max(hidden // 64, 4)`` heads; 128).

Tolerances: padded against unpadded atol 1e-6; against Pallas the forward
atol 2e-5 (as tests/test_torch_kernels.py) and the gradients of sum(o^2)
atol 1e-4 x the largest entry (fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch import kernels as tk
from dct_autoencoder_torch.kernels import _build
from dct_autoencoder_torch.kernels import attention as tatt
from dct_autoencoder_tpu.kernels import attention as jatt
from test_torch_kernels import _t, make_inputs
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


@pytest.mark.parametrize("d,want", [(1, 16), (15, 16), (16, 16), (17, 32), (24, 32), (33, 64), (48, 64), (80, 128), (128, 128)])
def test_kernel_head_dim_is_the_next_instantiation(d, want):
    assert tatt.kernel_head_dim(d) == want and want in tatt.HEAD_DIMS


@pytest.mark.parametrize("d", [0, 129, 256])
def test_head_dims_past_the_instantiations_raise_by_name(d, monkeypatch):
    with pytest.raises(ValueError, match="head dim"):
        tatt.kernel_head_dim(d)

    def no_build(name):
        raise AssertionError(f"the wrapper went on to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    q = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        tatt.attention_fwd_cuda(q, q, q, ids, ids, 1.0)
    assert set(tk.launch_counts().values()) == {0}


@pytest.mark.parametrize("d", [1, 5, 16, 24, 48, 80, 100, 128])
@pytest.mark.parametrize("mode,causal,rate", [("block", False, 0.0), ("bias", False, 0.2), ("block", True, 0.2)])
def test_zero_padding_gives_the_unpadded_result(d, mode, causal, rate):
    """The wrappers' padding (pad_head_dim to kernel_head_dim) through the
    plain versions, cut back, against the plain versions at d: forward and
    both backward kernels, with and without dropout."""
    q, k, v, ids, pad = make_inputs(b=2, h=3, s=70, d=d, seed=d)
    do = np.random.default_rng(d + 1).standard_normal(q.shape).astype(np.float32)
    q, k, v, do = _t(q, k, v, do)
    q_ids, kv_ids = tatt.segment_ids(*_t(ids, pad))
    scale = d**-0.5
    drop = tatt.AttentionDropout(rate, torch.tensor([11], dtype=torch.int64), row0=1, head0=2) if rate else None
    dim = tatt.kernel_head_dim(d)
    padded = [tatt.pad_head_dim(t, dim) for t in (q, k, v, do)]
    assert all(t.shape[-1] == dim and t.is_contiguous() for t in padded)
    assert all(torch.equal(p[..., :d], t) and not p[..., d:].any() for p, t in zip(padded, (q, k, v, do)))
    qp, kp, vp, dop = padded

    o, lse = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal, drop)
    op, lsep = tatt.attention_fwd_plain(qp, kp, vp, q_ids, kv_ids, scale, mode, causal, drop)
    torch.testing.assert_close(op[..., :d], o, atol=1e-6, rtol=0)
    torch.testing.assert_close(lsep, lse, atol=1e-6, rtol=0)
    assert not op[..., d:].any()
    want = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, drop)
    got = tatt.attention_bwd_plain(qp, kp, vp, q_ids, kv_ids, op, lsep, dop, scale, mode, causal, drop)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :d], w, atol=1e-6, rtol=0)
        assert not g[..., d:].any()


@pytest.mark.parametrize("d", [16, 24, 48, 128])
@pytest.mark.parametrize("mode,causal", [("block", False), ("bias", False), ("block", True)])
def test_plain_matches_pallas_at_head_dim(d, mode, causal):
    """packed_flash_attention (the plain versions under autograd on the CPU)
    against JAX's packed_flash_attention in interpret mode: o and the
    gradients of sum(o^2)."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=40, d=d, seed=100 + d)
    scale = d**-0.5

    def loss(q, k, v):
        o = jatt.packed_flash_attention(q, k, v, jnp.asarray(ids), jnp.asarray(pad), scale, mode=mode, causal=causal,
                                        interpret=True)
        return jnp.sum(o**2), o

    (_, o_jax), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    o = tatt.packed_flash_attention(tq, tk_, tv, *_t(ids, pad), scale, mode=mode, causal=causal)
    (o**2).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_jax), atol=2e-5)
    for g, w in zip((tq.grad, tk_.grad, tv.grad), grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max())
