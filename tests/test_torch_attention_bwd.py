"""The port's attention backward against the JAX package, on the CPU.

The JAX backward kernels (dq, dk/dv) run in Pallas interpret mode, as
tests/test_kernels.py runs them.  The port's CUDA kernels cannot run here;
on CPU tensors the backward runs `attention_bwd_plain`, which is what these
tests hold against JAX (tests/test_torch_cuda.py holds the kernels against
the plain version on the card).

Tolerances: the plain backward against the Pallas backward on the same
saved o and lse atol 1e-4, rtol 1e-4 (as tests/test_kernels.py holds the
Pallas backward against its XLA reference); gradients through the
autograd.Function against jax.grad through the custom_vjp atol 1e-3,
rtol 1e-3 (as test_flash_gradients_match_reference); rows of padded queries
give dq exactly 0 in 'block' mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch import kernels as tk
from dct_autoencoder_torch.kernels import attention as tatt
from dct_autoencoder_tpu.kernels import attention as jatt
from test_torch_kernels import _t, make_inputs


def _ids(ids, pad):
    return np.where(pad, -2, ids).astype(np.int32), np.where(pad, -1, ids).astype(np.int32)


@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s", [128, 384, 160])
def test_attention_bwd_plain_matches_pallas(mode, s):
    """The inputs of tests/test_kernels.py::test_flash_bwd_kernels_match_xla_recompute."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=7)
    scale = 32**-0.5
    q_ids, kv_ids = _ids(ids, pad)
    jq, jk, jv, jqi, jki = map(jnp.asarray, (q, k, v, q_ids, kv_ids))
    o, lse = jatt._flash_attention_fwd_impl(jq, jk, jv, jqi, jki, scale, mode, False, True)
    do = np.random.default_rng(8).standard_normal(o.shape).astype(np.float32)
    want = jatt._flash_attention_bwd_impl(jq, jk, jv, jqi, jki, o, lse, jnp.asarray(do), scale, mode, False, True)
    got = tatt.attention_bwd_plain(
        *_t(q, k, v, q_ids, kv_ids, np.asarray(o), np.asarray(lse), do), scale, mode
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s,d", [(128, 16), (173, 32)])
def test_attention_autograd_matches_jax_grad(mode, s, d):
    """Gradients of sum(o^2) through the autograd.Function, including a ragged length."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=s, d=d, seed=3)
    scale = d**-0.5

    def loss(q, k, v):
        o = jatt.packed_flash_attention(q, k, v, jnp.asarray(ids), jnp.asarray(pad), scale, mode=mode, interpret=True)
        return jnp.sum(o**2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk_, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    tk.reset_launch_counts()
    o = tatt.packed_flash_attention(tq, tk_, tv, *_t(ids, pad), scale, mode=mode)
    assert o.grad_fn is not None and type(o.grad_fn).__name__.startswith("_PackedAttention")
    (o**2).sum().backward()
    for g, w in zip((tq.grad, tk_.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3)
    if mode == "block":
        assert (tq.grad.numpy().transpose(0, 2, 1, 3)[pad] == 0).all()
    # the CPU path never counts as a kernel launch
    assert set(tk.launch_counts().values()) == {0}


def test_attention_backward_takes_transposed_grad():
    """The head merge hands the backward a transposed view of grad_output."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=64, d=32, seed=4)
    grads = []
    for merge in (False, True):
        tq, tk_, tv = (t.requires_grad_(True) for t in _t(q, k, v))
        o = tatt.packed_flash_attention(tq, tk_, tv, *_t(ids, pad), 32**-0.5)
        w = torch.linspace(-1, 1, o.numel()).reshape(2, 64, 2 * 32)
        if merge:
            (o.transpose(1, 2).reshape(2, 64, 64) * w).sum().backward()
        else:
            (o * w.reshape(2, 64, 2, 32).transpose(1, 2)).sum().backward()
        grads.append([t.grad for t in (tq, tk_, tv)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_attention_without_grad_skips_the_function():
    q, k, v, ids, pad = _t(*make_inputs(b=1, h=1, s=16, d=32))
    assert tatt.packed_flash_attention(q, k, v, ids, pad, 1.0).grad_fn is None
    with torch.no_grad():
        out = tatt.packed_flash_attention(q.requires_grad_(True), k, v, ids, pad, 1.0)
    assert out.grad_fn is None


def test_backward_refuses_other_devices():
    q = torch.empty((1, 1, 4, 32), device="meta")
    ids = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    lse = torch.empty((1, 1, 4), device="meta")
    with pytest.raises(ValueError):
        tatt.attention_bwd(q, q, q, ids, ids, q, lse, q, 1.0)
