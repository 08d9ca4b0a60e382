"""The causal mode of the port's packed attention against the JAX package, on the CPU.

The JAX kernels (forward, dq, dk/dv, with ``causal=True``) run in Pallas
interpret mode, as tests/test_kernels.py runs them, and beside them JAX's
``_reference_attention``.  The port's CUDA kernels cannot run here; on CPU
tensors the wrappers run ``attention_fwd_plain`` and ``attention_bwd_plain``
with ``causal=True``, which is what these tests hold against JAX
(tests/test_torch_cuda.py holds the kernels against the plain versions on
the card).  Inputs are those of
tests/test_kernels.py::test_flash_causal_matches_reference.

Tolerances, as there: values atol 2e-5 on valid tokens; gradients of
sum(o^2) atol = rtol = 1e-3, with the outputs of padded queries masked on
both sides ('bias' mode masks nothing, so padded queries give non-zero
outputs the model never reads); no future leakage atol 1e-5 (and 2e-4
against JAX on values that the moved v raises to ~100).  Without
``causal`` the results are the same bits as before the argument existed.
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
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


def _ids(ids, pad):
    return np.where(pad, -2, ids).astype(np.int32), np.where(pad, -1, ids).astype(np.int32)


@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s", [128, 384, 160])
def test_causal_forward_matches_pallas_and_reference(mode, s):
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=11)
    scale = 32**-0.5
    q_ids, kv_ids = _ids(ids, pad)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = jatt.packed_flash_attention(
        jq, jk, jv, jnp.asarray(ids), jnp.asarray(pad), scale, mode=mode, causal=True, interpret=True
    )
    reference = jatt._reference_attention(jq, jk, jv, jnp.asarray(q_ids), jnp.asarray(kv_ids), scale, mode, causal=True)
    tk.reset_launch_counts()
    got = tatt.packed_flash_attention(*_t(q, k, v, ids, pad), scale, mode=mode, causal=True).numpy()
    valid = ~pad
    for want in (pallas, reference):
        np.testing.assert_allclose(
            got.transpose(0, 2, 1, 3)[valid], np.asarray(want).transpose(0, 2, 1, 3)[valid], atol=2e-5
        )
    # the saved log-sum-exp, which the backward recomputes p from
    _, lse_j = jatt._flash_attention_fwd_impl(
        jq, jk, jv, jnp.asarray(q_ids), jnp.asarray(kv_ids), scale, mode, True, True
    )
    _, lse_t = tatt.attention_fwd_plain(*_t(q, k, v, q_ids, kv_ids), scale, mode, causal=True)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j).reshape(lse_t.shape), atol=2e-5, rtol=1e-6)
    if mode == "block":
        assert (got.transpose(0, 2, 1, 3)[pad] == 0).all()
    # the CPU path never counts as a kernel launch
    assert set(tk.launch_counts().values()) == {0}


@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s", [128, 384, 160])
def test_causal_gradients_match_jax_grad(mode, s):
    """Gradients of q, k, v through the port's autograd.Function against jax.grad
    through the Pallas custom_vjp and through the reference."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=11)
    scale = 32**-0.5
    q_ids, kv_ids = _ids(ids, pad)
    jids, jpad = jnp.asarray(ids), jnp.asarray(pad)

    def loss_pallas(q, k, v):
        o = jatt.packed_flash_attention(q, k, v, jids, jpad, scale, mode=mode, causal=True, interpret=True)
        return jnp.sum((o * (~jpad)[:, None, :, None]) ** 2)

    def loss_ref(q, k, v):
        o = jatt._reference_attention(q, k, v, jnp.asarray(q_ids), jnp.asarray(kv_ids), scale, mode, causal=True)
        return jnp.sum((o * (~jpad)[:, None, :, None]) ** 2)

    tq, tk_, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    tids, tpad = _t(ids, pad)
    o = tatt.packed_flash_attention(tq, tk_, tv, tids, tpad, scale, mode=mode, causal=True)
    assert type(o.grad_fn).__name__.startswith("_PackedAttention")
    ((o * (~tpad)[:, None, :, None]) ** 2).sum().backward()
    for loss in (loss_pallas, loss_ref):
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        for g, w in zip((tq.grad, tk_.grad, tv.grad), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_causal_backward_plain_matches_pallas_kernels(mode):
    """The plain backward against the two Pallas backward kernels on the same saved o and lse."""
    s = 384
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=7)
    scale = 32**-0.5
    q_ids, kv_ids = _ids(ids, pad)
    jq, jk, jv, jqi, jki = map(jnp.asarray, (q, k, v, q_ids, kv_ids))
    o, lse = jatt._flash_attention_fwd_impl(jq, jk, jv, jqi, jki, scale, mode, True, True)
    do = np.random.default_rng(8).standard_normal(o.shape).astype(np.float32)
    want = jatt._flash_attention_bwd_impl(jq, jk, jv, jqi, jki, o, lse, jnp.asarray(do), scale, mode, True, True)
    got = tatt.attention_bwd_plain(
        *_t(q, k, v, q_ids, kv_ids, np.asarray(o), np.asarray(lse).reshape(2, 2, s), do), scale, mode, causal=True
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_causal_no_future_leakage(mode):
    """A token's output does not depend on strictly later keys and values.  In
    'bias' mode later keys do take part in the softmax (only the +1 is
    causal), as in the JAX kernel, so there the outputs must move."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=256, d=16, n_img=2, seed=12)
    scale = 16**-0.5
    base = tatt.packed_flash_attention(*_t(q, k, v, ids, pad), scale, mode=mode, causal=True).numpy()
    cut = 100
    v2, k2 = v.copy(), k.copy()
    v2[:, :, cut:, :] += 100.0
    k2[:, :, cut:, :] += 3.0
    moved = tatt.packed_flash_attention(*_t(q, k2, v2, ids, pad), scale, mode=mode, causal=True).numpy()
    want = np.asarray(jatt.packed_flash_attention(
        *map(jnp.asarray, (q, k2, v2, ids, pad)), scale, mode=mode, causal=True, interpret=True
    ))
    valid_pre = ~pad[0, :cut]
    np.testing.assert_allclose(moved[0, :, :cut][:, valid_pre], want[0, :, :cut][:, valid_pre], atol=2e-4)
    if mode == "block":
        np.testing.assert_allclose(base[0, :, :cut][:, valid_pre], moved[0, :, :cut][:, valid_pre], atol=1e-5)
        assert np.abs(base[0, :, cut:] - moved[0, :, cut:]).max() > 1
    else:
        assert np.abs(base[0, :, :cut][:, valid_pre] - moved[0, :, :cut][:, valid_pre]).max() > 1


def test_causal_differs_from_non_causal_only_by_the_triangle():
    """Row i of the causal result is the non-causal result over keys 0..i."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=48, d=32, n_img=2, seed=2)
    scale = 32**-0.5
    causal = tatt.packed_flash_attention(*_t(q, k, v, ids, pad), scale, causal=True).numpy()
    for i in (0, 7, 31, 47):
        if pad[0, i]:
            continue
        upto = tatt.packed_flash_attention(
            *_t(q[:, :, : i + 1], k[:, :, : i + 1], v[:, :, : i + 1], ids[:, : i + 1], pad[:, : i + 1]), scale
        ).numpy()
        np.testing.assert_allclose(causal[0, :, i], upto[0, :, i], atol=1e-5)


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_non_causal_results_are_unchanged_bit_for_bit(mode):
    """causal=False, and the argument left out, give the bits of the formulas
    written out here, which are those of the wrappers without the argument."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=160, d=32, seed=5)
    scale = 32**-0.5
    tq, tk_, tv, tqi, tki = _t(q, k, v, *_ids(ids, pad))
    logits = torch.einsum("bhqd,bhkd->bhqk", tq, tk_) * scale
    allowed = tqi[:, None, :, None] == tki[:, None, None, :]
    logits = logits + allowed.float() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, -1e9))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=-5e8)
    p = torch.exp(logits - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    o_want = torch.einsum("bhqk,bhkd->bhqd", p, tv) / denom
    lse_want = (m + torch.log(denom))[..., 0]
    for kwargs in ({}, {"causal": False}):
        o, lse = tatt.attention_fwd_plain(tq, tk_, tv, tqi, tki, scale, mode, **kwargs)
        assert torch.equal(o, o_want) and torch.equal(lse, lse_want)
        o2 = tatt.packed_flash_attention(tq, tk_, tv, *_t(ids, pad), scale, mode=mode, **kwargs)
        assert torch.equal(o2, o_want)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(q.shape).astype(np.float32))
    a = tatt.attention_bwd_plain(tq, tk_, tv, tqi, tki, o_want, lse_want, do, scale, mode)
    b = tatt.attention_bwd_plain(tq, tk_, tv, tqi, tki, o_want, lse_want, do, scale, mode, causal=False)
    c = tatt.attention_bwd_plain(tq, tk_, tv, tqi, tki, o_want, lse_want, do, scale, mode, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
