"""The port's attention backward in bfloat16 against the JAX package, on the CPU.

With bfloat16 operands the Pallas backward kernels round p and ds to
bfloat16 before the second products (``ds.astype(q.dtype)``,
``p_t.astype(do.dtype)``, ``ds_t.astype(q.dtype)``) and sum in float32.  The
port's tensor-core kernels do the same, and so does ``attention_bwd_plain``,
which is what runs here (the CUDA kernels cannot; tests/test_torch_cuda.py
holds them against the plain version on the card).  The JAX kernels run in
Pallas interpret mode, as tests/test_kernels.py runs them.

Tolerances: both sides take the same bfloat16 inputs, the same saved o and
lse, round p and ds at the same places and round the result once, so they
differ by the order of the float32 sums, which now and then moves a value
across a rounding boundary of p, ds or the result: at most one bfloat16 ulp
of the largest gradient (2^-8 to 2^-7 of it), and nothing at all in most
elements.  Through the whole autograd.Function the forward takes part too;
the plain forward rounds p to bfloat16 before P.V as the Pallas forward does
(tests/test_torch_attention_fwd_bf16.py), so the gradients stay within the
same one ulp of the largest (measured: an eighth of one).
In float32 the casts do nothing, and the plain version's results are the
bits of the formula it had before the casts were written.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.kernels import _build
from dct_autoencoder_torch.kernels import attention as tatt
from dct_autoencoder_tpu.kernels import attention as jatt
from test_torch_kernels import _t, make_inputs


def _ids(ids, pad):
    return np.where(pad, -2, ids).astype(np.int32), np.where(pad, -1, ids).astype(np.int32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _to_torch_bf16(x) -> torch.Tensor:
    """A JAX or numpy array as a bfloat16 tensor (exact for values that are bfloat16 already)."""
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s", [128, 160])
def test_bf16_backward_plain_matches_pallas(mode, s, causal):
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=7)
    scale = 32**-0.5
    q_ids, kv_ids = _ids(ids, pad)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    jqi, jki = jnp.asarray(q_ids), jnp.asarray(kv_ids)
    o, lse = jatt._flash_attention_fwd_impl(jq, jk, jv, jqi, jki, scale, mode, causal, True)
    assert o.dtype == jnp.bfloat16 and lse.dtype == jnp.float32
    do = jnp.asarray(np.random.default_rng(8).standard_normal(o.shape).astype(np.float32)).astype(jnp.bfloat16)
    want = jatt._flash_attention_bwd_impl(jq, jk, jv, jqi, jki, o, lse, do, scale, mode, causal, True)
    got = tatt.attention_bwd_plain(
        *map(_to_torch_bf16, (jq, jk, jv)), *_t(q_ids, kv_ids), _to_torch_bf16(o),
        torch.from_numpy(np.asarray(lse)).reshape(2, 2, s), _to_torch_bf16(do), scale, mode, causal,
    )
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        diff = np.abs(g - w)
        assert diff.max() <= _bf16_ulp(np.abs(w).max()), (name, diff.max(), np.abs(w).max())
        assert (diff > 0).mean() < 0.05, (name, (diff > 0).mean())
    if mode == "block":
        assert (got[0].float().numpy().transpose(0, 2, 1, 3)[pad] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
def test_bf16_autograd_matches_jax_grad(mode, causal):
    """Gradients of sum((o * valid)^2) through the autograd.Function in bfloat16
    against jax.grad through the Pallas custom_vjp on the same bfloat16 inputs."""
    s = 160
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=11)
    scale = 32**-0.5
    jids, jpad = jnp.asarray(ids), jnp.asarray(pad)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))

    def loss(q, k, v):
        o = jatt.packed_flash_attention(q, k, v, jids, jpad, scale, mode=mode, causal=causal, interpret=True)
        return jnp.sum((o.astype(jnp.float32) * (~jpad)[:, None, :, None]) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk_, tv = (_to_torch_bf16(x).requires_grad_(True) for x in (jq, jk, jv))
    tids, tpad = _t(ids, pad)
    o = tatt.packed_flash_attention(tq, tk_, tv, tids, tpad, scale, mode=mode, causal=causal)
    assert o.dtype == torch.bfloat16
    ((o.float() * (~tpad)[:, None, :, None]) ** 2).sum().backward()
    for g, w in zip((tq.grad, tk_.grad, tv.grad), want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= _bf16_ulp(np.abs(w).max())


def _bwd_formula(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, round_to=None):
    """The backward written out; with `round_to`, p and ds are cast to it before the second products."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    if causal:
        pos = torch.arange(q.shape[2])
        allowed = allowed & (pos[None, :] <= pos[:, None])
    logits = logits + allowed.float() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, -1e9))
    p = torch.exp(logits - lse[..., None])
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    if round_to is not None:
        p, ds = p.to(round_to).float(), ds.to(round_to).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
def test_fp32_backward_plain_keeps_its_bits(mode, causal):
    """In float32 the plain version gives the bits of the formula without any cast."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=160, d=32, seed=5)
    scale = 32**-0.5
    tq, tk_, tv, tqi, tki = _t(q, k, v, *_ids(ids, pad))
    o, lse = tatt.attention_fwd_plain(tq, tk_, tv, tqi, tki, scale, mode, causal)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(q.shape).astype(np.float32))
    got = tatt.attention_bwd_plain(tq, tk_, tv, tqi, tki, o, lse, do, scale, mode, causal)
    want = _bwd_formula(tq, tk_, tv, tqi, tki, o, lse, do, scale, mode, causal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_bf16_backward_plain_rounds_p_and_ds(mode):
    """In bfloat16 the plain version is the formula with p and ds cast to
    bfloat16 before the second products, and that cast does move results."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=160, d=32, seed=6)
    scale = 32**-0.5
    tq, tk_, tv = (t.bfloat16() for t in _t(q, k, v))
    tqi, tki = _t(*_ids(ids, pad))
    o, lse = tatt.attention_fwd_plain(tq, tk_, tv, tqi, tki, scale, mode)
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)).bfloat16()
    got = tatt.attention_bwd_plain(tq, tk_, tv, tqi, tki, o, lse, do, scale, mode)
    rounded = _bwd_formula(tq, tk_, tv, tqi, tki, o, lse, do, scale, mode, False, round_to=torch.bfloat16)
    unrounded = _bwd_formula(tq, tk_, tv, tqi, tki, o, lse, do, scale, mode, False)
    assert all(torch.equal(g, w) for g, w in zip(got, rounded))
    assert any(not torch.equal(g, w) for g, w in zip(got, unrounded))
    for g, w in zip(got, unrounded):
        assert (g.float() - w.float()).abs().max() <= _bf16_ulp(w.float().abs().max().item())


def _backward_call(kernel, dtype, impl):
    q = torch.zeros((1, 2, 8, 32), dtype=dtype)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    rows = torch.zeros((1, 2, 8))
    if kernel == "dq":
        return tatt.attention_dq_cuda(q, q, q, ids, ids, q, rows, q, 1.0, impl=impl)
    return tatt.attention_dkv_cuda(q, q, q, ids, ids, rows, rows, q, 1.0, impl=impl)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize(
    "dtype,impl,error", [(torch.float32, "mma", TypeError), (torch.bfloat16, "wgmma", ValueError), (torch.float32, "", ValueError)]
)
def test_bad_impl_raises_before_anything_is_built(monkeypatch, kernel, dtype, impl, error):
    def no_build(name):
        raise AssertionError(f"the wrapper went on to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(error, match="impl|bfloat16"):
        _backward_call(kernel, dtype, impl)
    assert all(n == 0 for n in tatt.LAUNCHES_BWD_IMPL.values())


def test_default_impl_follows_the_dtype():
    assert tatt._kernel_impl(None, torch.bfloat16) == "mma"
    assert tatt._kernel_impl(None, torch.float32) == "tf32x3"  # float32's tensor-core kernels, in 3xTF32
    assert tatt._kernel_impl("simt", torch.bfloat16) == "simt"
    assert tatt._kernel_impl("simt", torch.float32) == "simt"
    assert tatt._kernel_impl("mma", torch.bfloat16) == "mma"
    assert tatt.IMPLS.index("simt") == 0 and tatt.IMPLS.index("mma") == 1  # the C entry points' numbers
    with pytest.raises(ValueError, match="attention kernel"):
        tatt.attention_kernel_info("dv", "mma", torch.bfloat16, 64)
