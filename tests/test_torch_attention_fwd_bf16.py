"""The port's attention forward in bfloat16 against the JAX package, on the CPU.

With bfloat16 operands the Pallas forward kernel rounds p to bfloat16 before
the second product (``p.astype(v.dtype)``) and keeps the denominator and lse
from the unrounded float32 p.  The port's tensor-core forward kernel rounds p
the same way (it feeds p to the tensor cores as bfloat16), and so does
``attention_fwd_plain``, which is what runs here (the CUDA kernels cannot;
tests/test_torch_cuda.py holds them against the plain version on the card).
The JAX kernel runs in Pallas interpret mode, as tests/test_kernels.py runs it.

Tolerances: both sides take the same bfloat16 inputs, round p at the same
place and round o once, so they differ only where the order of the float32
sums (or the last bit of exp) moves a value across a rounding boundary: at
most one bfloat16 ulp of max |o|, in under 5 % of the elements.  lse is
float32 on both sides, from the same unrounded p: 2e-5.  In float32 the cast
does nothing, and the plain version's results are the bits of the formula it
had before the cast was written.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch import kernels as tk
from dct_autoencoder_torch.kernels import _build
from dct_autoencoder_torch.kernels import attention as tatt
from dct_autoencoder_tpu.kernels import attention as jatt
from test_torch_attention_bwd_bf16 import _bf16_ulp, _ids, _to_torch_bf16
from test_torch_kernels import _t, make_inputs


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s", [128, 160])
def test_bf16_forward_plain_matches_pallas(mode, s, causal):
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=s, d=32, seed=3)
    scale = 32**-0.5
    q_ids, kv_ids = _ids(ids, pad)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    o_j, lse_j = jatt._flash_attention_fwd_impl(jq, jk, jv, jnp.asarray(q_ids), jnp.asarray(kv_ids), scale, mode, causal, True)
    assert o_j.dtype == jnp.bfloat16
    o, lse = tatt.attention_fwd_plain(*map(_to_torch_bf16, (jq, jk, jv)), *_t(q_ids, kv_ids), scale, mode, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got, want = o.float().numpy(), np.asarray(o_j.astype(jnp.float32))
    diff = np.abs(got - want)
    assert diff.max() <= _bf16_ulp(np.abs(want).max()), (diff.max(), np.abs(want).max())
    assert (diff > 0).mean() < 0.05, (diff > 0).mean()
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j).reshape(2, 2, s), atol=2e-5, rtol=0)
    if mode == "block":
        assert (got.transpose(0, 2, 1, 3)[pad] == 0).all()


def _fwd_formula(q, k, v, q_ids, kv_ids, scale, mode, causal, round_to=None):
    """The forward written out as it was before the cast; with `round_to`, p is cast to it before P.V."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    if causal:
        pos = torch.arange(q.shape[2])
        allowed = allowed & (pos[None, :] <= pos[:, None])
    logits = logits + allowed.float() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, -1e9))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=-5e8)
    p = torch.exp(logits - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    pv = p if round_to is None else p.to(round_to).float()
    o = torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) / denom
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
def test_fp32_forward_plain_keeps_its_bits(mode, causal):
    """In float32 the plain forward gives the bits of the formula without any cast."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=160, d=32, seed=4)
    args = (*_t(q, k, v, *_ids(ids, pad)), 32**-0.5, mode, causal)
    got, want = tatt.attention_fwd_plain(*args), _fwd_formula(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_bf16_forward_plain_rounds_p(mode):
    """In bfloat16 the plain forward is the formula with p cast to bfloat16
    before P.V (lse from the unrounded p), and that cast does move o."""
    q, k, v, ids, pad = make_inputs(b=2, h=2, s=160, d=32, seed=6)
    tq, tk_, tv = (t.bfloat16() for t in _t(q, k, v))
    args = (tq, tk_, tv, *_t(*_ids(ids, pad)), 32**-0.5, mode, False)
    o, lse = tatt.attention_fwd_plain(*args)
    o_r, lse_r = _fwd_formula(*args, round_to=torch.bfloat16)
    o_u, lse_u = _fwd_formula(*args)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r) and torch.equal(lse, lse_u)
    assert not torch.equal(o, o_u)
    assert (o.float() - o_u.float()).abs().max() <= _bf16_ulp(o_u.float().abs().max().item())


def _forward_call(dtype, impl):
    q = torch.zeros((1, 2, 8, 32), dtype=dtype)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    return tatt.attention_fwd_cuda(q, q, q, ids, ids, 1.0, impl=impl)


@pytest.mark.parametrize(
    "dtype,impl,error", [(torch.float32, "mma", TypeError), (torch.bfloat16, "wgmma", ValueError), (torch.float32, "", ValueError)]
)
def test_bad_forward_impl_raises_before_anything_is_built(monkeypatch, dtype, impl, error):
    def no_build(name):
        raise AssertionError(f"the wrapper went on to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    tk.reset_launch_counts()
    with pytest.raises(error, match="impl|bfloat16"):
        _forward_call(dtype, impl)
    assert tk.fwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_forward_launches_nothing(dtype):
    """On CPU tensors the forward runs its plain version: no launch of either implementation is counted."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=40, d=32, seed=2)
    tk.reset_launch_counts()
    tq, tk_, tv = (t.to(dtype) for t in _t(q, k, v))
    o = tatt.packed_flash_attention(tq, tk_, tv, *_t(ids, pad), 32**-0.5)
    assert o.dtype == dtype
    assert tk.fwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 0}
    assert set(tk.launch_counts().values()) == {0}


def test_forward_kernel_info_checks_its_arguments():
    """The forward's instantiations are named as the backward's are; a bad one raises before anything is built."""
    with pytest.raises(TypeError, match="bfloat16"):
        tatt.attention_kernel_info("fwd", "mma", torch.float32, 64)
    with pytest.raises(ValueError, match="attention kernel"):
        tatt.attention_kernel_info("fwd_causal", "mma", torch.bfloat16, 64)
