"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: attention atol 2e-2 in bf16 and 1e-5 in fp32 on o, 1e-4 on lse;
padded queries exactly 0 in 'block' mode, and a fully masked row has lse =
-5e8 + log(1e-9) exactly.  In bf16 the forward multiplies on the tensor cores
and rounds p to bf16 before P.V, as the plain version does; it is also held
against the CUDA-core forward (`impl="simt"`, p in fp32) to the larger of
2e-2 and one bf16 ulp of max |o|, and two launches, and causal launches with
and without tile skipping, to the same bits.  The attention backward (dq, dk,
dv) atol 3e-2 in bf16 (one bf16 rounding of values up to ~4 at the store)
and 1e-5 in fp32; dq of padded queries exactly 0 in 'block' mode.  The causal
mode of the three kernels is held to the same limits, and with and without
its tile skipping to the same bits.  In bf16 the backward kernels multiply on
the tensor cores and round p and ds to bf16, as the plain version does; they
are also held against the CUDA-core kernels (`impl="simt"`, p and ds in
fp32), to the larger of 3e-2 and one bf16 ulp of the largest gradient (two
results rounded once each can land one ulp apart, which from |g| = 4 on is
3.1e-2), and two launches on the same inputs to the same bits.  In fp32
the forward and the backward kernels multiply on the tensor cores in 3xTF32
(impl tf32x3); they are held to 1e-5 of the largest value against the plain
version and against the CUDA-core kernels (impl simt), and against float64
to at most 8 x the fp32 plain version's error
(tests/test_torch_attention_fwd_tf32x3.py and
tests/test_torch_attention_bwd_tf32x3.py argue the limit on the CPU).  The
tensor-core kernels read head dims between the instantiations in place;
they are held to the wrappers' padded run bit for bit.  DCT and
IDCT (products on the tensor cores in 3xTF32) max|diff| <= 1e-5 x
max|value| against the fp32 plain version; against the float64 plain
version, each kernel's largest error at most 8 x the fp32 plain
version's, over the whole output and over the high-frequency quarter alone
(one TF32 product would miss this by orders of magnitude:
tests/test_torch_dct_tf32.py argues the limit on the CPU); two launches give
the same bits.  Head dims between the kernels' instantiations (16, 32, 64,
128) and the dropout mode are held to the plain versions at the larger of
those limits and one bf16 ulp of the largest value in bf16 (dropout scales
values by 1 / (1 - rate)), and 1e-5 of the largest value in fp32; the
dropout mode's keep bits to the plain twin's bit for bit.
"""
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (imports no JAX)
from dct_autoencoder_torch import kernels as tk  # noqa: E402
from dct_autoencoder_torch.kernels import attention as tatt  # noqa: E402
from dct_autoencoder_torch.kernels import dct_patchify as tdp  # noqa: E402
from dct_autoencoder_torch.kernels import idct_unpatchify as tid  # noqa: E402
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _attn_inputs(b, h, s, d, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g).to(dtype).to(device) for _ in range(3))
    ids = torch.sort(torch.randint(0, 4, (b, s), generator=g), dim=1).values.int()
    lens = torch.randint(max(1, s // 2), s + 1, (b,), generator=g)
    pad = torch.arange(s)[None] >= lens[:, None]
    return q, k, v, ids.to(device), pad.to(device)


@pytest.mark.parametrize(
    "b,h,s,d,dtype,mode",
    [
        (4, 16, 256, 64, torch.bfloat16, "block"),
        (4, 16, 256, 64, torch.bfloat16, "bias"),
        (3, 8, 173, 32, torch.float32, "block"),
        (3, 8, 173, 64, torch.float32, "bias"),
        (1, 8, 1, 32, torch.float32, "block"),
    ],
)
def test_attention_kernel_matches_plain(cuda, b, h, s, d, dtype, mode):
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, dtype, cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    tk.reset_launch_counts()
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, d**-0.5, mode)
    torch.cuda.synchronize()
    assert tk.launch_counts()["attention"] == 1
    o_ref, lse_ref = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, d**-0.5, mode)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-6)
    if mode == "block" and pad.any():
        assert (o.transpose(1, 2)[pad] == 0).all()


@pytest.mark.parametrize(
    "b,h,s,d,dtype,mode",
    [
        (4, 16, 256, 64, torch.bfloat16, "block"),
        (4, 16, 256, 64, torch.bfloat16, "bias"),
        (4, 8, 256, 32, torch.bfloat16, "block"),
        (3, 8, 173, 32, torch.float32, "block"),
        (3, 8, 173, 64, torch.float32, "bias"),
        (1, 8, 1, 32, torch.float32, "block"),
    ],
)
def test_attention_backward_kernels_match_plain(cuda, b, h, s, d, dtype, mode):
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, dtype, cuda)
    do = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(1)).to(dtype).to(cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, d**-0.5, mode)
    tk.reset_launch_counts()
    got = tatt.attention_bwd(q, k, v, q_ids, kv_ids, o, lse, do, d**-0.5, mode)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts["attention_dq"] == 1 and counts["attention_dkv"] == 1 and counts["attention"] == 0
    want = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, d**-0.5, mode)
    atol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)
    if mode == "block" and pad.any():
        assert (got[0].transpose(1, 2)[pad] == 0).all()


def _poison_allocator():
    """Fill the blocks the caching allocator hands out next (small and large pools) with NaN."""
    small = [torch.full((n,), float("nan"), device="cuda") for n in (1 << 12, 1 << 15, 1 << 18) for _ in range(32)]
    large = torch.full((64 << 20,), float("nan"), device="cuda")
    torch.cuda.synchronize()
    del small, large


def _grads_f64(q, k, v, ids, pad, scale, mode):
    """d sum(o^2) / d(q, k, v) of the kernels' function in float64 on the CPU."""
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    qq, kk, vv = (t.double().requires_grad_(True) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * scale
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    logits = logits + allowed.double() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, tatt.NEG_INF))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=tatt.NEG_INF * 0.5).detach()
    p = torch.exp(logits - m)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv) / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    (o**2).sum().backward()
    return [t.grad for t in (qq, kk, vv)]


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_attention_gradients_match_cpu(cuda, mode):
    """fp32 gradients through the autograd.Function on the card (the
    backward's default there, impl tf32x3) against the plain path on the CPU,
    with the head merge's transposed grad_output.  The
    card's computation is repeated 5 times, each after filling the memory the
    allocator hands out next with NaN: every repeat must give the same bits (a
    kernel that read memory nothing wrote would not).  Both sides are also
    held to a float64 computation (same limits), so that a failure names the
    side that moved."""
    b, h, s, d = 2, 4, 173, 32
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.float32, "cpu", seed=2)
    ref64 = _grads_f64(q, k, v, ids, pad, d**-0.5, mode)

    def grads(dev):
        qq, kk, vv = (t.clone().to(dev).requires_grad_(True) for t in (q, k, v))
        o = tatt.packed_flash_attention(qq, kk, vv, ids.to(dev), pad.to(dev), d**-0.5, mode)
        (o.transpose(1, 2).reshape(b, s, h * d) ** 2).sum().backward()
        return [t.grad.cpu() for t in (qq, kk, vv)]

    want = grads("cpu")
    for a, r in zip(want, ref64):
        torch.testing.assert_close(a.double(), r, atol=1e-5, rtol=1e-5, msg=lambda m: f"the CPU side against float64: {m}")
    first = None
    for _ in range(5):
        _poison_allocator()
        got = grads("cuda")
        first = first or got
        assert all(torch.equal(x, y) for x, y in zip(first, got)), "a repeat on the card gave other bits"
        for c, r in zip(got, ref64):
            torch.testing.assert_close(c.double(), r, atol=1e-5, rtol=1e-5, msg=lambda m: f"the card against float64: {m}")
        for a, c in zip(want, got):
            torch.testing.assert_close(c, a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_attention_gradients_match_cpu_simt(cuda, mode):
    """test_attention_gradients_match_cpu's case on the CUDA-core backward
    (impl simt, which float32 took before the 3xTF32 kernels), through the
    wrappers with the grad_output autograd hands over (2 o): the same bits in
    5 poisoned repeats, and within 1e-5 (+ 1e-5 relative) of float64 and of
    the plain path on the CPU."""
    b, h, s, d = 2, 4, 173, 32
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.float32, "cpu", seed=2)
    ref64 = _grads_f64(q, k, v, ids, pad, d**-0.5, mode)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    o, lse = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, d**-0.5, mode)
    want = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, 2 * o, d**-0.5, mode)

    def grads():
        qq, kk, vv = (t.to(cuda) for t in (q, k, v))
        qi, ki = q_ids.to(cuda), kv_ids.to(cuda)
        oo, ll = tatt.attention_fwd_cuda(qq, kk, vv, qi, ki, d**-0.5, mode)
        dq, delta = tatt.attention_dq_cuda(qq, kk, vv, qi, ki, oo, ll, 2 * oo, d**-0.5, mode, impl="simt")
        dk, dv = tatt.attention_dkv_cuda(qq, kk, vv, qi, ki, ll, delta, 2 * oo, d**-0.5, mode, impl="simt")
        return [t.cpu() for t in (dq, dk, dv)]

    first = None
    for _ in range(5):
        _poison_allocator()
        got = grads()
        first = first or got
        assert all(torch.equal(x, y) for x, y in zip(first, got)), "a repeat on the card gave other bits"
    for c, r, a in zip(first, ref64, want):
        torch.testing.assert_close(c.double(), r, atol=1e-5, rtol=1e-5, msg=lambda m: f"the card against float64: {m}")
        torch.testing.assert_close(c, a, atol=1e-5, rtol=1e-5)


def test_attention_backward_refuses_bad_input_on_cuda(cuda):
    q, k, v, ids, pad = _attn_inputs(1, 2, 16, 32, torch.float32, cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, 1.0)
    with pytest.raises(ValueError):
        tatt.attention_bwd(q, k, v, q_ids, kv_ids, o, lse, q.mT.contiguous().mT, 1.0)  # not contiguous
    with pytest.raises(ValueError, match="head dim"):
        wide = lambda t: t.repeat(1, 1, 1, 5)[..., :136].contiguous()  # head dims above 128 have no kernel
        tatt.attention_bwd(wide(q), wide(k), wide(v), q_ids, kv_ids, wide(o), lse, wide(q), 1.0)


CAUSAL_CASES = [
    (2, 16, 1024, 64, torch.bfloat16, "block"),
    (2, 8, 384, 32, torch.float32, "block"),
    (2, 8, 384, 32, torch.float32, "bias"),
    (2, 8, 384, 64, torch.bfloat16, "bias"),
    (1, 8, 173, 32, torch.float32, "block"),
    (3, 8, 173, 64, torch.float32, "bias"),
    (1, 8, 1, 32, torch.float32, "block"),
]


@pytest.mark.parametrize("b,h,s,d,dtype,mode", CAUSAL_CASES)
def test_causal_attention_kernel_matches_plain(cuda, b, h, s, d, dtype, mode):
    """The forward kernel's causal mode, across tiles, in both modes and at a ragged length."""
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, dtype, cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    tk.reset_launch_counts()
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, d**-0.5, mode, causal=True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts.pop("attention_causal") == 1 and set(counts.values()) == {0}
    o_ref, lse_ref = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, d**-0.5, mode, causal=True)
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-6)
    if mode == "block" and pad.any():
        assert (o.transpose(1, 2)[pad] == 0).all()
    # skipping the key tiles above the diagonal changes no bit
    o_all, lse_all = tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, d**-0.5, mode, causal=True, skip_tiles=False)
    assert torch.equal(o, o_all) and torch.equal(lse, lse_all)


@pytest.mark.parametrize("b,h,s,d,dtype,mode", CAUSAL_CASES)
def test_causal_attention_backward_kernels_match_plain(cuda, b, h, s, d, dtype, mode):
    """The dq and dk/dv kernels' causal mode against the plain backward."""
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, dtype, cuda)
    do = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(1)).to(dtype).to(cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, d**-0.5, mode, causal=True)
    tk.reset_launch_counts()
    got = tatt.attention_bwd(q, k, v, q_ids, kv_ids, o, lse, do, d**-0.5, mode, causal=True)
    torch.cuda.synchronize()
    counts = tk.launch_counts()
    assert counts.pop("attention_dq_causal") == 1 and counts.pop("attention_dkv_causal") == 1
    assert set(counts.values()) == {0}
    want = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, d**-0.5, mode, causal=True)
    atol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)
    if mode == "block" and pad.any():
        assert (got[0].transpose(1, 2)[pad] == 0).all()
    dq_all, delta = tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, d**-0.5, mode, True, skip_tiles=False)
    dk_all, dv_all = tatt.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, d**-0.5, mode, True, skip_tiles=False)
    assert all(torch.equal(a, b) for a, b in zip(got, (dq_all, dk_all, dv_all)))


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_causal_attention_gradients_match_cpu(cuda, mode):
    """fp32 gradients through the autograd.Function with causal=True on the card
    against the plain path on the CPU; no future leakage in 'block' mode."""
    b, h, s, d = 2, 4, 173, 32
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.float32, "cpu", seed=2)
    grads, outs = {}, {}
    for dev in ("cpu", "cuda"):
        qq, kk, vv = (t.clone().to(dev).requires_grad_(True) for t in (q, k, v))
        o = tatt.packed_flash_attention(qq, kk, vv, ids.to(dev), pad.to(dev), d**-0.5, mode, causal=True)
        (o.transpose(1, 2).reshape(b, s, h * d) ** 2).sum().backward()
        grads[dev], outs[dev] = [t.grad.cpu() for t in (qq, kk, vv)], o.detach().cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=1e-5, rtol=1e-5)
    for a, c in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(c, a, atol=1e-5, rtol=1e-5)
    if mode == "block":
        cut = 100
        k2, v2 = k.clone(), v.clone()
        k2[:, :, cut:] += 3.0
        v2[:, :, cut:] += 100.0
        moved = tatt.packed_flash_attention(
            q.to(cuda), k2.to(cuda), v2.to(cuda), ids.to(cuda), pad.to(cuda), d**-0.5, mode, causal=True
        ).cpu()
        torch.testing.assert_close(moved[:, :, :cut], outs["cuda"][:, :, :cut], atol=1e-5, rtol=0)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


@pytest.mark.parametrize("s", [64, 173, 256, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("d", [32, 64])
def test_tensor_core_backward_kernels(cuda, d, mode, causal, s):
    """The bf16 dq and dk/dv kernels (impl mma) against the plain version and
    against impl simt; deterministic; tile skipping changes no bit; delta and
    the dq of padded queries as the contract says."""
    b, h = 2, 4
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.bfloat16, cuda, seed=s + d)
    do = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(1)).bfloat16().to(cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    scale = d**-0.5
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal)

    def run(impl=None, skip_tiles=True):
        dq, delta = tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, skip_tiles, impl)
        dk, dv = tatt.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, causal, skip_tiles, impl)
        return dq, dk, dv, delta

    tk.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert tk.bwd_impl_launch_counts() == {"mma": 2, "simt": 0, "tf32x3": 0}
    want = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(got[3], (do.float() * o.float()).sum(-1), atol=1e-3, rtol=0)
    if mode == "block" and pad.any():
        assert (got[0].transpose(1, 2)[pad] == 0).all()
    old = run("simt")
    assert tk.bwd_impl_launch_counts() == {"mma": 2, "simt": 2, "tf32x3": 0}
    atol = max(3e-2, _bf16_ulp(max(t.float().abs().max().item() for t in old[:3])))
    for g, w in zip(got[:3], old[:3]):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=0)
    assert all(torch.equal(x, y) for x, y in zip(got, run()))
    assert all(torch.equal(x, y) for x, y in zip(got, run(skip_tiles=False)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
def test_bf16_attention_gradients_match_cpu(cuda, mode, causal):
    """bf16 gradients through the autograd.Function on the card (forward kernel,
    tensor-core backward kernels) against the plain path on the CPU, with the
    head merge's transposed grad_output: a few bf16 ulps of the largest gradient
    (the forward kernel rounds p against the running max and sums in another
    order)."""
    b, h, s, d = 2, 4, 173, 64
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.bfloat16, "cpu", seed=2)
    grads = {}
    for dev in ("cpu", "cuda"):
        qq, kk, vv = (t.clone().to(dev).requires_grad_(True) for t in (q, k, v))
        tk.reset_launch_counts()
        o = tatt.packed_flash_attention(qq, kk, vv, ids.to(dev), pad.to(dev), d**-0.5, mode, causal)
        valid = (~pad).to(dev)[:, :, None]
        ((o.transpose(1, 2).reshape(b, s, h * d).float() * valid) ** 2).sum().backward()
        grads[dev] = [t.grad.float().cpu() for t in (qq, kk, vv)]
        assert tk.bwd_impl_launch_counts() == ({"mma": 2, "simt": 0, "tf32x3": 0} if dev == "cuda" else {"mma": 0, "simt": 0, "tf32x3": 0})
    for a, c in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(c, a, atol=4 * _bf16_ulp(a.abs().max().item()), rtol=0)


def test_backward_impl_argument_on_cuda(cuda):
    """fp32 takes the 3xTF32 tensor-core kernels (tf32x3) when the impl is
    left out, simt when asked; asking for mma with fp32, or tf32x3 with
    bf16, raises."""
    q, k, v, ids, pad = _attn_inputs(1, 2, 64, 32, torch.float32, cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, 1.0)
    tk.reset_launch_counts()
    tatt.attention_bwd(q, k, v, q_ids, kv_ids, o, lse, q, 1.0)
    assert tk.bwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 2}
    assert tk.fwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 0}
    tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, q, 1.0, impl="simt")
    assert tk.bwd_impl_launch_counts() == {"mma": 0, "simt": 1, "tf32x3": 2}
    with pytest.raises(TypeError):
        tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, q, 1.0, impl="mma")
    with pytest.raises(TypeError):
        tatt.attention_dq_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), q_ids, kv_ids, o.bfloat16(), lse, q.bfloat16(),
                               1.0, impl="tf32x3")
    for kernel in ("dq", "dkv"):
        info = tatt.attention_kernel_info(kernel, "mma", torch.bfloat16, 64)
        assert info["num_regs"] > 0 and info["blocks_per_sm"] >= 1
        for d in tatt.HEAD_DIMS:
            info = tatt.attention_kernel_info(kernel, "tf32x3", torch.float32, d)
            assert info["num_regs"] > 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("s", [1, 64, 173, 256, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_tf32x3_backward_kernels(cuda, d, mode, causal, s):
    """The fp32 dq and dk/dv kernels (impl tf32x3) against the plain version
    (1e-5 of the largest value), against impl simt (the same), and against
    float64 (at most 8 x the fp32 plain version's error, as chip_smoke.py's
    ATTN_F64_RATIO; 1e-6 of the largest gradient at least, ATTN_F64_FLOOR:
    at s = 1 dq and dk are rounding noise around 0); deterministic; tile
    skipping changes no bit; delta and the dq of padded queries as the
    contract says."""
    b, h = 2, 3
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.float32, cuda, seed=s + d)
    do = torch.randn(b, h, s, d, generator=torch.Generator().manual_seed(1)).to(cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    scale = d**-0.5
    o, lse = tatt.attention_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal)

    def run(impl=None, skip_tiles=True):
        dq, delta = tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, skip_tiles, impl)
        dk, dv = tatt.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, causal, skip_tiles, impl)
        return dq, dk, dv, delta

    tk.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert tk.bwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 2}
    want = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal)
    ref64 = chip_smoke.attention_bwd_f64(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal)
    old = run("simt")
    top = max(r.abs().max().item() for r in ref64)
    for g, w, r, x in zip(got, want, ref64, old):
        assert torch.isfinite(g).all()
        tol = 1e-5 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= tol
        assert (g - x).abs().max().item() <= tol
        e64, p64 = (g.double() - r).abs().max().item(), (w.double() - r).abs().max().item()
        assert e64 <= max(8.0 * p64, 1e-6 * top), (e64, p64)
    torch.testing.assert_close(got[3], (do * o).sum(-1), atol=1e-5, rtol=1e-5)
    if mode == "block" and pad.any():
        assert (got[0].transpose(1, 2)[pad] == 0).all()
    assert all(torch.equal(x, y) for x, y in zip(got, run()))
    assert all(torch.equal(x, y) for x, y in zip(got, run(skip_tiles=False)))


FWD_MMA_CASES = [
    (4, 16, 256, 64, "block"),
    (4, 16, 256, 64, "bias"),
    (4, 8, 256, 32, "block"),
    (3, 8, 173, 64, "block"),
    (3, 8, 173, 64, "bias"),
]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s,d,mode", FWD_MMA_CASES)
def test_tensor_core_forward_kernel(cuda, b, h, s, d, mode, causal):
    """The bf16 forward (impl mma) against the plain version and against impl
    simt; deterministic; tile skipping changes no bit; counted under mma."""
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.bfloat16, cuda, seed=s + d)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    scale = d**-0.5
    run = lambda **kw: tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, causal, **kw)
    tk.reset_launch_counts()
    o, lse = run()
    torch.cuda.synchronize()
    assert tk.fwd_impl_launch_counts() == {"mma": 1, "simt": 0, "tf32x3": 0}
    o_ref, lse_ref = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal)
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-6)
    if mode == "block" and pad.any():
        assert (o.transpose(1, 2)[pad] == 0).all()
    o_simt, lse_simt = run(impl="simt")
    assert tk.fwd_impl_launch_counts() == {"mma": 1, "simt": 1, "tf32x3": 0}
    atol = max(2e-2, _bf16_ulp(o_simt.float().abs().max().item()))
    torch.testing.assert_close(o.float(), o_simt.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, lse_simt, atol=1e-4, rtol=1e-6)
    assert all(torch.equal(x, y) for x, y in zip((o, lse), run()))
    assert all(torch.equal(x, y) for x, y in zip((o, lse), run(skip_tiles=False)))


@pytest.mark.parametrize("impl", ["mma", "simt", "tf32x3"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_fully_masked_rows(cuda, impl, causal):
    """'block' mode: padded queries, and a query whose image has no key
    (its keys are padding), give o = 0 and lse = -5e8 + log(1e-9), as the
    reference's clamps give; the other rows are untouched (bf16, and fp32
    for tf32x3)."""
    b, h, s, d = 2, 4, 150, 64
    dtype = torch.float32 if impl == "tf32x3" else torch.bfloat16
    q, k, v, ids, _ = _attn_inputs(b, h, s, d, dtype, cuda, seed=9)
    pad = torch.zeros(b, s, dtype=torch.bool, device=cuda)
    pad[:, 120:] = True
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    kv_ids[1, 70:90] = 77  # row 1: keys 70..89 belong to no query's image
    q_ids[1, 100:110] = 55  # and queries 100..109 to an image without keys
    o, lse = tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, d**-0.5, "block", causal, impl=impl)
    torch.cuda.synchronize()
    floor = (torch.tensor(-5e8) + torch.log(torch.tensor(1e-9))).item()
    masked = pad.clone()
    masked[1, 100:110] = True
    assert (o.transpose(1, 2)[masked] == 0).all()
    assert (lse.transpose(1, 2)[masked] == floor).all()
    o_ref, lse_ref = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, d**-0.5, "block", causal)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2 if dtype == torch.bfloat16 else 1e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


def test_forward_impl_argument_and_kernel_info_on_cuda(cuda):
    """fp32 takes the 3xTF32 forward (tf32x3) whatever is left out, bf16 the
    tensor cores (mma); mma with fp32 and tf32x3 with bf16 raise.  The
    tensor-core forward's registers and blocks per SM (on an NVIDIA H100 80GB
    HBM3: 160-168 registers at d = 64 and 121-125 at d = 32, no spill, 3 and 4
    blocks an SM); the tf32x3 forward's at every instantiation."""
    q, k, v, ids, pad = _attn_inputs(1, 2, 64, 32, torch.float32, cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    tk.reset_launch_counts()
    tatt.attention_fwd(q, k, v, q_ids, kv_ids, 1.0)
    tatt.attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), q_ids, kv_ids, 1.0, causal=True)
    assert tk.fwd_impl_launch_counts() == {"mma": 1, "simt": 0, "tf32x3": 1}
    assert tk.launch_counts()["attention"] == 1 and tk.launch_counts()["attention_causal"] == 1
    with pytest.raises(TypeError):
        tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, 1.0, impl="mma")
    with pytest.raises(TypeError):
        tatt.attention_fwd_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), q_ids, kv_ids, 1.0, impl="tf32x3")
    tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, 1.0, impl="simt")
    assert tk.fwd_impl_launch_counts() == {"mma": 1, "simt": 1, "tf32x3": 1}
    for d in (32, 64):
        mma = tatt.attention_kernel_info("fwd", "mma", torch.bfloat16, d)
        simt = tatt.attention_kernel_info("fwd", "simt", torch.bfloat16, d)
        assert 0 < mma["num_regs"] <= 168 and mma["blocks_per_sm"] >= 3 and mma["local_size_bytes"] == 0
        assert mma["blocks_per_sm"] > simt["blocks_per_sm"]
    assert tatt.attention_kernel_info("fwd", "simt", torch.float32, 64)["num_regs"] > 0
    for d in tatt.HEAD_DIMS:
        info = tatt.attention_kernel_info("fwd", "tf32x3", torch.float32, d)
        assert info["num_regs"] > 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("s", [1, 64, 173, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("d", [16, 24, 32, 48, 64, 80, 128])
def test_tf32x3_forward_kernel(cuda, d, mode, causal, s):
    """The fp32 forward (impl tf32x3) against the plain version (o and lse
    within 1e-5 of the largest value), against impl simt (the same), and
    against float64 (at most 8 x the fp32 plain version's error, or 1e-6 of
    the largest value); deterministic; tile skipping changes no bit; padded
    queries 0 in 'block' mode; counted under tf32x3, with no pad copy."""
    b, h = 2, 3
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, torch.float32, cuda, seed=s + d)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    scale = d**-0.5
    run = lambda **kw: tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, causal, **kw)
    tk.reset_launch_counts()
    o, lse = run()
    torch.cuda.synchronize()
    assert tk.fwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 1} and tk.pad_copy_count() == 0
    o_ref, lse_ref = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal)
    o64, _ = chip_smoke.attention_fwd_f64(q, k, v, q_ids, kv_ids, scale, mode, causal)
    o_simt, lse_simt = run(impl="simt")
    tol = 1e-5 * max(1.0, o_ref.abs().max().item())
    valid = lse_ref > -1e8  # rows that attend to something; a fully masked one's lse is -5e8 on every side
    lse_tol = 1e-5 * max(1.0, lse_ref[valid].abs().max().item() if valid.any() else 0.0)
    assert torch.isfinite(o).all()
    assert (o - o_ref).abs().max().item() <= tol and (o - o_simt).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= lse_tol and (lse - lse_simt).abs().max().item() <= lse_tol
    e64, p64 = (o.double() - o64).abs().max().item(), (o_ref.double() - o64).abs().max().item()
    assert e64 <= max(8.0 * p64, 1e-6 * o64.abs().max().item()), (e64, p64)
    if mode == "block" and pad.any():
        assert (o.transpose(1, 2)[pad] == 0).all()
    assert all(torch.equal(x, y) for x, y in zip((o, lse), run()))
    assert all(torch.equal(x, y) for x, y in zip((o, lse), run(skip_tiles=False)))


@pytest.mark.parametrize("d", [24, 48, 80])
@pytest.mark.parametrize("dtype,impl", [(torch.bfloat16, "mma"), (torch.float32, "tf32x3")])
def test_in_place_head_dims_equal_the_padded_run(cuda, dtype, impl, d):
    """The tensor-core kernels read and write rows of d in place (no pad copy)
    and give the bits of the same kernels on rows padded with zero columns to
    the next instantiation and cut back, in the three kernels, causal or not,
    with dropout or not."""
    b, h, s = 2, 3, 173
    dim = tatt.kernel_head_dim(d)
    q, k, v, ids, pad = _attn_inputs(b, h, s, d, dtype, cuda, seed=d)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(dtype).to(cuda)
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    seed = torch.tensor([99], dtype=torch.int64, device=cuda)
    for mode, causal, rate in (("block", False, 0.0), ("bias", True, 0.0), ("block", True, 0.2)):
        drop = tatt.AttentionDropout(rate, seed) if rate else None
        kw = dict(impl=impl, dropout=drop)

        def kernels(q, k, v, do):
            o, lse = tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, d**-0.5, mode, causal, **kw)
            dq, delta = tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, d**-0.5, mode, causal, **kw)
            return (o, lse, dq, delta, *tatt.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, d**-0.5, mode,
                                                                causal, **kw))

        tk.reset_launch_counts()
        got = kernels(q, k, v, do)
        torch.cuda.synchronize()
        assert tk.pad_copy_count() == 0
        padded = kernels(*(tatt.pad_head_dim(t, dim) for t in (q, k, v, do)))
        assert tk.pad_copy_count() == 4  # the four padded by hand; the kernels took them as they came
        want = [w[..., :d] if w.dim() == 4 else w for w in padded]
        assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
        assert not any(w[..., d:].any() for w in padded if w.dim() == 4)


def _tol(dtype, limit, ref):
    """bf16: the larger of `limit` and one ulp of the largest value; fp32: 1e-5 of it, at least 1e-5."""
    top = ref.float().abs().max().item()
    if dtype != torch.bfloat16:
        return 1e-5 * max(1.0, top)
    return max(limit, 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0)


def _kernels_against_plain(q, k, v, ids, pad, mode, causal, impl=None, dropout=None):
    """The forward, dq and dk/dv kernels against the plain versions on the same inputs."""
    b, h, s, d = q.shape
    scale = d**-0.5
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)).to(q.dtype).to(q.device)
    o, lse = tatt.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, causal, impl=impl, dropout=dropout)
    dq, delta = tatt.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, impl=impl, dropout=dropout)
    dk, dv = tatt.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, causal, impl=impl, dropout=dropout)
    torch.cuda.synchronize()
    o_ref, lse_ref = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal, dropout)
    refs = tatt.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, dropout)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for got, ref, limit in ((o, o_ref, 2e-2), *((g, r, 3e-2) for g, r in zip((dq, dk, dv), refs))):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() <= _tol(q.dtype, limit, ref)
    return o, dq, dk, dv


@pytest.mark.parametrize("d", [16, 24, 48, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_refuses_head_dim_16_on_cuda(cuda, d, dtype):
    """Once refused on the card, head dim 16 (the JAX tests' tiny AR model)
    and every other 1 <= d <= 128 now run there: the kernels (instantiated at
    16, 32, 64 and 128, the rest padded) against the plain versions, causal
    or not, in both mask modes; d > 128 raises by name."""
    for mode, causal in (("block", False), ("bias", False), ("block", True)):
        q, k, v, ids, pad = _attn_inputs(2, 4, 150, d, dtype, cuda, seed=d)
        _kernels_against_plain(q, k, v, ids, pad, mode, causal)
    q = torch.zeros((1, 2, 8, 129), dtype=dtype, device=cuda)
    ids = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tatt.packed_flash_attention(q, q, q, ids, ids.bool(), 1.0)


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize(
    "dtype,impl", [(torch.bfloat16, "mma"), (torch.bfloat16, "simt"), (torch.float32, "simt"), (torch.float32, "tf32x3")]
)
def test_attention_dropout_kernels_match_plain(cuda, rate, dtype, impl):
    """The dropout mode of the three kernels against the plain versions (the
    twin's mask from the same seed), rows and heads offset, causal or not."""
    seed = torch.tensor([12345], dtype=torch.int64, device=cuda)
    drop = tatt.AttentionDropout(rate, seed, row0=3, head0=1)
    tk.reset_launch_counts()
    for mode, causal in (("block", False), ("bias", False), ("block", True)):
        q, k, v, ids, pad = _attn_inputs(2, 4, 200, 64, dtype, cuda, seed=7)
        o, *_ = _kernels_against_plain(q, k, v, ids, pad, mode, causal, impl, drop)
        o0, _ = tatt.attention_fwd_cuda(q, k, v, *tatt.segment_ids(ids, pad), 0.125, mode, causal, impl=impl)
        assert not torch.equal(o, o0)
    counts = tk.launch_counts()
    assert counts["attention_dropout"] == counts["attention_dq_dropout"] == counts["attention_dkv_dropout"] == 3


@pytest.mark.parametrize("dtype,impl", [(torch.bfloat16, "mma"), (torch.float32, "simt"), (torch.float32, "tf32x3")])
def test_attention_dropout_mask_equals_the_twin_bit_for_bit(cuda, dtype, impl):
    """With every p = 1/s (q = 0) and v = I, the forward's o is z / ((1 - rate) s):
    its nonzeros are the kernel's keep bits, which equal the plain twin's."""
    b, h, s = 2, 2, 128
    drop = tatt.AttentionDropout(0.3, torch.tensor([2**40 + 9], dtype=torch.int64, device=cuda), row0=5, head0=3)
    zeros = torch.zeros(b, h, s, s, dtype=dtype, device=cuda)
    eye = torch.eye(s, dtype=dtype, device=cuda).expand(b, h, s, s).contiguous()
    ids = torch.zeros(b, s, dtype=torch.int32, device=cuda)
    o, _ = tatt.attention_fwd_cuda(zeros, eye, eye, ids, ids, s**-0.5, impl=impl, dropout=drop)
    want = tatt.attention_dropout_keep_mask(drop.seed, 0.3, b, h, s, 5, 3)
    assert torch.equal(o != 0, want)


@pytest.mark.parametrize("impl", ["tf32x3", "simt"])
def test_fp32_backward_keep_bits_equal_the_twin_bit_for_bit(cuda, impl):
    """With every p = 1/s (q = 0): dv with do = I is (z / (1 - rate) / s)^T, so
    its nonzeros are the dk/dv kernel's keep bits; dq with k = I and
    v = do = e_0 is (z - mean(z)) / (1 - rate) scale / s, whose sign is the dq
    kernel's keep bit where that value is clear of 0."""
    b, h, s = 2, 2, 128
    drop = tatt.AttentionDropout(0.3, torch.tensor([2**41 + 7], dtype=torch.int64, device=cuda), row0=3, head0=5)
    zeros = torch.zeros(b, h, s, s, device=cuda)
    eye = torch.eye(s, device=cuda).expand(b, h, s, s).contiguous()
    e0 = zeros.clone()
    e0[..., 0] = 1
    ids = torch.zeros(b, s, dtype=torch.int32, device=cuda)
    k = torch.randn(b, h, s, s, generator=torch.Generator().manual_seed(0)).to(cuda)
    scale = s**-0.5
    want = tatt.attention_dropout_keep_mask(drop.seed, 0.3, b, h, s, 3, 5)
    o, lse = tatt.attention_fwd_cuda(zeros, k, eye, ids, ids, scale, dropout=drop)
    _, delta = tatt.attention_dq_cuda(zeros, k, eye, ids, ids, o, lse, eye, scale, impl=impl, dropout=drop)
    _, dv = tatt.attention_dkv_cuda(zeros, k, eye, ids, ids, lse, delta, eye, scale, impl=impl, dropout=drop)
    assert torch.equal(dv.transpose(-1, -2) != 0, want)
    o2, lse2 = tatt.attention_fwd_cuda(zeros, eye, e0, ids, ids, scale, dropout=drop)
    dq, _ = tatt.attention_dq_cuda(zeros, eye, e0, ids, ids, o2, lse2, e0, scale, impl=impl, dropout=drop)
    z = want.float() * drop.keep_scale
    expect = z - z.mean(dim=-1, keepdim=True)
    clear = expect.abs() > 0.05
    assert clear.float().mean().item() > 0.9
    assert not (((dq > 0) != want) & clear).any()


@pytest.mark.parametrize("b,h,w,ch,cw,p", [(2, 43, 61, 40, 56, 8), (2, 448, 448, 448, 448, 14), (1, 700, 1000, 700, 994, 14)])
def test_dct_kernels_match_plain(cuda, b, h, w, ch, cw, p):
    g = torch.Generator().manual_seed(h)
    x = torch.rand(b, 3, h, w, generator=g).to(cuda)
    tk.reset_launch_counts()
    y = tdp.fused_ipt_dct_patchify(x, p, ch, cw)
    torch.cuda.synchronize()
    y_ref = tdp.fused_ipt_dct_patchify_plain(x, p, ch, cw)
    assert (y - y_ref).abs().max().item() <= 1e-5 * y_ref.abs().max().item()

    planes = y_ref.reshape(b, ch // p, cw // p, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(b, 3, ch, cw).contiguous()
    r = tid.fused_idct_unpatchify_rgb(planes, h, w)
    torch.cuda.synchronize()
    r_ref = tid.fused_idct_unpatchify_rgb_plain(planes, h, w)
    assert (r - r_ref).abs().max().item() <= 1e-5 * r_ref.abs().max().item()
    counts = tk.launch_counts()
    assert counts.pop("dct_patchify") == 1 and counts.pop("idct_unpatchify") == 1
    assert set(counts.values()) == {0}


# (b, h, w, p, ch, cw): the serving batch, one served request, ragged edges,
# odd widths with ragged K slices (the IDCT copies 994-wide planes 4 bytes at a time)
DCT_CASES = [
    (16, 448, 448, 14, 448, 448),
    (1, 448, 448, 14, 448, 448),
    (2, 1000, 700, 14, 994, 700),
    (3, 333, 447, 8, 320, 432),
    (1, 700, 1000, 14, 700, 994),
]


def _held_to_fp32_and_float64(got, plain, ref64, hf):
    """max|got - plain| <= 1e-5 max|plain|, and against float64 at most 8 x
    the plain version's error, whole and where `hf` is set."""
    assert (got - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()
    for where in (torch.ones_like(hf), hf):
        err = (got.double() - ref64).abs().masked_select(where).max().item()
        err_plain = (plain.double() - ref64).abs().masked_select(where).max().item()
        assert err <= 8 * err_plain, (err, err_plain)


@pytest.mark.parametrize("b,h,w,p,ch,cw", DCT_CASES)
def test_dct_kernels_against_fp32_and_float64(cuda, b, h, w, p, ch, cw):
    g = torch.Generator().manual_seed(h + w)
    x = torch.rand(b, 3, h, w, generator=g).to(cuda)
    planes = lambda t: t.reshape(b, ch // p, cw // p, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(b, 3, ch, cw)
    tk.reset_launch_counts()
    y = tdp.fused_ipt_dct_patchify_cuda(x, p, ch, cw)
    torch.cuda.synchronize()
    assert tk.launch_counts()["dct_patchify"] == 1
    hf = torch.zeros(b, 3, ch, cw, dtype=torch.bool, device=cuda)
    hf[..., ch // 2 :, cw // 2 :] = True
    y_plain = tdp.fused_ipt_dct_patchify_plain(x, p, ch, cw)
    y64 = tdp.fused_ipt_dct_patchify_plain(x, p, ch, cw, torch.float64)
    _held_to_fp32_and_float64(planes(y), planes(y_plain), planes(y64), hf)
    assert torch.equal(y, tdp.fused_ipt_dct_patchify_cuda(x, p, ch, cw))

    y_in = planes(y_plain).contiguous()
    for inputs in (y_in, y_in * hf):  # all frequencies; the high-frequency quarter alone
        r = tid.fused_idct_unpatchify_rgb_cuda(inputs, h, w)
        torch.cuda.synchronize()
        r_plain = tid.fused_idct_unpatchify_rgb_plain(inputs, h, w)
        r64 = tid.fused_idct_unpatchify_rgb_plain(inputs, h, w, torch.float64)
        _held_to_fp32_and_float64(r, r_plain, r64, torch.ones_like(r, dtype=torch.bool))
        assert torch.equal(r, tid.fused_idct_unpatchify_rgb_cuda(inputs, h, w))
    if (ch, cw) == (h, w):
        back = tid.fused_idct_unpatchify_rgb_cuda(planes(y).contiguous(), h, w)
        assert (back - x).abs().max().item() < 1e-3
    # two inputs, twice each, and the round trip
    assert tk.launch_counts()["idct_unpatchify"] == 4 + int((ch, cw) == (h, w))


def test_dct_kernel_info(cuda):
    """Both products of both kernels: registers within the launch bound, two blocks an SM, no spill in the first product
    and at most 16 bytes a thread in the second (measured on an H100: the
    three channels' accumulators take 96 of the 255 registers)."""
    for lib in ("dct_patchify", "idct_unpatchify"):
        for which in (1, 2):
            info = tdp.kernel_info(lib, which)
            spill = 0 if which == 1 else 16
            assert 0 < info["num_regs"] <= 255 and info["local_size_bytes"] <= spill and info["blocks_per_sm"] >= 2, (lib, which, info)


# ---------------------------------------------------------------- int8 serving and reconstruct_direct


@pytest.mark.parametrize("group_size", [0, 128])
@pytest.mark.parametrize("d_in,d_out", [(1024, 4096), (4096, 1024)])  # patch14-L's fc1 and fc2
def test_int8_dense_dynamic_on_card_matches_cpu(cuda, d_in, d_out, group_size):
    """The dynamic int8 layer at patch14-L widths: the int32 sums are exact and
    every other step is the same fp32 operation, so the card gives the CPU's
    bits, in fp32 and in bf16 (one rounding of equal fp32 values)."""
    from dct_autoencoder_torch.models import quant as tq

    g = torch.Generator().manual_seed(d_in + group_size)
    w = (torch.randn(d_in, d_out, generator=g) * 0.02).numpy()
    q, scale = tq._quantize_weight(w, group_size)
    x = torch.randn(3, 333, d_in, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        layers = {}
        for dev in ("cpu", cuda):
            layer = tq.Int8Dense(d_in, d_out, dtype=dtype, group_size=group_size, mode="dynamic")
            layer.load_state_dict({"kernel_q": torch.from_numpy(q), "kernel_scale": torch.from_numpy(scale),
                                   "bias": torch.randn(d_out, generator=torch.Generator().manual_seed(1))})
            layers[str(dev)] = layer.to(dev)
        calls = tq.INT_MM_CALLS
        got = layers["cuda"](x.to(dtype).to(cuda))
        torch.cuda.synchronize()
        assert tq.INT_MM_CALLS - calls == (d_in // group_size if group_size else 1)
        want = layers["cpu"](x.to(dtype))
        assert got.dtype == dtype and torch.equal(got.cpu(), want)


def test_int8_matmul_pads_to_the_card_s_shape_rules(cuda):
    """torch._int_mm on the card takes more than 16 rows and widths that are
    multiples of 8: smaller and odd shapes are padded, the sums stay exact."""
    from dct_autoencoder_torch.models import quant as tq

    g = torch.Generator().manual_seed(0)
    for m, k, n in [(1, 3, 5), (16, 24, 8), (17, 20, 12), (333, 1024, 4096)]:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        got = tq.int8_matmul(a.to(cuda), b.t().contiguous().to(cuda))
        assert got.shape == (m, n) and torch.equal(got.cpu(), a.int() @ b.int())


def test_reconstruct_direct_on_card_matches_cpu(cuda):
    """reconstruct_direct of the r3b float model in fp32 on the card (the
    kernels) against the plain path on the CPU, on the same tokens: > 40 dB
    between them (the JAX package's figure for two paths at rounding level),
    one IDCT launch for the uniform group, and its uint8 output the host
    quantization of its float output."""
    import os
    import random

    import numpy as np

    import dct_autoencoder_torch as dt

    r3b = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "calibrated_run_r3b", "model")
    rng = np.random.default_rng(0)
    ims = [rng.uniform(0.1, 0.9, size=(3, 224, 224)).astype(np.float32) for _ in range(5)]
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = dt.DCTPipeline.from_pretrained(r3b, dtype=torch.float32, device=dev, prefer_int8="never")
        pipe = dt.DCTPipeline(pipe.model, pipe.processor, pad_rows_to=8)
        pipe.processor.rng = random.Random(0)
        tk.reset_launch_counts()
        out[dev] = pipe.reconstruct_direct(ims)
        if dev == "cuda":
            assert tk.launch_counts()["idct_unpatchify"] == 1
            pipe.processor.rng = random.Random(0)
            u8 = pipe.reconstruct_direct(ims, as_uint8=True)
            for f, u in zip(out[dev], u8):
                assert u.dtype == np.uint8 and np.array_equal((np.clip(f, 0, 1) * 255.0 + 0.5).astype(np.uint8), u)
    for a, c in zip(out["cpu"], out["cuda"]):
        mse = float(np.mean((a.astype(np.float64) - c) ** 2))
        assert 10 * np.log10(1.0 / max(mse, 1e-20)) > 40.0


def test_adamw8bit_on_card_equals_cpu(cuda):
    """3 updates of AdamW8bit on the card and on the CPU from the same
    parameters and gradients: the same codes and absmax, bit for bit (the
    update divides by tensors and takes 1 - b**count from the host), and
    parameters within 1e-6."""
    from dct_autoencoder_torch.train.opt8bit import AdamW8bit

    g = torch.Generator().manual_seed(0)
    shapes = [(64, 64), (300,), (7, 5, 3), (513,)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 0.01 for s in shapes] for _ in range(3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        params = [torch.nn.Parameter(p.clone().to(dev)) for p in init]
        opt = AdamW8bit(params, lr=1e-3)
        for step_grads in grads:
            for p, gr in zip(params, step_grads):
                p.grad = gr.to(dev)
            opt.step()
        runs[dev] = (params, opt)
    (pc, oc), (pg, og) = runs["cpu"], runs["cuda"]
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=1e-6, rtol=0)
        for name in ("mu_codes", "nu_codes", "mu_absmax", "nu_absmax"):
            assert torch.equal(og.state[b][name].cpu(), oc.state[a][name]), name


def test_pixel_loss_train_step_on_card_matches_cpu(cuda):
    """One fp32 train step of the r3b model with the pixel loss and 8-bit
    moments, on the card (the kernels) and on the CPU (the plain path), on
    the same batch: losses rtol 1e-4, grad norm rtol 1e-3."""
    import os
    import random

    import numpy as np

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import train as T

    r3b = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "calibrated_run_r3b", "model")
    rng = np.random.default_rng(0)
    ims = [rng.uniform(0.1, 0.9, size=(3, 112, 112)).astype(np.float32) for _ in range(5)]
    metrics = {}
    for dev in ("cpu", "cuda"):
        model, proc = dt.get_model_and_processor(resume_path=r3b, dtype=torch.float32, device=dev)
        proc.rng = random.Random(0)
        ds = proc.preprocess_many(ims)
        batch = next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]), batch_size=None))
        batch, gs = T.prepare_train_batch(batch, pixel_loss_max_images=8, clip_grid=(32, 32))
        tx = T.make_optimizer(1e-4, 10, warmup_steps=0, opt_8bit=True)
        step = T.make_train_step(model.module, tx, use_pixel_loss=True)
        _, m = step(T.TrainState.create(model.module, tx), model.patchnorm, batch, gs)
        metrics[dev] = {k: v.item() for k, v in m.items()}
    for k in ("loss", "pixel_loss", "rec_loss", "rec_loss_unnormalized"):
        np.testing.assert_allclose(metrics["cuda"][k], metrics["cpu"][k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["cuda"]["grad_norm"], metrics["cpu"]["grad_norm"], rtol=1e-3)
