"""The float32 attention forward's 3xTF32 arithmetic, argued on the CPU against the JAX package.

On the card the float32 forward (csrc/attention_fwd_tf32x3.cu, impl
"tf32x3") multiplies on the tensor cores in 3xTF32: S = Q.K^T by 8-deep
slices, each slice's three mma (lo*hi, hi*lo, hi*hi of the operands' TF32
parts, taken by Veltkamp's split with the lo part truncated) summed from
zero and rounded toward zero by the tensor cores, then added to the fp32
accumulator; the online softmax over 64-key tiles in fp32 (the running max
from -5e8, the accumulator and l rescaled by exp(m_old - m_new) once a
tile); p split and P.V summed the same way onto the rescaled accumulator.
That arithmetic is emulated here (the helpers of
tests/test_torch_attention_bwd_tf32x3.py) and held, at small shapes in both
mask modes, causal or not, to JAX's fp32 forward (the Pallas kernel
_attn_fwd_kernel in interpret mode) at the fp32 limit the card holds the
kernel to: o and lse within 1e-5 of the largest value.  Against a float64
computation of the same function o's largest error is at most
chip_smoke.ATTN_F64_RATIO x that of the fp32 plain version (or
ATTN_F64_FLOOR of the largest value); one TF32 product (hi*hi alone) misses
1e-5, so the limit tells 3xTF32 from TF32.  The emulation is test code, not
a path of the package: on the CPU the port runs ``attention_fwd_plain``.

Also here: which implementation a float32 forward takes (tf32x3 unless simt
is asked for), that one whose library does not build raises instead of
falling back to simt, which head dims the wrappers pad (``row_width``) and
which they hand to the kernels in place, and the row alignment the
tensor-core kernels need (``_check_mma_alignment``).
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from dct_autoencoder_torch import kernels as tk  # noqa: E402
from dct_autoencoder_torch.kernels import _build  # noqa: E402
from dct_autoencoder_torch.kernels import attention as tatt  # noqa: E402
from dct_autoencoder_tpu.kernels import attention as jatt  # noqa: E402
from test_torch_attention_bwd_tf32x3 import _ids, _kernel_split, _round_toward_zero, _tc_product, _tf32_product  # noqa: E402
from test_torch_kernels import make_inputs  # noqa: E402

TILE = 64  # keys a streamed tile: the online softmax rescales once a tile


def _slices_onto(acc, a, b):
    """acc + a (..., m, k) @ b (..., k, n) as the kernel adds it: each 8-deep
    slice's three mma of the split parts from zero, rounded toward zero,
    then added to acc in fp32 in order."""
    depth = -(-a.shape[-1] // 8) * 8
    a = torch.nn.functional.pad(a, (0, depth - a.shape[-1]))
    b = torch.nn.functional.pad(b, (0, 0, 0, depth - b.shape[-2]))
    ah, al = _kernel_split(a.contiguous())
    bh, bl = _kernel_split(b.contiguous())
    for j in range(depth // 8):
        cols = slice(8 * j, 8 * j + 8)
        d = torch.zeros(())
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            d = _round_toward_zero(d.double() + x[..., cols].double() @ y[..., cols, :].double())
        acc = acc + d
    return acc


def _emulated_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal, product=_tc_product, onto=_slices_onto):
    """(o, lse) of the kernel's arithmetic: `product` for S = Q.K^T, the online
    softmax over 64-key tiles in fp32, `onto` for O += P.V."""
    b, h, s, d = q.shape
    m = torch.full((b, h, s, 1), -5e8)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    pos = torch.arange(s)
    for k0 in range(0, s, TILE):
        keys = slice(k0, min(s, k0 + TILE))
        dots = product(q, k[:, :, keys].transpose(-1, -2))
        allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, keys]
        if causal:
            allowed = allowed & (pos[keys][None, :] <= pos[:, None])
        logits = dots * scale
        logits = logits + allowed.float() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, -1e9))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = onto(acc * alpha, p, v[:, :, keys])
        m = m_new
    den = torch.clamp(l, min=1e-9)
    return acc * (1.0 / den), (m + torch.log(den))[..., 0]


def _one_tf32_onto(acc, a, b):
    return acc + _tf32_product(a, b)


@functools.lru_cache(maxsize=None)
def _jax_fwd_case(s, d, mode, causal):
    """The inputs (q, k, v, q_ids, kv_ids) and JAX's fp32 (o, lse), as numpy arrays."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=s, d=d, seed=3 * s + d)
    q_ids, kv_ids = _ids(ids, pad)
    o, lse = jatt._flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v, q_ids, kv_ids)), d**-0.5, mode, causal, True)
    return (q, k, v, q_ids, kv_ids), (np.array(o), np.array(lse))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s,d", [(128, 16), (173, 32), (200, 64)])
def test_emulated_3xtf32_forward_matches_jax_and_float64(s, d, mode, causal):
    scale = d**-0.5
    inputs, (o_jax, lse_jax) = _jax_fwd_case(s, d, mode, causal)
    args = [torch.from_numpy(a.copy()) for a in inputs]
    o, lse = _emulated_fwd(*args, scale, mode, causal)
    o_want, lse_want = torch.from_numpy(o_jax), torch.from_numpy(lse_jax)
    tol_o = 1e-5 * max(1.0, o_want.abs().max().item())
    # the largest lse of a row that attends to something (a fully masked row's is -5e8 in both)
    tol_lse = 1e-5 * max(1.0, lse_want[lse_want > -1e8].abs().max().item())
    err_o, err_lse = (o - o_want).abs().max().item(), (lse - lse_want).abs().max().item()
    o_plain, _ = tatt.attention_fwd_plain(*args, scale, mode, causal)
    o64, lse64 = chip_smoke.attention_fwd_f64(*args, scale, mode, causal)
    e64, p64 = (o.double() - o64).abs().max().item(), (o_plain.double() - o64).abs().max().item()
    print(f"o: max|3xTF32 - JAX| {err_o:.3g} (limit {tol_o:.3g}); lse {err_lse:.3g} (limit {tol_lse:.3g}); "
          f"float64 error {e64:.3g}, fp32 plain {p64:.3g}")
    assert err_o <= tol_o and err_lse <= tol_lse, (err_o, tol_o, err_lse, tol_lse)
    assert e64 <= max(chip_smoke.ATTN_F64_RATIO * p64, chip_smoke.ATTN_F64_FLOOR * o64.abs().max().item()), (e64, p64)
    if mode == "block":  # padded queries attend to nothing: o = 0, lse = -5e8 + log(1e-9)
        assert not o[..., inputs[3][0] == -2, :].any()
    o_tf32, _ = _emulated_fwd(*args, scale, mode, causal, _tf32_product, _one_tf32_onto)
    assert (o_tf32 - o_want).abs().max().item() > tol_o  # one TF32 product misses the fp32 limit


def test_float32_forward_takes_tf32x3_and_simt_on_request():
    assert tatt._kernel_impl(None, torch.float32, "fwd") == tatt._kernel_impl(None, torch.float32) == "tf32x3"
    assert tatt._kernel_impl("simt", torch.float32, "fwd") == "simt"
    assert tatt._kernel_impl(None, torch.bfloat16, "fwd") == "mma"
    with pytest.raises(TypeError, match="float32"):
        tatt._kernel_impl("tf32x3", torch.bfloat16, "fwd")
    assert tatt.IMPLS.index("tf32x3") == 2  # the C entry points' number, the forward's too
    assert set(tatt.LAUNCHES_FWD_IMPL) == set(tatt.IMPLS) == {"mma", "simt", "tf32x3"}
    assert _build.SOURCES["attention_fwd_tf32x3"] == "attention_fwd_tf32x3.cu"
    assert "attention_fwd_tf32x3" not in _build.DEFINES


def test_float32_forward_that_cannot_build_raises(monkeypatch):
    """The forward asks for the 3xTF32 library alone, and a failure to build it
    raises: float32 never drops back to the CUDA-core kernel quietly."""
    asked = []

    def failing_build(name):
        asked.append(name)
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", failing_build)
    q = torch.zeros((1, 2, 8, 32))
    ids = torch.zeros((1, 8), dtype=torch.int32)
    tk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tatt.attention_fwd_cuda(q, q, q, ids, ids, 1.0)
    assert asked == ["attention_fwd_tf32x3"]
    assert tk.fwd_impl_launch_counts() == {"mma": 0, "simt": 0, "tf32x3": 0}
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tatt.attention_kernel_info("fwd", "tf32x3", torch.float32, 64)
    assert asked[-1] == "attention_fwd_tf32x3"


# (d, dtype, impl) -> the row width the kernel takes: d in place, or the instantiation the wrapper pads to
ROW_WIDTHS = [
    (24, torch.bfloat16, "mma", 24), (48, torch.bfloat16, "mma", 48), (80, torch.bfloat16, "mma", 80),
    (96, torch.bfloat16, "mma", 96), (112, torch.bfloat16, "mma", 112), (64, torch.bfloat16, "mma", 64),
    (20, torch.bfloat16, "mma", 32), (36, torch.bfloat16, "mma", 64), (5, torch.bfloat16, "mma", 16),
    (24, torch.float32, "tf32x3", 24), (48, torch.float32, "tf32x3", 48), (80, torch.float32, "tf32x3", 80),
    (20, torch.float32, "tf32x3", 20), (36, torch.float32, "tf32x3", 36), (100, torch.float32, "tf32x3", 100),
    (18, torch.float32, "tf32x3", 32), (5, torch.float32, "tf32x3", 16), (1, torch.float32, "tf32x3", 16),
    (48, torch.bfloat16, "simt", 64), (48, torch.float32, "simt", 64), (24, torch.float32, "simt", 32),
    (128, torch.float32, "simt", 128), (16, torch.bfloat16, "simt", 16),
]


@pytest.mark.parametrize("d,dtype,impl,want", ROW_WIDTHS)
def test_row_width_pads_only_where_a_row_is_not_whole_chunks(d, dtype, impl, want):
    """The tensor-core kernels take rows of d in place where a row is whole
    16-byte chunks (d % 8 == 0 in bfloat16, d % 4 == 0 in float32); other
    widths, and every width of the CUDA-core kernels, pad to the next
    instantiation."""
    assert tatt.row_width(d, dtype, impl) == want
    assert want in (d, tatt.kernel_head_dim(d))


@pytest.mark.parametrize("d", [0, 129, 256])
def test_row_width_past_the_instantiations_raises(d):
    for dtype, impl in ((torch.bfloat16, "mma"), (torch.float32, "tf32x3"), (torch.float32, "simt")):
        with pytest.raises(ValueError, match="head dim"):
            tatt.row_width(d, dtype, impl)


def _fake_library(calls):
    """A stand-in for a kernel library: each entry point records its arguments and returns 0."""

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0

            return entry

    return Lib()


@pytest.mark.parametrize(
    "d,dtype,impl,width,copies",
    [(48, torch.float32, None, 48, 0), (80, torch.bfloat16, None, 80, 0), (24, torch.float32, None, 24, 0),
     (20, torch.bfloat16, None, 32, 3), (48, torch.float32, "simt", 64, 3), (18, torch.float32, None, 32, 3)],
)
def test_wrappers_hand_rows_in_place_or_padded(monkeypatch, d, dtype, impl, width, copies):
    """The three wrappers, their libraries stood in for on the CPU: each passes
    the kernels the row width of ``row_width`` and copies (pads) q, k, v for
    the forward, and q, k, v, o, do or q, k, v, do for the backward, only
    where that width is not d; the results come back at d."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: _fake_library(calls))
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    b, h, s = 1, 2, 8
    q = torch.zeros((b, h, s, d), dtype=dtype)
    ids = torch.zeros((b, s), dtype=torch.int32)
    rows = torch.zeros((b, h, s))
    tk.reset_launch_counts()
    o, lse = tatt.attention_fwd_cuda(q, q, q, ids, ids, 1.0, impl=impl)
    assert tk.pad_copy_count() == copies
    dq, delta = tatt.attention_dq_cuda(q, q, q, ids, ids, q, rows, q, 1.0, impl=impl)
    assert tk.pad_copy_count() == copies + 5 * (copies > 0)
    dk, dv = tatt.attention_dkv_cuda(q, q, q, ids, ids, rows, rows, q, 1.0, impl=impl)
    assert tk.pad_copy_count() == copies + 9 * (copies > 0)
    assert all(t.shape == q.shape for t in (o, dq, dk, dv))
    fwd_entry = "attn_fwd_tf32x3" if (impl or tatt._kernel_impl(None, dtype)) == "tf32x3" else "attn_fwd"
    assert [name for name, _ in calls][0] == fwd_entry
    # the row width: argument 10 of the forward (7 pointers, b, h, s, d), 13 of the backward's (10 pointers, ...)
    assert [args[10] if name.startswith("attn_fwd") else args[13] for name, args in calls] == [width] * 3


def test_mma_alignment_checks_base_and_row_stride():
    """The tensor-core kernels copy 16 bytes at a time: a base off a 16-byte
    boundary, or rows a number of bytes apart that is not a multiple of 16,
    raises ValueError naming the tensor."""
    tatt._check_mma_alignment({"q": torch.zeros(1, 2, 8, 48), "o": torch.zeros(1, 2, 8, 24, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="k's rows must lie a multiple of 16 bytes apart"):
        tatt._check_mma_alignment({"q": torch.zeros(1, 2, 8, 48), "k": torch.zeros(1, 2, 8, 18)})
    with pytest.raises(ValueError, match="v's rows"):
        tatt._check_mma_alignment({"v": torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="do's rows"):
        tatt._check_mma_alignment({"do": torch.zeros(1, 2, 8, 96)[..., ::2]})  # columns 8 bytes apart
    base = torch.zeros(4 * 48 + 1)
    with pytest.raises(ValueError, match="dq must start at a 16-byte boundary"):
        tatt._check_mma_alignment({"dq": base[1:].view(1, 1, 4, 48)})
