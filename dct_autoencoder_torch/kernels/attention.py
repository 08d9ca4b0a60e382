"""Packed block-diagonal attention, forward and backward, with CUDA kernels for Hopper.

Replaces the three Pallas kernels of dct_autoencoder_tpu/kernels/attention.py:
_attn_fwd_kernel (called from _flash_attention_fwd_impl), and _attn_dq_kernel
and _attn_dkv_kernel (called from _flash_attention_bwd_impl).  The forward
kernel is csrc/attention_fwd.cu: one block per (b*h, 64-row q tile) streams
64-row k/v tiles through shared memory with an online fp32 softmax, because
a Hopper block cannot hold the whole k/v stripe the Pallas kernel keeps in
VMEM.  The backward kernels are csrc/attention_bwd.cu: one block per q tile
for dq, one per k tile for dk/dv, each recomputing p = exp(logits - lse)
from the saved row log-sum-exp.  The mask is derived from per-token ids
inside the kernels.  On the H100 the bound of these calls is memory (the
q/k/v/o/do bytes).

Each kernel has two implementations (see the sources' headers).  For
bfloat16 the products run on the tensor cores (``mma.sync``, bf16 operands,
fp32 accumulators); what holds them above their byte bound is inside the SM
(one ``ldmatrix`` feeds two ``mma``, and the mask and the exp run on the CUDA
cores between the products).  p (and in the backward ds) is rounded to bf16
before the second product, as the Pallas kernels round it
(``p.astype(v.dtype)``), because the tensor cores take it as a bf16 operand;
the plain versions round at the same places, so the kernels and the plain
versions compute the same function.  The forward's online softmax rounds p
relative to the running row max where the Pallas kernel rounds it relative
to the row's final max, so o can differ by one bf16 ulp now and then; no bit
of the masking differs.  float32 keeps the CUDA-core kernels, which are true
fp32 and bound by the CUDA cores' fp32 rate.  ``impl="simt"`` on the
``*_cuda`` wrappers runs the CUDA-core kernels on bfloat16 too, for timing
the old design beside the new one on one card; nothing on a model's path
passes it.

``packed_flash_attention`` keeps the JAX layout (b, h, s, d) and contract,
and carries the gradient through a ``torch.autograd.Function`` whenever an
input requires it.  For a CPU tensor each wrapper runs its plain version
(``attention_fwd_plain``, ``attention_bwd_plain``); for a CUDA tensor it
launches the kernel or raises.

``causal=True`` (``_causal_allowed`` in the JAX module; the autoregressive
token model trains through it) ANDs k_pos <= q_pos, the row indices, into
the segment mask inside the same three kernels.  In 'bias' mode that only
decides who gets the +1.  In 'block' mode the kernels skip the key tiles
above the diagonal, which changes no bit of the result (see the sources'
headers); ``skip_tiles=False`` on the ``*_cuda`` wrappers runs every tile,
for timing the difference.

``LAUNCHES``, ``LAUNCHES_DQ`` and ``LAUNCHES_DKV`` count the non-causal
kernel launches, ``LAUNCHES_CAUSAL``, ``LAUNCHES_DQ_CAUSAL`` and
``LAUNCHES_DKV_CAUSAL`` the causal ones.  ``LAUNCHES_FWD_IMPL`` counts the
forward's launches, causal or not, and ``LAUNCHES_BWD_IMPL`` those of both
backward kernels, by implementation ("mma", "simt").
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e9

LAUNCHES = 0
LAUNCHES_DQ = 0
LAUNCHES_DKV = 0
LAUNCHES_CAUSAL = 0
LAUNCHES_DQ_CAUSAL = 0
LAUNCHES_DKV_CAUSAL = 0
LAUNCHES_FWD_IMPL = {"mma": 0, "simt": 0}
LAUNCHES_BWD_IMPL = {"mma": 0, "simt": 0}

IMPLS = ("simt", "mma")  # the index is the `impl` argument of the C entry points


def segment_ids(image_ids: torch.Tensor, key_pad_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_ids, kv_ids) int32: padded queries get -2, padded keys -1."""
    ids = image_ids.to(torch.int32)
    q_ids = torch.where(key_pad_mask, torch.full_like(ids, -2), ids)
    kv_ids = torch.where(key_pad_mask, torch.full_like(ids, -1), ids)
    return q_ids.contiguous(), kv_ids.contiguous()


def _masked_logits(q, k, q_ids, kv_ids, scale: float, mode: str, causal: bool = False) -> torch.Tensor:
    """(b, h, s, s) fp32 logits with the segment mask applied as the kernels apply it."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    allowed = (q_ids[:, None, :, None] == kv_ids[:, None, None, :])
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        allowed = allowed & (pos[None, :] <= pos[:, None])
    if mode == "bias":
        return logits + allowed.float()
    return torch.where(allowed, logits, torch.full_like(logits, NEG_INF))


def _check_kernel_inputs(q, like_q, q_ids, kv_ids, mode: str, rows=None) -> None:
    """Raise on what the kernels do not take.  `like_q` maps names to tensors of
    q's layout, `rows` to (b, h, s) fp32 row vectors (lse, delta)."""
    b, h, s, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bfloat16 or float32, got {q.dtype}")
    if d not in (32, 64):
        raise ValueError(f"attention kernel supports head dim 32 or 64, got {d}")
    if mode not in ("block", "bias"):
        raise ValueError(f"unknown attention mask mode {mode!r}")
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, t in (("q_ids", q_ids), ("kv_ids", kv_ids)):
        if t.shape != (b, s) or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name} must be int32 of shape {(b, s)} on {q.device}")
    rows = rows or {}
    for name, t in rows.items():
        if t.shape != (b, h, s) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be float32 of shape {(b, h, s)} on {q.device}")
    if not all(t.is_contiguous() for t in (q, *like_q.values(), q_ids, kv_ids, *rows.values())):
        raise ValueError("attention kernel takes contiguous tensors")


def attention_fwd_plain(q, k, v, q_ids, kv_ids, scale: float, mode: str = "block", causal: bool = False):
    """Eager PyTorch version of the kernel: returns (o, lse).

    p is rounded to the input type before P.V (``p.astype(v.dtype)`` in the
    Pallas kernel; nothing happens to float32); the denominator and lse come
    from the unrounded fp32 p, o is rounded once at the end.
    """
    logits = _masked_logits(q, k, q_ids, kv_ids, scale, mode, causal)
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF * 0.5)
    p = torch.exp(logits - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / denom
    lse = (m + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def _kernel_impl(impl: Optional[str], dtype: torch.dtype) -> str:
    """The implementation an attention launch takes (forward and backward
    alike): tensor cores ("mma") for bfloat16 unless "simt" is asked for, the
    CUDA-core kernels for float32."""
    if impl is None:
        return "mma" if dtype == torch.bfloat16 else "simt"
    if impl not in IMPLS:
        raise ValueError(f"unknown attention kernel impl {impl!r}: one of {IMPLS}")
    if impl == "mma" and dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core attention kernels take bfloat16, got {dtype}")
    return impl


def _check_mma_alignment(tensors: Dict[str, torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte boundary for the tensor-core kernels")


def attention_fwd_cuda(
    q, k, v, q_ids, kv_ids, scale: float, mode: str = "block", causal: bool = False, skip_tiles: bool = True,
    impl: Optional[str] = None,
):
    """Launch csrc/attention_fwd.cu: returns (o, lse).

    ``impl``: None takes the tensor-core kernel for bfloat16 and the
    CUDA-core kernel for float32; "simt" asks for the CUDA-core kernel on
    bfloat16 too; "mma" with float32 raises TypeError.
    """
    global LAUNCHES, LAUNCHES_CAUSAL
    from . import _build

    impl = _kernel_impl(impl, q.dtype)
    _check_kernel_inputs(q, {"k": k, "v": v}, q_ids, kv_ids, mode)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if impl == "mma":
        _check_mma_alignment({"q": q, "k": k, "v": v, "o": o})
    fn = _build.load("attention_fwd").attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ids.data_ptr(), kv_ids.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, s, d, float(scale),
        int(mode == "bias"), int(causal), int(skip_tiles), int(q.dtype == torch.bfloat16), IMPLS.index(impl),
        _build.stream_ptr(q.device),
    )
    _build.check(err, f"attention_fwd ({impl})")
    if causal:
        LAUNCHES_CAUSAL += 1
    else:
        LAUNCHES += 1
    LAUNCHES_FWD_IMPL[impl] += 1
    return o, lse


def attention_fwd(q, k, v, q_ids, kv_ids, scale: float, mode: str = "block", causal: bool = False):
    """(o, lse) from the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cuda":
        return attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, causal)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on CUDA or the CPU, not {q.device}")
    return attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal)


def attention_bwd_plain(
    q, k, v, q_ids, kv_ids, o, lse, do, scale: float, mode: str = "block", causal: bool = False
):
    """Eager PyTorch version of the two backward kernels: returns (dq, dk, dv).

    Recomputes p from the saved lse in fp32.  p and ds are rounded to the
    input type before the second products (``ds.astype(q.dtype)`` and
    ``p_t.astype(do.dtype)`` in the Pallas kernels; nothing happens to
    float32), sums are fp32, results are in the input types.
    """
    logits = _masked_logits(q, k, q_ids, kv_ids, scale, mode, causal)
    p = torch.exp(logits - lse[..., None])  # rows of padded queries are 0 in 'block' mode
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# both backward entry points: 10 pointers, b h s d, scale, mode, causal, skip_tiles, dtype, impl, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p
]


def attention_dq_cuda(
    q, k, v, q_ids, kv_ids, o, lse, do, scale: float, mode: str = "block", causal: bool = False,
    skip_tiles: bool = True, impl: Optional[str] = None,
):
    """Launch the dq kernel of csrc/attention_bwd.cu: returns (dq, delta).

    delta = rowsum(do * o) (b, h, s) fp32 is computed in the kernel's
    prologue; ``attention_dkv_cuda`` takes it.  ``impl``: None takes the
    tensor-core kernel for bfloat16 and the CUDA-core kernel for float32;
    "simt" asks for the CUDA-core kernel on bfloat16 too; "mma" with float32
    raises TypeError.
    """
    global LAUNCHES_DQ, LAUNCHES_DQ_CAUSAL
    from . import _build

    impl = _kernel_impl(impl, q.dtype)
    like_q = {"k": k, "v": v, "o": o, "do": do}
    _check_kernel_inputs(q, like_q, q_ids, kv_ids, mode, {"lse": lse})
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if impl == "mma":
        _check_mma_alignment({"q": q, **like_q, "dq": dq})
    fn = _build.load("attention_bwd").attn_bwd_dq
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        q_ids.data_ptr(), kv_ids.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        b, h, s, d, float(scale), int(mode == "bias"), int(causal), int(skip_tiles),
        int(q.dtype == torch.bfloat16), IMPLS.index(impl), _build.stream_ptr(q.device),
    )
    _build.check(err, f"attention_bwd dq ({impl})")
    if causal:
        LAUNCHES_DQ_CAUSAL += 1
    else:
        LAUNCHES_DQ += 1
    LAUNCHES_BWD_IMPL[impl] += 1
    return dq, delta


def attention_dkv_cuda(
    q, k, v, q_ids, kv_ids, lse, delta, do, scale: float, mode: str = "block", causal: bool = False,
    skip_tiles: bool = True, impl: Optional[str] = None,
):
    """Launch the dk/dv kernel of csrc/attention_bwd.cu: returns (dk, dv).  ``impl`` as in ``attention_dq_cuda``."""
    global LAUNCHES_DKV, LAUNCHES_DKV_CAUSAL
    from . import _build

    impl = _kernel_impl(impl, q.dtype)
    like_q = {"k": k, "v": v, "do": do}
    _check_kernel_inputs(q, like_q, q_ids, kv_ids, mode, {"lse": lse, "delta": delta})
    b, h, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if impl == "mma":
        _check_mma_alignment({"q": q, **like_q, "dk": dk, "dv": dv})
    fn = _build.load("attention_bwd").attn_bwd_dkv
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        q_ids.data_ptr(), kv_ids.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, s, d, float(scale), int(mode == "bias"), int(causal), int(skip_tiles),
        int(q.dtype == torch.bfloat16), IMPLS.index(impl), _build.stream_ptr(q.device),
    )
    _build.check(err, f"attention_bwd dkv ({impl})")
    if causal:
        LAUNCHES_DKV_CAUSAL += 1
    else:
        LAUNCHES_DKV += 1
    LAUNCHES_BWD_IMPL[impl] += 1
    return dk, dv


def attention_kernel_info(kernel: str, impl: str, dtype: torch.dtype, d: int) -> Dict[str, int]:
    """What the compiler and the card make of one instantiation of an attention
    kernel ("fwd", "dq" or "dkv"): registers and local-memory (spill) bytes a
    thread (``cudaFuncGetAttributes``), the blocks that fit on one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the shared-memory
    bytes a block.  Needs the card."""
    from . import _build

    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"unknown attention kernel {kernel!r}: one of fwd, dq, dkv")
    impl = _kernel_impl(impl, dtype)
    out = (ctypes.c_int * 4)()
    if kernel == "fwd":
        fn = _build.load("attention_fwd").attn_fwd_kernel_info
        args = (IMPLS.index(impl), int(dtype == torch.bfloat16), d)
    else:
        fn = _build.load("attention_bwd").attn_bwd_kernel_info
        args = (int(kernel == "dkv"), IMPLS.index(impl), int(dtype == torch.bfloat16), d)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    _build.check(fn(*args, ctypes.addressof(out)), f"attention {kernel} ({impl}) info")
    return dict(zip(("num_regs", "local_size_bytes", "blocks_per_sm", "shared_size_bytes"), out))


def attention_bwd(q, k, v, q_ids, kv_ids, o, lse, do, scale: float, mode: str = "block", causal: bool = False):
    """(dq, dk, dv) from the two kernels for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cuda":
        dq, delta = attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal)
        dk, dv = attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, causal)
        return dq, dk, dv
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on CUDA or the CPU, not {q.device}")
    return attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal)


class _PackedAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, scale, mode, causal):
        o, lse = attention_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal)
        ctx.save_for_backward(q, k, v, q_ids, kv_ids, o, lse)
        ctx.scale, ctx.mode, ctx.causal = scale, mode, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_ids, kv_ids, o, lse = ctx.saved_tensors
        # autograd often hands over a transposed view (the head merge)
        dq, dk, dv = attention_bwd(
            q, k, v, q_ids, kv_ids, o, lse, do.contiguous(), ctx.scale, ctx.mode, ctx.causal
        )
        return dq, dk, dv, None, None, None, None, None


def packed_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    image_ids: torch.Tensor,
    key_pad_mask: torch.Tensor,
    scale: float,
    mode: str = "block",
    causal: bool = False,
) -> torch.Tensor:
    """Attention over packed rows; (b, h, s, d) q/k/v, (b, s) ids and padding.

    Tokens attend only within their image (mode='block') or get the
    reference's +1 logit bias inside it (mode='bias').  Padded queries give
    zeros in 'block' mode.  causal=True adds k_pos <= q_pos (positions are
    the row indices) to what is allowed.
    """
    q_ids, kv_ids = segment_ids(image_ids, key_pad_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _PackedAttention.apply(q, k, v, q_ids, kv_ids, scale, mode, causal)
    o, _ = attention_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal)
    return o
