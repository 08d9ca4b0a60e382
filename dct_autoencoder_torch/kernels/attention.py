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

Each kernel has several implementations (see the sources' headers).  For
bfloat16 the products run on the tensor cores ("mma": ``mma.sync``, bf16
operands, fp32 accumulators); what holds them above their byte bound is
inside the SM (one ``ldmatrix`` feeds two ``mma``, and the mask and the exp
run on the CUDA cores between the products).  p (and in the backward ds) is
rounded to bf16 before the second product, as the Pallas kernels round it
(``p.astype(v.dtype)``), because the tensor cores take it as a bf16 operand;
the plain versions round at the same places, so the kernels and the plain
versions compute the same function.  The forward's online softmax rounds p
relative to the running row max where the Pallas kernel rounds it relative
to the row's final max, so o can differ by one bf16 ulp now and then; no bit
of the masking differs.  For float32 the three kernels run on the
tensor cores in 3xTF32 ("tf32x3": each product as three TF32 products of hi
and lo parts, about 22 significant bits, within fp32's 1e-5): the forward in
csrc/attention_fwd_tf32x3.cu, the two backward kernels in
csrc/attention_bwd_tf32x3.cu, the online softmax, p and ds in fp32.
``impl="simt"`` on the ``*_cuda`` wrappers runs the CUDA-core kernels (true
fp32 on the CUDA cores, their first design) on either type, for timing the
old design beside the new one on one card; nothing on a model's path passes
it.

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

Head dims: the kernels are compiled for d = 16, 32, 64 and 128
(``HEAD_DIMS``), and the ``*_cuda`` wrappers take any 1 <= d <= 128
(``row_width``).  The tensor-core kernels ("mma", "tf32x3") read and write
rows of d in place wherever a row is whole 16-byte chunks (d % 8 == 0 in
bfloat16, d % 4 == 0 in float32: d = 24, 48, 80, 96, 112 run with no copy):
their loads zero-fill the columns from d to the instantiation and their
stores write only columns < d.  Other widths, and ``impl="simt"``, are
padded by the wrapper with zero columns up to the next instantiation
(``pad_head_dim``, counted in ``LAUNCHES_PAD``) and the results cut back.
Both are exact: zero columns add nothing to q.k, a zero v column only makes
an o column that is not kept, and ``scale`` stays the caller's.  d > 128
raises ValueError.

Dropout (an ``AttentionDropout``; JAX drops the softmax weights with
``nn.Dropout`` on its XLA attention path): the kernels draw the keep bits
from a counter-based Philox4x32-10 stream keyed by a 64-bit seed that they
read from a device tensor (csrc/attn_dropout.cuh), so the forward and both
backward kernels draw the same mask without storing it, and a layer does no
host read.  The counter is (batch row, head, query, key), offset by where
the call's rows and heads lie in the whole batch and model, so a data- or
tensor-parallel rank draws its block of the single-device mask.
``attention_dropout_keep_mask`` is the same stream in plain PyTorch, bit for
bit, and the plain versions use it.  The forward computes
o = (1/l) sum_j p_j z_j v_j / (1 - rate) with l and lse from the undropped
p; the backward regenerates z from the seed (see attention_bwd_plain).

``LAUNCHES``, ``LAUNCHES_DQ`` and ``LAUNCHES_DKV`` count the non-causal
kernel launches without dropout, ``LAUNCHES_CAUSAL``, ``LAUNCHES_DQ_CAUSAL``
and ``LAUNCHES_DKV_CAUSAL`` the causal ones; ``LAUNCHES_DROPOUT``,
``LAUNCHES_DQ_DROPOUT`` and ``LAUNCHES_DKV_DROPOUT`` the launches in the
dropout mode, causal or not.  ``LAUNCHES_FWD_IMPL`` counts the
forward's launches, causal or not, and ``LAUNCHES_BWD_IMPL`` those of both
backward kernels, by implementation ("mma", "simt", "tf32x3").
``LAUNCHES_PAD`` counts the tensors ``pad_head_dim`` copied.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are compiled for

LAUNCHES = 0
LAUNCHES_DQ = 0
LAUNCHES_DKV = 0
LAUNCHES_CAUSAL = 0
LAUNCHES_DQ_CAUSAL = 0
LAUNCHES_DKV_CAUSAL = 0
LAUNCHES_DROPOUT = 0
LAUNCHES_DQ_DROPOUT = 0
LAUNCHES_DKV_DROPOUT = 0
LAUNCHES_FWD_IMPL = {"mma": 0, "simt": 0, "tf32x3": 0}
LAUNCHES_BWD_IMPL = {"mma": 0, "simt": 0, "tf32x3": 0}
LAUNCHES_PAD = 0

IMPLS = ("simt", "mma", "tf32x3")  # the index is the `impl` argument of the C entry points


def segment_ids(image_ids: torch.Tensor, key_pad_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_ids, kv_ids) int32: padded queries get -2, padded keys -1."""
    ids = image_ids.to(torch.int32)
    q_ids = torch.where(key_pad_mask, torch.full_like(ids, -2), ids)
    kv_ids = torch.where(key_pad_mask, torch.full_like(ids, -1), ids)
    return q_ids.contiguous(), kv_ids.contiguous()


def kernel_head_dim(d: int) -> int:
    """The head dim of the kernel instantiation that runs head dim d (the
    smallest of HEAD_DIMS >= d); ValueError past the largest."""
    for dim in HEAD_DIMS:
        if 1 <= d <= dim:
            return dim
    raise ValueError(f"attention kernel supports head dims 1 to {HEAD_DIMS[-1]}, got head dim {d}")


def row_width(d: int, dtype: torch.dtype, impl: str) -> int:
    """The width of the rows that kernel `impl` reads and writes for head dim d:
    d itself where the kernel takes rows of d in place (the tensor-core
    kernels, "mma" and "tf32x3", on rows of whole 16-byte chunks), else
    ``kernel_head_dim(d)``, to which the wrapper pads.  ValueError past the
    largest instantiation."""
    dim = kernel_head_dim(d)
    in_place = impl != "simt" and (d * torch.finfo(dtype).bits // 8) % 16 == 0
    return d if in_place else dim


def pad_head_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t with zero columns appended to its last axis up to `dim` (t itself at
    `dim`); each copy counts one in ``LAUNCHES_PAD``."""
    global LAUNCHES_PAD
    if t.shape[-1] == dim:
        return t
    LAUNCHES_PAD += 1
    return F.pad(t, (0, dim - t.shape[-1]))


@dataclasses.dataclass(frozen=True)
class AttentionDropout:
    """Dropout of the softmax weights inside the attention kernels.

    ``seed`` is the 64-bit key of the Philox stream, an int64 tensor of one
    element on the attention's device (the kernels read it there).  ``row0``
    and ``head0`` are where this call's batch rows and heads start in the
    whole batch and model: a data-parallel rank passes its first row, a
    tensor-parallel rank its first head, so that each draws its block of the
    single-device mask."""

    rate: float
    seed: torch.Tensor
    row0: int = 0
    head0: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"attention dropout rate must be in [0, 1), got {self.rate}")
        if self.seed.dtype != torch.int64 or self.seed.numel() != 1:
            raise ValueError("the attention dropout seed is an int64 tensor of one element")

    @property
    def threshold(self) -> int:
        """A pair is kept when its 32-bit word is >= this: round(rate * 2^32)."""
        return min(round(self.rate * 2**32), 2**32 - 1)

    @property
    def keep_scale(self) -> float:
        """1 / (1 - rate), rounded to float32 as the kernels apply it."""
        return torch.tensor(1.0 / (1.0 - self.rate), dtype=torch.float32).item()


def draw_dropout_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One 64-bit attention dropout seed from `generator` (the default
    generator of `device` for None), as an int64 tensor on `device`."""
    return torch.randint(0, 2**62, (1,), generator=generator, device=device, dtype=torch.int64)


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo32(a: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of a * x for a 32-bit constant and int64 tensors
    of 32-bit values.  a * x itself overflows int64, so the constant is split
    into 16-bit halves: a * x = (ah x) 2^16 + al x, each part < 2^48, and
    sum = al x + (ah x mod 2^16) 2^16 holds the low word and the carry."""
    hx, lx = (a >> 16) * x, (a & 0xFFFF) * x
    low = lx + ((hx & 0xFFFF) << 16)
    return (hx >> 16) + (low >> 32), low & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 of csrc/attn_dropout.cuh in int64 tensors: four counter
    words and two key words (tensors or ints, broadcast together, each a
    32-bit value) -> the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def attention_dropout_keep_mask(
    seed, rate: float, b: int, h: int, s: int, row0: int = 0, head0: int = 0
) -> torch.Tensor:
    """(b, h, s, s) bool: the keep bits the kernels draw for `seed` (an int or
    an int64 tensor of one element; the mask lies on its device) at `rate`.

    Pair (q, k) of row r and head j is decided by word
    (q >> 3 & 1) * 2 + (k >> 3 & 1) of Philox4x32-10 at the counter
    (row0 + r, head0 + j, g(q), g(k)), g(i) = (i >> 4) * 8 + (i & 7), keyed
    by the seed's low and high 32 bits; it is kept when the word is >=
    round(rate * 2^32)."""
    if not torch.is_tensor(seed):
        seed = torch.tensor([seed], dtype=torch.int64)
    seed = seed.reshape(-1)
    dev, n16 = seed.device, (s + 15) // 16
    groups = n16 * 8
    i64 = dict(dtype=torch.int64, device=dev)
    shape = (b, h, groups, groups)
    counter = (
        (row0 + torch.arange(b, **i64)).view(b, 1, 1, 1).expand(shape),
        (head0 + torch.arange(h, **i64)).view(1, h, 1, 1).expand(shape),
        torch.arange(groups, **i64).view(1, 1, groups, 1).expand(shape),
        torch.arange(groups, **i64).view(1, 1, 1, groups).expand(shape),
    )
    words = torch.stack(philox4x32_10(counter, (seed & _U32, (seed >> 32) & _U32)), dim=-1)
    keep = words >= AttentionDropout(rate, seed).threshold
    # (b, h, q block, q low, k block, k low, q bit 3, k bit 3) -> positions
    keep = keep.view(b, h, n16, 8, n16, 8, 2, 2).permute(0, 1, 2, 6, 3, 4, 7, 5)
    return keep.reshape(b, h, n16 * 16, n16 * 16)[:, :, :s, :s]


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


def _check_kernel_inputs(q, like_q, q_ids, kv_ids, mode: str, rows=None, dropout=None) -> None:
    """Raise on what the kernels do not take.  `like_q` maps names to tensors of
    q's layout, `rows` to (b, h, s) fp32 row vectors (lse, delta)."""
    b, h, s, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bfloat16 or float32, got {q.dtype}")
    kernel_head_dim(d)
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
    if dropout is not None and dropout.seed.device != q.device:
        raise ValueError(f"the attention dropout seed must lie on {q.device}")


def attention_fwd_plain(
    q, k, v, q_ids, kv_ids, scale: float, mode: str = "block", causal: bool = False,
    dropout: Optional[AttentionDropout] = None,
):
    """Eager PyTorch version of the kernel: returns (o, lse).

    p is rounded to the input type before P.V (``p.astype(v.dtype)`` in the
    Pallas kernel; nothing happens to float32); the denominator and lse come
    from the unrounded fp32 p, o is rounded once at the end.  With `dropout`
    the rounded p is multiplied by the keep bits and o by 1 / (1 - rate).
    """
    logits = _masked_logits(q, k, q_ids, kv_ids, scale, mode, causal)
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF * 0.5)
    p = torch.exp(logits - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    pv = p.to(v.dtype).float()
    if dropout is not None:
        b, h, s, _ = q.shape
        pv = pv * attention_dropout_keep_mask(dropout.seed, dropout.rate, b, h, s, dropout.row0, dropout.head0)
    o = torch.einsum("bhqk,bhkd->bhqd", pv, v.float()) / denom
    if dropout is not None:
        o = o * dropout.keep_scale
    lse = (m + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def _kernel_impl(impl: Optional[str], dtype: torch.dtype, kernel: str = "fwd") -> str:
    """The implementation a launch of attention kernel `kernel` ("fwd", "dq"
    or "dkv") takes: the tensor cores of its dtype, "mma" for bfloat16 and
    "tf32x3" for float32, unless "simt" (the CUDA cores) is asked for."""
    if impl is None:
        return "mma" if dtype == torch.bfloat16 else "tf32x3"
    if impl not in IMPLS:
        raise ValueError(f"unknown attention {kernel} kernel impl {impl!r}: one of {IMPLS}")
    if impl == "mma" and dtype != torch.bfloat16:
        raise TypeError(f"the bf16 tensor-core attention kernels take bfloat16, got {dtype}")
    if impl == "tf32x3" and dtype != torch.float32:
        raise TypeError(f"the 3xTF32 attention kernels take float32, got {dtype}")
    return impl


def _check_mma_alignment(tensors: Dict[str, torch.Tensor]) -> None:
    """Raise ValueError, naming the tensor, unless every row of each tensor
    starts on a 16-byte boundary, as the tensor-core kernels' 16-byte copies
    need: its base address, and its row stride (contiguous rows: the row
    width times the element size), multiples of 16 bytes."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte boundary for the tensor-core kernels")
        if t.stride(-1) != 1 or (t.stride(-2) * t.element_size()) % 16:
            raise ValueError(
                f"{name}'s rows must lie a multiple of 16 bytes apart for the tensor-core kernels, "
                f"got a row stride of {t.stride(-2) * t.element_size()} bytes"
            )


def _fwd_entry(impl: str, info: bool = False):
    """The C entry point of the forward in implementation `impl` (its
    kernel-info function with `info`): csrc/attention_fwd_tf32x3.cu for
    "tf32x3", csrc/attention_fwd.cu for the others."""
    from . import _build

    tag = "_tf32x3" if impl == "tf32x3" else ""
    lib = _build.load(f"attention_fwd{tag}")
    return getattr(lib, f"attn_fwd{tag}_kernel_info" if info else f"attn_fwd{tag}")


def _bwd_entry(kernel: str, impl: str, info: bool = False):
    """The C entry point of backward kernel `kernel` ("dq" or "dkv") in
    implementation `impl` (its kernel-info function with `info`):
    csrc/attention_bwd_tf32x3.cu for "tf32x3", csrc/attention_bwd.cu for the
    others; each source builds one library a kernel."""
    from . import _build

    tag = "_tf32x3" if impl == "tf32x3" else ""
    lib = _build.load(f"attention_bwd{tag}_{kernel}")
    return getattr(lib, f"attn_bwd{tag}_kernel_info" if info else f"attn_bwd{tag}_{kernel}")


# the dropout arguments of the C entry points: seed pointer, threshold, 1 / (1 - rate), row0, head0
_DROP_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ctypes.c_int]


# the forward's entry point: 7 pointers, b h s d, scale, mode, causal, skip_tiles, dtype, impl, dropout, stream
_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + _DROP_ARGTYPES
    + [ctypes.c_void_p]
)


def _drop_args(dropout: Optional[AttentionDropout]) -> tuple:
    if dropout is None:
        return (None, 0, 1.0, 0, 0)
    return (dropout.seed.data_ptr(), dropout.threshold, dropout.keep_scale, dropout.row0, dropout.head0)


def attention_fwd_cuda(
    q, k, v, q_ids, kv_ids, scale: float, mode: str = "block", causal: bool = False, skip_tiles: bool = True,
    impl: Optional[str] = None, dropout: Optional[AttentionDropout] = None,
):
    """Launch csrc/attention_fwd.cu (csrc/attention_fwd_tf32x3.cu for
    "tf32x3"): returns (o, lse).

    ``impl``: None takes the tensor-core kernel of the dtype ("mma" for
    bfloat16, "tf32x3" for float32); "simt" asks for the CUDA-core kernel;
    "mma" with float32 or "tf32x3" with bfloat16 raises TypeError.  Head
    dims as ``row_width`` says: in place, or padded with zero columns and o
    cut back.
    """
    global LAUNCHES, LAUNCHES_CAUSAL, LAUNCHES_DROPOUT
    from . import _build

    impl = _kernel_impl(impl, q.dtype)
    _check_kernel_inputs(q, {"k": k, "v": v}, q_ids, kv_ids, mode, dropout=dropout)
    b, h, s, d = q.shape
    width = row_width(d, q.dtype, impl)
    q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if impl != "simt":
        _check_mma_alignment({"q": q, "k": k, "v": v, "o": o})
    fn = _fwd_entry(impl)
    fn.restype = ctypes.c_int
    fn.argtypes = _FWD_ARGTYPES
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ids.data_ptr(), kv_ids.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, s, width, float(scale),
        int(mode == "bias"), int(causal), int(skip_tiles), int(q.dtype == torch.bfloat16), IMPLS.index(impl),
        *_drop_args(dropout), _build.stream_ptr(q.device),
    )
    _build.check(err, f"attention_fwd ({impl})")
    if dropout is not None:
        LAUNCHES_DROPOUT += 1
    elif causal:
        LAUNCHES_CAUSAL += 1
    else:
        LAUNCHES += 1
    LAUNCHES_FWD_IMPL[impl] += 1
    return (o if width == d else o[..., :d].contiguous()), lse


def attention_fwd(
    q, k, v, q_ids, kv_ids, scale: float, mode: str = "block", causal: bool = False,
    dropout: Optional[AttentionDropout] = None,
):
    """(o, lse) from the kernel for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cuda":
        return attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, causal, dropout=dropout)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on CUDA or the CPU, not {q.device}")
    return attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal, dropout)


def attention_bwd_plain(
    q, k, v, q_ids, kv_ids, o, lse, do, scale: float, mode: str = "block", causal: bool = False,
    dropout: Optional[AttentionDropout] = None,
):
    """Eager PyTorch version of the two backward kernels: returns (dq, dk, dv).

    Recomputes p from the saved lse in fp32.  p and ds are rounded to the
    input type before the second products (``ds.astype(q.dtype)`` and
    ``p_t.astype(do.dtype)`` in the Pallas kernels; nothing happens to
    float32), sums are fp32, results are in the input types.  With `dropout`
    the keep bits z are drawn again from the seed: dv = (p z / (1 - rate))^T
    do, dp = z / (1 - rate) * (do v^T), ds = p (dp - delta) with delta =
    rowsum(do * o) of the dropped o.
    """
    logits = _masked_logits(q, k, q_ids, kv_ids, scale, mode, causal)
    p = torch.exp(logits - lse[..., None])  # rows of padded queries are 0 in 'block' mode
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    pv = p
    if dropout is not None:
        b, h, s, _ = q.shape
        keep = attention_dropout_keep_mask(dropout.seed, dropout.rate, b, h, s, dropout.row0, dropout.head0)
        z = keep.float() * dropout.keep_scale  # z / (1 - rate)
        pv, dp = p * z, dp * z
    dv = torch.einsum("bhqk,bhqd->bhkd", pv.to(do.dtype).float(), do32)
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# both backward entry points: 10 pointers, b h s d, scale, mode, causal, skip_tiles, dtype, impl, dropout, stream
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 + _DROP_ARGTYPES
    + [ctypes.c_void_p]
)


def attention_dq_cuda(
    q, k, v, q_ids, kv_ids, o, lse, do, scale: float, mode: str = "block", causal: bool = False,
    skip_tiles: bool = True, impl: Optional[str] = None, dropout: Optional[AttentionDropout] = None,
):
    """Launch the dq kernel of csrc/attention_bwd.cu (csrc/attention_bwd_tf32x3.cu
    for "tf32x3"): returns (dq, delta).

    delta = rowsum(do * o) (b, h, s) fp32 is computed in the kernel's
    prologue; ``attention_dkv_cuda`` takes it.  ``impl``: None takes the
    tensor-core kernel of the dtype ("mma" for bfloat16, "tf32x3" for
    float32); "simt" asks for the CUDA-core kernel; "mma" with float32 or
    "tf32x3" with bfloat16 raises TypeError.  Head dims as in
    ``attention_fwd_cuda``.
    """
    global LAUNCHES_DQ, LAUNCHES_DQ_CAUSAL, LAUNCHES_DQ_DROPOUT
    from . import _build

    impl = _kernel_impl(impl, q.dtype, "dq")
    like_q = {"k": k, "v": v, "o": o, "do": do}
    _check_kernel_inputs(q, like_q, q_ids, kv_ids, mode, {"lse": lse}, dropout)
    b, h, s, d = q.shape
    width = row_width(d, q.dtype, impl)
    q = pad_head_dim(q, width)
    like_q = {name: pad_head_dim(t, width) for name, t in like_q.items()}
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if impl != "simt":
        _check_mma_alignment({"q": q, **like_q, "dq": dq})
    fn = _bwd_entry("dq", impl)
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    k, v, o, do = like_q["k"], like_q["v"], like_q["o"], like_q["do"]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        q_ids.data_ptr(), kv_ids.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        b, h, s, width, float(scale), int(mode == "bias"), int(causal), int(skip_tiles),
        int(q.dtype == torch.bfloat16), IMPLS.index(impl), *_drop_args(dropout), _build.stream_ptr(q.device),
    )
    _build.check(err, f"attention_bwd dq ({impl})")
    if dropout is not None:
        LAUNCHES_DQ_DROPOUT += 1
    elif causal:
        LAUNCHES_DQ_CAUSAL += 1
    else:
        LAUNCHES_DQ += 1
    LAUNCHES_BWD_IMPL[impl] += 1
    return (dq if width == d else dq[..., :d].contiguous()), delta


def attention_dkv_cuda(
    q, k, v, q_ids, kv_ids, lse, delta, do, scale: float, mode: str = "block", causal: bool = False,
    skip_tiles: bool = True, impl: Optional[str] = None, dropout: Optional[AttentionDropout] = None,
):
    """Launch the dk/dv kernel of csrc/attention_bwd.cu (csrc/attention_bwd_tf32x3.cu
    for "tf32x3"): returns (dk, dv).  ``impl`` and head dims as in ``attention_dq_cuda``."""
    global LAUNCHES_DKV, LAUNCHES_DKV_CAUSAL, LAUNCHES_DKV_DROPOUT
    from . import _build

    impl = _kernel_impl(impl, q.dtype, "dkv")
    like_q = {"k": k, "v": v, "do": do}
    _check_kernel_inputs(q, like_q, q_ids, kv_ids, mode, {"lse": lse, "delta": delta}, dropout)
    b, h, s, d = q.shape
    width = row_width(d, q.dtype, impl)
    q = pad_head_dim(q, width)
    like_q = {name: pad_head_dim(t, width) for name, t in like_q.items()}
    k, v, do = like_q["k"], like_q["v"], like_q["do"]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if impl != "simt":
        _check_mma_alignment({"q": q, **like_q, "dk": dk, "dv": dv})
    fn = _bwd_entry("dkv", impl)
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        q_ids.data_ptr(), kv_ids.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, s, width, float(scale), int(mode == "bias"), int(causal), int(skip_tiles),
        int(q.dtype == torch.bfloat16), IMPLS.index(impl), *_drop_args(dropout), _build.stream_ptr(q.device),
    )
    _build.check(err, f"attention_bwd dkv ({impl})")
    if dropout is not None:
        LAUNCHES_DKV_DROPOUT += 1
    elif causal:
        LAUNCHES_DKV_CAUSAL += 1
    else:
        LAUNCHES_DKV += 1
    LAUNCHES_BWD_IMPL[impl] += 1
    if width != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def attention_kernel_info(
    kernel: str, impl: str, dtype: torch.dtype, d: int, dropout: bool = False
) -> Dict[str, int]:
    """What the compiler and the card make of one instantiation of an attention
    kernel ("fwd", "dq" or "dkv"; the one that runs head dim d, in the dropout
    mode with `dropout`): registers and local-memory (spill) bytes a thread
    (``cudaFuncGetAttributes``), the blocks that fit on one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the shared-memory
    bytes a block.  Needs the card."""
    from . import _build

    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"unknown attention kernel {kernel!r}: one of fwd, dq, dkv")
    impl = _kernel_impl(impl, dtype, kernel)
    out = (ctypes.c_int * 4)()
    dim = kernel_head_dim(d)
    fn = _fwd_entry(impl, info=True) if kernel == "fwd" else _bwd_entry(kernel, impl, info=True)
    args = (IMPLS.index(impl), int(dtype == torch.bfloat16), dim, int(dropout))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    _build.check(fn(*args, ctypes.addressof(out)), f"attention {kernel} ({impl}) info")
    return dict(zip(("num_regs", "local_size_bytes", "blocks_per_sm", "shared_size_bytes"), out))


def attention_bwd(
    q, k, v, q_ids, kv_ids, o, lse, do, scale: float, mode: str = "block", causal: bool = False,
    dropout: Optional[AttentionDropout] = None,
):
    """(dq, dk, dv) from the two kernels for CUDA tensors, the plain version on the CPU."""
    if q.device.type == "cuda":
        dq, delta = attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, dropout=dropout)
        dk, dv = attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, causal, dropout=dropout)
        return dq, dk, dv
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on CUDA or the CPU, not {q.device}")
    return attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, dropout)


class _PackedAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the backward kernels as its gradient; the
    dropout's seed is kept for the backward, which draws the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, scale, mode, causal, dropout):
        o, lse = attention_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal, dropout)
        ctx.save_for_backward(q, k, v, q_ids, kv_ids, o, lse)
        ctx.scale, ctx.mode, ctx.causal, ctx.dropout = scale, mode, causal, dropout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_ids, kv_ids, o, lse = ctx.saved_tensors
        # autograd often hands over a transposed view (the head merge)
        dq, dk, dv = attention_bwd(
            q, k, v, q_ids, kv_ids, o, lse, do.contiguous(), ctx.scale, ctx.mode, ctx.causal, ctx.dropout
        )
        return dq, dk, dv, None, None, None, None, None, None


def packed_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    image_ids: torch.Tensor,
    key_pad_mask: torch.Tensor,
    scale: float,
    mode: str = "block",
    causal: bool = False,
    dropout_rate: float = 0.0,
    seed: Optional[torch.Tensor] = None,
    row0: int = 0,
    head0: int = 0,
) -> torch.Tensor:
    """Attention over packed rows; (b, h, s, d) q/k/v, (b, s) ids and padding.

    Tokens attend only within their image (mode='block') or get the
    reference's +1 logit bias inside it (mode='bias').  Padded queries give
    zeros in 'block' mode.  causal=True adds k_pos <= q_pos (positions are
    the row indices) to what is allowed.  dropout_rate > 0 drops the softmax
    weights with the keep bits of `seed` (an int64 tensor of one element on
    q's device; ``draw_dropout_seed``), this call's rows and heads taken as
    rows row0.. and heads head0.. of the whole batch and model.
    """
    q_ids, kv_ids = segment_ids(image_ids, key_pad_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dropout = None
    if dropout_rate > 0.0:
        if seed is None:
            raise ValueError("attention dropout needs a seed (draw_dropout_seed)")
        dropout = AttentionDropout(dropout_rate, seed, row0, head0)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _PackedAttention.apply(q, k, v, q_ids, kv_ids, scale, mode, causal, dropout)
    o, _ = attention_fwd(q, k, v, q_ids, kv_ids, scale, mode, causal, dropout)
    return o
