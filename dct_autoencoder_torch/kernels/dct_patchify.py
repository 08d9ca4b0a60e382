"""Fused RGB -> IPT -> DCT -> crop -> patchify, with a CUDA kernel for Hopper.

Replaces dct_autoencoder_tpu/kernels/dct_patchify.py::_kernel (the Pallas
kernel called from fused_ipt_dct_patchify).  The kernel is
csrc/dct_patchify.cu (see the source's header): the colour transform once
per pixel into IPT planes, then both products on the tensor cores in
3xTF32, which keeps fp32's precision where one TF32 product would not, with
the patch layout fused into the store of the tokens.  The tiles live in
shared memory, so unlike the TPU kernel there is no limit on the image area.
The DCT matrices, and their TF32 splits, come from ops/dct.py's caches on
the device.

For a CPU tensor ``fused_ipt_dct_patchify`` runs the plain version; for a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts calls
that launched the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..ops.colorspace import IPT_GAMMA, M_IPT, RGB2LMS
from ..ops.dct import dct_matrix_cropped, dct_matrix_tf32

LAUNCHES = 0


def round_up4(n: int) -> int:
    """n rounded up to a multiple of 4: a row stride the 16-byte copies take."""
    return -(-n // 4) * 4


def kernel_info(lib: str, which: int) -> Dict[str, int]:
    """What the compiler and the card make of product `which` (1 or 2) of
    kernel library `lib` ("dct_patchify" or "idct_unpatchify"): registers
    and local-memory (spill) bytes a thread, the blocks that fit on one SM
    and the shared-memory bytes a block, at its 64 x 64 tile.  Needs the card."""
    from . import _build

    fn = getattr(_build.load(lib), f"{lib}_kernel_info")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check(fn(which, ctypes.addressof(out)), f"{lib} info")
    return dict(zip(("num_regs", "local_size_bytes", "blocks_per_sm", "shared_size_bytes"), out))


def _signed_pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """sign(x) |x|^gamma in the kernels' exp/log form."""
    return torch.sign(x) * torch.exp(gamma * torch.log(torch.clamp(x.abs(), min=1e-30)))


def _patch_layout(y: torch.Tensor, p: int) -> torch.Tensor:
    """(B, 3, ch, cw) -> (B, ph*pw, 3, p*p)."""
    b, c, ch, cw = y.shape
    ph, pw = ch // p, cw // p
    y = y.reshape(b, c, ph, p, pw, p).permute(0, 2, 4, 1, 3, 5)
    return y.reshape(b, ph * pw, c, p * p)


def fused_ipt_dct_patchify_plain(
    x: torch.Tensor, patch_size: int, crop_h: int, crop_w: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Eager PyTorch version of the kernel, same contract.  ``dtype=torch.float64``
    computes the same function in float64: the yardstick of the kernels' precision."""
    x = x.to(dtype)
    m1 = torch.as_tensor(RGB2LMS, dtype=dtype, device=x.device)
    m2 = torch.as_tensor(M_IPT, dtype=dtype, device=x.device)
    lms = _signed_pow(torch.einsum("ij,bjhw->bihw", m1, x), IPT_GAMMA)
    ipt = torch.einsum("ij,bjhw->bihw", m2, lms)
    dh = dct_matrix_cropped(x.shape[-2], crop_h, dtype, x.device)
    dw = dct_matrix_cropped(x.shape[-1], crop_w, dtype, x.device)
    return _patch_layout(dh @ ipt @ dw.T, patch_size)


def fused_ipt_dct_patchify_cuda(x: torch.Tensor, patch_size: int, crop_h: int, crop_w: int) -> torch.Tensor:
    """Launch csrc/dct_patchify.cu."""
    global LAUNCHES
    from . import _build

    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"expected (B, 3, H, W) RGB, got {tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("DCT kernel takes contiguous float32 images")
    b, _, h, w = x.shape
    p = patch_size
    if crop_h % p or crop_w % p or not (0 < crop_h <= h and 0 < crop_w <= w):
        raise ValueError(f"crop {crop_h}x{crop_w} must be patch multiples within {h}x{w}")
    out = torch.empty((b, (crop_h // p) * (crop_w // p), 3, p * p), dtype=torch.float32, device=x.device)
    dh_hi, dh_lo = dct_matrix_tf32(h, crop_h, False, x.device)
    dwt_hi, dwt_lo = dct_matrix_tf32(w, crop_w, True, x.device)
    ld = round_up4(w)
    ipt = torch.empty((b, 3, h, ld), dtype=torch.float32, device=x.device)
    scratch = torch.empty((b, 3, crop_h, ld), dtype=torch.float32, device=x.device)
    rgb2lms = _build.host_floats(RGB2LMS.astype("float32").reshape(-1))
    lms2ipt = _build.host_floats(M_IPT.astype("float32").reshape(-1))
    fn = _build.load("dct_patchify").dct_patchify_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    )
    err = fn(
        x.data_ptr(), dh_hi.data_ptr(), dh_lo.data_ptr(), dh_hi.shape[1],
        dwt_hi.data_ptr(), dwt_lo.data_ptr(), dwt_hi.shape[1], ipt.data_ptr(), scratch.data_ptr(), ld,
        out.data_ptr(), b, h, w, crop_h, crop_w, p,
        ctypes.cast(rgb2lms, ctypes.c_void_p), ctypes.cast(lms2ipt, ctypes.c_void_p), IPT_GAMMA,
        _build.stream_ptr(x.device),
    )
    _build.check(err, "dct_patchify")
    LAUNCHES += 1
    return out


def fused_ipt_dct_patchify(x: torch.Tensor, patch_size: int, crop_h: int, crop_w: int) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> (B, ph*pw, 3, p*p) DCT patch tokens.

    The DCT runs at the full image size and the frequency plane is cropped
    to crop_h x crop_w (patch multiples), as in the reference.
    """
    if x.device.type == "cuda":
        return fused_ipt_dct_patchify_cuda(x, patch_size, crop_h, crop_w)
    if x.device.type != "cpu":
        raise ValueError(f"DCT patchify runs on CUDA or the CPU, not {x.device}")
    return fused_ipt_dct_patchify_plain(x, patch_size, crop_h, crop_w)
