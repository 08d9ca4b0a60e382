"""Fused cropped DCT plane -> IDCT -> IPT -> RGB, with a CUDA kernel for Hopper.

Replaces dct_autoencoder_tpu/kernels/idct_unpatchify.py::_kernel (the
Pallas kernel called from fused_idct_unpatchify_rgb).  The kernel is
csrc/idct_unpatchify.cu: T_c = D_H[:ch]^T Y_c into scratch, then one block
per (image, pixel tile) computes X_c = T_c D_W[:cw] for all three channels
and runs IPT -> LMS, the signed power 1/gamma and LMS -> RGB in its
epilogue.  Both products run on the tensor cores in 3xTF32, which keeps
fp32's precision where one TF32 product would not.  The zero pad to the
output size is folded into the truncated DCT matrices.  The DCT matrices,
and their TF32 splits, come from ops/dct.py's caches on the device.

For a CPU tensor ``fused_idct_unpatchify_rgb`` runs the plain version; for a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts calls
that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.colorspace import IPT2LMS, IPT_GAMMA, LMS2RGB
from ..ops.dct import dct_matrix_cropped, dct_matrix_tf32
from .dct_patchify import _signed_pow, round_up4

LAUNCHES = 0


def fused_idct_unpatchify_rgb_plain(
    y: torch.Tensor, out_h: int, out_w: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Eager PyTorch version of the kernel, same contract.  ``dtype=torch.float64``
    computes the same function in float64: the yardstick of the kernels' precision."""
    y = y.to(dtype)
    ch, cw = y.shape[-2:]
    dh = dct_matrix_cropped(out_h, ch, dtype, y.device)
    dw = dct_matrix_cropped(out_w, cw, dtype, y.device)
    ipt = dh.T @ y @ dw
    m1 = torch.as_tensor(IPT2LMS, dtype=dtype, device=y.device)
    m2 = torch.as_tensor(LMS2RGB, dtype=dtype, device=y.device)
    lms = _signed_pow(torch.einsum("ij,bjhw->bihw", m1, ipt), 1.0 / IPT_GAMMA)
    return torch.einsum("ij,bjhw->bihw", m2, lms)


def fused_idct_unpatchify_rgb_cuda(y: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Launch csrc/idct_unpatchify.cu."""
    global LAUNCHES
    from . import _build

    if y.dim() != 4 or y.shape[1] != 3:
        raise ValueError(f"expected (B, 3, ch, cw) planes, got {tuple(y.shape)}")
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("IDCT kernel takes contiguous float32 planes")
    b, _, ch, cw = y.shape
    if not (0 < ch <= out_h and 0 < cw <= out_w):
        raise ValueError(f"plane {ch}x{cw} does not fit the output {out_h}x{out_w}")
    out = torch.empty((b, 3, out_h, out_w), dtype=torch.float32, device=y.device)
    dht_hi, dht_lo = dct_matrix_tf32(out_h, ch, True, y.device)
    dw_hi, dw_lo = dct_matrix_tf32(out_w, cw, False, y.device)
    ld = round_up4(cw)
    scratch = torch.empty((b, 3, out_h, ld), dtype=torch.float32, device=y.device)
    ipt2lms = _build.host_floats(IPT2LMS.astype("float32").reshape(-1))
    lms2rgb = _build.host_floats(LMS2RGB.astype("float32").reshape(-1))
    fn = _build.load("idct_unpatchify").idct_unpatchify_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    )
    err = fn(
        y.data_ptr(), dht_hi.data_ptr(), dht_lo.data_ptr(), dht_hi.shape[1],
        dw_hi.data_ptr(), dw_lo.data_ptr(), dw_hi.shape[1], scratch.data_ptr(), ld, out.data_ptr(),
        b, ch, cw, out_h, out_w,
        ctypes.cast(ipt2lms, ctypes.c_void_p), ctypes.cast(lms2rgb, ctypes.c_void_p), 1.0 / IPT_GAMMA,
        _build.stream_ptr(y.device),
    )
    _build.check(err, "idct_unpatchify")
    LAUNCHES += 1
    return out


def fused_idct_unpatchify_rgb(y: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, 3, ch, cw) cropped DCT planes -> (B, 3, out_h, out_w) RGB pixels.

    Equivalent to zero-padding each plane to (out_h, out_w), idct2, then
    ipt_to_rgb.
    """
    if y.device.type == "cuda":
        return fused_idct_unpatchify_rgb_cuda(y, out_h, out_w)
    if y.device.type != "cpu":
        raise ValueError(f"IDCT runs on CUDA or the CPU, not {y.device}")
    return fused_idct_unpatchify_rgb_plain(y, out_h, out_w)
