"""IPT, LMS and JPEG YCbCr colour spaces on (..., 3, h, w) tensors.

Same matrices and gamma as the JAX package's ops/colorspace.py (sRGB -> XYZ
D65, Hunt-Pointer-Estevez XYZ -> LMS, LMS' -> IPT), built in float64 and
cast to the tensor's type at use.  YCbCr uses the correct JPEG constants,
as the JAX package does, so the pair is an exact round trip.
"""
from __future__ import annotations

import numpy as np
import torch

# sRGB -> XYZ D65
_M_SRGB = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=np.float64,
)
# XYZ D65 -> LMS (Hunt-Pointer-Estevez)
_M_HPE = np.array(
    [[0.4002, 0.7076, -0.0807], [-0.2280, 1.1500, 0.0612], [0.0, 0.0, 0.9184]],
    dtype=np.float64,
)
# LMS' -> IPT
M_IPT = np.array(
    [[0.4, 0.4, 0.2], [4.455, -4.851, 0.3960], [0.8056, 0.3572, -1.1628]],
    dtype=np.float64,
)

RGB2LMS = _M_HPE @ _M_SRGB
LMS2RGB = np.linalg.inv(RGB2LMS)
IPT2LMS = np.linalg.inv(M_IPT)

IPT_GAMMA = 0.43


def _channel_mult(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Apply a 3x3 colour matrix along the channel axis of (..., 3, h, w)."""
    mt = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    return torch.einsum("ij,...jhw->...ihw", mt, x)


def _signed_pow(x: torch.Tensor, gamma: float) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** gamma


def rgb_to_lms(x: torch.Tensor) -> torch.Tensor:
    return _channel_mult(RGB2LMS, x)


def lms_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return _channel_mult(LMS2RGB, x)


def rgb_to_ipt(x: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> IPT."""
    return _channel_mult(M_IPT, _signed_pow(_channel_mult(RGB2LMS, x), IPT_GAMMA))


def ipt_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """IPT -> sRGB."""
    return _channel_mult(LMS2RGB, _signed_pow(_channel_mult(IPT2LMS, x), 1.0 / IPT_GAMMA))


def rgb_to_ycbcr(x: torch.Tensor) -> torch.Tensor:
    """JPEG-convention YCbCr: Cb = (B - Y) / 1.772 + 0.5, Cr = (R - Y) / 1.402 + 0.5."""
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (-0.299 * r - 0.587 * g + 0.886 * b) / 1.772 + 0.5
    cr = (0.701 * r - 0.587 * g - 0.114 * b) / 1.402 + 0.5
    return torch.stack([y, cb, cr], dim=-3)


def ycbcr_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_ycbcr."""
    y, cb, cr = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    r = y + 1.402 * (cr - 0.5)
    g = y - (0.114 * 1.772 * (cb - 0.5) + 0.299 * 1.402 * (cr - 0.5)) / 0.587
    b = y + 1.772 * (cb - 0.5)
    return torch.stack([r, g, b], dim=-3)
