"""Frequency-plane masks and small signal-processing helpers.

Counterpart of the JAX package's ops/masks.py: triangle masks with
per-channel budgets (for DCT low-pass experiments), circular masks, the
square DCT basis images and Gaussian kernels are built on the host in numpy
(they are static per shape); the FFT amplitude/phase split runs on tensors
through torch.fft.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_square_dct_basis(resolution: int = 16) -> np.ndarray:
    """(res, res, res, res) DCT basis images; the first two axes are the (u, v)
    DCT coordinates."""
    x, y = np.meshgrid(np.arange(resolution), np.arange(resolution), indexing="ij")
    u = np.arange(resolution)[:, None, None, None]
    v = np.arange(resolution)[None, :, None, None]
    return np.cos(((2 * x + 1) * u * np.pi) / (2 * resolution)) * np.cos(
        ((2 * y + 1) * v * np.pi) / (2 * resolution)
    )


def get_upper_left_tri_p(shape, p: float) -> np.ndarray:
    """Keep-mask dropping about a fraction p of the coefficients farthest (in
    h + w) from the DC corner."""
    h, w = shape[-2], shape[-1]
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    dist = (x + y) * -1.0
    mask = dist > np.quantile(dist, p)
    return mask.reshape((1,) * (len(shape) - 2) + (h, w))


def get_upper_left_tri_p_w_channel_preferences(
    shape: Tuple[int, int, int], p: float, channel_preferences: Tuple[float, ...]
) -> np.ndarray:
    """Per-channel triangle masks with the keep budget split by channel importance."""
    c, h, w = shape
    prefs = np.asarray(channel_preferences, dtype=np.float64)
    channel_ps = prefs / prefs.sum() * c * p
    return np.stack([get_upper_left_tri_p((h, w), float(cp)) for cp in channel_ps], axis=0)


def get_upper_left_tri(shape, triangle_n: int = 1) -> np.ndarray:
    """Hard triangle of size triangle_n anchored at the DC corner."""
    h, w = shape[-2], shape[-1]
    if triangle_n < 1:
        raise ValueError(f"triangle_n must be >= 1, got {triangle_n}")
    diagonal = w - triangle_n
    if diagonal < -h - 2:
        raise ValueError(f"triangle_n {triangle_n} is too large for a {h} x {w} plane")
    tri = np.fliplr(np.triu(np.ones((h, w)), k=diagonal))
    return tri.reshape((1,) * (len(shape) - 2) + (h, w))


def get_circular_mask(shape, p: float = 0.5) -> np.ndarray:
    """Mask cutting a centred disk that holds about a fraction p of the coefficients."""
    h, w = shape[-2], shape[-1]
    cy, cx = h / 2 - 0.5, w / 2 - 0.5
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    dist = np.sqrt((y - cy) ** 2 + (x - cx) ** 2)
    mask = dist > np.quantile(dist, p)
    return mask.reshape((1,) * (len(shape) - 2) + (h, w))


def fft_amp_phase(x: torch.Tensor):
    """2-D FFT over the trailing two axes, split into amplitude and phase."""
    f = torch.fft.fft2(x)
    return f.abs(), f.angle()


def inverse_fft(amp: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Inverse of fft_amp_phase (the real part)."""
    return torch.fft.ifft2(torch.polar(amp, phase)).real


def gaussian_fn(m: int, std: float) -> np.ndarray:
    n = np.arange(0, m) - (m - 1.0) / 2.0
    return np.exp(-(n**2) / (2 * std * std))


def gkern(size: int = 256, std: float = None) -> np.ndarray:
    """2-D Gaussian kernel (std defaults to size / 2)."""
    if std is None:
        std = size / 2
    g = gaussian_fn(size, std)
    return np.outer(g, g)
