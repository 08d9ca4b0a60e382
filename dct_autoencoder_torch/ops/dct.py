"""Orthonormal 2-D DCT-II / DCT-III as matrix products.

``dct2(X) = D_H X D_W^T`` with D_N the orthonormal DCT-II matrix, built in
float64 and cast.  The products must run in true fp32: the DC coefficient is
about sqrt(H*W)/2, and TF32 keeps only three digits of it.  The package
turns TF32 off for matmuls and cuDNN when it is imported.

The fused DCT kernels and their plain versions take their matrices from
per-(n, crop, ...) caches on the tensor's device (``dct_matrix_cropped``,
``dct_matrix_tf32``), so no call after the first builds or uploads one.
The tensor-core kernels multiply in 3xTF32: each operand is split into a
TF32 "hi" part and a TF32 "lo" part of the remainder (``tf32_split``) and
the three products lo*hi, hi*lo and hi*hi are summed in fp32, which keeps
about 22 of fp32's 24 significant bits where one TF32 product keeps 11.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, float64.  Row k: s_k cos(pi (2i+1) k / 2n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * (2.0 * i + 1.0) * k / (2.0 * n))
    scale = np.full((n, 1), np.sqrt(2.0 / n))
    scale[0, 0] = np.sqrt(1.0 / n)
    return mat * scale


def dct_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, n) orthonormal DCT-II matrix, computed in float64 then cast."""
    return torch.as_tensor(_dct_matrix_np(n), device=device).to(dtype)


@lru_cache(maxsize=64)
def dct_matrix_cropped(n: int, crop: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """D_n[:crop], (crop, n) contiguous, cached per (n, crop, dtype, device).

    The same tensor object comes back on every call: never modify it.  It is
    made outside inference mode, so that a first call under
    ``torch.inference_mode`` does not cache a tensor autograd refuses."""
    with torch.inference_mode(False):
        return torch.as_tensor(_dct_matrix_np(n)[:crop], device=device).to(dtype).contiguous()


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 stored mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds; the 13 dropped bits are 0."""
    if t.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    # sign and magnitude: adding half of the dropped range to the bit pattern
    # rounds the magnitude half away from zero, whatever the sign
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """(hi, lo) TF32 parts with hi + lo = t to within 2^-22 relative:
    hi = tf32(t), lo = tf32(t - hi); t - hi is exact in fp32."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


@lru_cache(maxsize=64)
def dct_matrix_tf32(n: int, crop: int, transpose: bool, device) -> tuple:
    """The (hi, lo) TF32 split of D_n[:crop] (transpose=False: (crop, n)) or
    of its transpose ((n, crop)), each row zero-padded to a multiple of 4
    floats so that the tensor-core kernels copy it in 16-byte pieces.  Cached
    per (n, crop, transpose, device); never modify the tensors."""
    with torch.inference_mode(False):
        m = dct_matrix_cropped(n, crop, torch.float32, device)
        if transpose:
            m = m.T
        rows, cols = m.shape
        padded = torch.zeros((rows, -(-cols // 4) * 4), dtype=torch.float32, device=device)
        padded[:, :cols] = m
        return tf32_split(padded)


def dct1d(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Orthonormal DCT-II along `dim`."""
    d = dct_matrix(x.shape[dim], x.dtype, x.device)
    return (x.movedim(dim, -1) @ d.T).movedim(-1, dim)


def idct1d(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Orthonormal DCT-III (inverse of dct1d) along `dim`."""
    d = dct_matrix(x.shape[dim], x.dtype, x.device)
    return (x.movedim(dim, -1) @ d).movedim(-1, dim)


def dct2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II over the trailing (h, w) axes."""
    dh = dct_matrix(x.shape[-2], x.dtype, x.device)
    dw = dct_matrix(x.shape[-1], x.dtype, x.device)
    return dh @ x @ dw.T


def idct2(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D inverse DCT (DCT-III) over the trailing (h, w) axes."""
    dh = dct_matrix(x.shape[-2], x.dtype, x.device)
    dw = dct_matrix(x.shape[-1], x.dtype, x.device)
    return dh.T @ x @ dw


@lru_cache(maxsize=None)
def _block_dct_basis_np(patch_size: int) -> np.ndarray:
    """(p*p, p*p) matrix mapping a flattened p x p pixel block to its 2-D DCT:
    vec(D X D^T) = (D kron D) vec(X)."""
    d = _dct_matrix_np(patch_size)
    return np.kron(d, d)


def block_dct_basis(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(_block_dct_basis_np(patch_size), device=device).to(dtype)
