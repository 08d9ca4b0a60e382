"""JPEG zigzag ordering as static permutations.

Counterpart of the JAX package's ops/zigzag.py: the diagonal walk runs once
on the host (cached per (h, w)) and is applied as an index_select along the
last axis.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def zigzag(h: int, w: int) -> np.ndarray:
    """(h, w) int64 array: entry [r, c] is that cell's rank in the JPEG
    codec's diagonal walk."""
    out = np.empty((h, w), dtype=np.int64)
    row, col = 0, 0
    for rank in range(h * w):
        out[row, col] = rank
        if (row + col) % 2 == 0:  # going up and to the right
            if col == w - 1:
                row += 1
            elif row == 0:
                col += 1
            else:
                row -= 1
                col += 1
        else:
            if row == h - 1:
                col += 1
            elif col == 0:
                row += 1
            else:
                row += 1
                col -= 1
    return out


@lru_cache(maxsize=None)
def _inverse_zigzag_perm(h: int, w: int) -> np.ndarray:
    """perm with flat_zigzag[k] = x_rowmajor[perm[k]]."""
    return np.argsort(zigzag(h, w).reshape(-1))


def flatten_zigzag(x: torch.Tensor) -> torch.Tensor:
    """Flatten the trailing (h, w) axes in zigzag order."""
    h, w = x.shape[-2], x.shape[-1]
    perm = torch.as_tensor(_inverse_zigzag_perm(h, w), device=x.device)
    return x.reshape(*x.shape[:-2], h * w).index_select(-1, perm)


def unflatten_zigzag(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of flatten_zigzag."""
    perm = torch.as_tensor(zigzag(h, w).reshape(-1), device=x.device)
    return x.index_select(-1, perm).reshape(*x.shape[:-1], h, w)


class ZigzagFlattener:
    """Zigzag helper bound to one (h, w)."""

    def __init__(self, h: int, w: int):
        self.h = h
        self.w = w
        self.zigzag = zigzag(h, w)

    def flatten(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2:] != (self.h, self.w):
            raise ValueError(f"expected trailing axes ({self.h}, {self.w}), got {tuple(x.shape[-2:])}")
        return flatten_zigzag(x)

    def unflatten(self, x: torch.Tensor) -> torch.Tensor:
        return unflatten_zigzag(x, self.h, self.w)
