"""Image-grid / visualization helpers (reference: util.py:570-607, 413-434).

Counterpart of the JAX package's tools/viz.py.  PIL-based (no
torchvision/matplotlib): side-by-side original-vs-reconstruction grids for
training logs and demos.  PIL is imported by the functions that draw.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def image_clip(im: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0,1] (reference util.py:143-147)."""
    lo, hi = im.min(), im.max()
    return (im - lo) / max(hi - lo, 1e-9)


def to_pil(im: np.ndarray) -> "Image.Image":  # noqa: F821
    """(c, h, w) float array in [0,1] -> PIL image."""
    from PIL import Image

    arr = np.clip(im, 0.0, 1.0).transpose(1, 2, 0)
    return Image.fromarray((arr * 255).astype(np.uint8))


def _resize_to_height(im, height: int, max_size: int = 1024):
    from PIL import Image

    w = int(im.width * height / im.height)
    w = min(w, max_size)
    return im.resize((w, height), Image.BICUBIC)


def make_image_grid(
    x: List[np.ndarray],
    x_hat: List[np.ndarray],
    filename: Optional[str] = None,
    n: int = 10,
    cell_height: int = 384,
):
    """Two columns: original | reconstruction, one row per image
    (reference util.py:570-607).  Returns the PIL image."""
    from PIL import Image

    n = min(len(x), len(x_hat), n)
    rows = []
    for i in range(n):
        a = _resize_to_height(to_pil(image_clip(np.asarray(x[i]))), cell_height)
        b = _resize_to_height(to_pil(image_clip(np.asarray(x_hat[i]))), cell_height)
        rows.append((a, b))

    col_w = max(max(a.width, b.width) for a, b in rows)
    grid = Image.new("RGB", (2 * col_w + 12, n * (cell_height + 4)), (16, 16, 16))
    for i, (a, b) in enumerate(rows):
        y = i * (cell_height + 4)
        grid.paste(a, (0, y))
        grid.paste(b, (col_w + 12, y))

    if filename:
        grid.save(filename)
        print("saved", filename)
    return grid


def save_image(im: np.ndarray, filename: str) -> None:
    to_pil(np.asarray(im)).save(filename)
