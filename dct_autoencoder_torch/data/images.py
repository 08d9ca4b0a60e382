"""Shared fixture/validation image loading (a copy of the JAX package's data/images.py).

One canonical loader so eval PSNR, serving-bench payloads and the int8
sensitivity study all read pixels identically (PIL RGB -> optional square
BICUBIC resize -> float32 (c, h, w) in [0, 1]).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def load_image_chw(path: str, resize: int = 0) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGB")
    if resize:
        im = im.resize((resize, resize), Image.BICUBIC)
    return np.asarray(im).astype(np.float32).transpose(2, 0, 1) / 255.0


def load_images_chw(paths: Sequence[str], resize: int = 0) -> List[np.ndarray]:
    return [load_image_chw(p, resize) for p in paths]
