"""Host-side image augmentation for the training input pipeline.

A copy of the JAX package's data/augment.py: the same seed draws the same
crops, flips and jitter, so both packages augment an image identically.

The reference has no transform story beyond a resize cap
(reference dataset.py:35-89); its end product is a tokenizer trained on a
web-scale corpus where augmentation matters less.  On small corpora the
round-3 calibrated runs showed pure memorization (train PSNR 16->24 dB,
held-out declining), so the framework needs a regularization lever.

Design constraints:
  * host-side numpy/PIL, applied BEFORE the on-device IPT+DCT preprocess;
  * SHAPE-PRESERVING: random-resized-crop selects a random region then
    resizes back to the input size, so the set of distinct preprocess
    shapes is unchanged;
  * seeded and restart-stable: one np.random.Generator per stream, seeded
    from the CLI's data_seed (which folds in restart_count, so a watchdog
    self-restart draws fresh crops instead of replaying the stream head).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class AugmentConfig:
    """Random-resized-crop + horizontal flip + optional color jitter.

    scale: area fraction range of the random crop (1.0, 1.0) disables;
    ratio: aspect-ratio range of the crop box (log-uniform draw);
    hflip: probability of a horizontal flip;
    color_jitter: max relative delta for brightness/contrast/saturation
      (0 disables; each factor ~ U[1-j, 1+j], applied in that order).
    """

    scale: Tuple[float, float] = (0.3, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    hflip: float = 0.5
    color_jitter: float = 0.0

    def __post_init__(self):
        assert 0.0 < self.scale[0] <= self.scale[1] <= 1.0, self.scale
        assert 0.0 < self.ratio[0] <= self.ratio[1], self.ratio
        assert 0.0 <= self.hflip <= 1.0, self.hflip
        assert 0.0 <= self.color_jitter < 1.0, self.color_jitter


def _resize_chw(im: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(
        (np.clip(im, 0.0, 1.0).transpose(1, 2, 0) * 255).astype(np.uint8)
    )
    pil = pil.resize((w, h), Image.BICUBIC)
    return np.asarray(pil, dtype=np.float32).transpose(2, 0, 1) / 255.0


def random_resized_crop(
    im: np.ndarray, rng: np.random.Generator, cfg: AugmentConfig
) -> np.ndarray:
    """Crop a random-scale/aspect region and resize back to the input shape
    (torchvision RandomResizedCrop semantics, 10-attempt rejection then a
    center-crop fallback).  Output shape == input shape by construction."""
    c, h, w = im.shape
    area = float(h * w)
    for _ in range(10):
        target_area = area * rng.uniform(cfg.scale[0], cfg.scale[1])
        log_ratio = rng.uniform(np.log(cfg.ratio[0]), np.log(cfg.ratio[1]))
        ar = float(np.exp(log_ratio))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = im[:, top : top + ch, left : left + cw]
            if (ch, cw) == (h, w):
                return crop
            return _resize_chw(crop, h, w)
    # fallback: central crop at the mean scale
    s = float(np.sqrt((cfg.scale[0] + cfg.scale[1]) / 2.0))
    ch, cw = max(1, int(h * s)), max(1, int(w * s))
    top, left = (h - ch) // 2, (w - cw) // 2
    return _resize_chw(im[:, top : top + ch, left : left + cw], h, w)


def color_jitter(
    im: np.ndarray, rng: np.random.Generator, j: float
) -> np.ndarray:
    """Brightness -> contrast -> saturation, each factor ~ U[1-j, 1+j]."""
    out = im
    b = rng.uniform(1.0 - j, 1.0 + j)
    out = out * b
    ct = rng.uniform(1.0 - j, 1.0 + j)
    mean = out.mean(dtype=np.float64)
    out = (out - mean) * ct + mean
    st = rng.uniform(1.0 - j, 1.0 + j)
    # ITU-R 601 luma, same weights torchvision uses for grayscale
    gray = (
        0.299 * out[0] + 0.587 * out[1] + 0.114 * out[2]
    )[None].astype(np.float32)
    out = gray + (out - gray) * st
    return np.clip(out, 0.0, 1.0).astype(np.float32)


class Augmenter:
    """Stateful seeded augmenter: apply(im) -> im, same (c, h, w) shape.

    One numpy Generator drives all draws; for a fixed stream order the
    augmented stream is deterministic given the seed.  Reseeding with
    data_seed = seed + K * restart_count (train/cli.py) makes restarts draw
    fresh augmentations while staying reproducible end-to-end.
    """

    def __init__(self, cfg: Optional[AugmentConfig] = None, seed: int = 0):
        self.cfg = cfg or AugmentConfig()
        self.rng = np.random.default_rng(seed)

    def __call__(self, im: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        assert im.ndim == 3 and im.shape[0] in (1, 3, 4), im.shape
        out = im
        if cfg.scale != (1.0, 1.0) or cfg.ratio != (1.0, 1.0):
            out = random_resized_crop(out, self.rng, cfg)
        if cfg.hflip > 0 and self.rng.random() < cfg.hflip:
            out = out[:, :, ::-1]
        if cfg.color_jitter > 0 and out.shape[0] == 3:
            out = color_jitter(out, self.rng, cfg.color_jitter)
        return np.ascontiguousarray(out, dtype=np.float32)
