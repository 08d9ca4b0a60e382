"""Packed batches of random tokens, for timing and probing the model without
images: token counts drawn as the extractor's TruncExp(beta) budget draws
them, packed into rows by the port's packer.  Used by
tools/compile_probe.py and chip_smoke.py."""
from __future__ import annotations

import math
import random

import numpy as np


def token_items(cfg, max_seq_len, rows, beta, rng, nprng):
    """Random tokens of images with TruncExp(beta) token counts, a little more than `rows` rows' worth."""
    items, total = [], 0
    grid = min(32, cfg.max_patch_h, cfg.max_patch_w)  # patch positions inside the model's grid
    while total < rows * max_seq_len * 1.05:
        k = min(max(1, round(-1.0 / beta * math.log(rng.random()))), max_seq_len)
        items.append((
            nprng.standard_normal((k, cfg.patch_dim)).astype(np.float32),
            nprng.integers(0, grid, size=(k, 2)).astype(np.int32),
            nprng.integers(0, 3, size=(k,)).astype(np.int32),
        ))
        total += k
    return items


def packed_batch(cfg, max_seq_len=256, rows=64, beta=0.02, seed=0, device="cuda"):
    """(batch, n_images): TruncExp(beta) token counts packed into `rows` rows by the port's packer."""
    from .packing import batch_groups, group_patches_by_max_seq_len

    items = token_items(cfg, max_seq_len, rows, beta, random.Random(seed), np.random.default_rng(seed))
    groups = group_patches_by_max_seq_len(items, max_seq_len).groups[:rows]
    n_images = sum(len(g) for g in groups)
    batch = batch_groups(
        groups, max_seq_len, patch_sizes=((32, 32),) * n_images, original_sizes=((448, 448),) * n_images,
        device=device,
    )
    return batch, n_images
