"""Scatter of packed patch tokens onto per-image DCT planes, on the device.

Counterpart of the first two pieces of dct_autoencoder_tpu/train/pixel_loss.py
(``unpatch_to_planes`` and ``row_image_layout``).  The serving pipeline's
fused reconstruct path uses them today; the pixel loss itself is not ported
yet.

Images are given global slots: rows contribute their packed images in order,
so row r's images take slots [offsets[r], offsets[r] + n_per_row[r]).
Padding tokens (padded rows included, whose image ids are 0) and tokens of
images past `max_images` land in one trash slot past the end of the canvas,
which is dropped, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..patches.container import DCTPatches


def row_image_layout(batch: DCTPatches) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (global image offset, image count), int32 (b,) each, on the batch's device.

    Packing never splits an image across rows, so the slot ranges of distinct
    rows are disjoint."""
    ids = batch.batched_image_ids.to(torch.int32)
    pad = batch.key_pad_mask
    any_valid = (~pad).any(dim=1)
    max_id = torch.where(pad, torch.full_like(ids, -1), ids).amax(dim=1)
    n_per_row = torch.where(any_valid, max_id + 1, torch.zeros_like(max_id)).to(torch.int32)
    offsets = (torch.cumsum(n_per_row, 0) - n_per_row).to(torch.int32)
    return offsets, n_per_row


def unpatch_to_planes(
    patches: torch.Tensor,  # (b, s, p*p) decoded DCT patch tokens
    batch: DCTPatches,
    row_offsets: torch.Tensor,  # (b,) global image offset of each row
    grid: Tuple[int, int],  # (ph, pw), the patch grid all images share
    patch_size: int,
    channels: int,
    max_images: int,
) -> torch.Tensor:
    """(max_images, c, ph*p, pw*p) fp32 DCT planes; unused slots are zeros.

    One index_put_ onto a flat canvas: the on-device counterpart of the
    extractor's host-side ``revert_patching``."""
    ph, pw = grid
    p, c = patch_size, channels
    pz = patches.shape[-1]
    gid = row_offsets.long()[:, None] + batch.batched_image_ids.long()  # (b, s)
    valid = (~batch.key_pad_mask) & (gid < max_images)  # overflow images go to the trash slot
    flat_idx = ((gid * c + batch.patch_channels.long()) * ph + batch.h_indices.long()) * pw + batch.w_indices.long()
    trash = max_images * c * ph * pw
    flat_idx = torch.where(valid, flat_idx, torch.full_like(flat_idx, trash))

    canvas = torch.zeros((trash + 1, pz), dtype=torch.float32, device=patches.device)
    canvas.index_put_((flat_idx.reshape(-1),), patches.reshape(-1, pz).float())
    canvas = canvas[:-1].reshape(max_images, c, ph, pw, p, p)
    return canvas.permute(0, 1, 2, 4, 3, 5).reshape(max_images, c, ph * p, pw * p)
