"""Differentiable RGB-space pixel loss, and the scatter of packed tokens onto
per-image DCT planes.

Counterpart of dct_autoencoder_tpu/train/pixel_loss.py.  All images of a
batch share one static canvas grid (the config's max_patch_h x max_patch_w):

  tokens --scatter--> (max_images, c, ph, pw, p*p) canvases --reshape-->
  DCT planes --IDCT (matmul)--> pixels --IPT->RGB--> per-image MSE.

As in JAX, the loss runs the plain ``ops/dct.py::idct2`` and
``ops/colorspace.py::ipt_to_rgb`` in true fp32 (the package turns TF32 off)
and autograd differentiates them; it does not call the IDCT kernel, which
has no backward.  The serving pipeline's fused reconstruct path uses the
scatter (``unpatch_to_planes``) alone.

Images are given global slots: rows contribute their packed images in order,
so row r's images take slots [offsets[r], offsets[r] + n_per_row[r]).
Padding tokens (padded rows included, whose image ids are 0) and tokens of
images past `max_images` land in one trash slot past the end of the canvas,
which is dropped, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.colorspace import ipt_to_rgb
from ..ops.dct import idct2
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


def unpatch_to_images(
    patches: torch.Tensor,
    batch: DCTPatches,
    row_offsets: torch.Tensor,
    grid: Tuple[int, int],
    patch_size: int,
    channels: int,
    max_images: int,
) -> torch.Tensor:
    """(max_images, c, ph*p, pw*p) RGB images from packed tokens (unused slots
    hold the RGB of an all-zero DCT plane)."""
    planes = unpatch_to_planes(patches, batch, row_offsets, grid, patch_size, channels, max_images)
    return ipt_to_rgb(idct2(planes))


def pixel_loss(
    rec_patches: torch.Tensor,
    batch: DCTPatches,
    pixel_targets: torch.Tensor,  # (max_images, c, H, W) RGB originals
    image_valid: torch.Tensor,  # (max_images,) bool
    row_offsets: torch.Tensor,
    grid: Tuple[int, int],
    patch_size: int,
) -> torch.Tensor:
    """Masked mean-squared error in RGB space over the valid image slots."""
    c = pixel_targets.shape[1]
    max_images = pixel_targets.shape[0]
    rec = unpatch_to_images(rec_patches, batch, row_offsets, grid, patch_size, c, max_images)
    se = (rec - pixel_targets.float()) ** 2
    se = se * image_valid[:, None, None, None]
    denom = torch.clamp(image_valid.sum(), min=1) * np_prod(se.shape[1:])
    return se.sum() / denom


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def row_offsets_on_device(batch: DCTPatches) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row global image offsets and the total image count, as tensors on
    the batch's device (JAX's ``row_offsets_in_jit``)."""
    offsets, n_per_row = row_image_layout(batch)
    return offsets, n_per_row.sum()


def packed_pixel_loss(
    rec_patches: torch.Tensor,  # (b, s, p*p) decoded UNNORMALIZED DCT tokens
    target_patches: torch.Tensor,  # (b, s, p*p) target UNNORMALIZED DCT tokens
    batch: DCTPatches,
    grid_sizes: torch.Tensor,  # (max_images, 2) per-image (ph, pw); 0 = empty slot
    grid: Tuple[int, int],  # (max_patch_h, max_patch_w) static canvas grid
    patch_size: int,
    channels: int,
    row_offsets: Optional[torch.Tensor] = None,  # (b,) global image offsets
    slot_valid: Optional[torch.Tensor] = None,  # (max_images,) slots to average
) -> torch.Tensor:
    """Reference-parity RGB pixel loss: the mean over images of each image's
    MSE between the unpatched, inverse-DCT'd RGB of `rec_patches` and of
    `target_patches`.

    The reference compares postprocess(inv_normalize(output)) against
    postprocess(inv_normalize(normalized_batch)) (main.py:95-110): the
    target is itself a token reconstruction.  Both sides run on shared
    (max_images, c, PH*p, PW*p) canvases; image i's squared error is divided
    by c * ph_i*p * pw_i*p from `grid_sizes`.  As in JAX, the planes are
    evaluated at the canvas resolution, not zero-padded to the original
    size first (Parseval keeps the DCT-domain error; only the IPT->RGB
    nonlinearity differs).  Images past `max_images` slots, or whose slot
    has a zero grid, are excluded.

    Whole-batch mode takes the slots from the batch's packing order; in
    micro-batch mode (gradient accumulation) the caller passes the GLOBAL
    per-row offsets and the window of slots this micro-batch owns, so
    `grid_sizes` (built once for the full batch) stay aligned.
    """
    max_images = grid_sizes.shape[0]
    if row_offsets is None:
        offsets, n_images = row_offsets_on_device(batch)
        slot_valid = torch.arange(max_images, device=grid_sizes.device) < n_images
    else:
        if slot_valid is None:
            raise ValueError("micro-batch mode needs slot_valid beside row_offsets")
        offsets = row_offsets
    rec = unpatch_to_images(rec_patches, batch, offsets, grid, patch_size, channels, max_images)
    tgt = unpatch_to_images(target_patches, batch, offsets, grid, patch_size, channels, max_images)
    se = ((rec - tgt) ** 2).sum(dim=(1, 2, 3))  # (max_images,)
    denom = (channels * grid_sizes[:, 0] * patch_size * grid_sizes[:, 1] * patch_size).float()
    slot_valid = slot_valid & (grid_sizes[:, 0] > 0)
    per_image = torch.where(slot_valid, se / torch.clamp(denom, min=1.0), torch.zeros_like(se))
    return per_image.sum() / torch.clamp(slot_valid.sum(), min=1)


def make_grid_sizes(batch: DCTPatches, max_images: int, clip_grid: Tuple[int, int]) -> torch.Tensor:
    """(max_images, 2) int32 per-image patch grids, clipped to the canvas, on
    the batch's device.

    Images beyond max_images are dropped from the loss (their slots stay 0);
    grids are clipped to (max_patch_h, max_patch_w) because tokens outside
    that grid were already dropped at preprocess time."""
    gs = np.zeros((max_images, 2), dtype=np.int32)
    for i, (ph, pw) in enumerate(batch.patch_sizes[:max_images]):
        gs[i] = (min(ph, clip_grid[0]), min(pw, clip_grid[1]))
    return torch.as_tensor(gs, device=batch.patches.device)


def make_row_offsets(batch: DCTPatches) -> Tuple[torch.Tensor, int]:
    """Host-side per-row global image offsets (int32, on the batch's device)
    and the image count."""
    ids = batch.batched_image_ids.cpu().numpy()
    pad = batch.key_pad_mask.cpu().numpy()
    n_per_row = np.where((~pad).any(axis=1), ids.max(axis=1, where=~pad, initial=0) + 1, 0)
    offsets = np.concatenate([[0], np.cumsum(n_per_row)])[:-1].astype(np.int32)
    return torch.as_tensor(offsets, device=batch.patches.device), int(n_per_row.sum())
