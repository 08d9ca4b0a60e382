"""PatchNorm: per-(channel, row, col, coefficient) Laplace normalization.

State is three tensors: `n` (c, H, W) counts, `median` (c, H, W, pz) and
`b` (c, H, W, pz) mean absolute deviations; std = b * sqrt(2), and
normalized values are clamped to +-6.

Calibration (`update_patchnorm`) computes the per-bucket batch median with
one scatter onto an (n_images, c*H*W, pz) canvas and one sort along the
image axis: every image holds at most one patch per (c, h, w) bucket, so
the median of `cnt` values is the sorted entry (cnt - 1) // 2 (the
lower-middle convention).  Batch medians are merged into the running
median by a count-weighted average, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..patches.container import DCTPatches

EPS = 1e-6
MAX_VAL = 6.0
MIN_VAL = -6.0


@dataclasses.dataclass
class PatchNormState:
    n: torch.Tensor  # (c, H, W)
    median: torch.Tensor  # (c, H, W, pz)
    b: torch.Tensor  # (c, H, W, pz)

    @staticmethod
    def create(channels: int, max_patch_h: int, max_patch_w: int, patch_dim: int, device="cpu") -> "PatchNormState":
        return PatchNormState(
            n=torch.zeros((channels, max_patch_h, max_patch_w), device=device),
            median=torch.zeros((channels, max_patch_h, max_patch_w, patch_dim), device=device),
            b=torch.ones((channels, max_patch_h, max_patch_w, patch_dim), device=device),
        )

    @staticmethod
    def load(path: str, device="cpu") -> "PatchNormState":
        """Load a patchnorm.npz written by the JAX package's save_pretrained."""
        with np.load(path) as pn:
            return PatchNormState(
                **{k: torch.as_tensor(pn[k], dtype=torch.float32, device=device) for k in ("n", "median", "b")}
            )

    def to(self, device) -> "PatchNormState":
        return PatchNormState(n=self.n.to(device), median=self.median.to(device), b=self.b.to(device))


def _gather(state_arr: torch.Tensor, x: DCTPatches) -> torch.Tensor:
    return state_arr[x.patch_channels.long(), x.h_indices.long(), x.w_indices.long()]


def apply_patchnorm(state: PatchNormState, x: DCTPatches) -> torch.Tensor:
    """Normalize packed patches with frozen stats."""
    medians = _gather(state.median, x)
    std = _gather(state.b, x) * 2**0.5 + EPS
    return torch.clamp((x.patches.float() - medians) / std, MIN_VAL, MAX_VAL)


def inverse_patchnorm(state: PatchNormState, x: DCTPatches) -> torch.Tensor:
    """Inverse of apply_patchnorm (without the clamp)."""
    medians = _gather(state.median, x)
    std = _gather(state.b, x) * 2**0.5 + EPS
    return x.patches.float() * std + medians


def update_patchnorm(
    state: PatchNormState,
    patches: torch.Tensor,  # (b, s, pz)
    channels: torch.Tensor,  # (b, s)
    positions: torch.Tensor,  # (b, s, 2)
    key_pad_mask: torch.Tensor,  # (b, s) True where padding
    image_ids: torch.Tensor,  # (b, s) per-row image ids
    row_offsets: torch.Tensor,  # (b,) global image-index offset per row
    n_images: int,
) -> Tuple[PatchNormState, torch.Tensor]:
    """One online calibration step.

    Returns (new_state, patches zero-filled at padding): the raw patches, not
    normalized ones, as the JAX package does during calibration.
    """
    c, H, W, pz = state.median.shape
    n_buckets = c * H * W
    valid = ~key_pad_mask
    patches32 = patches.float()
    flat_valid = valid.reshape(-1)

    # flat bucket index per token; padding goes to a trash bucket
    bucket_in = ((channels.long() * H + positions[..., 0].long()) * W + positions[..., 1].long())
    bucket_in = torch.where(valid, bucket_in, torch.zeros_like(bucket_in))
    bucket = torch.where(valid, bucket_in, torch.full_like(bucket_in, n_buckets)).reshape(-1)

    batch_n_flat = torch.zeros(n_buckets + 1, dtype=torch.float32, device=patches.device)
    batch_n_flat.index_add_(0, bucket, flat_valid.float())
    batch_n_flat = batch_n_flat[:-1]
    batch_n = batch_n_flat.reshape(c, H, W)

    # dense canvas: every image fills each (c, h, w) bucket at most once
    gid = row_offsets[:, None].long() + image_ids.long()
    canvas_idx = torch.where(valid, gid * n_buckets + bucket_in, torch.full_like(gid, n_images * n_buckets))
    canvas = torch.full((n_images * n_buckets + 1, pz), float("inf"), dtype=torch.float32, device=patches.device)
    canvas[canvas_idx.reshape(-1)] = patches32.reshape(-1, pz)
    canvas = canvas[:-1].reshape(n_images, n_buckets, pz)

    # +inf sorts to the end, so the median of cnt values is at (cnt - 1) // 2
    canvas_sorted = torch.sort(canvas, dim=0).values
    cnt = batch_n_flat.long()
    take = torch.clamp((cnt - 1) // 2, 0, max(n_images - 1, 0))
    batch_median = torch.gather(canvas_sorted, 0, take[None, :, None].expand(1, n_buckets, pz))[0]
    batch_median = torch.where((cnt > 0)[:, None], batch_median, torch.zeros_like(batch_median))
    batch_median = batch_median.reshape(c, H, W, pz)

    n_old = state.n
    denom = torch.clamp(n_old + batch_n, min=1.0)[..., None]
    new_median = (state.median * n_old[..., None] + batch_median * batch_n[..., None]) / denom

    # mean absolute deviation against the *updated* median
    med_tok = new_median.reshape(n_buckets, pz)[bucket_in]
    dist = torch.where(valid[..., None], (patches32 - med_tok).abs(), torch.zeros_like(patches32))
    batch_b_flat = torch.zeros((n_buckets + 1, pz), dtype=torch.float32, device=patches.device)
    batch_b_flat.index_add_(0, bucket, dist.reshape(-1, pz))
    batch_b = batch_b_flat[:-1].reshape(c, H, W, pz) / torch.clamp(batch_n, min=1.0)[..., None]

    new_b = (state.b * n_old[..., None] + batch_b * batch_n[..., None]) / denom
    new_state = PatchNormState(n=n_old + batch_n, median=new_median, b=new_b)
    out = torch.where(valid[..., None], patches, torch.zeros_like(patches))
    return new_state, out


def calibrate_patchnorm_batch(state: PatchNormState, batch: DCTPatches) -> Tuple[PatchNormState, torch.Tensor]:
    """`update_patchnorm` on a packed batch; per-row image offsets are computed on the host."""
    ids = batch.batched_image_ids.detach().cpu().numpy()
    pad = batch.key_pad_mask.detach().cpu().numpy()
    n_per_row = np.where((~pad).any(axis=1), ids.max(axis=1, where=~pad, initial=0) + 1, 0)
    row_offsets = np.concatenate([[0], np.cumsum(n_per_row)])[:-1].astype(np.int64)
    device = batch.patches.device
    return update_patchnorm(
        state.to(device),
        batch.patches,
        batch.patch_channels,
        batch.patch_positions,
        batch.key_pad_mask,
        batch.batched_image_ids,
        torch.as_tensor(row_offsets, device=device),
        int(n_per_row.sum()),
    )
