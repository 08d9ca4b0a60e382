"""Loss assembly for autoencoder training (LFQ or VQ).

Masked L1 in normalized DCT space (weight 0.1), masked L1 in unnormalized
DCT space (weight 1.0), the commit loss (0.1: LFQ's, or VQ's commitment +
codebook loss), MaskGIT entropy loss (0.1, LFQ only; 0 for VQ), plus
codebook perplexity as a metric, and optionally the differentiable RGB
pixel loss (train/pixel_loss.py).  DCT features are treated as Laplace
distributed, hence L1.

Under data parallelism (a `shard`, parallel/mesh.py's DataShard) every
mean's count is summed over the data group, so each rank's loss is its share
of the global batch's loss and the shares sum to it (JAX computes each
statistic over the global batch under pjit).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import obs
from ..models.autoencoder import DCTAutoencoderModule
from ..models.patchnorm import PatchNormState, inverse_patchnorm
from ..ops.stats import calculate_perplexity, compute_entropy_loss, group_sum
from ..patches.container import DCTPatches

DEFAULT_LOSS_WEIGHTS = dict(
    rec_loss_unnormalized=1.0,
    rec_loss=0.1,
    commit_loss=0.1,
    entropy_loss=0.1,
)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """Mean |pred - target| over valid tokens (== F.l1_loss(pred[mask], target[mask])),
    the count summed over the process `group` (the step's data group)."""
    diff = (pred - target).abs() * mask[..., None]
    denom = torch.clamp(group_sum(mask.sum(), group) * pred.shape[-1], min=1)
    return diff.sum() / denom


def step_autoencoder(
    module: DCTAutoencoderModule,
    patchnorm: PatchNormState,
    batch: DCTPatches,
    normalized_batch: DCTPatches,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
    pixel_grid_sizes: Optional[torch.Tensor] = None,
    pixel_rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    vq_generator: Optional[torch.Generator] = None,
    update_vq_stats: bool = False,
    shard=None,
) -> Dict[str, torch.Tensor]:
    """One forward pass and the loss dict.

    Keys ending in 'loss' enter `weighted_total`; 'perplexity' is a metric;
    'codes' and 'rec_patches' ride along.  `generator` draws the dropout
    masks when the config has dropout.

    pixel_grid_sizes != None adds 'pixel_loss', the differentiable RGB pixel
    loss (reference decode_pixels=True, main.py:95-110): a (max_images, 2)
    tensor of per-image patch grids (train/pixel_loss.py::make_grid_sizes).
    pixel_rows (gradient accumulation) carries (row_offsets, slot_valid),
    which map this micro-batch's rows onto global slots of the grid sizes.

    VQ: `vq_generator` samples the codes with gumbel noise, and
    update_vq_stats=True updates the EMA statistics in the module's buffers
    (JAX: vq_stats passed in, applied with mutable=['vq_stats']; here they
    are read from module.vq_stats()); then the projections before
    quantization come back under 'vq_z', detached.

    shard (parallel/mesh.py's DataShard, the sharded step's): this rank's
    rows of a data-parallel batch; every batch statistic is summed over its
    group (JAX: sync_axis).
    """
    group = None if shard is None else shard.group
    out = module(
        normalized_batch, training=training, generator=generator, vq_generator=vq_generator,
        update_vq_stats=update_vq_stats, shard=shard,
    )
    output_patches: DCTPatches = out["dct_patches"]
    mask = ~output_patches.key_pad_mask

    losses: Dict[str, torch.Tensor] = {}
    if training and module.config.vq_type == "lfq":
        with obs.span("dct.loss.entropy"):
            losses["entropy_loss"] = compute_entropy_loss(out["distances"], mask, group=group)
    else:
        losses["entropy_loss"] = out["distances"].new_zeros(())
    with obs.span("dct.loss.rec"):
        losses["rec_loss"] = masked_l1(output_patches.patches, normalized_batch.patches, mask, group)
    losses["commit_loss"] = out["commit_loss"]
    with obs.span("dct.loss.rec"):
        unnormalized = inverse_patchnorm(patchnorm, output_patches)
        losses["rec_loss_unnormalized"] = masked_l1(unnormalized, batch.patches, mask, group)

    if pixel_grid_sizes is not None:
        from .pixel_loss import packed_pixel_loss

        cfg = module.config
        # the reference's target: postprocess(inv_normalize_(normalized_batch))
        # (main.py:96-98), the input tokens pushed back through the inverse
        # norm, not the raw pixels
        with torch.no_grad():
            target = inverse_patchnorm(patchnorm, normalized_batch)
        row_offsets, slot_valid = pixel_rows if pixel_rows is not None else (None, None)
        losses["pixel_loss"] = packed_pixel_loss(
            unnormalized, target, output_patches, pixel_grid_sizes, (cfg.max_patch_h, cfg.max_patch_w),
            cfg.patch_size, cfg.image_channels, row_offsets=row_offsets, slot_valid=slot_valid,
        )

    codes = out["codes"]
    with torch.no_grad():
        null_codes = torch.where(mask[..., None], codes, torch.full_like(codes, -1))
        losses["perplexity"] = calculate_perplexity(null_codes, module.config.vq_codebook_size, group=group)
    losses["codes"] = codes
    losses["rec_patches"] = output_patches.patches
    if update_vq_stats and "vq_z" in out:
        losses["vq_z"] = out["vq_z"].detach()
    return losses


def weighted_total(
    losses: Dict[str, torch.Tensor],
    loss_weights: Optional[Dict[str, float]] = None,
    warmup_dict: Optional[Dict[str, int]] = None,
    global_step: Optional[float] = None,
) -> torch.Tensor:
    """Weighted sum of the '*loss' terms with an optional per-term linear
    warmup.  Weights are Python numbers, or 0-d tensors (per-trial weights
    of the shared-step sweep, train/sweep.py); a term whose weight is the
    Python number 0 is skipped, a tensor weight always contributes, as in
    JAX."""
    weights = dict(DEFAULT_LOSS_WEIGHTS)
    if loss_weights:
        weights.update(loss_weights)
    total = None
    for k, v in losses.items():
        if not k.endswith("loss"):
            continue
        w = weights.get(k, 1.0)
        if warmup_dict and k in warmup_dict and global_step is not None:
            w = w * min((float(global_step) + 1.0) / warmup_dict[k], 1.0)
        if isinstance(w, (int, float)) and w == 0.0:
            continue
        total = v * w if total is None else total + v * w
    if total is None:
        raise ValueError("no loss term has a non-zero weight")
    return total
