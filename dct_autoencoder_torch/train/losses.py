"""Loss assembly for autoencoder training (LFQ).

Masked L1 in normalized DCT space (weight 0.1), masked L1 in unnormalized
DCT space (weight 1.0), LFQ commit loss (0.1), MaskGIT entropy loss (0.1),
plus codebook perplexity as a metric.  DCT features are treated as Laplace
distributed, hence L1.  The differentiable pixel loss and VQ mode are not
ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.autoencoder import DCTAutoencoderModule
from ..models.patchnorm import PatchNormState, inverse_patchnorm
from ..ops.stats import calculate_perplexity, compute_entropy_loss
from ..patches.container import DCTPatches

DEFAULT_LOSS_WEIGHTS = dict(
    rec_loss_unnormalized=1.0,
    rec_loss=0.1,
    commit_loss=0.1,
    entropy_loss=0.1,
)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over valid tokens (== F.l1_loss(pred[mask], target[mask]))."""
    diff = (pred - target).abs() * mask[..., None]
    denom = torch.clamp(mask.sum() * pred.shape[-1], min=1)
    return diff.sum() / denom


def step_autoencoder(
    module: DCTAutoencoderModule,
    patchnorm: PatchNormState,
    batch: DCTPatches,
    normalized_batch: DCTPatches,
    training: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """One forward pass and the loss dict.

    Keys ending in 'loss' enter `weighted_total`; 'perplexity' is a metric;
    'codes' and 'rec_patches' ride along.  `generator` draws the dropout
    masks when the config has dropout.
    """
    out = module(normalized_batch, training=training, generator=generator)
    output_patches: DCTPatches = out["dct_patches"]
    mask = ~output_patches.key_pad_mask

    losses: Dict[str, torch.Tensor] = {}
    if training:
        losses["entropy_loss"] = compute_entropy_loss(out["distances"], mask)
    else:
        losses["entropy_loss"] = out["distances"].new_zeros(())
    losses["rec_loss"] = masked_l1(output_patches.patches, normalized_batch.patches, mask)
    losses["commit_loss"] = out["commit_loss"]
    unnormalized = inverse_patchnorm(patchnorm, output_patches)
    losses["rec_loss_unnormalized"] = masked_l1(unnormalized, batch.patches, mask)

    codes = out["codes"]
    with torch.no_grad():
        null_codes = torch.where(mask[..., None], codes, torch.full_like(codes, -1))
        losses["perplexity"] = calculate_perplexity(null_codes, module.config.vq_codebook_size)
    losses["codes"] = codes
    losses["rec_patches"] = output_patches.patches
    return losses


def weighted_total(
    losses: Dict[str, torch.Tensor],
    loss_weights: Optional[Dict[str, float]] = None,
    warmup_dict: Optional[Dict[str, int]] = None,
    global_step: Optional[float] = None,
) -> torch.Tensor:
    """Weighted sum of the '*loss' terms with an optional per-term linear
    warmup; a term whose weight is exactly 0 is skipped."""
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
        if w == 0.0:
            continue
        total = v * w if total is None else total + v * w
    if total is None:
        raise ValueError("no loss term has a non-zero weight")
    return total
