"""Lookup-free quantization (LFQ): sign quantization, and its training terms.

Token-stream compatibility with the JAX package rests on two rules:
  * the sign is strict: `x > 0` -> +scale, else -scale;
  * ids are packed MSB-first: bit i of a codebook weighs 2**(codebook_dim-1-i).
The projections (present when dim != codebook_dim * num_codebooks) run in
fp32, as in the JAX model.  With training=True the output carries
straight-through gradients, and the masked MSE commit loss and the
`-2 x . C^T` affinities against the materialised +-1 codebook (for the
entropy loss) are returned as well.
"""
from __future__ import annotations

import math

from typing import Optional

import torch
from torch import nn

from .. import obs
from ..ops.stats import masked_mean


class LFQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int, num_codebooks: int = 1, codebook_scale: float = 1.0):
        super().__init__()
        cd = int(math.log2(codebook_size))
        if 2**cd != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.dim = dim
        self.codebook_dim = cd
        self.num_codebooks = num_codebooks
        self.codebook_dims = cd * num_codebooks
        self.codebook_scale = codebook_scale
        self.has_projections = dim != self.codebook_dims
        if self.has_projections:
            self.project_in = nn.Linear(dim, self.codebook_dims)
            self.project_out = nn.Linear(self.codebook_dims, dim)
        bit_mask = 2 ** torch.arange(cd - 1, -1, -1, dtype=torch.int64)
        self.register_buffer("bit_mask", bit_mask, persistent=False)
        # (codebook_size, codebook_dim) of +-scale code vectors, times -2: the
        # affinities are -2 x . C^T, and the factor is exact in fp32
        bits = (torch.arange(codebook_size)[:, None] & bit_mask) != 0
        self.register_buffer("neg2_codebook", -2.0 * (bits.float() * 2.0 - 1.0) * codebook_scale, persistent=False)

    def indices_to_codes(self, indices: torch.Tensor, project_out: bool = True) -> torch.Tensor:
        """(..., c) int ids -> (..., dim) fp32 code vectors."""
        bits = (indices.long()[..., None] & self.bit_mask) != 0
        codes = (bits.float() * 2.0 - 1.0) * self.codebook_scale
        codes = codes.reshape(*codes.shape[:-2], self.codebook_dims)
        if project_out and self.has_projections:
            codes = self.project_out(codes)
        return codes

    def pre_sign(self, x: torch.Tensor) -> torch.Tensor:
        """(b, n, dim) features -> (b, n, c, d) fp32 values whose signs are the bits."""
        x = x.float()
        if self.has_projections:
            x = self.project_in(x)
        return x.reshape(*x.shape[:-1], self.num_codebooks, self.codebook_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, training: bool = False, group=None):
        """x: (b, n, dim); mask: (b, n) bool, False where padding; the commit
        loss's count is summed over the process `group` (data parallelism).

        Returns (quantized (b, n, dim) fp32, ids (b, n, c) int64, commit_loss
        scalar, distances (b, n, c, codebook_size)); the last two are zeros
        when training is False.
        """
        original = self.pre_sign(x)
        bits = original > 0
        indices = (bits.long() * self.bit_mask).sum(dim=-1)
        quantized = torch.where(bits, self.codebook_scale, -self.codebook_scale).float()
        if training:
            # straight-through: forward = quantized, backward = identity
            q = original + (quantized - original).detach()
            distances = torch.einsum("bncd,zd->bncz", original, self.neg2_codebook)
            with obs.span("dct.loss.commit"):
                se = (original - quantized) ** 2
                if mask is not None:
                    commit_loss = masked_mean(se, mask, dim=0, group=group).sum(dim=0).mean()
                else:
                    commit_loss = se.mean()
        else:
            q = quantized
            distances = commit_loss = original.new_zeros(())
        q = q.reshape(*q.shape[:-2], self.codebook_dims)
        if self.has_projections:
            q = self.project_out(q)
        return q, indices, commit_loss, distances
