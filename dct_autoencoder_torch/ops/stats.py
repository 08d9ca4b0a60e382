"""Masked statistics, MaskGIT-style entropy loss, codebook perplexity.

The loss and metric numerics of the JAX package's ops/stats.py, in PyTorch.
`compute_entropy_loss` gives the same value and gradient as the reference
but walks the codebook heads one at a time: at the full-width batch the
affinities are (64, 256, 16, 8192) fp32 = 8.6 GB, and softmax, log_softmax
and their product would each keep another copy for the backward.  The loss
separates over heads (a per-head masked mean of the probabilities, averaged
over heads at the end; a sum over heads of per-token entropies), so each
head runs under torch.utils.checkpoint and only about one head's worth of
temporaries (0.5 GB a copy) is alive at a time.

Under data parallelism each statistic takes the step's data `group` (a
torch.distributed process group; JAX's `sync_axis`): the masked counts, the
averaged code probabilities and the perplexity histogram are summed over
it, so each rank's entropy loss is its share of the global batch's, and the
code-probability entropy, alike on every rank, enters each share divided
by the group's size.  group=None is one device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint


def group_size(group=None) -> int:
    """The number of ranks in a process group (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def group_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over a process group, without a gradient (counts,
    histograms); x itself for None."""
    if group is None:
        return x
    with torch.no_grad():
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return group_sum(g, ctx.group), None


def group_sum_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over a process group, differentiably.  The sum is consumed
    on every rank, by each rank's share of the loss, so its gradient is the
    sum of the ranks' gradients: the backward sums too.  A term computed
    from it alike on every rank (the entropy of the averaged code
    probabilities, say) enters each share divided by group_size(group)."""
    return x if group is None else _GroupSum.apply(x, group)


def mult_along_first_dims(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x * m where m broadcasts over x's leading dims."""
    return x * m.reshape(m.shape + (1,) * (x.ndim - m.ndim))


def masked_mean(x: torch.Tensor, m: torch.Tensor, dim=None, group=None) -> torch.Tensor:
    """Mean of x over entries where m (a 0/1 or bool mask on leading dims) is set.

    With `dim` given the division is still by the *total* mask count (the
    reference's convention), summed over `group`.  An all-zero mask yields
    0, not 0/0.
    """
    m = m.to(x.dtype)
    x = mult_along_first_dims(x, m) / torch.clamp(group_sum(m.sum(), group), min=1)
    return x.sum() if dim is None else x.sum(dim=dim)


def _head_entropy_terms(affinity: torch.Tensor, weights: torch.Tensor, temperature: float, eps: float):
    """One codebook head: affinity (n, z), weights (n,) = mask / max(count, 1).

    Returns (sum_n w_n sum_z p log p, sum_n w_n p) = (scalar, (z,)).
    """
    log_probs = torch.log_softmax(affinity / temperature + eps, dim=-1)
    probs = torch.exp(log_probs)
    neg_entropy = (probs * log_probs).sum(dim=-1)  # as a batched dot this runs as n tiny GEMVs
    return torch.dot(weights, neg_entropy), weights @ probs


def compute_entropy_loss(
    affinity: torch.Tensor, mask: torch.Tensor, temperature: float = 0.01, eps: float = 1e-9, group=None
) -> torch.Tensor:
    """MaskGIT-style codebook entropy loss: sample_entropy - avg_entropy, in fp32.

    affinity: (b, s, c, z) code affinities (last dim over codebook entries).
    mask: (b, s) bool, False where padding is.
    """
    og_dtype = affinity.dtype
    b, s = mask.shape
    m = mask.reshape(b * s).to(torch.float32)
    weights = m / torch.clamp(group_sum(m.sum(), group), min=1)
    need_grad = torch.is_grad_enabled() and affinity.requires_grad

    sample_sum = None
    avg_probs = None
    heads = affinity.float().unbind(dim=2)  # c views of (b, s, z); one stacked gradient
    for head in heads:
        head = head.reshape(b * s, head.shape[-1])
        if need_grad:
            neg_ent, probs = checkpoint(_head_entropy_terms, head, weights, temperature, eps, use_reentrant=False)
        else:
            neg_ent, probs = _head_entropy_terms(head, weights, temperature, eps)
        sample_sum = neg_ent if sample_sum is None else sample_sum + neg_ent
        avg_probs = probs if avg_probs is None else avg_probs + probs
    avg_probs = group_sum_grad(avg_probs / len(heads), group)

    avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + eps))
    sample_entropy = -sample_sum
    return (sample_entropy - avg_entropy / group_size(group)).to(og_dtype)


def calculate_perplexity(codes: torch.Tensor, codebook_size: int, null_index: int = -1, group=None) -> torch.Tensor:
    """2^H(p) over the empirical code histogram (summed over `group`);
    entries equal to `null_index` are left out."""
    codes = codes.reshape(-1)
    valid = codes != null_index
    bucket = torch.where(valid, codes, torch.full_like(codes, codebook_size)).long()
    counts = group_sum(torch.bincount(bucket, minlength=codebook_size + 1)[:codebook_size].float(), group)
    probs = counts / torch.clamp(group_sum(valid.sum(), group), min=1)
    logits = torch.where(probs > 0.0, torch.log2(torch.clamp(probs, min=1e-30)), torch.zeros_like(probs))
    return 2.0 ** (-torch.sum(probs * logits))


def pad_sequence(seqs, max_seq_len: int) -> torch.Tensor:
    """Right-pad a list of (k_i, ...) arrays or tensors with zeros to (n, max_seq_len, ...)."""
    seqs = [torch.as_tensor(np.asarray(s)) for s in seqs]
    out = seqs[0].new_zeros((len(seqs), max_seq_len, *seqs[0].shape[1:]))
    for i, s in enumerate(seqs):
        if s.shape[0] > max_seq_len:
            raise ValueError(f"sequence {i} has {s.shape[0]} entries, more than max_seq_len {max_seq_len}")
        out[i, : s.shape[0]] = s
    return out


def ema_update_2d(old: torch.Tensor, new: torch.Tensor, alpha: float = 0.8) -> torch.Tensor:
    """EMA over the overlapping top-left (h, w) region of `new`; returns an
    updated copy of `old` (which is left as it is)."""
    h, w = new.shape[-2], new.shape[-1]
    out = old.clone()
    out[..., :h, :w] = alpha * new[..., :h, :w] + (1 - alpha) * old[..., :h, :w]
    return out


def get_decay_fn(start_val: float, end_value: float, n: int):
    """Linear decay schedule fn."""

    def fn(i: int) -> float:
        if i > n:
            return end_value
        return ((n - i) / n) * start_val + (i / n) * end_value

    return fn


def psnr(a, b) -> float:
    """RGB-space PSNR in dB between two [0, 1] images (clipped; mse floored at
    1e-12, so capped at 120 dB)."""
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))
