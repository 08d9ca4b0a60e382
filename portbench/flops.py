"""Operations and bytes of the work a cell asks for, from its shapes alone.

Peaks: one NVIDIA H100 SXM at its 700 W limit, dense, from the data sheet:
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM.

The counts are of the work, not of how the program does it, so that no
implementation of the same work can read over 100 % of a bound:

* attention (the packed block-diagonal mode): only the allowed (query, key)
  pairs, the pairs within one image of a row, sum k_i^2 over the images;
  4 d operations a pair and head forward (q.k and p.v), 8 d backward (dv,
  dp, dq, dk; the recomputed logits are not counted).  Bytes: the valid
  tokens' q, k, v and o in bf16 and the fp32 log-sum-exp once each forward;
  q, k, v and do read and dq, dk, dv written in bf16, and two fp32 row
  vectors (lse and the row sums of do * o), once each, backward.
* DCT and IDCT: bytes alone (a fast transform needs far fewer operations
  than the matrix products do): the images read as uint8 and the fp32
  tokens written, the fp32 tokens read and the pixels written as uint8.
* model FLOPs: 2 x (the matmul weights: both stacks' q, k, v, out, fc1 and
  fc2, the patch embedding, the output projection and the quantizer's two
  projections) x valid tokens for a forward, 6 x for a train step, plus
  the attention operations above.  Padding and recomputation are not
  counted, nor the loss's affinity product.
"""
from __future__ import annotations

import math
from typing import Iterable

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def pair_count(lengths: Iterable[int]) -> int:
    """Allowed (query, key) pairs of packed images of these token counts."""
    return sum(int(k) * int(k) for k in lengths)


def attention_fwd(pairs: int, tokens: int, heads: int, head_dim: int):
    """(operations, bytes) of one layer's attention forward."""
    return 4 * head_dim * heads * pairs, tokens * heads * (4 * head_dim * 2 + 4)


def attention_bwd(pairs: int, tokens: int, heads: int, head_dim: int):
    """(operations, bytes) of one layer's attention backward (dq, dk, dv)."""
    return 8 * head_dim * heads * pairs, tokens * heads * (7 * head_dim * 2 + 2 * 4)


def bound_s(operations: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over the bf16 peak and bytes over HBM's rate."""
    return max(operations / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def dct_bytes(images: int, h: int, w: int, tokens: int, patch_size: int) -> int:
    """Bytes of the front end of `images` uint8 images h x w giving `tokens` fp32 tokens."""
    return images * 3 * h * w + tokens * patch_size**2 * 4


def idct_bytes(images: int, h: int, w: int, tokens: int, patch_size: int) -> int:
    """Bytes of the back end: `tokens` fp32 tokens read, `images` uint8 images h x w written."""
    return tokens * patch_size**2 * 4 + images * 3 * h * w


def matmul_weights(cfg: dict) -> int:
    """Weights that multiply every token once: both stacks, the patch embedding, the output projection
    and the quantizer's two projections."""
    d = cfg["encoder_config"]["hidden_size"]
    pz = cfg["patch_size"] ** 2
    stacks = 0
    for s in ("encoder", "decoder"):
        c = cfg[f"{s}_config"]
        stacks += c["num_hidden_layers"] * (4 * d * d + 2 * d * c["intermediate_size"])
    code = cfg["vq_num_codebooks"] * int(math.log2(cfg["vq_codebook_size"]))  # LFQ's bits
    return stacks + 2 * d * pz + 2 * d * code


def attention_layers(cfg: dict) -> int:
    return sum(cfg[f"{s}_config"]["num_hidden_layers"] for s in ("encoder", "decoder"))


def _heads(cfg: dict):
    c = cfg["encoder_config"]
    return c["num_attention_heads"], c["hidden_size"] // c["num_attention_heads"]


def model_flops(cfg: dict, tokens: int, pairs: int, train: bool) -> float:
    """Model FLOPs of a forward (train=False) or a train step over `tokens` valid tokens with `pairs` allowed pairs."""
    heads, d = _heads(cfg)
    per_pair = (4 + (8 if train else 0)) * d * heads * attention_layers(cfg)
    return (6 if train else 2) * matmul_weights(cfg) * tokens + per_pair * pairs


def attention_bound_s(cfg: dict, tokens: int, pairs: int, backward: bool) -> float:
    """Summed bounds of every layer's attention forward (and backward) over `tokens` and `pairs`."""
    heads, d = _heads(cfg)
    t = bound_s(*attention_fwd(pairs, tokens, heads, d))
    if backward:
        t += bound_s(*attention_bwd(pairs, tokens, heads, d))
    return t * attention_layers(cfg)
