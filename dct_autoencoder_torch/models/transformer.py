"""CLIP-architecture pre-LN transformer stack.

Separate q/k/v/out projections (so the JAX checkpoints map one to one),
quick-gelu MLP, LayerNorm with statistics in fp32 and the config's eps.
Masking is derived from per-token image ids and padding; attention goes
through kernels/attention.py, which launches the CUDA kernels (forward, and
backward under autograd) for CUDA tensors and runs their plain versions for
CPU tensors.

Parameters are fp32 masters whatever the compute type: `Dense` casts its
weight and bias to the compute type at each use, as flax's
``nn.Dense(dtype=...)`` does, so an optimizer updates fp32 values while the
products run in bf16.  A weight cast once and a weight cast per call are
the same bf16 numbers.

Training adds MLP dropout when ``cfg.dropout > 0`` (the draw takes an
explicit ``torch.Generator``) and per-layer recomputation when
``cfg.remat`` is set.  Attention dropout exists in the JAX package only on
its XLA attention path, never under the kernel, and is not applied here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import packed_flash_attention
from .config import TransformerConfig


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu, "gelu": F.gelu, "relu": F.relu}


class Dense(nn.Linear):
    """Linear layer with fp32 parameters whose product runs in `dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x, self.weight.to(self.compute_dtype), bias)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from `generator` (on x's device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 parameters and fp32 statistics; output in the input's type."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps).to(x.dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = d // self.num_heads
        self.q_proj = Dense(d, d, dtype=dtype)
        self.k_proj = Dense(d, d, dtype=dtype)
        self.v_proj = Dense(d, d, dtype=dtype)
        self.out_proj = Dense(d, d, dtype=dtype)

    def forward(self, x: torch.Tensor, image_ids: torch.Tensor, key_pad_mask: torch.Tensor, mode: str) -> torch.Tensor:
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        out = packed_flash_attention(q, k, v, image_ids, key_pad_mask, self.head_dim**-0.5, mode=mode)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        self.act = _ACTS[cfg.hidden_act]
        self.dropout = cfg.dropout
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x, image_ids, key_pad_mask, mode, training: bool = False, generator=None):
        x = x + self.self_attn(self.layer_norm1(x), image_ids, key_pad_mask, mode)
        y = self.act(self.fc1(self.layer_norm2(x)))
        if training and self.dropout > 0.0:
            y = dropout(y, self.dropout, generator)
        return x + self.fc2(y)


class TransformerEncoder(nn.Module):
    """Stack of pre-LN CLIP encoder layers."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = cfg.remat
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))

    def forward(self, x, image_ids, key_pad_mask, mode: str = "block", training: bool = False, generator=None):
        remat = self.remat and torch.is_grad_enabled()
        if remat and training and generator is not None and self.layers and self.layers[0].dropout > 0.0:
            # a recomputed layer must redraw the same mask; checkpoint restores
            # only the default generators' state
            raise ValueError("remat with dropout draws from the default generator: pass generator=None")
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, image_ids, key_pad_mask, mode, training, generator, use_reentrant=False)
            else:
                x = layer(x, image_ids, key_pad_mask, mode, training, generator)
        return x
