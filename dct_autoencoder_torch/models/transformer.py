"""CLIP-architecture pre-LN transformer stack.

Separate q/k/v/out projections (so the JAX checkpoints map one to one),
quick-gelu MLP, LayerNorm with statistics in fp32 and the config's eps.
Masking is derived from per-token image ids and padding; attention goes
through kernels/attention.py, which launches the CUDA kernels (forward, and
backward under autograd) for CUDA tensors and runs their plain versions for
CPU tensors.

With ``cfg.quantize_int8`` the projections are the weight-only int8
serving form (models/quant.py), except in the layers that
``quantize_int8_bf16_layers`` lists, as in the JAX package.

Parameters are fp32 masters whatever the compute type: `Dense` casts its
weight and bias to the compute type at each use, as flax's
``nn.Dense(dtype=...)`` does, so an optimizer updates fp32 values while the
products run in bf16.  A weight cast once and a weight cast per call are
the same bf16 numbers.

Training adds MLP dropout when ``cfg.dropout > 0`` (the draw takes an
explicit ``torch.Generator``), attention dropout when
``cfg.attention_dropout > 0`` and per-layer recomputation when
``cfg.remat`` is set.  JAX drops the softmax weights with ``nn.Dropout`` on
its XLA attention path; here the attention kernels drop them themselves:
each layer draws one 64-bit seed from the same generator (before its MLP
dropout's mask, in JAX's order) and the kernels derive the mask from it,
for this rank's rows and heads (``row0``, and the head offset of a
tensor-parallel rank).  Under remat both draws come from the default
generator, whose state the recomputation restores, so the recomputed layer
draws the same seed and masks.

``causal=True`` (the autoregressive token model, models/ar.py) goes down to
the attention kernels' causal mode.  Token-at-a-time decoding has its own
path, ``decode_step``: the keys and values of one new token are written into
a ``KVCache`` at its index and the token attends to the filled prefix.  In
the JAX package that path is an einsum outside any Pallas kernel, so here it
is plain PyTorch.  The cache is explicit state that the caller owns, and its
index is a device tensor, so a decode step does no host read and can be
captured in a CUDA graph and replayed.

Tensor and sequence parallelism (parallel/mesh.py): after
``parallel.shard_params`` a stack holds a `ModelParallel` and each rank
keeps its block of the column-parallel q/k/v and fc1 and of the
row-parallel out_proj and fc2, so a layer runs num_heads // n_model heads of
the same head_dim and intermediate_size // n_model hidden units; the
row-parallel bias enters the sum over the model group once (model rank 0
adds it to its partial product).  With ``sequence_parallel`` the residual stream, the
LayerNorms and the residual adds run on this rank's tokens: the stream is
gathered before q/k/v and fc1 and reduce-scattered after out_proj and fc2,
as JAX's sp_gather / sp_scatter pair lowers; the token count must divide by
n_model.  Without a ModelParallel the stack is the single-device one.

Pipeline parallelism (parallel/pipeline.py): after
``make_pipelined_module`` a stack holds only the layers that its rank's
stage owns (a `StageLayers`, keyed by their indices in the whole stack) and
runs them through ``pipeline_stack_apply``: microbatches of its rows stream
through the stages and the output, broadcast from the last stage, is the
whole stack's on every model rank.  As JAX's ``_pipelined`` asserts, the
layers must be homogeneous (no per-layer int8/bf16 mix), a training forward
must have no dropout and there is no KV-cached decode; each raises
ValueError by name.  ``cfg.remat`` checkpoints each layer inside the stage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import NEG_INF, draw_dropout_seed, packed_flash_attention
from ..parallel.mesh import copy_to_model, gather_tokens, reduce_from_model, sp_gather, sp_scatter, split_tokens
from .config import TransformerConfig
from .quant import dense


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


class KVCache:
    """Per-layer keys and values (b, h, size, d) of the tokens decoded so far,
    and the index the next token is written at (a 0-d int64 device tensor)."""

    def __init__(self, cfg: TransformerConfig, batch: int, size: int, dtype: torch.dtype, device):
        h = cfg.num_attention_heads
        shape = (batch, h, size, cfg.hidden_size // h)
        self.k: List[torch.Tensor] = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_hidden_layers)]
        self.v: List[torch.Tensor] = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_hidden_layers)]
        self.idx = torch.zeros((), dtype=torch.long, device=device)

    def reset(self) -> None:
        """Empty the cache in place (the buffers keep their addresses)."""
        for t in (*self.k, *self.v, self.idx):
            t.zero_()


def row_parallel(layer: nn.Linear, x: torch.Tensor, mp) -> torch.Tensor:
    """A row-parallel product: this rank's partial product, summed over the
    model group (reduce-scattered onto this rank's tokens under sequence
    parallelism).  The whole bias enters once: model rank 0 adds it inside
    its partial product, as the single-device layer adds it, so that a group
    of one gives the single-device bits."""
    bias = layer.bias.to(layer.compute_dtype) if mp.rank == 0 else None
    y = F.linear(x, layer.weight.to(layer.compute_dtype), bias)
    return sp_scatter(y, mp) if mp.sequence_parallel else reduce_from_model(y, mp)


def column_input(x: torch.Tensor, mp) -> torch.Tensor:
    """The input of a column-parallel block: the whole token axis (gathered
    under sequence parallelism), its gradient summed over the model group."""
    return sp_gather(x, mp) if mp.sequence_parallel else copy_to_model(x, mp)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = d // self.num_heads
        self.q_proj = dense(cfg, d, d, dtype)
        self.k_proj = dense(cfg, d, d, dtype)
        self.v_proj = dense(cfg, d, d, dtype)
        self.out_proj = dense(cfg, d, d, dtype)
        self.mp = None  # parallel.mesh.ModelParallel, set by TransformerEncoder.set_model_parallel

    def _qkv(self, x: torch.Tensor):
        b, s, _ = x.shape
        heads = self.num_heads // (self.mp.size if self.mp is not None else 1)
        split = lambda t: t.reshape(b, s, heads, self.head_dim).transpose(1, 2)
        return split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))

    def forward(
        self, x: torch.Tensor, image_ids: torch.Tensor, key_pad_mask: torch.Tensor, mode: str, causal: bool = False,
        dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None, row0: int = 0,
    ) -> torch.Tensor:
        if self.mp is not None:
            x = column_input(x, self.mp)
        b, s, _ = x.shape
        q, k, v = self._qkv(x)
        head0 = 0 if self.mp is None else self.mp.rank * q.shape[1]
        out = packed_flash_attention(
            q, k, v, image_ids, key_pad_mask, self.head_dim**-0.5, mode=mode, causal=causal,
            dropout_rate=dropout_rate, seed=seed, row0=row0, head0=head0,
        )
        out = out.transpose(1, 2).reshape(b, s, q.shape[1] * self.head_dim)
        return self.out_proj(out) if self.mp is None else row_parallel(self.out_proj, out, self.mp)

    def decode_step(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """One token (b, 1, d) against the cache: k and v are written at `idx`
        in place; logits over the whole cache in fp32, keys after `idx` at
        -1e9, softmax in fp32 and cast to the compute type."""
        b, s, d = x.shape
        if s != 1:
            raise ValueError("KV-cached decode consumes one token at a time")
        q, k, v = self._qkv(x)
        at = idx.reshape(1)
        cache_k.index_copy_(2, at, k)
        cache_v.index_copy_(2, at, v)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), cache_k.float()) * self.head_dim**-0.5
        filled = torch.arange(cache_k.shape[2], device=x.device) <= idx
        logits = torch.where(filled, logits, torch.full_like(logits, NEG_INF))
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(weights, cache_v)
        return self.out_proj(out.transpose(1, 2).reshape(b, 1, d))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype):
        super().__init__()
        self.act = _ACTS[cfg.hidden_act]
        self.dropout = cfg.dropout
        self.attention_dropout = cfg.attention_dropout
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = dense(cfg, cfg.hidden_size, cfg.intermediate_size, dtype)
        self.fc2 = dense(cfg, cfg.intermediate_size, cfg.hidden_size, dtype)
        self.mp = None  # parallel.mesh.ModelParallel, set by TransformerEncoder.set_model_parallel

    def _mlp(self, x, training: bool = False, generator=None):
        y = self.layer_norm2(x)
        if self.mp is not None:
            y = column_input(y, self.mp)
        y = self.act(self.fc1(y))
        if training and self.dropout > 0.0:
            y = dropout(y, self.dropout, generator)
        return x + (self.fc2(y) if self.mp is None else row_parallel(self.fc2, y, self.mp))

    def forward(
        self, x, image_ids, key_pad_mask, mode, training: bool = False, generator=None, causal: bool = False,
        row0: int = 0,
    ):
        """`row0`: where x's rows start in the whole batch (a data-parallel
        rank's share), which the attention dropout's mask is drawn by."""
        rate, seed = 0.0, None
        if training and self.attention_dropout > 0.0:
            rate, seed = self.attention_dropout, draw_dropout_seed(generator, x.device)
        x = x + self.self_attn(self.layer_norm1(x), image_ids, key_pad_mask, mode, causal, rate, seed, row0)
        return self._mlp(x, training, generator)

    def decode_step(self, x, cache_k, cache_v, idx):
        x = x + self.self_attn.decode_step(self.layer_norm1(x), cache_k, cache_v, idx)
        return self._mlp(x)


class StageLayers(nn.Module):
    """The layers of a stack that one pipeline stage owns, registered under
    their indices in the whole stack, so that their state_dict keys are the
    single-device ones; iterated in order, as an nn.ModuleList is."""

    def __init__(self, layers: Dict[int, nn.Module]):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)
        self.indices = range(min(layers), max(layers) + 1)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


class TransformerEncoder(nn.Module):
    """Stack of pre-LN CLIP encoder layers."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.remat = cfg.remat
        self.mp = None
        self.pipeline = None  # parallel.pipeline.PipelineSpec, set by set_pipeline
        self.layers = nn.ModuleList(EncoderLayer(self._layer_config(i), dtype) for i in range(cfg.num_hidden_layers))

    def _layer_config(self, i: int) -> TransformerConfig:
        # int8 serving form: layers listed in quantize_int8_bf16_layers keep float weights
        cfg = self.config
        return dataclasses.replace(cfg, quantize_int8=False) if i in cfg.quantize_int8_bf16_layers else cfg

    def set_pipeline(self, spec) -> None:
        """Keep only the layers that spec's stage owns (spec a
        parallel.pipeline.PipelineSpec; parallel.pipeline.make_pipelined_module
        checks the config first) and run them as a pipeline; or, with None,
        hold every layer again (those of other stages rebuilt at their
        initial values, for the caller to load)."""
        from ..parallel.mesh import stage_layers

        cfg = self.config
        if spec is None:
            if self.pipeline is not None:
                own = dict(zip(self.layers.indices, self.layers))
                device = next(self.parameters()).device
                self.layers = nn.ModuleList(
                    own[i] if i in own else EncoderLayer(self._layer_config(i), self.dtype).to(device)
                    for i in range(cfg.num_hidden_layers)
                )
            self.pipeline = None
            return
        if self.mp is not None or self.pipeline is not None:
            raise ValueError("a pipeline stages a whole stack: it was sharded or staged already")
        own = stage_layers(cfg.num_hidden_layers, spec.n_stages, spec.stage)
        self.layers = StageLayers({i: self.layers[i] for i in own})
        self.pipeline = spec

    def set_model_parallel(self, mp) -> None:
        """Run the layers on this rank's heads and hidden units (a
        parallel.mesh.ModelParallel), or on one device again (None)."""
        self.mp = mp
        for layer in self.layers:
            layer.mp = layer.self_attn.mp = mp

    def forward(
        self, x, image_ids, key_pad_mask, mode: str = "block", training: bool = False, generator=None,
        causal: bool = False, row0: int = 0,
    ):
        remat = self.remat and torch.is_grad_enabled()
        if self.pipeline is not None:
            return self._pipelined(x, image_ids, key_pad_mask, mode, training, causal, remat)
        drops = self.config.dropout > 0.0 or self.config.attention_dropout > 0.0
        if remat and training and generator is not None and drops:
            # a recomputed layer must redraw the same masks and seeds; checkpoint
            # restores only the default generators' state
            raise ValueError("remat with dropout draws from the default generator: pass generator=None")
        sp = self.mp is not None and self.mp.sequence_parallel
        if sp:
            if x.shape[1] % self.mp.size:
                raise ValueError(
                    f"sequence_parallel: {x.shape[1]} tokens a row do not divide over n_model_parallel={self.mp.size}"
                )
            x = split_tokens(x, self.mp)
        for layer in self.layers:
            if remat:
                x = checkpoint(
                    layer, x, image_ids, key_pad_mask, mode, training, generator, causal, row0, use_reentrant=False
                )
            else:
                x = layer(x, image_ids, key_pad_mask, mode, training, generator, causal, row0)
        if sp:
            x = gather_tokens(x, self.mp)
        return x

    def _pipelined(self, x, image_ids, key_pad_mask, mode, training, causal, remat):
        from ..parallel.pipeline import check_no_dropout, pipeline_stack_apply

        if training:
            check_no_dropout(self.config)

        def layer_apply(layer, xm, ids, pad):
            return layer(xm, ids, pad, mode, training, None, causal)

        return pipeline_stack_apply(layer_apply, list(self.layers), x, image_ids, key_pad_mask, self.pipeline, remat)

    def decode_step(self, x: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """One token (b, 1, d) through every layer against `cache`, whose index
        then moves on by one.  No dropout: decoding is inference."""
        if self.pipeline is not None:
            raise ValueError("a pipelined stack is a training and encode path: it has no KV-cached decode")
        for layer, cache_k, cache_v in zip(self.layers, cache.k, cache.v):
            x = layer.decode_step(x, cache_k, cache_v, cache.idx)
        cache.idx += 1
        return x
