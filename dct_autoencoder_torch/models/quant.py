"""int8 serving form of the transformer stacks.

Counterpart of dct_autoencoder_tpu/models/quant.py.  The JAX package runs
both modes in XLA, not in a Pallas kernel, so here they are plain PyTorch:

* ``weight_only`` (the mode of the gated checkpoints, e.g.
  docs/calibrated_run_r3b/model-int8-wo): w = kernel_q * scale in fp32,
  rounded to the compute type, and the product runs in the compute type
  with fp32 sums.  The rounded weight is made once, at the first call after
  the int8 weights or scales change (a load, a move to another device), and
  kept beside them: a bf16 product then runs on bf16 tensors, as ``Dense``'s
  does.  Like ``Dense`` the bias is rounded to the compute type and added in
  the product's epilogue (JAX adds it in fp32 before its one rounding: the
  two differ by at most one ulp of the compute type).
* ``dynamic``: each token's activations are quantized symmetrically in fp32
  (x_scale = max(amax, 1e-8) / 127, round half to even, clip to +-127), so
  both operands are int8; the product is int8 x int8 -> int32
  (``torch._int_mm``, exact), scaled by x_scale and then the weight's scale,
  as JAX orders it.  With a group size each group of input rows keeps its
  own int32 sum and its scale is applied before the sum across groups.  The
  bias is added in fp32 and the result cast to the compute type.  On the card
  ``torch._int_mm`` needs more than 16 rows and widths that are multiples of
  8: ``int8_matmul`` pads with zeros to meet them and never falls back to a
  float product.  ``INT_MM_CALLS`` counts its calls.

A layer holds ``kernel_q`` int8 (in, out), in the JAX layout, and
``kernel_scale`` fp32, per output channel ``(out,)`` or, with a group size g,
per (g input rows, output channel) block ``(in // g, out)``.  The layer is a
serving form and is never trained, so they are buffers, not parameters.

``quantize_model_for_serving`` turns a float model into its int8 sibling: it
quantizes the JAX-layout parameter tree (models/convert.py) as the JAX
package does, with the same per-channel or per-group scales bit for bit, and
loads it into a model built from the int8 config.
"""
from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import TransformerConfig

MODES = ("weight_only", "dynamic")
INT_MM_CALLS = 0


def _quantize_weight(w: np.ndarray, group_size: int = 0):
    """(in, out) float kernel -> (int8 kernel, fp32 scales), as the JAX package computes them.

    group_size=0: per-output-channel scales, shape (out,).
    group_size=g: scales per (g input rows, output channel) block, shape
    (in // g, out); `in` must divide by g."""
    w = np.asarray(w, dtype=np.float32)
    if group_size:
        d_in, d_out = w.shape
        if d_in % group_size:
            raise ValueError(f"input width {d_in} does not divide by group size {group_size}")
        wg = w.reshape(d_in // group_size, group_size, d_out)
        scale = np.abs(wg).max(axis=1) / 127.0  # (groups, out)
        scale = np.where(scale == 0.0, 1.0, scale)
        q = np.clip(np.round(wg / scale[:, None, :]), -127, 127)
        return q.reshape(d_in, d_out).astype(np.int8), scale.astype(np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 times b (k, n) int8 -> (m, n) int32, exact; b is given as
    b_t (n, k), so that it reaches ``torch._int_mm`` column-major.

    On the card the shapes are padded with zeros to what ``torch._int_mm``
    takes there (m > 16; k and n multiples of 8), which changes no sum."""
    global INT_MM_CALLS
    m, k = a.shape
    n = b_t.shape[0]
    if a.device.type == "cuda":
        pad_m, pad_k, pad_n = max(17 - m, 0), (-k) % 8, (-n) % 8
        if pad_m or pad_k:
            a = F.pad(a, (0, pad_k, 0, pad_m))
        if pad_k or pad_n:
            b_t = F.pad(b_t, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    INT_MM_CALLS += 1
    return out[:m, :n]


class Int8Dense(nn.Module):
    """Linear layer with int8 weights and fp32 scales, in mode 'weight_only' or 'dynamic'."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32,
        group_size: int = 0, mode: str = "weight_only",
    ):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"quantize_int8_mode must be 'weight_only' or 'dynamic', got {mode!r}")
        if group_size and in_features % group_size:
            raise ValueError(f"input width {in_features} does not divide by group size {group_size}")
        self.compute_dtype = dtype
        self.group_size = group_size
        self.mode = mode
        scale_shape = (in_features // group_size, out_features) if group_size else (out_features,)
        self.register_buffer("kernel_q", torch.zeros((in_features, out_features), dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(scale_shape))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self._derived = None  # (key of the int8 weights and scales it was made from, weight)

    def _cached(self, make):
        """`make()`'s weight, made again only when kernel_q or kernel_scale changed."""
        q, scale = self.kernel_q, self.kernel_scale
        key = (q.device, q.data_ptr(), q._version, scale.data_ptr(), scale._version)
        if self._derived is None or self._derived[0] != key:
            self._derived = (key, make())
        return self._derived[1]

    @torch.no_grad()
    def weight(self) -> torch.Tensor:
        """weight_only: the dequantized kernel as an (out, in) weight in the compute type."""

        def make():
            w = self.kernel_q.float()
            if self.group_size:
                d_in, d_out = w.shape
                w = (w.reshape(-1, self.group_size, d_out) * self.kernel_scale[:, None, :]).reshape(d_in, d_out)
            else:
                w = w * self.kernel_scale
            return w.to(self.compute_dtype).t().contiguous()

        return self._cached(make)

    @torch.no_grad()
    def _int8_weights(self):
        """dynamic: the int8 kernel as (out, in) blocks, one per group of input rows (one without groups)."""
        g = self.group_size or self.kernel_q.shape[0]
        return self._cached(lambda: [blk.t().contiguous() for blk in self.kernel_q.split(g, dim=0)])

    def _dynamic(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float().reshape(-1, x.shape[-1])
        amax = xf.abs().amax(dim=-1, keepdim=True)
        # a tensor divisor: the card turns division by a Python number into a
        # multiplication by its rounded reciprocal, which differs in the last bit
        x_scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
        xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
        blocks = self._int8_weights()
        if not self.group_size:
            return int8_matmul(xq, blocks[0]).float() * x_scale * self.kernel_scale
        g = self.group_size
        y = None
        for i, w_t in enumerate(blocks):
            term = int8_matmul(xq[:, i * g:(i + 1) * g], w_t).float() * self.kernel_scale[i]
            y = term if y is None else y + term
        return y * x_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "weight_only":
            bias = None if self.bias is None else self.bias.to(self.compute_dtype)
            return F.linear(x.to(self.compute_dtype), self.weight(), bias)
        y = self._dynamic(x)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.compute_dtype).reshape(*x.shape[:-1], y.shape[-1])


def dense(cfg: TransformerConfig, in_features: int, out_features: int, dtype: torch.dtype):
    """The transformer's projection: ``Dense``, or ``Int8Dense`` in the
    config's mode when ``cfg.quantize_int8`` (a layer listed in
    ``quantize_int8_bf16_layers`` comes with a config whose ``quantize_int8``
    is off)."""
    from .transformer import Dense

    if not cfg.quantize_int8:
        return Dense(in_features, out_features, dtype=dtype)
    return Int8Dense(
        in_features, out_features, dtype=dtype, group_size=cfg.quantize_int8_group_size, mode=cfg.quantize_int8_mode
    )


# ------------------------------------------------------- the JAX-layout tree


def quantize_dense_params(params: Any, group_size: int = 0) -> Any:
    """Rewrite every Dense {kernel, bias} subtree of a JAX-layout tree into
    Int8Dense params {kernel_q, kernel_scale, bias}; the rest passes through."""
    return _quantize_stack(params, group_size)


def quantize_transformer_params(params: Any, encoder_bf16_layers=(), decoder_bf16_layers=(), group_size: int = 0) -> Any:
    """Quantize only the encoder and decoder stacks of a DCTAutoencoder tree
    (patch embed, LFQ and proj_out stay float).  Layers listed in
    *_bf16_layers keep their float Dense params."""
    out = dict(params)
    for stack, bf16 in (("encoder", encoder_bf16_layers), ("decoder", decoder_bf16_layers)):
        if stack in out:
            skip = frozenset(f"layers_{i}" for i in bf16)
            out[stack] = {k: (v if k in skip else _quantize_stack(v, group_size)) for k, v in out[stack].items()}
    return out


def _quantize_stack(node: Any, group_size: int = 0) -> Any:
    if isinstance(node, dict):
        if "kernel" in node and np.ndim(node["kernel"]) == 2:
            q, scale = _quantize_weight(np.asarray(node["kernel"]), group_size)
            out = {"kernel_q": q, "kernel_scale": scale}
            if "bias" in node:
                out["bias"] = np.asarray(node["bias"], np.float32)
            return out
        return {k: _quantize_stack(v, group_size) for k, v in node.items()}
    return node


def quantize_model_for_serving(
    model, mode: str = None, encoder_bf16_layers=(), decoder_bf16_layers=(), group_size: int = 0
):
    """Float DCTAutoencoder -> its int8 serving sibling, on the same device and compute type.

    The sibling's config sets quantize_int8 on both stacks, with the given
    bf16 layers, group size and (if given) mode; its weights are the float
    model's JAX-layout tree quantized by ``quantize_transformer_params``.
    Loading checks the structure: every quantized leaf must fill a parameter
    or buffer of the int8 module and every one must be filled.  Patchnorm and
    VQ's statistics are carried over."""
    from .autoencoder import DCTAutoencoder
    from .convert import flatten_jax_tree, jax_param_tree, load_jax_arrays, vq_stats_from_state_dict

    cfg = copy.deepcopy(model.config)
    for stack, bf16 in ((cfg.encoder_config, encoder_bf16_layers), (cfg.decoder_config, decoder_bf16_layers)):
        stack.quantize_int8 = True
        stack.quantize_int8_bf16_layers = tuple(bf16)
        stack.quantize_int8_group_size = group_size
        if mode is not None:
            stack.quantize_int8_mode = mode
    qmodel = DCTAutoencoder(cfg, dtype=model.dtype, device=model.device)
    tree = quantize_transformer_params(
        jax_param_tree(model.module.state_dict(), model.config), encoder_bf16_layers, decoder_bf16_layers, group_size
    )
    stats = vq_stats_from_state_dict(model.module.state_dict())
    load_jax_arrays(qmodel.module, flatten_jax_tree(tree), cfg, stats or None)
    qmodel.patchnorm = model.patchnorm
    return qmodel
