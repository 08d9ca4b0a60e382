"""Weight-only int8 serving form of the transformer stacks.

Counterpart of dct_autoencoder_tpu/models/quant.py::Int8Dense in mode
'weight_only', the mode its gated checkpoints use
(docs/calibrated_run_r3b/model-int8-wo).  The JAX package runs it in XLA,
not in a Pallas kernel, so here it is plain PyTorch.

A layer holds ``kernel_q`` int8 (in, out), in the JAX layout, and
``kernel_scale`` fp32, per output channel ``(out,)`` or, with a group size g,
per (g input rows, output channel) block ``(in // g, out)``.  As in JAX, the
weight is w = kernel_q * scale in fp32, rounded to the compute type, and the
product runs in the compute type with fp32 sums.  The rounded weight is made
once, at the first call after the int8 weights or scales change (a load, a
move to another device), and kept beside them: a bf16 product then runs on
bf16 tensors, as ``Dense``'s does, at the tensor cores' rate.  Like
``Dense`` the bias is rounded to the compute type and added in the
product's epilogue (JAX adds it in fp32 before its one rounding: the two
differ by at most one ulp of the compute type).  The layer is a serving form
and is never trained, so ``kernel_q`` and ``kernel_scale`` are buffers, not
parameters.

The 'dynamic' mode (int8 activations as well) is not ported and raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import TransformerConfig


class Int8Dense(nn.Module):
    """Linear layer with int8 weights and fp32 scales, dequantized once."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = True, dtype: torch.dtype = torch.float32,
        group_size: int = 0,
    ):
        super().__init__()
        if group_size and in_features % group_size:
            raise ValueError(f"input width {in_features} does not divide by group size {group_size}")
        self.compute_dtype = dtype
        self.group_size = group_size
        scale_shape = (in_features // group_size, out_features) if group_size else (out_features,)
        self.register_buffer("kernel_q", torch.zeros((in_features, out_features), dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(scale_shape))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self._weight = None  # (key of the int8 weights and scales it was made from, weight)

    @torch.no_grad()
    def weight(self) -> torch.Tensor:
        """The dequantized kernel as an (out, in) weight in the compute type."""
        q, scale = self.kernel_q, self.kernel_scale
        key = (q.device, q.data_ptr(), q._version, scale.data_ptr(), scale._version)
        if self._weight is None or self._weight[0] != key:
            w = q.float()
            if self.group_size:
                d_in, d_out = w.shape
                w = (w.reshape(-1, self.group_size, d_out) * scale[:, None, :]).reshape(d_in, d_out)
            else:
                w = w * scale
            self._weight = (key, w.to(self.compute_dtype).t().contiguous())
        return self._weight[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), self.weight(), bias)


def dense(cfg: TransformerConfig, in_features: int, out_features: int, dtype: torch.dtype):
    """The transformer's projection: ``Dense``, or ``Int8Dense`` when
    ``cfg.quantize_int8`` (a layer listed in ``quantize_int8_bf16_layers``
    comes with a config whose ``quantize_int8`` is off)."""
    from .transformer import Dense

    if not cfg.quantize_int8:
        return Dense(in_features, out_features, dtype=dtype)
    if cfg.quantize_int8_mode != "weight_only":
        raise NotImplementedError(
            f"quantize_int8_mode={cfg.quantize_int8_mode!r}: int8 activations (the 'dynamic' mode) are not "
            "ported yet; 'weight_only' is"
        )
    return Int8Dense(in_features, out_features, dtype=dtype, group_size=cfg.quantize_int8_group_size)
