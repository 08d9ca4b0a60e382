"""Blockwise 8-bit AdamW state: the counterpart of the reference's default
optimizer, bitsandbytes' PagedAdamW8bit (reference main.py:420-425).

Port of dct_autoencoder_tpu/train/opt8bit.py, with the same codebooks,
blocks and arithmetic, so both packages store the same codes:
  * each parameter is flattened and zero-padded to a multiple of 256 and
    viewed as (n_blocks, 256): blocks never straddle two parameters;
  * each block stores `absmax` (fp32) and uint8 indices into a fixed
    256-level codebook over [-1, 1] (signed, cubic: for the first moment) or
    [0, 1] (unsigned, quartic: for the second), both built in float64 and
    cast to float32;
  * the nearest level is found by `searchsorted` on the sorted codebook;
    a tie goes to the lower level.

State: 1 byte a parameter a moment plus 4 bytes a block, about 2.03 bytes a
parameter against fp32 Adam's 8.

`AdamW8bit` keeps every parameter's padded blocks in one contiguous buffer
per field, so each pass of the update is one launch over all parameters
(the block edges stay those of one parameter at a time).  The optimizer's
per-parameter state (`mu_codes`, `mu_absmax`, `nu_codes`, `nu_absmax`) is
made of views into those buffers, and its one update count is in the
parameter group; `state_dict` and `load_state_dict` work as for any
torch optimizer (uint8 codes, fp32 absmax, an int count).

The update is optax's chain scale_by_adam8bit -> add_decayed_weights ->
scale_by_learning_rate, step by step in fp32.  Where the card must give the
CPU's bits it divides by tensors, never by a Python number (PyTorch's CUDA
division by a Python number multiplies by its rounded reciprocal), and the
bias corrections 1 - b**count are computed in float32 on the host.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np
import torch

BLOCK = 256


def _signed_codebook() -> torch.Tensor:
    """256 monotone levels in [-1, 1], cubically concentrated near 0."""
    u = np.linspace(-1.0, 1.0, 256)
    return torch.as_tensor(np.sign(u) * np.abs(u) ** 3).to(torch.float32)


def _unsigned_codebook() -> torch.Tensor:
    """256 monotone levels in [0, 1] (u**4), concentrated near 0: nu is
    non-negative with a huge dynamic range (the JAX package's measured
    choice; changing it changes every stored code)."""
    u = np.linspace(0.0, 1.0, 256)
    return torch.as_tensor(u**4).to(torch.float32)


def _nearest_idx(cb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook level (cb sorted ascending), uint8."""
    hi = torch.clamp(torch.searchsorted(cb, x, out_int32=True), 1, cb.shape[0] - 1)
    lo = hi - 1
    take = lambda idx: cb.index_select(0, idx.reshape(-1)).view_as(x)  # noqa: E731
    pick_hi = (take(hi) - x) < (x - take(lo))
    return torch.where(pick_hi, hi, lo).to(torch.uint8)


def _blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, block)


def _unblockify(b: torch.Tensor, shape, size: int) -> torch.Tensor:
    return b.reshape(-1)[:size].reshape(shape)


def _quantize_blocks(xb: torch.Tensor, cb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_blocks, block) fp32 -> (uint8 codes, fp32 absmax (n_blocks,))."""
    absmax = xb.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    return _nearest_idx(cb, xb / scale[:, None]), absmax


def _dequantize_blocks(codes: torch.Tensor, absmax: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    return cb.index_select(0, codes.reshape(-1).int()).view(codes.shape) * absmax[:, None]


def quantize_blockwise(x: torch.Tensor, cb: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (uint8 codes (n_blocks, block), fp32 absmax (n_blocks,))."""
    return _quantize_blocks(_blockify(x.float(), block), cb.to(x.device))


def dequantize_blockwise(codes: torch.Tensor, absmax: torch.Tensor, cb: torch.Tensor, shape, size: int) -> torch.Tensor:
    return _unblockify(_dequantize_blocks(codes, absmax, cb.to(codes.device)), shape, size)


def _f32_bias_correction(b: float, count: int, device) -> torch.Tensor:
    """1 - b**count in float32, as JAX computes it (count cast to float32)."""
    one = torch.tensor(b, dtype=torch.float32) ** torch.tensor(float(count), dtype=torch.float32)
    return (1.0 - one).to(device)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with both moments stored blockwise in 8 bits (one parameter group).

    Same defaults as the reference's PagedAdamW8bit call (main.py:420-425)
    and the JAX package's `adamw8bit`, and its blocks of 256.  A parameter
    without a gradient is updated as if its gradient were zero, as in JAX,
    where every parameter has one.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.99),
        eps: float = 1e-8,
        weight_decay: float = 0.1,
    ):
        defaults = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, count=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW8bit takes one parameter group")
        self._build_buffers()

    # ---------------------------------------------------------------- layout

    def _params(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    def _build_buffers(self) -> None:
        """One padded buffer per field over every parameter, and the per-parameter state as views of it."""
        params = self._params()
        device = params[0].device
        if any(p.device != device or p.dtype != torch.float32 for p in params):
            raise ValueError("AdamW8bit takes float32 parameters on one device")
        counts = [-(-p.numel() // BLOCK) for p in params]
        starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        n_blocks = int(starts[-1])
        self._starts = starts
        self._cb_s = _signed_codebook().to(device)
        self._cb_u = _unsigned_codebook().to(device)
        zero = torch.zeros((1, BLOCK), dtype=torch.float32, device=device)
        self._mu_codes = _nearest_idx(self._cb_s, zero).expand(n_blocks, BLOCK).contiguous()
        self._nu_codes = _nearest_idx(self._cb_u, zero).expand(n_blocks, BLOCK).contiguous()
        self._mu_absmax = torch.zeros(n_blocks, dtype=torch.float32, device=device)
        self._nu_absmax = torch.zeros(n_blocks, dtype=torch.float32, device=device)
        # gradients gathered into the padded layout; the padding stays 0
        self._grad = torch.zeros(n_blocks * BLOCK, dtype=torch.float32, device=device)
        self._grad_views = [self._flat_view(self._grad, i, p) for i, p in enumerate(params)]
        pad = [np.arange(starts[i] * BLOCK + p.numel(), starts[i + 1] * BLOCK) for i, p in enumerate(params)]
        self._pad_idx = torch.as_tensor(np.concatenate(pad).astype(np.int64), device=device)
        self._point_state_at_buffers()

    def _flat_view(self, flat: torch.Tensor, i: int, p: torch.Tensor) -> torch.Tensor:
        start = int(self._starts[i]) * BLOCK
        return flat[start : start + p.numel()].view(p.shape)

    def _point_state_at_buffers(self) -> None:
        for i, p in enumerate(self._params()):
            a, b = int(self._starts[i]), int(self._starts[i + 1])
            self.state[p] = {
                "mu_codes": self._mu_codes[a:b], "mu_absmax": self._mu_absmax[a:b],
                "nu_codes": self._nu_codes[a:b], "nu_absmax": self._nu_absmax[a:b],
            }

    def load_state_dict(self, state_dict) -> None:
        """Load as any optimizer does, then copy the per-parameter state back
        into the contiguous buffers."""
        super().load_state_dict(state_dict)
        loaded = [self.state[p] for p in self._params()]
        for i, st in enumerate(loaded):
            a, b = int(self._starts[i]), int(self._starts[i + 1])
            for name, buf in (("mu_codes", self._mu_codes), ("mu_absmax", self._mu_absmax),
                              ("nu_codes", self._nu_codes), ("nu_absmax", self._nu_absmax)):
                if tuple(st[name].shape) != tuple(buf[a:b].shape):
                    raise ValueError(f"parameter {i}: {name} of shape {tuple(st[name].shape)}, not {tuple(buf[a:b].shape)}")
                buf[a:b].copy_(st[name])
        self._point_state_at_buffers()

    # ---------------------------------------------------------------- update

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = self._params()
        b1, b2 = group["betas"]
        group["count"] += 1
        count = group["count"]
        device = self._grad.device

        with_grad = [(v, p.grad) for v, p in zip(self._grad_views, params) if p.grad is not None]
        if with_grad:
            torch._foreach_copy_([v for v, _ in with_grad], [g.float() for _, g in with_grad])
        for v, p in zip(self._grad_views, params):
            if p.grad is None:
                v.zero_()
        g = self._grad.view(-1, BLOCK)
        c1 = _f32_bias_correction(b1, count, device)
        c2 = _f32_bias_correction(b2, count, device)

        m = b1 * _dequantize_blocks(self._mu_codes, self._mu_absmax, self._cb_s)
        m = m + (1.0 - b1) * g
        v = b2 * _dequantize_blocks(self._nu_codes, self._nu_absmax, self._cb_u)
        v = v + (1.0 - b2) * g * g
        update = (m / c1) / (torch.sqrt(v / c2) + group["eps"])
        # JAX quantizes each parameter's moments zero-padded: the padding of
        # the dequantized codes is not carried into the new blocks
        m.view(-1).index_fill_(0, self._pad_idx, 0.0)
        v.view(-1).index_fill_(0, self._pad_idx, 0.0)
        codes, absmax = _quantize_blocks(m, self._cb_s)
        self._mu_codes.copy_(codes)
        self._mu_absmax.copy_(absmax)
        codes, absmax = _quantize_blocks(v, self._cb_u)
        self._nu_codes.copy_(codes)
        self._nu_absmax.copy_(absmax)

        # add_decayed_weights, then scale_by_learning_rate, then apply_updates
        flat = update.view(-1)
        updates = torch._foreach_mul(params, group["weight_decay"])
        torch._foreach_add_(updates, [self._flat_view(flat, i, p) for i, p in enumerate(params)])
        torch._foreach_mul_(updates, -group["lr"])
        torch._foreach_add_(params, updates)
        return loss


def opt_state_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of every tensor in an optimizer's per-parameter state."""
    return sum(
        t.numel() * t.element_size() for st in opt.state.values() for t in st.values() if isinstance(t, torch.Tensor)
    )
