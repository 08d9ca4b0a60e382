"""Plain DCT autoencoder: forward, training losses and AdamW, in float32.

Written from the model's description (CLIP-style pre-LN stacks, LFQ):

  encode: x = LayerNorm_1e-4(patches W_pe^T) + pos_c[c] + pos_h[h] + pos_w[w];
          each layer: x += Attn(LN1(x)); x += fc2(quick_gelu(fc1(LN2(x))));
          z = x W_in^T + b_in, in 16 groups of 13; bits z > 0; codes +-1.
  decode: y = (codes W_out^T + b_out) + decoder positions; the decoder stack;
          patches = LayerNorm_1e-4(y) W_po^T.

Attention is allowed between tokens of one image of a packed row, never to a
padding key; a padding query attends to nothing (its output is 0).  The
training objective is 0.1 x each of: L1 in normalized space, the commit loss
(mean squared distance of z to its code over valid tokens, codebooks and
bits) and the MaskGIT entropy loss over the affinities -2 z.C (temperature
0.01): mean per-token entropy minus the entropy of the mean code
distribution.  The L1 of the de-normalized prediction against the raw
patches is reported beside them and is not in the objective (the trainer
sums the terms whose names end in "loss").

`quant` set to "fp8" rounds to float8 e4m3 (one scale a tensor), forward
and backward, every tensor that the configuration keeps in bf16: the weights
as products use them, the stacks' activations and residual stream, q, k, v,
the attention weights and outputs, the patch embedding's and the output
projection's; the precision below the configurations' bf16, and so the
control of the comparison.  "bf16" rounds the same tensors to bfloat16, the
configurations' own precision, which shows what that precision alone does to
each compared number.

Everything runs in blocks of rows so that a batch of any size fits; the
entropy loss, which is not a sum over rows, takes two passes (the mean code
distribution first, then each block's gradient through its linearization).
Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

LOSS_WEIGHTS = {"rec_loss": 0.1, "commit_loss": 0.1, "entropy_loss": 0.1}  # the objective's terms
ENTROPY_TEMPERATURE = 0.01
ENTROPY_EPS = 1e-9
NORM_EPS = 1e-6
NORM_CLAMP = 6.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (largest magnitude -> 448)."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


ROUNDINGS = {"fp8": _fp8, "bf16": _bf16}


class _Round(torch.autograd.Function):
    """Values and gradients alike rounded to a lower precision."""

    @staticmethod
    def forward(ctx, t, how):
        ctx.how = how
        return ROUNDINGS[how](t)

    @staticmethod
    def backward(ctx, g):
        return ROUNDINGS[ctx.how](g), None


class Plain:
    """The plain model over a dict of weights named as the benchmark makes them."""

    def __init__(self, w: Weights, cfg: dict, quant: Optional[str] = None):
        self.w = w
        self.cfg = cfg
        self.quant = quant
        self.heads = cfg["encoder_config"]["num_attention_heads"]
        self.layers = {s: cfg[f"{s}_config"]["num_hidden_layers"] for s in ("encoder", "decoder")}
        self.eps = {s: cfg[f"{s}_config"].get("layer_norm_eps", 1e-5) for s in ("encoder", "decoder")}
        self.codebooks = cfg["vq_num_codebooks"]
        self.bits = int(math.log2(cfg["vq_codebook_size"]))

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return _Round.apply(t, self.quant) if self.quant else t

    def linear(self, x, name: str, bias: bool = True):
        y = x @ self._q(self.w[name + ".weight"]).T
        return self._q(y + self._q(self.w[name + ".bias"]) if bias else y)

    def norm(self, x, name: str, eps: float):
        return self._q(F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"], eps))

    def attention(self, x, prefix: str, q_ids, kv_ids):
        b, s, d = x.shape
        h = self.heads
        split = lambda t: t.reshape(b, s, h, d // h).transpose(1, 2)
        q = split(self.linear(x, prefix + ".q_proj"))
        k = split(self.linear(x, prefix + ".k_proj"))
        v = split(self.linear(x, prefix + ".v_proj"))
        logits = (q @ k.transpose(-1, -2)) * (d // h) ** -0.5
        allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        p = torch.softmax(logits.masked_fill(~allowed, float("-inf")), dim=-1)
        p = torch.nan_to_num(p, nan=0.0)  # a padding query: no key allowed
        o = self._q((self._q(p) @ v).transpose(1, 2).reshape(b, s, d))
        return self.linear(o, prefix + ".out_proj")

    def stack(self, x, which: str, q_ids, kv_ids):
        eps = self.eps[which]
        for i in range(self.layers[which]):
            pre = f"{which}.layers.{i}"
            x = self._q(x + self.attention(self.norm(x, pre + ".layer_norm1", eps), pre + ".self_attn", q_ids, kv_ids))
            y = self.linear(self.norm(x, pre + ".layer_norm2", eps), pre + ".fc1")
            x = self._q(x + self.linear(self._q(y * torch.sigmoid(1.702 * y)), pre + ".fc2"))
        return x

    def positions(self, which: str, chans, pos):
        w = self.w
        return (w[f"{which}_pos_embed_channel"][chans] + w[f"{which}_pos_embed_height"][pos[..., 0]]
                + w[f"{which}_pos_embed_width"][pos[..., 1]])

    def encode(self, x: torch.Tensor, rows: dict) -> torch.Tensor:
        """Normalized patches (b, s, p*p) -> pre-sign values z (b, s, codebooks, bits)."""
        f = self.norm(self.linear(self._q(x), "patch_embed_linear", bias=False), "patch_embed_norm", 1e-4)
        f = self._q(f + self._q(self.positions("encoder", rows["chans"], rows["pos"])))
        f = self.stack(f, "encoder", rows["q_ids"], rows["kv_ids"])
        z = f @ self.w["vq_model.project_in.weight"].T + self.w["vq_model.project_in.bias"]
        return z.reshape(*z.shape[:-1], self.codebooks, self.bits)

    def decode(self, codes: torch.Tensor, rows: dict) -> torch.Tensor:
        """Code vectors (b, s, codebooks * bits) -> predicted normalized patches (b, s, p*p)."""
        f = codes @ self.w["vq_model.project_out.weight"].T + self.w["vq_model.project_out.bias"]
        f = self._q(self._q(f) + self._q(self.positions("decoder", rows["chans"], rows["pos"])))
        f = self.stack(f, "decoder", rows["q_ids"], rows["kv_ids"])
        return self.linear(self.norm(f, "proj_out_norm", 1e-4), "proj_out_linear", bias=False)

    def ids(self, z: torch.Tensor) -> torch.Tensor:
        """Pre-sign values -> (b, s, codebooks) token ids, most significant bit first."""
        weights = 2 ** torch.arange(self.bits - 1, -1, -1, device=z.device)
        return ((z > 0).long() * weights).sum(-1)

    def codebook(self, device) -> torch.Tensor:
        """The (2**bits, bits) table of +-1 code vectors, id bits most significant first."""
        n = 2**self.bits
        bits = (torch.arange(n, device=device)[:, None] >> torch.arange(self.bits - 1, -1, -1, device=device)) & 1
        return bits.float() * 2 - 1


def row_fields(batch: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of a packed batch, with the attention ids of its tokens."""
    ids, pad = batch["ids"][lo:hi], batch["pad"][lo:hi]
    return dict(
        patches=batch["patches"][lo:hi], pad=pad, chans=batch["chans"][lo:hi].long(), pos=batch["pos"][lo:hi].long(),
        q_ids=torch.where(pad, -2, ids), kv_ids=torch.where(pad, -1, ids),
    )


def normalize(patches, chans, pos, norm: dict):
    med = norm["median"][chans, pos[..., 0], pos[..., 1]]
    std = norm["b"][chans, pos[..., 0], pos[..., 1]] * 2**0.5 + NORM_EPS
    return torch.clamp((patches - med) / std, -NORM_CLAMP, NORM_CLAMP), med, std


def _entropy_terms(z: torch.Tensor, valid: torch.Tensor, count: float, codebook: torch.Tensor):
    """(sum over valid tokens and codebooks of sum_z p log p / count, sum over the same of p / count / codebooks)."""
    logits = torch.einsum("nci,zi->ncz", z[valid], -2.0 * codebook) / ENTROPY_TEMPERATURE + ENTROPY_EPS
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    return (p * logp).sum() / count, p.sum(dim=(0, 1)) / count / z.shape[-2]


def train_losses(model: Plain, batch: dict, norm: dict, block_rows: int) -> Dict[str, float]:
    """The losses of one packed batch and the gradient of their weighted sum
    with respect to every weight that requires it (accumulated in .grad)."""
    n_rows = batch["patches"].shape[0]
    valid_all = ~batch["pad"]
    count = float(valid_all.sum().clamp(min=1))
    pz = batch["patches"].shape[-1]
    cb = model.codebook(batch["patches"].device)
    blocks = [(lo, min(lo + block_rows, n_rows)) for lo in range(0, n_rows, block_rows)]

    # pass 1: the mean code distribution over the whole batch
    with torch.no_grad():
        avg = None
        for lo, hi in blocks:
            r = row_fields(batch, lo, hi)
            x, _, _ = normalize(r["patches"], r["chans"], r["pos"], norm)
            _, part = _entropy_terms(model.encode(x, r), ~r["pad"], count, cb)
            avg = part if avg is None else avg + part
        avg_entropy = -(avg * torch.log(avg + ENTROPY_EPS)).sum()
        # d(-avg_entropy)/d avg: the linearization that carries each block's gradient
        g_avg = torch.log(avg + ENTROPY_EPS) + avg / (avg + ENTROPY_EPS)

    totals = {"rec_loss": 0.0, "rec_loss_unnormalized": 0.0, "commit_loss": 0.0}
    sample_neg_entropy = 0.0
    for lo, hi in blocks:
        r = row_fields(batch, lo, hi)
        valid = ~r["pad"]
        x, med, std = normalize(r["patches"], r["chans"], r["pos"], norm)
        z = model.encode(x, r)
        code = torch.where(z > 0, 1.0, -1.0)
        st = z + (code - z).detach()
        out = model.decode(st.reshape(*st.shape[:2], -1), r)
        m = valid[..., None].float()
        rec = ((out - x).abs() * m).sum() / (count * pz)
        rec_un = ((out * std + med - r["patches"]).abs() * m).sum() / (count * pz)
        commit = ((z - code) ** 2 * valid[..., None, None].float()).sum() / (count * z.shape[-2] * z.shape[-1])
        neg_ent, part = _entropy_terms(z, valid, count, cb)
        entropy_lin = -neg_ent + (g_avg * part).sum()
        total = (LOSS_WEIGHTS["rec_loss"] * rec + LOSS_WEIGHTS["commit_loss"] * commit
                 + LOSS_WEIGHTS["entropy_loss"] * entropy_lin)
        total.backward()
        totals["rec_loss"] += float(rec.detach())
        totals["rec_loss_unnormalized"] += float(rec_un.detach())
        totals["commit_loss"] += float(commit.detach())
        sample_neg_entropy += float(neg_ent.detach())
    totals["entropy_loss"] = -sample_neg_entropy - float(avg_entropy)
    totals["loss"] = sum(LOSS_WEIGHTS[k] * totals[k] for k in LOSS_WEIGHTS)
    totals["scale"] = sum(LOSS_WEIGHTS[k] * abs(totals[k]) for k in LOSS_WEIGHTS)
    return totals


class AdamW:
    """torch.optim.AdamW's update (decoupled decay), behind optax's global-norm clip, on a dict of weights."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-4, betas=(0.9, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.1, clip: float = 5.0, warmup: int = 200, decay_steps: int = 10000):
        self.params = params
        self.lr, self.b1, self.b2, self.eps, self.wd, self.clip = lr, betas[0], betas[1], eps, weight_decay, clip
        self.warmup, self.decay_steps = warmup, decay_steps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    def rate(self, count: int) -> float:
        """The warmup-cosine schedule's rate for update number `count` (0 first)."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        span = self.decay_steps - self.warmup
        return self.lr * 0.5 * (1 + math.cos(math.pi * min(count - self.warmup, span) / span))

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update from the weights' .grad; returns the clipped gradients (and the norm before, as `self.norm`)."""
        grads = {k: p.grad for k, p in self.params.items() if p.grad is not None}  # as torch, skip the rest
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        self.norm = float(norm)
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        lr = self.rate(self.t)
        self.t += 1
        bc1, bc2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        out = {}
        for k, p in self.params.items():
            if k not in grads:
                continue
            g = grads[k] * scale
            out[k] = g
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(self.m[k], (self.v[k].sqrt() / math.sqrt(bc2)).add_(self.eps), value=-lr / bc1)
            p.grad = None
        return out


def train_steps(weights: Weights, cfg: dict, batches: Iterable[dict], norm: dict, block_rows: int,
                quant: Optional[str] = None) -> dict:
    """Train on each batch in turn from `weights` (copied); returns each step's
    losses, the first step's clipped gradient norm by weight, and the norm by
    weight of the change the steps made."""
    start = {k: v.detach().clone() for k, v in weights.items()}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    model = Plain(params, cfg, quant)
    opt = AdamW(params)
    losses, first_grad = [], None
    for batch in batches:
        totals = train_losses(model, batch, norm, block_rows)
        grads = opt.step()
        totals["grad_norm"] = opt.norm
        if first_grad is None:
            first_grad = {k: float(g.double().norm()) for k, g in grads.items()}
        losses.append(totals)
    change = {k: float((params[k].detach().double() - start[k].double()).norm()) for k in params}
    return {"losses": losses, "first_grad": first_grad, "change": change}


@torch.no_grad()
def reconstruct(weights: Weights, cfg: dict, batch: dict, norm: dict, block_rows: int,
                quant: Optional[str] = None) -> torch.Tensor:
    """Rows of a packed batch -> de-normalized predicted patches (b, s, p*p), by blocks of rows."""
    model = Plain(weights, cfg, quant)
    out = []
    for lo in range(0, batch["patches"].shape[0], block_rows):
        r = row_fields(batch, lo, lo + block_rows)
        x, med, std = normalize(r["patches"], r["chans"], r["pos"], norm)
        z = model.encode(x, r)
        code = torch.where(z > 0, 1.0, -1.0)
        out.append(model.decode(code.reshape(*code.shape[:2], -1), r) * std + med)
    return torch.cat(out)
