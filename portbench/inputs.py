"""What the benchmark makes from --seed and hands to both the program and the
reference: weights, the patch-norm statistics, images and token-budget draws.

Images are drawn in the IPT-DCT domain: each coefficient of frequency index
f = |(u, v)| is normal with standard deviation A_c sqrt(h w) / max(f, 1)
(a 1/f amplitude spectrum, as natural images have), the DC of the intensity
channel holds the mean level, and the planes go back to RGB through the
inverse DCT and the IPT transform, clipped and rounded to uint8.  The
patch-norm statistics are the same spectrum's: median 0 (the intensity DC at
its level) and mean absolute deviation sqrt(2 / pi) times the standard
deviation at each coefficient, for the typical image side `norm_side`.

Weights follow the program's own initial scales (normal, standard deviation
1 / sqrt(3 fan_in) for products and their biases, N(0, 1) position tables,
LayerNorms at 1 and 0), drawn on the device by one generator in one call.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference.frontend import dct_matrix, ipt_to_rgb, to_uint8

LEVEL = 0.72  # mean intensity (IPT's I) of the images: about mid-grey
AMPLITUDE = (0.04, 0.013, 0.013)  # A_c of I, P and T


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the model `cfg` describes, in the program's parameter names."""
    d = cfg["encoder_config"]["hidden_size"]
    ff = cfg["encoder_config"]["intermediate_size"]
    pz = cfg["patch_size"] ** 2
    c, mh, mw = cfg["image_channels"], cfg["max_patch_h"], cfg["max_patch_w"]
    out = []
    for s in ("encoder", "decoder"):
        out += [(f"{s}_pos_embed_channel", (c, d)), (f"{s}_pos_embed_height", (mh, d)), (f"{s}_pos_embed_width", (mw, d))]
    out += [("patch_embed_linear.weight", (d, pz)), ("patch_embed_norm.weight", (d,)), ("patch_embed_norm.bias", (d,))]
    for s in ("encoder", "decoder"):
        for i in range(cfg[f"{s}_config"]["num_hidden_layers"]):
            pre = f"{s}.layers.{i}"
            out += [(f"{pre}.layer_norm1.weight", (d,)), (f"{pre}.layer_norm1.bias", (d,))]
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out += [(f"{pre}.self_attn.{proj}.weight", (d, d)), (f"{pre}.self_attn.{proj}.bias", (d,))]
            out += [(f"{pre}.layer_norm2.weight", (d,)), (f"{pre}.layer_norm2.bias", (d,))]
            out += [(f"{pre}.fc1.weight", (ff, d)), (f"{pre}.fc1.bias", (ff,)), (f"{pre}.fc2.weight", (d, ff)),
                    (f"{pre}.fc2.bias", (d,))]
    code = cfg["vq_num_codebooks"] * int(math.log2(cfg["vq_codebook_size"]))
    out += [("vq_model.project_in.weight", (code, d)), ("vq_model.project_in.bias", (code,)),
            ("vq_model.project_out.weight", (d, code)), ("vq_model.project_out.bias", (d,))]
    out += [("proj_out_norm.weight", (d,)), ("proj_out_norm.bias", (d,)), ("proj_out_linear.weight", (pz, d))]
    return out


def _fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    return shapes[name.rsplit(".", 1)[0] + ".weight"][-1]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, fp32, on `device`: one normal draw cut into the tensors and scaled."""
    shapes = param_shapes(cfg)
    by_name = dict(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[off : off + n].view(shape)
        off += n
        if "norm" in name:
            t.fill_(1.0 if name.endswith("weight") else 0.0)
        elif "pos_embed" not in name:
            t.mul_(1.0 / math.sqrt(3 * _fan_in(name, by_name)))
        out[name] = t
    return out


def make_norm(cfg: dict, norm_side: int, device) -> Dict[str, torch.Tensor]:
    """Patch-norm statistics (c, H, W, p*p): median and mean absolute deviation of the images' spectrum."""
    p, c, mh, mw = cfg["patch_size"], cfg["image_channels"], cfg["max_patch_h"], cfg["max_patch_w"]
    u = torch.arange(mh * p, dtype=torch.float64).reshape(mh, p)
    v = torch.arange(mw * p, dtype=torch.float64).reshape(mw, p)
    f = torch.sqrt(u[:, None, :, None] ** 2 + v[None, :, None, :] ** 2).clamp(min=1.0)  # (H, W, p, p)
    amp = torch.as_tensor(AMPLITUDE, dtype=torch.float64)[:, None, None, None, None] * norm_side / f
    b = (amp * math.sqrt(2 / math.pi)).reshape(c, mh, mw, p * p)
    median = torch.zeros_like(b)
    median[0, 0, 0, 0] = LEVEL * norm_side
    return {"median": median.float().to(device), "b": b.float().to(device)}


def make_images(sizes: Sequence[Tuple[int, int]], gen: torch.Generator, device) -> List[torch.Tensor]:
    """uint8 RGB images (3, h, w) on `device`, one for each (h, w), from `gen`; same sizes in one call."""
    out: List[torch.Tensor] = [None] * len(sizes)  # type: ignore[list-item]
    by_size: Dict[Tuple[int, int], List[int]] = {}
    for i, s in enumerate(sizes):
        by_size.setdefault(tuple(s), []).append(i)
    for (h, w), idx in by_size.items():
        fy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        fx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
        f = torch.sqrt(fy**2 + fx**2).clamp(min=1.0)
        amp = torch.as_tensor(AMPLITUDE, device=device)[:, None, None] * math.sqrt(h * w) / f
        coef = torch.randn((len(idx), 3, h, w), generator=gen, device=device) * amp
        coef[:, 0, 0, 0] = LEVEL * math.sqrt(h * w)
        coef[:, 1:, 0, 0] = 0.0
        dh = dct_matrix(h, torch.float32, device)
        dw = dct_matrix(w, torch.float32, device)
        ipt = dh.T @ coef @ dw
        rgb = to_uint8(ipt_to_rgb(ipt))
        for j, i in enumerate(idx):
            out[i] = rgb[j]
    return out


def image_generator(seed: int, device) -> torch.Generator:
    """The images' generator: a stream of its own, apart from the weights' (seeded by `seed` itself)."""
    return torch.Generator(device=device).manual_seed((seed * 1000003 + 1) % (1 << 63))


class Draws:
    """A random.Random stand-in that returns given numbers in turn: the token
    budgets' uniform draws, which the extractor turns into round(Exp(beta))."""

    def __init__(self, values: Sequence[float]):
        self._it = iter(values)

    def random(self) -> float:
        return next(self._it)


def stratified(n: int) -> np.ndarray:
    """n uniform draws that are the same set for every seed: the midpoints (i + 0.5) / n."""
    return (np.arange(n) + 0.5) / n


def shuffled(n: int, seed: int) -> List[int]:
    order = list(range(n))
    random.Random(seed).shuffle(order)
    return order
