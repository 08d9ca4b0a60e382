"""Plain front and back end of the tokenizer, written from its description.

RGB -> IPT (sRGB -> XYZ D65 -> LMS (Hunt-Pointer-Estevez) -> signed power
0.43 -> IPT) -> orthonormal DCT-II of the whole image -> the low-frequency
crop (the largest patch multiples) -> p x p patches of coefficients, and
back: patches -> zero-padded coefficient plane -> DCT-III -> IPT -> RGB.
Tokens are ranked by importance, 0.1 * max |coefficient| of the patch minus
(h + w) / channel importance (8, 1, 1), highest first with ties in (patch,
channel) order, and the first k are kept.  Greedy packing closes a row as
soon as the next image would overflow it.

Everything here is float64 unless a caller passes another dtype, and imports
nothing of the program.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

_M_SRGB = np.array(
    [[0.4124564, 0.3575761, 0.1804375], [0.2126729, 0.7151522, 0.0721750], [0.0193339, 0.1191920, 0.9503041]]
)
_M_HPE = np.array([[0.4002, 0.7076, -0.0807], [-0.2280, 1.1500, 0.0612], [0.0, 0.0, 0.9184]])
M_IPT = np.array([[0.4, 0.4, 0.2], [4.455, -4.851, 0.3960], [0.8056, 0.3572, -1.1628]])
RGB2LMS = _M_HPE @ _M_SRGB
LMS2RGB = np.linalg.inv(RGB2LMS)
IPT2LMS = np.linalg.inv(M_IPT)
IPT_GAMMA = 0.43
CHANNEL_IMPORTANCE = (8.0, 1.0, 1.0)
MAGNITUDE_WEIGHT = 0.1


def dct_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Orthonormal DCT-II matrix: row k is s_k cos(pi (2i + 1) k / 2n)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return torch.as_tensor(m, dtype=dtype, device=device)


def _colour(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,bjhw->bihw", torch.as_tensor(m, dtype=x.dtype, device=x.device), x)


def _signed_pow(x: torch.Tensor, g: float) -> torch.Tensor:
    return torch.sign(x) * x.abs() ** g


def rgb_to_ipt(x: torch.Tensor) -> torch.Tensor:
    return _colour(M_IPT, _signed_pow(_colour(RGB2LMS, x), IPT_GAMMA))


def ipt_to_rgb(x: torch.Tensor) -> torch.Tensor:
    return _colour(LMS2RGB, _signed_pow(_colour(IPT2LMS, x), 1.0 / IPT_GAMMA))


def crop_dims(h: int, w: int, p: int) -> Tuple[int, int]:
    return (h // p) * p, (w // p) * p


def dct_tokens(images: torch.Tensor, p: int, dtype=torch.float64) -> torch.Tensor:
    """(B, 3, H, W) RGB (uint8, or floats in [0, 1]) -> (B, ph * pw, 3, p * p)
    coefficient patches of the cropped whole-image DCT, patches row-major."""
    x = images.to(dtype) / 255.0 if images.dtype == torch.uint8 else images.to(dtype)
    b, c, h, w = x.shape
    ch, cw = crop_dims(h, w, p)
    y = dct_matrix(h, dtype, x.device)[:ch] @ rgb_to_ipt(x) @ dct_matrix(w, dtype, x.device)[:cw].T
    y = y.reshape(b, c, ch // p, p, cw // p, p).permute(0, 2, 4, 1, 3, 5)
    return y.reshape(b, (ch // p) * (cw // p), c, p * p)


def ranked_tokens(images: torch.Tensor, p: int, max_patch_h: int, max_patch_w: int, dtype=torch.float64):
    """Importance-ranked tokens of same-size images: (patches (B, n, p*p),
    positions (B, n, 2) as (h, w), channels (B, n)), n the tokens of the
    patches within the max_patch_h x max_patch_w grid."""
    x = dct_tokens(images, p, dtype)
    b, _, c, pz = x.shape
    ch, cw = crop_dims(images.shape[-2], images.shape[-1], p)
    ph, pw = ch // p, cw // p
    hh, ww = torch.meshgrid(torch.arange(ph), torch.arange(pw), indexing="ij")
    keep = ((hh < max_patch_h) & (ww < max_patch_w)).reshape(-1).nonzero()[:, 0].to(x.device)
    hh = hh.reshape(-1).to(x.device)[keep]
    ww = ww.reshape(-1).to(x.device)[keep]
    x = x[:, keep]
    imp = torch.as_tensor(CHANNEL_IMPORTANCE, dtype=x.dtype, device=x.device)
    score = x.abs().amax(-1) * MAGNITUDE_WEIGHT - (hh + ww).to(x.dtype)[None, :, None] / imp[None, None, :]
    order = torch.argsort(-score.reshape(b, -1), dim=1, stable=True)
    flat = x.reshape(b, -1, pz)
    patches = torch.gather(flat, 1, order[..., None].expand(-1, -1, pz))
    pos = torch.stack([hh, ww], -1).repeat_interleave(c, 0)
    chans = torch.arange(c, device=x.device).repeat(len(keep))
    return patches, pos[order], chans[order]


def token_budget(u: float, beta: float, total: int, max_seq_len: int) -> int:
    """k for the draw u in (0, 1): round(Exp(beta)) by inversion, within [1, total], at most max_seq_len."""
    k = total
    if beta > 0:
        k = max(1, min(round(-1.0 / beta * math.log(u)), k))
    return min(k, max_seq_len)


def pack(lengths: Sequence[int], max_seq_len: int) -> List[List[int]]:
    """Greedy rows of image indices: a row closes when the next image would overflow it."""
    rows, row, used = [], [], 0
    for i, k in enumerate(lengths):
        if used + k > max_seq_len:
            rows.append(row)
            row, used = [], 0
        row.append(i)
        used += k
    if row:
        rows.append(row)
    return rows


def unpatch_planes(tokens: torch.Tensor, pos: torch.Tensor, chans: torch.Tensor, grid: Tuple[int, int], p: int):
    """One image's tokens (n, p*p) at (h, w) and channel -> (3, ph*p, pw*p) zero-filled coefficient plane."""
    ph, pw = grid
    canvas = torch.zeros((3, ph, pw, p, p), dtype=tokens.dtype, device=tokens.device)
    canvas[chans.long(), pos[:, 0].long(), pos[:, 1].long()] = tokens.reshape(-1, p, p)
    return canvas.permute(0, 1, 3, 2, 4).reshape(3, ph * p, pw * p)


def planes_to_rgb(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 3, ch, cw) coefficient planes -> (B, 3, h, w) RGB: the DCT-III of the plane zero-padded to h x w."""
    ch, cw = planes.shape[-2:]
    dt, dev = planes.dtype, planes.device
    ipt = dct_matrix(h, dt, dev)[:ch].T @ planes @ dct_matrix(w, dt, dev)[:cw]
    return ipt_to_rgb(ipt)


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
