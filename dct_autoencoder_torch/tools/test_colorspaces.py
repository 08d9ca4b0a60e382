"""Colour-space round trip and noise-robustness probe (reference: test_colorspaces.py).

Counterpart of the JAX package's tools/test_colorspaces.py, with the same
flags and printed lines, except that --device (the card by default; the
JAX tool defaults to the CPU platform) replaces --platform.  Writes side-by-side
(original | IPT round trip | IPT noised | YCbCr round trip | YCbCr noised)
panels to a PNG and prints each space's round-trip error and noise
amplification.

Usage:
  python -m dct_autoencoder_torch.tools.test_colorspaces --image girl.jpg --out_file colorspaces.png
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.colorspace import ipt_to_rgb, rgb_to_ipt, rgb_to_ycbcr, ycbcr_to_rgb
from .decode_gif import load_image
from .viz import to_pil


def main(
    image: str,
    out_file: str = "colorspaces.png",
    noise_std: float = 0.02,
    max_side: int = 384,
    device: str = "cuda",
):
    x = load_image(image, max_side)
    spaces = {"ipt": (rgb_to_ipt, ipt_to_rgb), "ycbcr": (rgb_to_ycbcr, ycbcr_to_rgb)}
    on_device = lambda a: torch.as_tensor(a, device=device)  # noqa: E731

    panels = [x]
    rng = np.random.default_rng(0)
    noise = rng.normal(0, noise_std, size=x.shape).astype(np.float32)
    results = {}
    for name, (fwd, inv) in spaces.items():
        y = fwd(on_device(x))
        rt = inv(y).cpu().numpy()
        err = np.abs(rt - x).mean()
        # noise amplification: perturb in the transformed space
        back = inv(y + on_device(noise)).cpu().numpy()
        amp = np.abs(back - x).mean() / noise_std
        print(f"{name}: roundtrip L1 {err:.2e}, noise amplification x{amp:.2f}")
        results[name] = {"roundtrip_l1": float(err), "noise_amplification": float(amp)}
        panels.append(np.clip(rt, 0, 1))
        panels.append(np.clip(back, 0, 1))

    h = min(p.shape[1] for p in panels)
    w = min(p.shape[2] for p in panels)
    to_pil(np.concatenate([p[:, :h, :w] for p in panels], axis=2)).save(out_file)
    print("saved", out_file, "(original | ipt rt | ipt noised | ycbcr rt | ycbcr noised)")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--out_file", default="colorspaces.png")
    p.add_argument("--noise_std", type=float, default=0.02)
    p.add_argument("--max_side", type=int, default=384)
    p.add_argument("--device", default="cuda", help="where the transforms run ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
