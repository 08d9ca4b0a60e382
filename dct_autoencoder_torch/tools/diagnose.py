"""Checkpoint diagnosis probe (reference: diagnose_splotchiness.py).

Counterpart of the JAX package's tools/diagnose.py, with the same flags and
printed lines, except that --device (the card by default) replaces
--platform.  Loads a checkpoint in float32, runs one batch of images through
normalize -> encode -> decode -> inverse normalize and prints per-stage
statistics (token counts, the normalized patches' distribution, the code
perplexity, the reconstruction error per channel), and writes a side-by-side
PNG.  In float32 on the card the attention runs on the CUDA-core kernels.

Usage:
  python -m dct_autoencoder_torch.tools.diagnose --model_load_path out/<ts>/model --image_dir images/
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..models.factory import get_model_and_processor
from ..ops.stats import calculate_perplexity
from .viz import make_image_grid


def load_dir_images(image_dir: str, n_images: Optional[int], max_side: int):
    """(file names, RGB (c, h, w) float32 images) of the first n_images
    .jpg/.jpeg/.png files of image_dir in name order, the longer side scaled
    down to max_side."""
    files = sorted(f for f in os.listdir(image_dir) if f.lower().endswith((".jpg", ".jpeg", ".png")))[:n_images]
    ims = []
    for f in files:
        im = Image.open(os.path.join(image_dir, f)).convert("RGB")
        if max(im.size) > max_side:
            s = max_side / max(im.size)
            im = im.resize((int(im.width * s), int(im.height * s)), Image.BICUBIC)
        ims.append(np.asarray(im, dtype=np.float32).transpose(2, 0, 1) / 255.0)
    return files, ims


def main(
    model_load_path: str,
    image_dir: str = "./images",
    n_images: int = 4,
    max_side: int = 448,
    out_file: Optional[str] = "diagnose.png",
    device: str = "cuda",
):
    model, proc = get_model_and_processor(
        None, dtype=torch.float32, sample_patches_beta=0.0, resume_path=model_load_path, device=device
    )
    files, ims = load_dir_images(image_dir, n_images, max_side)

    ds = proc.preprocess_many(ims)
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    batch = next(proc.iter_batches(iter([cols]), batch_size=None))
    valid = ~batch.key_pad_mask
    print(f"batch: {tuple(batch.patches.shape)}, {int(valid.sum())} valid tokens, {len(ims)} images")

    nb = model.normalize_(batch)
    nvals = nb.patches[valid].cpu().numpy()
    print(
        f"normalized patches: median {np.median(nvals):+.3f} std {nvals.std():.3f} "
        f"clip-rate {(np.abs(nvals) >= 6.0).mean():.4f}"
    )

    out = model.forward(nb, training=False)
    codes = out["codes"][valid]
    ppl = float(calculate_perplexity(codes, model.config.vq_codebook_size))
    print(f"codes: perplexity {ppl:.1f} / {model.config.vq_codebook_size}")

    rec_images = proc.postprocess(model.inv_normalize_(out["dct_patches"]))
    for f, im, r in zip(files, ims, rec_images):
        err = np.clip(r, 0, 1) - im
        mse = float((err**2).mean())
        psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
        per_c = [float(np.abs(err[c]).mean()) for c in range(3)]
        print(f"{f}: PSNR {psnr:.2f} dB, per-channel L1 {per_c}")

    if out_file:
        make_image_grid(ims, [np.clip(r, 0, 1) for r in rec_images], filename=out_file)
    return rec_images


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_load_path", required=True)
    p.add_argument("--image_dir", default="./images")
    p.add_argument("--n_images", type=int, default=4)
    p.add_argument("--max_side", type=int, default=448)
    p.add_argument("--out_file", default="diagnose.png")
    p.add_argument("--device", default="cuda", help="where the model runs ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
