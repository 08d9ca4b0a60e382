"""Round-trip smoke test over a directory of images (reference: testpipe.py).

Counterpart of the JAX package's tools/testpipe.py, with the same flags and
printed lines, except that --device (the card by default) replaces
--platform.  The whole pipeline without a model: preprocess (the DCT
kernel) -> pack into one batch -> patchnorm calibrate, forward and inverse
-> postprocess (the IDCT kernel) -> save junk.png.  Prints per-channel token
counts and the normalized patches' statistics.

Usage:
  python -m dct_autoencoder_torch.tools.testpipe --image_dir images/
"""
from __future__ import annotations

import argparse
import random

import numpy as np

from ..models.patchnorm import PatchNormState, apply_patchnorm, calibrate_patchnorm_batch, inverse_patchnorm
from ..patches.extractor import DCTAutoencoderFeatureExtractor
from .diagnose import load_dir_images
from .viz import save_image


def main(
    image_dir: str = "./images",
    patch_size: int = 16,
    max_patch_h: int = 32,
    max_patch_w: int = 32,
    max_seq_len: int = 256,
    sample_patches_beta: float = 0.005,
    out_file: str = "junk.png",
    seed: int = 42,
    max_side: int = 768,
    device: str = "cuda",
):
    _, images = load_dir_images(image_dir, None, max_side)
    proc = DCTAutoencoderFeatureExtractor(
        channels=3,
        patch_size=patch_size,
        sample_patches_beta=sample_patches_beta,
        max_patch_h=max_patch_h,
        max_patch_w=max_patch_w,
        max_seq_len=max_seq_len,
        channel_importances=(16, 1, 1),
        patch_sample_magnitude_weight=0.0,
        rng=random.Random(seed),
        device=device,
    )

    # one image at a time, as the JAX tool does: the budgets are drawn in file order
    preprocessed = [proc.preprocess(im) for im in images]
    cols = {k: [d[k] for d in preprocessed] for k in preprocessed[0]}
    batch = next(proc.iter_batches(iter([cols]), batch_size=None))

    ids = batch.batched_image_ids.cpu().numpy()
    pad = batch.key_pad_mask.cpu().numpy()
    chs = batch.patch_channels.cpu().numpy()
    im0 = (ids == 0) & ~pad
    im0[1:] = False  # image 0 lives in row 0
    print("number of patches for image 0:", int(im0.sum()))
    for ci, name in enumerate(["I", "Ct", "Cp"]):
        print(f"channel {name}:", int((chs[im0] == ci).sum()))

    state = PatchNormState.create(3, max_patch_h, max_patch_w, patch_size**2, device=proc.device)
    state, _ = calibrate_patchnorm_batch(state, batch)
    normed = apply_patchnorm(state, batch)
    vals = normed[~batch.key_pad_mask].cpu().numpy()
    print(f"std {vals.std():.3f} mean {vals.mean():.3f} max {vals.max():.3f} min {vals.min():.3f}")

    denormed = inverse_patchnorm(state, batch.replace(patches=normed))
    rec = proc.postprocess(batch.replace(patches=denormed))[0]
    print("original size", batch.original_sizes[0])
    save_image(np.clip(rec, 0, 1), out_file)
    print("saved", out_file)
    return rec


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dir", default="./images")
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--max_patch_h", type=int, default=32)
    p.add_argument("--max_patch_w", type=int, default=32)
    p.add_argument("--max_seq_len", type=int, default=256)
    p.add_argument("--sample_patches_beta", type=float, default=0.005)
    p.add_argument("--out_file", default="junk.png")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_side", type=int, default=768)
    p.add_argument("--device", default="cuda", help="where the DCT and IDCT run ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
