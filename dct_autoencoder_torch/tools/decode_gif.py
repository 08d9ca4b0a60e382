"""Progressive-decode GIF demo (reference: decode_gif.py:16-125).

Counterpart of the JAX package's tools/decode_gif.py, with the same flags,
except that --device (the card by default) replaces --platform.  Decodes an
image from its first i quantized codes for i = 1..n_frames and writes
(original | reconstruction) frames to an animated GIF: the coarse-to-fine
property of the importance-ordered token stream.  PIL writes the GIF.

Usage:
  python -m dct_autoencoder_torch.tools.decode_gif --image bold.jpg --model_load_path out/<ts>/model
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..models.factory import get_model_and_processor
from ..patches.container import DCTPatches


def mask_and_rec(model, batch: DCTPatches, codes: torch.Tensor, n_keep: int) -> DCTPatches:
    """Decode keeping only the first n_keep tokens of the packed row.

    Tokens from n_keep on are marked as padding, as the JAX tool does (there
    to keep one compiled program for every frame).  The attention kernels
    read the padding mask, so the dropped tokens are keys no query sees; the
    back end drops padded tokens, and their predictions are zeroed too."""
    s = batch.patches.shape[1]
    keep = torch.arange(s, device=batch.key_pad_mask.device) < n_keep
    pad = batch.key_pad_mask | ~keep[None, :]
    out = model.decode_from_codes(
        codes,
        key_pad_mask=pad,
        batched_image_ids=batch.batched_image_ids,
        patch_channels=batch.patch_channels,
        patch_positions=batch.patch_positions,
        patch_sizes=batch.patch_sizes,
        original_sizes=batch.original_sizes,
    )
    return out.replace(patches=out.patches.masked_fill(pad[..., None], 0.0))


def load_image(image: str, max_side: int) -> np.ndarray:
    """RGB (c, h, w) float32 in [0, 1], the longer side scaled down to max_side."""
    im = Image.open(image).convert("RGB")
    if max(im.size) > max_side:
        s = max_side / max(im.size)
        im = im.resize((int(im.width * s), int(im.height * s)), Image.BICUBIC)
    return np.asarray(im, dtype=np.float32).transpose(2, 0, 1) / 255.0


def main(
    image: str,
    model_load_path: Optional[str] = None,
    out_file: str = "progressive.gif",
    n_frames: int = 16,
    sample_patches_beta: float = 0.0,
    max_side: int = 448,
    duration_ms: int = 250,
    device: str = "cuda",
):
    model, proc = get_model_and_processor(
        None, dtype=torch.float32, sample_patches_beta=sample_patches_beta, resume_path=model_load_path, device=device
    )

    x = load_image(image, max_side)
    d = proc.preprocess(x)
    batch = next(proc.iter_batches(iter([{k: [v] for k, v in d.items()}]), batch_size=None))
    nb = model.normalize_(batch)
    _, codes = model.encode(nb, training=False)

    n_tokens = int((~batch.key_pad_mask).sum())
    frames = []
    for i in range(1, n_frames + 1):
        n_keep = max(1, round(n_tokens * i / n_frames))
        rec_un = model.inv_normalize_(mask_and_rec(model, nb, codes, n_keep))
        rec = np.clip(proc.postprocess(rec_un)[0], 0, 1)
        pair = np.concatenate([x, rec], axis=2).transpose(1, 2, 0)
        frames.append(Image.fromarray((pair * 255).astype(np.uint8)))
        print(f"frame {i}/{n_frames}: {n_keep} tokens")

    frames[0].save(out_file, save_all=True, append_images=frames[1:], duration=duration_ms, loop=0)
    print("saved", out_file)
    return frames


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--model_load_path", default=None)
    p.add_argument("--out_file", default="progressive.gif")
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--sample_patches_beta", type=float, default=0.0)
    p.add_argument("--max_side", type=int, default=448)
    p.add_argument("--device", default="cuda", help="where the model runs ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
