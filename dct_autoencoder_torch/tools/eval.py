"""Checkpoint evaluation: PSNR and code perplexity on held-out images.

Counterpart of the JAX package's tools/eval.py, with the same flags, defaults and
output rows, except that --device (the card by default) replaces
--platform, --dtype picks the compute type (default: bfloat16 on the card,
as JAX's pipeline, float32 on the CPU) and --images has no default (JAX's
names two fixture images outside the repository).

  * each image goes through the whole encode -> decode pipeline
    (preprocess -> pack -> normalize -> transformer -> LFQ/VQ -> decode ->
    postprocess) at a fixed, seeded token budget; the tool reports RGB PSNR;
  * the code perplexity over the emitted token streams says how well the
    codebook is used.

The token budget is reseeded before every checkpoint (the processor's
random.Random), so every checkpoint sees the same packed shapes and the
same budget.  A scan builds one DCTPipeline and loads each further
checkpoint's weights, patchnorm and VQ statistics into its model in place,
so the kernels and buffers that are built stay.  The tool always measures
the float checkpoint itself, never its gated int8 sibling.

Usage:
  python -m dct_autoencoder_torch.tools.eval --scan out/<ts> --images a.jpg,b.jpg
  python -m dct_autoencoder_torch.tools.eval --checkpoint out/<ts>/model --images a.jpg,b.jpg
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.stats import calculate_perplexity, psnr


def load_images(paths: Sequence[str], resize: int = 448) -> List[np.ndarray]:
    """RGB images as (c, h, w) float32 in [0, 1], resized to resize x resize."""
    from ..data.images import load_images_chw

    return load_images_chw(paths, resize)


def evaluate_checkpoint(pipe, images: List[np.ndarray], seed: int) -> Dict[str, float]:
    """One checkpoint: mean and per-image PSNR, code perplexity, token count."""
    pipe.processor.rng = random.Random(seed)
    records = pipe.encode(images)
    recs = pipe.decode(records)
    psnrs = [psnr(r, o) for r, o in zip(recs, images)]
    codes = np.concatenate([np.asarray([c["data"] for c in rec["codes"]]) for rec in records], axis=0)
    ppl = float(calculate_perplexity(torch.from_numpy(codes), pipe.model.config.vq_codebook_size))
    return {
        "psnr": float(np.mean(psnrs)),
        "psnr_per_image": [round(p, 3) for p in psnrs],
        "perplexity": ppl,
        "n_tokens": int(codes.shape[0]),
    }


def scan_checkpoints(out_dir: str) -> List[str]:
    """Step-stamped checkpoints (ckpt_<step>) plus the final model directory."""
    ckpts = sorted(glob.glob(os.path.join(out_dir, "ckpt_*")))
    final = os.path.join(out_dir, "model")
    if os.path.isdir(final):
        ckpts.append(final)
    return ckpts


def load_weights_into(model, path: str) -> None:
    """Load checkpoint `path`'s weights, patchnorm and VQ statistics into
    `model` (a DCTAutoencoder of the same config) in place.  A VQ checkpoint
    without vq_stats.npz gets the statistics a new model starts with, as the
    JAX package's fresh load gives it."""
    from ..models.config import DCTAutoencoderConfig
    from ..models.convert import load_jax_arrays
    from ..models.patchnorm import PatchNormState

    config = DCTAutoencoderConfig.from_json_file(os.path.join(path, "config.json"))
    if config.to_dict() != model.config.to_dict():
        raise ValueError(f"{path} has another config than the first checkpoint of the scan")
    vq_path = os.path.join(path, "vq_stats.npz")
    if config.vq_type == "vq" and not os.path.exists(vq_path):
        for name, t in model.module.vq_stats().items():
            t.fill_(1.0 if name.endswith("variance") else 0.0)
    load_jax_arrays(model.module, os.path.join(path, "params.npz"), config, vq_path if os.path.exists(vq_path) else None)
    pn_path = os.path.join(path, "patchnorm.npz")
    model.patchnorm = (
        PatchNormState.load(pn_path, model.device) if os.path.exists(pn_path)
        else PatchNormState.create(config.image_channels, config.max_patch_h, config.max_patch_w, config.patch_dim,
                                   device=model.device)
    )


def main(
    checkpoint: Optional[str] = None,
    scan: Optional[str] = None,
    images: str = "",
    resize: int = 448,
    sample_patches_beta: float = 0.02,
    seed: int = 7,
    output: Optional[str] = None,
    device: str = "cuda",
    dtype: Optional[str] = None,
):
    from ..pipeline import DCTPipeline

    paths = scan_checkpoints(scan) if scan else [checkpoint]
    if not (paths and paths[0]):
        raise ValueError("pass --checkpoint <model_dir> or --scan <out_dir>")
    image_paths = [p for p in images.split(",") if p]
    if not image_paths:
        raise ValueError("pass --images <comma-separated image files>")
    ims = load_images(image_paths, resize=resize)
    torch_dtype = getattr(torch, dtype) if dtype else (torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32)

    out_path = output or (os.path.join(scan, "eval.jsonl") if scan else None)
    if out_path and os.path.exists(out_path):
        # one run, one file: a rerun must not mix its rows with a stale scan's
        os.remove(out_path)
    results = []
    pipe = None
    for path in paths:
        if pipe is None:
            pipe = DCTPipeline.from_pretrained(
                path, sample_patches_beta=sample_patches_beta, dtype=torch_dtype, device=device, prefer_int8="never"
            )
        else:
            load_weights_into(pipe.model, path)
        step = os.path.basename(path.rstrip("/"))
        res = {"checkpoint": path, "step": step, **evaluate_checkpoint(pipe, ims, seed)}
        results.append(res)
        print(json.dumps(res))
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(res) + "\n")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--scan", type=str, default=None)
    p.add_argument("--images", type=str, required=True, help="comma-separated image files")
    p.add_argument("--resize", type=int, default=448)
    p.add_argument("--sample_patches_beta", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", default="cuda", help="where the model runs ('cuda' or 'cpu')")
    p.add_argument("--dtype", default=None, help="bfloat16 or float32 (default: bfloat16 on the card, float32 on the CPU)")
    main(**vars(p.parse_args()))
