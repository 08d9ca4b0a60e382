"""End-to-end AR example: tokenize -> train a decoder-only LM -> sample ->
decode back to pixels.

Usage:
  python -m dct_autoencoder_torch.tools.train_ar_example \
      --model_path out/<run>/model --image_dir <images> \
      [--steps 200] [--out out_ar] [--device cuda]

Counterpart of dct_autoencoder_tpu/tools/train_ar_example.py: tokenizes
images with a trained DCTAutoencoder, trains models/ar.ARTokenModel on the
records with teacher forcing (through the causal attention kernels on the
card), then samples a code sequence for the first record's position layout
and decodes it through the tokenizer.  Writes ``ar_metrics.jsonl``,
``ar_model/`` (a checkpoint either package loads) and ``ar_sample.png``.

``train_ar`` is the loop itself and takes the images as arrays; ``main``
reads a directory with Pillow, which only it and the PNG writer need.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def records_to_arrays(records: List[dict], max_len: int):
    """Token records (to_dict schema) -> fixed-shape AR training arrays."""
    n = len(records)
    C = len(records[0]["codes"][0]["data"])
    codes = np.zeros((n, max_len, C), np.int32)
    chans = np.zeros((n, max_len), np.int32)
    poss = np.zeros((n, max_len, 2), np.int32)
    pad = np.ones((n, max_len), bool)
    for i, rec in enumerate(records):
        toks = rec["codes"][:max_len]
        for t, tok in enumerate(toks):
            codes[i, t] = tok["data"]
            chans[i, t] = tok["c"]
            poss[i, t] = (tok["h"], tok["w"])
        pad[i, : len(toks)] = False
    return codes, chans, poss, pad


def make_ar_optimizer(learning_rate: float, steps: int):
    """What ``optax.adamw(warmup_cosine_decay_schedule(0, lr, 20, max(steps, 21)))``
    is: optax's AdamW defaults (b2 0.999, eps 1e-8, weight decay 1e-4) under a
    20-step warmup from 0 and a cosine decay to 0, and no gradient clipping."""
    from ..train.loop import Optimizer

    return Optimizer(
        learning_rate=learning_rate, warmup_steps=20, decay_steps=max(steps, 21), weight_decay=1e-4,
        b1=0.9, b2=0.999, eps=1e-8, grad_clip=math.inf,
    )


def ar_train_step(model, adamw, learning_rate: float, codes, chans, poss, pad, image_ids=None) -> torch.Tensor:
    """One teacher-forced step at `learning_rate`: forward through the causal
    attention, ar_loss over the valid tokens, backward, AdamW update in place.
    Returns the loss as a 0-d device tensor (reading it waits for the device)."""
    from ..models.ar import ar_loss

    for group in adamw.param_groups:
        group["lr"] = learning_rate
    adamw.zero_grad(set_to_none=True)
    logits = model(codes, chans, poss, pad, image_ids=image_ids, training=True)
    loss = ar_loss(logits, codes, ~pad)
    loss.backward()
    adamw.step()
    return loss.detach()


def train_ar(
    pipe,
    images: Sequence[np.ndarray],
    steps: int = 200,
    batch_size: int = 8,
    max_len: int = 128,
    learning_rate: float = 3e-4,
    hidden: int = 256,
    layers: int = 4,
    out: str = "out_ar",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    log: Callable[[str], None] = print,
) -> dict:
    """records -> arrays -> train steps -> save -> sample -> decode, on the
    tokenizer pipeline's device.  `images` are (c, h, w) float arrays in
    [0, 1].  Returns the losses of every step, the trained model, the
    records, the sampled record and the decoded image (c, h, w)."""
    from ..models.ar import ARConfig, build_ar_model, sample_codes_scan, save_ar_model
    from ..models.config import TransformerConfig

    device = pipe.model.device
    pipe.processor.rng = random.Random(seed)
    cfg_tok = pipe.model.config
    images = list(images)
    records = pipe.encode(images * max(1, (batch_size * 4) // max(len(images), 1)))
    log(f"tokenized {len(records)} records")

    codes, chans, poss, pad = (torch.from_numpy(a).to(device) for a in records_to_arrays(records, max_len))

    ar_cfg = ARConfig(
        codebook_size=cfg_tok.vq_codebook_size,
        num_codebooks=cfg_tok.vq_num_codebooks,
        image_channels=cfg_tok.image_channels,
        max_patch_h=cfg_tok.max_patch_h,
        max_patch_w=cfg_tok.max_patch_w,
        transformer=TransformerConfig(
            hidden_size=hidden, intermediate_size=hidden * 4,
            num_hidden_layers=layers, num_attention_heads=max(hidden // 64, 4),
        ),
    )
    model = build_ar_model(ar_cfg, dtype=dtype, device=device, seed=seed)
    tx = make_ar_optimizer(learning_rate, steps)
    adamw = tx.init(model)

    os.makedirs(out, exist_ok=True)
    nprng = np.random.default_rng(seed)
    losses: List[torch.Tensor] = []
    with open(os.path.join(out, "ar_metrics.jsonl"), "w") as f:
        for i in range(steps):
            idx = torch.from_numpy(nprng.integers(0, codes.shape[0], batch_size)).to(device)
            losses.append(ar_train_step(model, adamw, tx.schedule(i), codes[idx], chans[idx], poss[idx], pad[idx]))
            if i % 20 == 0:  # reading the loss waits for the device: only where it is logged
                log(f"ar step {i}: loss {float(losses[-1]):.4f}")
                f.write(json.dumps({"step": i, "loss": float(losses[-1])}) + "\n")
    losses = [float(x) for x in losses]
    if losses:
        log(f"ar loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    save_ar_model(os.path.join(out, "ar_model"), model)
    log(f"ar checkpoint written to {out}/ar_model")

    # sample codes for a real layout and decode through the tokenizer
    tmpl = records[0]
    n = min(len(tmpl["codes"]), max_len)
    chans_t = np.asarray([[t["c"] for t in tmpl["codes"][:n]]], np.int32)
    poss_t = np.asarray([[[t["h"], t["w"]] for t in tmpl["codes"][:n]]], np.int32)
    generator = torch.Generator(device=device).manual_seed(1)
    sampled = sample_codes_scan(model, chans_t, poss_t, generator, temperature=1.0).cpu().numpy()
    rec = dict(tmpl)
    rec["codes"] = [
        dict(c=int(chans_t[0, t]), h=int(poss_t[0, t, 0]), w=int(poss_t[0, t, 1]), data=[int(v) for v in sampled[0, t]])
        for t in range(n)
    ]
    img = pipe.decode([rec])[0]
    return {"losses": losses, "model": model, "records": records, "sampled_record": rec, "image": img}


def load_images(image_dir: str, target: int) -> List[np.ndarray]:
    """The .jpg/.jpeg/.png files of a directory as (3, target, target) float arrays in [0, 1]."""
    from PIL import Image

    files = sorted(f for f in os.listdir(image_dir) if f.lower().endswith((".jpg", ".jpeg", ".png")))
    ims = []
    for f in files:
        im = Image.open(os.path.join(image_dir, f)).convert("RGB").resize((target, target), Image.BICUBIC)
        ims.append(np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0)
    return ims


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)).save(path)


def main(
    model_path: str,
    image_dir: str,
    steps: int = 200,
    batch_size: int = 8,
    max_len: int = 128,
    learning_rate: float = 3e-4,
    hidden: int = 256,
    layers: int = 4,
    out: str = "out_ar",
    seed: int = 0,
    device: str = "cuda",
):
    from ..pipeline import DCTPipeline

    tok_dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    pipe = DCTPipeline.from_pretrained(model_path, sample_patches_beta=0.02, dtype=tok_dtype, device=device)
    cfg_tok = pipe.model.config
    # one fixed bucket sized to the tokenizer's grid: one shape throughout
    target = min(448, cfg_tok.patch_size * cfg_tok.max_patch_h)
    result = train_ar(
        pipe, load_images(image_dir, target), steps=steps, batch_size=batch_size, max_len=max_len,
        learning_rate=learning_rate, hidden=hidden, layers=layers, out=out, seed=seed,
    )
    save_png(result["image"], os.path.join(out, "ar_sample.png"))
    print(f"sampled image written to {out}/ar_sample.png")
    return result["losses"]


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_path", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_len", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--out", default="out_ar")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    main(**vars(p.parse_args()))
