"""Convert a trained checkpoint to the int8 serving form, and gate serving on it.

Usage:
  python -m dct_autoencoder_torch.tools.quantize_checkpoint \\
      --model_path out/<run>/model --out_path out/<run>/model-int8 \\
      [--validate_images <dir>] [--gate [--gate_mode relative]]

Counterpart of dct_autoencoder_tpu/tools/quantize_checkpoint.py, with the
same flags, defaults and records.  It loads a checkpoint, rewrites the
transformer stacks to int8 (models/quant.py), saves the int8 model in the
checkpoint format both packages load (its config carries quantize_int8, so
``from_pretrained`` rebuilds ``Int8Dense``) and, given validation images,
reports token agreement and reconstruction drift against the float model.

--gate records a serving decision: ``int8_gate.json`` beside the int8 model
and ``int8_serving.json`` in the source checkpoint's directory, which
``DCTPipeline.from_pretrained(prefer_int8='auto')`` of either package reads.
With --gate and no --mode the int8 form is 'dynamic' with layers 0 and 1
kept float, as in the JAX package.  Two gate modes:
  * absolute: token agreement >= --gate_threshold;
  * relative: the int8 form's flips per 10k codes <= --flip_ratio_max x the
    checkpoint's own noise floor (the flips of uniform weight noise of the
    rounding's magnitude, tools/int8_study.py, averaged over
    --gate_noise_seeds draws), and the end-to-end PSNR drops by at most
    --psnr_tolerance dB.

--validate_images is a directory: the first six of its files, sorted by
name, among .jpg/.jpeg/.png (read with PIL and resized to 448 x 448 as the
JAX tool does; PIL is imported only for them) and .npy ((c, h, w) float in
[0, 1] or uint8, taken at their own size).  The model runs in fp32, as the
JAX tool runs it, on --device (the card by default).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def load_validation_images(folder: str, limit: int = 6):
    """(c, h, w) float32 images in [0, 1] from the first `limit` image or .npy files of `folder`."""
    files = sorted(f for f in os.listdir(folder) if f.lower().endswith(IMAGE_EXTS + (".npy",)))[:limit]
    ims = []
    for f in files:
        path = os.path.join(folder, f)
        if f.lower().endswith(".npy"):
            im = np.load(path, allow_pickle=False)
            if im.ndim != 3:
                raise ValueError(f"{path}: expected a (c, h, w) array, got shape {im.shape}")
            im = im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im.astype(np.float32)
        else:
            from PIL import Image

            pil = Image.open(path).convert("RGB").resize((448, 448), Image.BICUBIC)
            im = np.asarray(pil, np.float32).transpose(2, 0, 1) / 255.0
        ims.append(np.ascontiguousarray(im))
    return ims


def main(model_path: str, out_path: str, validate_images: str = "", group_size: int = 0,
         mode: str = None, bf16_layers: str = "", gate: bool = False,
         gate_threshold: float = 0.999, gate_mode: str = "absolute",
         flip_ratio_max: float = 1.25, psnr_tolerance: float = 0.05,
         gate_noise_seeds: int = 2, device="cuda") -> dict:
    """Quantize, save and optionally validate and gate; returns the gate record ({} without --gate)."""
    import torch

    from ..models.autoencoder import DCTAutoencoder
    from ..models.quant import quantize_model_for_serving

    if gate and not validate_images:
        raise SystemExit("--gate needs --validate_images to measure agreement on")
    if gate and mode is None:
        # the study's recommended opt-in: dynamic int8 with the two most
        # flip-sensitive (earliest) layers kept float
        mode = "dynamic"
        if not bf16_layers:
            bf16_layers = "0,1"

    model = DCTAutoencoder.from_pretrained(model_path, dtype=torch.float32, device=device)
    layers = tuple(int(i) for i in bf16_layers.split(",") if i)
    qmodel = quantize_model_for_serving(
        model, mode=mode, encoder_bf16_layers=layers, decoder_bf16_layers=layers, group_size=group_size
    )
    qmodel.save_pretrained(out_path)
    n_int8 = sum(t.numel() for t in qmodel.module.state_dict().values() if t.dtype == torch.int8)
    print(f"saved int8 model to {out_path} ({n_int8 / 1e6:.1f}M int8 weights)")
    if not validate_images:
        return {}

    from ..models.factory import get_max_seq_length
    from ..models.patchnorm import calibrate_patchnorm_batch
    from ..patches.extractor import DCTAutoencoderFeatureExtractor

    cfg = model.config
    proc = DCTAutoencoderFeatureExtractor(
        channels=cfg.image_channels, patch_size=cfg.patch_size, sample_patches_beta=0.0,
        max_patch_h=cfg.max_patch_h, max_patch_w=cfg.max_patch_w,
        max_seq_len=get_max_seq_length(cfg, 0.0), device=device,
    )
    ims = load_validation_images(validate_images)
    ds = proc.preprocess_many(ims)
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    batch = next(proc.iter_batches(iter([cols]), batch_size=None))
    if not float(model.patchnorm.n.max()) > 0:
        model.patchnorm, _ = calibrate_patchnorm_batch(model.patchnorm, batch)
        qmodel.patchnorm = model.patchnorm
        # the int8 model was saved above with the uncalibrated patchnorm;
        # save again so that serving loads what the gate measured
        qmodel.save_pretrained(out_path)
    nb = model.normalize_(batch)
    out_fp = model.forward(nb)
    out_q = qmodel.forward(nb)
    valid = ~nb.key_pad_mask.cpu().numpy()
    codes_fp = out_fp["codes"].cpu().numpy()
    agree = (codes_fp[valid] == out_q["codes"].cpu().numpy()[valid]).mean()
    a = out_fp["dct_patches"].patches.float().cpu().numpy()[valid]
    b = out_q["dct_patches"].patches.float().cpu().numpy()[valid]
    drift = np.abs(a - b).mean() / (np.abs(a).mean() + 1e-9)
    print(f"validation: token agreement {agree:.4f}, mean rec drift {drift:.4f}")
    if not gate:
        return {}

    extra = {}
    if gate_mode == "relative":
        from ..ops.stats import psnr as psnr_fn
        from ..pipeline import DCTPipeline
        from .int8_study import _noise_equiv_model

        noise_agrees = []
        seeds = list(range(1, max(int(gate_noise_seeds), 1) + 1))
        for seed in seeds:
            # the probe perturbs exactly the weights the int8 form rounds
            out_n = _noise_equiv_model(model, seed, skip_layers=layers).forward(nb)
            noise_agrees.append((codes_fp[valid] == out_n["codes"].cpu().numpy()[valid]).mean())
        noise_agree = float(np.mean(noise_agrees))
        int8_flips = (1.0 - float(agree)) * 1e4
        noise_flips = (1.0 - noise_agree) * 1e4
        flip_ok = int8_flips <= flip_ratio_max * max(noise_flips, 1e-9)

        # the end-to-end pixel contract: PSNR through the whole pipeline
        def mean_psnr(pipe):
            return float(np.mean([psnr_fn(r, o) for r, o in zip(pipe.decode(pipe.encode(ims)), ims)]))

        psnr_fp, psnr_q = mean_psnr(DCTPipeline(model, proc)), mean_psnr(DCTPipeline(qmodel, proc))
        psnr_ok = (psnr_q - psnr_fp) >= -psnr_tolerance
        ok = bool(flip_ok and psnr_ok)
        extra = {
            "int8_flips_per_10k": round(int8_flips, 1),
            "noise_floor_flips_per_10k": round(noise_flips, 1),
            "noise_seeds": seeds,
            "noise_floor_kind": "weight_rounding",
            "noise_floor_skip_layers": list(layers),
            "flip_ratio": round(int8_flips / max(noise_flips, 1e-9), 3),
            "flip_ratio_max": flip_ratio_max,
            "flip_ok": bool(flip_ok),
            "psnr_fp": round(psnr_fp, 3),
            "psnr_int8": round(psnr_q, 3),
            "psnr_delta": round(psnr_q - psnr_fp, 4),
            "psnr_tolerance": psnr_tolerance,
            "psnr_ok": bool(psnr_ok),
        }
        print(
            f"relative gate: int8 {int8_flips:.1f}/10k vs noise floor {noise_flips:.1f}/10k "
            f"(ratio {extra['flip_ratio']}, max {flip_ratio_max}); psnr {psnr_fp:.3f} -> {psnr_q:.3f} dB "
            f"(delta {extra['psnr_delta']:+.4f}, tol -{psnr_tolerance})"
        )
    else:
        ok = bool(agree >= gate_threshold)
    record = {
        "agreement": float(agree),
        # the absolute mode's criterion; relative records carry theirs in `extra`
        **({"threshold": float(gate_threshold)} if gate_mode == "absolute" else {}),
        "gate_mode": gate_mode,
        **extra,
        "pass": ok,
        "mode": mode,
        "bf16_layers": list(layers),
        "group_size": group_size,
        "n_validation_images": len(ims),
        "source_model": os.path.abspath(model_path),
        "int8_model": os.path.abspath(out_path),
        # resolved against the checkpoint's directory: survives copying the tree
        "int8_model_rel": os.path.relpath(os.path.abspath(out_path), os.path.abspath(model_path)),
    }
    with open(os.path.join(out_path, "int8_gate.json"), "w") as f:
        json.dump(record, f, indent=2)
    # the pointer that DCTPipeline.from_pretrained(prefer_int8='auto') reads
    with open(os.path.join(model_path, "int8_serving.json"), "w") as f:
        json.dump(record, f, indent=2)
    crit = f"agreement {agree:.4f} vs threshold {gate_threshold}" if gate_mode == "absolute" else "flip-floor + psnr criteria above"
    print(
        f"gate[{gate_mode}]: {'PASS' if ok else 'FAIL'} ({crit}) — "
        f"{'serving flips to int8' if ok else 'serving stays fp'} for this checkpoint (int8_serving.json)"
    )
    return record


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--validate_images", default="")
    p.add_argument("--group_size", type=int, default=0, help="group-wise weight scales over the input dim (0 = per-output-channel)")
    p.add_argument("--mode", default=None, help="weight_only (default) or dynamic")
    p.add_argument("--bf16_layers", default="", help="comma list of layer indices kept float in both stacks")
    p.add_argument("--gate", action="store_true", help="record the serving decision (int8_serving.json in the source dir)")
    p.add_argument("--gate_threshold", type=float, default=0.999)
    p.add_argument("--gate_mode", default="absolute", choices=("absolute", "relative"))
    p.add_argument("--flip_ratio_max", type=float, default=1.25)
    p.add_argument("--psnr_tolerance", type=float, default=0.05)
    p.add_argument("--gate_noise_seeds", type=int, default=2)
    p.add_argument("--device", default="cuda", help="where the models run ('cuda' or 'cpu')")
    return p.parse_args(argv)


def cli(argv=None) -> dict:
    args = parse_args(argv)
    return main(args.model_path, args.out_path, args.validate_images, args.group_size, args.mode,
                args.bf16_layers, args.gate, args.gate_threshold, args.gate_mode, args.flip_ratio_max,
                args.psnr_tolerance, args.gate_noise_seeds, args.device)


if __name__ == "__main__":
    cli()
