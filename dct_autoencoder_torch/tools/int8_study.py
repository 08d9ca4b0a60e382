"""int8 token-agreement study (per-layer sensitivity of the LFQ codes).

Counterpart of the JAX package's tools/int8_study.py, with the same flags,
variants and printed lines, except that --device (the card by default)
replaces --platform (the models run in bfloat16 on the card, as JAX always
runs the study, and in float32 on the CPU), --image_dir has no default
(JAX's names fixture images outside the repository), and each line also
gives the variant's wall ms and its torch._int_mm calls.

The dynamic int8 mode flips a few per cent of the LFQ tokens against the
float model; the study localizes where the flips come from:
  * weight_only vs fp: the serving default's own weight-rounding error;
  * dynamic (all layers): weight and per-token activation quantization;
  * dynamic with the first or last encoder blocks left in float;
  * group-wise weight scales (g = 128) for both modes;
  * with --per_layer, exactly one encoder layer in dynamic int8;
  * noise_equiv: the float weights plus uniform noise of the int8
    rounding's magnitude; if it flips as many tokens as weight_only, the
    flips are a property of the model's LFQ sign margins, a real floor
    (tools/quantize_checkpoint.py's relative gate runs this probe).
Tokens depend only on the encoder, so the variants change the encoder stack.
By default the study runs patch14-L (conf/patch14-l.json) at random init on
synthetic packed patches; --model_path takes a checkpoint and the .jpg
images of --image_dir instead.

Usage:
  python -m dct_autoencoder_torch.tools.int8_study [--rows 16] [--per_layer]
  python -m dct_autoencoder_torch.tools.int8_study --model_path docs/calibrated_run_r3b/model --image_dir imgs/
"""
from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import time

import numpy as np
import torch


def _noise_equiv_model(model, seed: int, skip_layers=()):
    """Float sibling of `model` whose stack kernels carry uniform noise of
    +-scale/2, scale = per-output-channel amax / 127 (the int8 rounding's
    magnitude), on the same device and compute type.

    skip_layers: layer indices left unperturbed (pass the int8 form's bf16
    layers, so that the probe perturbs exactly the weights it rounds).

    The noise comes from ``np.random.default_rng(seed)``, one draw per
    kernel, in the order in which the JAX package's walk meets the kernels:
    the encoder, then the decoder, and inside each the keys in the order of
    the JAX tree of a loaded checkpoint (models/convert.py::jax_param_tree).
    So the same seed perturbs the same weights by the same amounts as in the
    JAX package."""
    from ..models.autoencoder import DCTAutoencoder
    from ..models.convert import flatten_jax_tree, jax_param_tree, load_jax_arrays, vq_stats_from_state_dict

    rng = np.random.default_rng(seed)
    skip = set(skip_layers)

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node and np.ndim(node["kernel"]) == 2:
                w = np.asarray(node["kernel"], np.float32)
                scale = np.abs(w).max(axis=0) / 127.0
                noise = rng.uniform(-0.5, 0.5, size=w.shape).astype(np.float32)
                return {**node, "kernel": (w + noise * scale).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return node

    def walk_stack(stack_params):
        out = {}
        for k, v in stack_params.items():
            index = k.split("_")[-1]
            out[k] = v if k.startswith("layers_") and index.isdigit() and int(index) in skip else walk(v)
        return out

    m = DCTAutoencoder(copy.deepcopy(model.config), dtype=model.dtype, device=model.device)
    params = jax_param_tree(model.module.state_dict(), model.config)
    for stack in ("encoder", "decoder"):
        if stack in params:
            params[stack] = walk_stack(params[stack])
    load_jax_arrays(m.module, flatten_jax_tree(params), m.config, vq_stats_from_state_dict(model.module.state_dict()) or None)
    m.patchnorm = model.patchnorm
    return m


def synthetic_batch(cfg, rows: int, seq: int, rng: np.random.Generator, device):
    """Random packed patches of 4 images a row with padded tails, drawn from
    `rng` in the JAX study's order, so the same seed gives the same batch."""
    from ..patches.container import DCTPatches

    ids = np.sort(rng.integers(0, 4, size=(rows, seq))).astype(np.int32)
    lengths = rng.integers(seq // 2, seq, size=(rows,))
    pad = np.arange(seq)[None, :] >= lengths[:, None]
    patches = rng.standard_normal((rows, seq, cfg.patch_dim)).astype(np.float32)
    channels = rng.integers(0, cfg.image_channels, (rows, seq)).astype(np.int32)
    positions = rng.integers(0, min(cfg.max_patch_h, cfg.max_patch_w), (rows, seq, 2)).astype(np.int32)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return DCTPatches(
        patches=as_t(patches), key_pad_mask=as_t(pad), batched_image_ids=as_t(ids),
        patch_channels=as_t(channels), patch_positions=as_t(positions),
    )


def codes_of(model, nb) -> np.ndarray:
    """The model's codes of the normalized batch's valid tokens: (tokens, num_codebooks)."""
    _, codes = model.encode(nb, training=False)
    return codes[~nb.key_pad_mask].cpu().numpy()


def report(name: str, model, nb, codes_fp: np.ndarray) -> dict:
    """Print and return one variant's line: its agreement with the float
    model's codes, the flips per 10k codes, its wall ms (the encode, after a
    synchronize) and the torch._int_mm calls it made."""
    from ..models import quant

    calls = quant.INT_MM_CALLS
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    codes = codes_of(model, nb)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    agree = float((codes == codes_fp).mean())
    line = {"variant": name, "token_agreement": round(agree, 5), "flipped_per_10k": round((1 - agree) * 1e4, 1),
            "wall_ms": wall_ms, "int_mm_calls": quant.INT_MM_CALLS - calls}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="model config json (default conf/patch14-l.json)")
    p.add_argument("--model_path", default=None,
                   help="trained checkpoint dir; uses its weights and the .jpg images of --image_dir "
                   "instead of random init and synthetic patches")
    p.add_argument("--image_dir", default=None)
    p.add_argument("--resize", type=int, default=448)
    p.add_argument("--rows", type=int, default=16)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--per_layer", action="store_true", help="one-layer-at-a-time sweep")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="where the models run ('cuda' or 'cpu')")
    args = p.parse_args(argv)

    from ..models.autoencoder import DCTAutoencoder
    from ..models.config import DCTAutoencoderConfig
    from ..models.patchnorm import calibrate_patchnorm_batch
    from ..models.quant import quantize_model_for_serving

    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    rng = np.random.default_rng(args.seed)
    if args.model_path:
        from ..data.images import load_images_chw
        from ..models.factory import get_model_and_processor
        from ..train.loop import prepare_train_batch

        if not args.image_dir:
            raise SystemExit("--model_path needs --image_dir (a directory of .jpg images)")
        model, proc = get_model_and_processor(
            None, dtype=dtype, sample_patches_beta=0.0, resume_path=args.model_path, device=device
        )
        cfg = model.config
        ims = load_images_chw(sorted(glob.glob(os.path.join(args.image_dir, "*.jpg"))), args.resize)
        ds = proc.preprocess_many(ims)
        cols = {k: [d[k] for d in ds] for k in ds[0]}
        batch, _ = prepare_train_batch(next(proc.iter_batches(iter([cols]), batch_size=None)))
    else:
        here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        cfg = DCTAutoencoderConfig.from_json_file(args.config or os.path.join(here, "conf", "patch14-l.json"))
        model = DCTAutoencoder(cfg, dtype=dtype, device=device, seed=args.seed)
        batch = synthetic_batch(cfg, args.rows, args.seq, rng, model.device)
        model.patchnorm, _ = calibrate_patchnorm_batch(model.patchnorm, batch)
    nb = model.normalize_(batch)

    codes_fp = codes_of(model, nb)
    print(f"# {codes_fp.shape[0]} tokens x {codes_fp.shape[1]} codebooks = {codes_fp.size} codes")

    L = cfg.encoder_config.num_hidden_layers
    variants = [
        ("weight_only", dict(mode="weight_only")),
        ("dynamic", dict(mode="dynamic")),
        ("dynamic_last1_bf16", dict(mode="dynamic", encoder_bf16_layers=(L - 1,))),
        ("dynamic_last2_bf16", dict(mode="dynamic", encoder_bf16_layers=(L - 2, L - 1))),
        ("dynamic_first2_bf16", dict(mode="dynamic", encoder_bf16_layers=(0, 1))),
        ("weight_only_g128", dict(mode="weight_only", group_size=128)),
        ("dynamic_g128", dict(mode="dynamic", group_size=128)),
        ("dynamic_g128_first2_bf16", dict(mode="dynamic", group_size=128, encoder_bf16_layers=(0, 1))),
    ]
    lines = [report(name, quantize_model_for_serving(model, **kw), nb, codes_fp) for name, kw in variants]
    # the floor probe: float weights plus uniform noise of the int8 rounding's
    # magnitude; matching weight_only's flips says they come from the LFQ
    # sign margins, not from the quantizer
    for seed in (1, 2):
        lines.append(report(f"noise_equiv_seed{seed}", _noise_equiv_model(model, seed), nb, codes_fp))
    if args.per_layer:
        for i in range(L):
            others = tuple(j for j in range(L) if j != i)
            q = quantize_model_for_serving(model, mode="dynamic", encoder_bf16_layers=others)
            lines.append(report(f"only_layer_{i}_dynamic", q, nb, codes_fp))
    return lines


if __name__ == "__main__":
    main()
