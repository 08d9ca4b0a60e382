"""Offline dataset preprocessing CLI (reference: preproc_dataset.py:28-89).

Counterpart of the JAX package's tools/preproc_dataset.py, with the same
flags and shard format, except that --device (the card by default) replaces
--platform.  Runs steps 1-5 of the pipeline (RGB load -> IPT -> crop -> DCT
-> patchify + importance sampling, the DCT kernel on the card) and writes
webdataset-style shards of per-image token records, which either package's
``load_preprocessed_dataset`` reads.  Frozen-at-preproc-time invariants
(reference preproc_dataset.py:13-17): sample_patches_beta, patch size,
channel importances, magnitude weight.

Multi-host: each process owns a disjoint set of input shards
(--process_index/--process_count) and writes its own output shards.

Usage:
  python -m dct_autoencoder_torch.tools.preproc_dataset \\
      --image_dataset_path_or_url 'raw/{000000..000099}.tar' \\
      --model_config_path conf/patch14-l.json --output_dir preproc/
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.dataset import load_and_transform_dataset
from ..data.shards import ShardWriter
from ..models.config import DCTAutoencoderConfig
from ..models.factory import get_max_seq_length
from ..patches.extractor import DCTAutoencoderFeatureExtractor


def main(
    image_dataset_path_or_url: str,
    output_dir: str,
    model_config_path: str = "./conf/patch14-l.json",
    sample_patches_beta: float = 0.02,
    n: int = 1_000_000,
    seed: int = 42,
    maxsize: float = 1e9,
    compress: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    device: str = "cuda",
) -> int:
    cfg = DCTAutoencoderConfig.from_json_file(model_config_path)
    processor = DCTAutoencoderFeatureExtractor(
        channels=cfg.image_channels,
        patch_size=cfg.patch_size,
        sample_patches_beta=sample_patches_beta,
        max_patch_h=cfg.max_patch_h,
        max_patch_w=cfg.max_patch_w,
        max_seq_len=get_max_seq_length(cfg, sample_patches_beta),
        device=device,
    )
    print("Max sequence length:", processor.max_seq_len)

    stream = load_and_transform_dataset(
        image_dataset_path_or_url,
        processor,
        shuffle_buffer=1000,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )

    os.makedirs(output_dir, exist_ok=True)
    pattern = os.path.join(output_dir, f"h{process_index:03d}-%06d.tar")
    written = 0
    with ShardWriter(pattern, maxsize=maxsize, compress=compress) as writer:
        for i, data in enumerate(stream):
            if i >= n:
                break
            writer.write(
                {
                    "__key__": f"{i:08d}",
                    "patches.npy": np.asarray(data["patches"]),
                    "positions.npy": np.asarray(data["positions"]),
                    "channels.npy": np.asarray(data["channels"]),
                    "original_size.pyd": tuple(data["original_sizes"]),
                    "patch_size.pyd": tuple(data["patch_sizes"]),
                }
            )
            written += 1
            if written % 1000 == 0:
                print(f"wrote {written} samples")
    print(f"done: {written} samples -> {output_dir}")
    return written


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dataset_path_or_url", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_config_path", default="./conf/patch14-l.json")
    p.add_argument("--sample_patches_beta", type=float, default=0.02)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--maxsize", type=float, default=1e9)
    p.add_argument("--compress", type=lambda v: v.lower() in ("1", "true"), default=True)
    p.add_argument("--process_index", type=int, default=0)
    p.add_argument("--process_count", type=int, default=1)
    p.add_argument("--device", default="cuda", help="where the DCT runs ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
