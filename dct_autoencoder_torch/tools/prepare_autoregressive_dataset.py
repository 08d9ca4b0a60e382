"""Token dump for autoregressive-model training
(reference: prepare_autoregressive_dataset.py:14-71).

Counterpart of the JAX package's tools/prepare_autoregressive_dataset.py,
with the same flags, defaults and records, except that --device (the card
by default) replaces --platform.  Runs a trained tokenizer over an
image(+caption) shard stream and writes JSON token records
({"caption", "image_embedding": {size, original_size, codes: [{c, h, w, data}]}})
to compressed tar shards ``h{process_index:03d}-%06d.tar``; either
package's ``from_dict`` reads them.  The model runs in bfloat16 on the card
(as JAX always does) and in float32 on the CPU.

Multi-host operation: each process owns a disjoint set of input shards
(--process_index/--process_count) and writes its own output shards.  A
record's ``__key__`` is the ``__key__`` of the sample it was made from (the
JAX tool numbers each process's records from 0, so two processes write the
same keys): the processes of one dump together write the keys that one
process alone would.

Usage:
  python -m dct_autoencoder_torch.tools.prepare_autoregressive_dataset \\
      --image_dataset_path_or_url 'raw/{000000..000099}.tar' \\
      --model_load_path out/<ts>/model --output_dir tokens/
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from ..data.dataset import batched, load_and_transform_dataset
from ..data.shards import ShardWriter
from ..models.factory import get_model_and_processor
from ..patches.container import to_dict


def main(
    image_dataset_path_or_url: str,
    output_dir: str,
    model_load_path: Optional[str] = None,
    caption_key: str = "txt",
    sample_patches_beta: float = 0.01,
    batch_size: int = 32,
    n: int = 1_000_000,
    seed: int = 42,
    process_index: int = 0,
    process_count: int = 1,
    device: str = "cuda",
) -> int:
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    # no config: with no --model_load_path the factory refuses, as JAX's does
    model, processor = get_model_and_processor(
        None, dtype=dtype, sample_patches_beta=sample_patches_beta, resume_path=model_load_path, device=device
    )

    stream = load_and_transform_dataset(
        image_dataset_path_or_url,
        processor,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
        keep_key=True,
    )

    os.makedirs(output_dir, exist_ok=True)
    pattern = os.path.join(output_dir, f"h{process_index:03d}-%06d.tar")
    written = 0
    with ShardWriter(pattern, maxsize=1e9, compress=True) as writer:
        for batch in processor.iter_batches(batched(stream, batch_size), batch_size=batch_size, drain=True):
            nb = model.normalize_(batch)
            out = model.forward(nb, training=False)
            records = to_dict(out["dct_patches"], out["codes"])
            data = nb.data_dict
            captions = data.get(caption_key, [None] * len(records))
            for key, caption, rec in zip(data["__key__"], captions, records):
                writer.write({"__key__": key, "json": {"caption": caption, "image_embedding": rec}})
                written += 1
                if written >= n:
                    break
            if written % 1000 < batch_size:
                print(f"wrote {written} records")
            if written >= n:
                break
    print(f"done: {written} records -> {output_dir}")
    return written


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dataset_path_or_url", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_load_path", default=None)
    p.add_argument("--caption_key", default="txt")
    p.add_argument("--sample_patches_beta", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--process_index", type=int, default=0)
    p.add_argument("--process_count", type=int, default=1)
    p.add_argument("--device", default="cuda", help="where the model runs ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
