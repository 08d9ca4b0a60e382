"""Tokenizer pipeline: images <-> LFQ token records in one call.

    pipe = DCTPipeline.from_pretrained("docs/calibrated_run_r3b/model")  # its gated int8 sibling
    records = pipe.encode(images)        # JSON-able per-image token records
    recons  = pipe.decode(records)       # RGB arrays at original sizes

Encode runs the batched front-end kernel, packing, patchnorm and the model
forward; decode rebuilds one packed row per record, runs decode_from_codes,
the inverse patchnorm and the back-end kernel.  Records use the JAX
package's schema, so either package decodes the other's records.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .models.autoencoder import DCTAutoencoder
from .models.config import DCTAutoencoderConfig
from .models.factory import get_model_and_processor
from .patches.container import from_dict, to_dict
from .patches.extractor import DCTAutoencoderFeatureExtractor


def _int8_sibling(path: str, record: dict) -> Optional[str]:
    """The int8 sibling a passing gate record points to, or None.

    The path relative to the checkpoint (`int8_model_rel`) comes first, so a
    copied tree serves its own sibling.  The absolute pointer (`int8_model`)
    is taken only when that one does not exist, and only inside the directory
    that holds the checkpoint, where the gate writes its siblings: a record
    copied from elsewhere never sends the load outside the copy.  (The JAX
    package tries the absolute pointer first.)"""
    rel = record.get("int8_model_rel")
    if rel and os.path.isdir(os.path.join(path, rel)):
        return os.path.normpath(os.path.join(path, rel))
    absolute = record.get("int8_model")
    if not absolute or not os.path.isdir(absolute):
        return None
    home = os.path.dirname(os.path.realpath(path))
    return absolute if os.path.commonpath([home, os.path.realpath(absolute)]) == home else None


class DCTPipeline:
    def __init__(self, model: DCTAutoencoder, processor: DCTAutoencoderFeatureExtractor):
        self.model = model
        self.processor = processor

    @classmethod
    def from_pretrained(
        cls,
        path: str,
        sample_patches_beta: float = 0.02,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        prefer_int8: str = "auto",
    ) -> "DCTPipeline":
        """Load a checkpoint for serving.

        prefer_int8='auto' (the default) follows the int8 gate's record, as the
        JAX package does: if `int8_serving.json` in the checkpoint directory
        says the int8 form passed, the gated int8 sibling is loaded instead
        (see `_int8_sibling` for where it is looked for).  'never' ignores the
        record; 'always' needs a passing record and raises FileNotFoundError
        without one."""
        if prefer_int8 not in ("auto", "never", "always"):
            raise ValueError(f"prefer_int8 must be 'auto', 'never' or 'always', got {prefer_int8!r}")
        load_path = path
        if prefer_int8 != "never":
            gate_file = os.path.join(path, "int8_serving.json")
            record = None
            if os.path.exists(gate_file):
                with open(gate_file) as f:
                    record = json.load(f)
            int8_dir = _int8_sibling(path, record) if record is not None and record.get("pass") else None
            if int8_dir:
                load_path = int8_dir
                crit = (
                    f"agreement {record['agreement']:.4f} >= {record['threshold']}"
                    if "threshold" in record
                    else f"flip ratio {record.get('flip_ratio')} <= {record.get('flip_ratio_max')}, "
                    f"psnr delta {record.get('psnr_delta')}"
                )
                print(f"serving int8 form (gated: {crit}): {load_path}")
            elif prefer_int8 == "always":
                raise FileNotFoundError(
                    f"prefer_int8='always' but no passing int8 gate record at {gate_file} "
                    "(run tools/quantize_checkpoint --gate)"
                )
        model, proc = get_model_and_processor(
            None, dtype=dtype, sample_patches_beta=sample_patches_beta, resume_path=load_path, device=device
        )
        return cls(model, proc)

    @classmethod
    def from_config(
        cls,
        config: DCTAutoencoderConfig,
        sample_patches_beta: float = 0.02,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device="cuda",
    ) -> "DCTPipeline":
        """A randomly initialised model (seeded) for `config`."""
        model, proc = get_model_and_processor(
            config, dtype=dtype, sample_patches_beta=sample_patches_beta, seed=seed, device=device
        )
        return cls(model, proc)

    def encode(self, images: Sequence[np.ndarray], batch_size: Optional[int] = None) -> List[dict]:
        """RGB images ((c, h, w) float in [0, 1] or uint8) -> per-image token
        records {"size", "original_size", "codes": [{"c", "h", "w", "data"}]}."""
        ds = self.processor.preprocess_many(images)
        cols = {k: [d[k] for d in ds] for k in ds[0]}
        records: List[dict] = []
        for batch in self.processor.iter_batches(iter([cols]), batch_size=batch_size, drain=batch_size is not None):
            out = self.model.forward(self.model.normalize_(batch))
            records.extend(to_dict(out["dct_patches"], out["codes"]))
        return records

    def decode(self, records: Sequence[dict]) -> List[np.ndarray]:
        """Token records -> RGB images (c, h, w) in [0, 1] at their original sizes."""
        images: List[np.ndarray] = []
        for rec in records:
            dp, codes = from_dict(rec, device=self.model.device)
            decoded = self.model.decode_from_codes(
                torch.from_numpy(codes)[None],
                key_pad_mask=dp.key_pad_mask,
                batched_image_ids=dp.batched_image_ids,
                patch_channels=dp.patch_channels,
                patch_positions=dp.patch_positions,
                patch_sizes=dp.patch_sizes,
                original_sizes=dp.original_sizes,
            )
            decoded = self.model.inv_normalize_(decoded)
            images.append(np.clip(self.processor.postprocess(decoded)[0], 0.0, 1.0))
        return images

    def reconstruct(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """encode + decode in one step (keeps the image order)."""
        return self.decode(self.encode(images))
