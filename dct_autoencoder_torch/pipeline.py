"""Tokenizer pipeline: images <-> token records (LFQ or VQ) in one call.

    pipe = DCTPipeline.from_pretrained("docs/calibrated_run_r3b/model")  # its gated int8 sibling
    records = pipe.encode(images)        # JSON-able per-image token records
    recons  = pipe.decode(records)       # RGB arrays at original sizes

Encode runs the batched front-end kernel, packing, patchnorm and the model
forward; decode rebuilds one packed row per record, runs decode_from_codes,
the inverse patchnorm and the back-end kernel.  Records use the JAX
package's schema, so either package decodes the other's records.  A VQ
checkpoint encodes without training (the argmin, no gumbel draw, the
statistics as loaded from vq_stats.npz).

``reconstruct_direct`` is the serving daemon's /reconstruct: no token
records, and for a group of images of one size one back-end launch over the
whole group and one copy of uint8 pixels to the host.

``pad_rows_to`` / ``pad_tokens_to`` are the JAX package's shape buckets:
encode pads the packed rows to a multiple (fully masked rows), decode pads
each record's tokens to a multiple (masked tokens).  The port compiles no
program per shape, but it keeps them so that a daemon configured for either
package runs the same shapes and the same records come out; padding is
masked everywhere, so records and images equal the unpadded path's.

``data_parallel=True`` (JAX: rows sharded over every local device, one
process) copies the module to each visible card (or to each of `devices`)
at construction; a packed batch, its rows padded to the number of copies,
is cut into contiguous blocks, one forward a card launched in turn from one
thread, and the outputs are gathered on the model's device.  Eval rows are
independent, so the records equal the single-device ones; on one card it is
one block.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import obs
from .kernels.idct_unpatchify import fused_idct_unpatchify_rgb
from .models.autoencoder import DCTAutoencoder
from .models.config import DCTAutoencoderConfig
from .models.factory import get_model_and_processor
from .patches.container import from_dict, to_dict
from .parallel.mesh import pad_batch_rows, take_rows
from .patches.extractor import DCTAutoencoderFeatureExtractor
from .train.pixel_loss import row_image_layout, unpatch_to_planes


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
    def __init__(
        self,
        model: DCTAutoencoder,
        processor: DCTAutoencoderFeatureExtractor,
        data_parallel: bool = False,
        pad_rows_to: int = 0,
        pad_tokens_to: int = 0,
        devices: Optional[Sequence] = None,
    ):
        """devices: where data_parallel puts the copies (default: every
        visible card for a model on the card, else the model's device)."""
        self._replicas = None
        if data_parallel:
            if devices is None:
                on_card = model.device.type == "cuda"
                devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] if on_card else [model.device]
            devices = [torch.device(d) for d in devices]
            self._replicas = [(model.module, model.device)] + [
                (copy.deepcopy(model.module).to(d), d) for d in devices[1:]
            ]
        self.model = model
        self.processor = processor
        self.pad_rows_to = pad_rows_to
        self.pad_tokens_to = pad_tokens_to

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
            if self.pad_rows_to:
                batch = pad_batch_rows(batch, self.pad_rows_to)
            out = self._forward(self.model.normalize_(batch))
            records.extend(to_dict(out["dct_patches"], out["codes"]))
        return records

    def decode(self, records: Sequence[dict]) -> List[np.ndarray]:
        """Token records -> RGB images (c, h, w) in [0, 1] at their original sizes."""
        images: List[np.ndarray] = []
        for rec in records:
            dp, codes = from_dict(rec, device=self.model.device)
            n = codes.shape[0]
            padn = (-n) % self.pad_tokens_to if self.pad_tokens_to else 0
            if padn:
                # masked tokens land in revert_patching's trash slot
                codes = np.concatenate([codes, np.zeros((padn, codes.shape[1]), codes.dtype)])
                pad1 = lambda t, fill: torch.cat([t, t.new_full((1, padn, *t.shape[2:]), fill)], dim=1)
                dp = dp.replace(
                    key_pad_mask=pad1(dp.key_pad_mask, True),
                    batched_image_ids=pad1(dp.batched_image_ids, 0),
                    patch_channels=pad1(dp.patch_channels, 0),
                    patch_positions=pad1(dp.patch_positions, 0),
                )
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

    @torch.no_grad()
    def _forward(self, batch) -> dict:
        """The eval forward of a normalized batch: dct_patches and codes, over
        the copies under data_parallel."""
        with obs.span("dct.serve.forward"):
            if self._replicas is None:
                return self.model.forward(batch)
            batch = batch.to(self.model.device)
            b, n = batch.patches.shape[0], len(self._replicas)
            padded = pad_batch_rows(batch, n)
            rows = padded.patches.shape[0] // n
            outs = []
            for i, (module, device) in enumerate(self._replicas):
                # the hand kernels launch on the current card
                with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                    outs.append(module(take_rows(padded, i * rows, (i + 1) * rows).to(device), training=False))
            patches = torch.cat([o["dct_patches"].patches.to(self.model.device) for o in outs])[:b]
            codes = torch.cat([o["codes"].to(self.model.device) for o in outs])[:b]
            return {"dct_patches": batch.replace(patches=patches), "codes": codes}

    def reconstruct(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """encode + decode in one step (keeps the image order)."""
        return self.decode(self.encode(images))

    @torch.no_grad()
    def reconstruct_direct(self, images: Sequence[np.ndarray], as_uint8: bool = False) -> List[np.ndarray]:
        """reconstruct() without the token records: the serving path.

        The forward decodes from the same quantized codes that encode would
        write, so the images are those of reconstruct() (within 1e-5 in fp32
        on the CPU).  A group of images that share their patch grid and size
        (clients resize to a bucket) goes normalize -> forward -> inverse
        patchnorm -> scatter onto DCT planes -> one IDCT launch over
        ``bucket`` slots (the next power of two >= the group's images, as the
        JAX package buckets its program; empty slots cost the IDCT of a zero
        plane) -> clamp, and with as_uint8 ``(x * 255 + 0.5)`` to uint8, on
        the device; the pixels come to the host in one copy.  Groups of mixed
        sizes take the host scatter and one back-end launch per size."""
        with obs.span("dct.serve.reconstruct"):
            ds = self.processor.preprocess_many(images)
            cols = {k: [d[k] for d in ds] for k in ds[0]}
            outs: List[np.ndarray] = []
            for batch in self.processor.iter_batches(iter([cols]), batch_size=None):
                if self.pad_rows_to:
                    batch = pad_batch_rows(batch, self.pad_rows_to)
                out = self._forward(self.model.normalize_(batch))
                decoded = self.model.inv_normalize_(out["dct_patches"])
                n_images = len(batch.patch_sizes)
                if len(set(batch.patch_sizes)) == 1 and len(set(batch.original_sizes)) == 1:
                    bucket = 1 << (n_images - 1).bit_length()
                    imgs = self._fused_reconstruct(decoded, batch.patch_sizes[0], batch.original_sizes[0], bucket, as_uint8)
                    outs.extend(imgs[i] for i in range(n_images))
                    continue
                for im in self.processor.postprocess(decoded):
                    im = np.clip(im, 0.0, 1.0)
                    outs.append((im * 255.0 + 0.5).astype(np.uint8) if as_uint8 else im)
            return outs

    def _fused_reconstruct(self, decoded, grid, orig, max_images: int, as_uint8: bool) -> np.ndarray:
        """Decoded patches of one uniform group -> (max_images, c, h, w) pixels on the host."""
        with obs.span("dct.serve.backend"):
            p, c = self.processor.patch_size, self.processor.channels
            (ph, pw), (h, w) = grid, orig
            if not (ph * p <= h and pw * p <= w):
                raise ValueError(f"patch grid {grid} of {p}px patches does not fit the image size {orig}")
            offsets, _ = row_image_layout(decoded)
            planes = unpatch_to_planes(decoded.patches, decoded, offsets, (ph, pw), p, c, max_images)
            rgb = fused_idct_unpatchify_rgb(planes, h, w).clamp_(0.0, 1.0)
            if as_uint8:
                rgb = (rgb * 255.0 + 0.5).to(torch.uint8)
            return obs.to_host(rgb, "pixels").numpy()
