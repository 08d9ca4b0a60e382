"""Streaming dataset pipelines (reference: dct_autoencoder/dataset.py).

Counterpart of the JAX package's data/dataset.py, over the port's extractor.
Two sources feed training:
  * raw image shards (jpg + json metadata) -> resolution filter -> resize cap
    -> on-device preprocess (IPT+DCT+patchify+importance sampling: the DCT
    kernel on the card);
  * preprocessed shards written by tools/preproc_dataset.py of either
    package (or by the reference's preproc script: .pth tensors decode too).

Plus the list-of-dicts column collate the packing generator consumes
(reference dataset.py:8-25).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..patches.extractor import DCTAutoencoderFeatureExtractor
from .shards import WebDatasetReader, warn_and_continue


def dict_collate(rows: List[Dict]) -> Dict[str, List]:
    """List of row dicts -> dict of column lists (reference dataset.py:8-15)."""
    assert len(rows) > 0
    columns = rows[0].keys()
    out: Dict[str, List] = {k: [] for k in columns}
    for row in rows:
        for k in columns:
            out[k].append(row[k])
    return out


def tuple_collate(rows: List[Tuple]) -> List[List]:
    """List of row tuples -> list of column lists (reference dataset.py:18-25)."""
    assert len(rows) > 0
    n = len(rows[0])
    out: List[List] = [[] for _ in range(n)]
    for row in rows:
        for i, col in enumerate(row):
            out[i].append(col)
    return out


def batched(stream: Iterable[Dict], batch_size: int) -> Iterator[Dict[str, List]]:
    """Group a sample stream into collated column-dict batches (DataLoader stand-in)."""
    buf: List[Dict] = []
    for row in stream:
        buf.append(row)
        if len(buf) == batch_size:
            yield dict_collate(buf)
            buf = []
    if buf:
        yield dict_collate(buf)


def default_size_buckets(max_size: int = 768, min_size: int = 256, step: int = 128):
    """Aspect-ratio bucket grid for bounded-compile preprocessing.

    Returns (h, w) pairs covering portrait/landscape/square shapes; streaming
    images are resized to the closest bucket so the number of distinct
    preprocess shapes is fixed.
    """
    sizes = list(range(min_size, max_size + 1, step))
    buckets = set()
    for h in sizes:
        for w in sizes:
            if 0.5 <= h / w <= 2.0:
                buckets.add((h, w))
    return sorted(buckets)


def resize_to_bucket(im: np.ndarray, buckets) -> np.ndarray:
    """Resize (c, h, w) to the bucket with the closest aspect then scale."""
    from PIL import Image

    _, h, w = im.shape
    ar = h / w
    best = min(buckets, key=lambda b: (abs(math.log(ar / (b[0] / b[1]))), -b[0] * b[1]))
    bh, bw = best
    if (h, w) == (bh, bw):
        return im
    pil = Image.fromarray((im.transpose(1, 2, 0) * 255).astype(np.uint8))
    pil = pil.resize((bw, bh), Image.BICUBIC)
    return np.asarray(pil, dtype=np.float32).transpose(2, 0, 1) / 255.0


def _resize_cap(im: np.ndarray, max_size: int) -> np.ndarray:
    """Cap the longest side at max_size with antialiased resize (PIL)."""
    _, h, w = im.shape
    if max(h, w) <= max_size:
        return im
    from PIL import Image

    ar = h / w
    if h > w:
        nh, nw = max_size, int(max_size / ar)
    else:
        nw, nh = max_size, int(ar * max_size)
    pil = Image.fromarray((im.transpose(1, 2, 0) * 255).astype(np.uint8))
    pil = pil.resize((nw, nh), Image.BICUBIC)
    return np.asarray(pil, dtype=np.float32).transpose(2, 0, 1) / 255.0


def load_and_transform_dataset(
    dataset_url: str,
    dct_processor: DCTAutoencoderFeatureExtractor,
    shuffle_buffer: int = 0,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    min_res_factor: int = 12,
    size_buckets=None,
    preprocess_batch_size: int = 0,
    augment=None,
    keep_key: bool = False,
) -> Iterator[Dict[str, Any]]:
    """Raw image shards -> per-image preprocess dicts (reference dataset.py:35-89).

    Filters out images below 12x patch_size, caps the longest side at
    max(768, patch_size * max_patch) before the on-device DCT.

    Options beyond the reference, as in the JAX package:
      * size_buckets: resize each image to the nearest (h, w) bucket so the
        number of distinct preprocess shapes is bounded (pass
        `default_size_buckets()` or your own list);
      * preprocess_batch_size: accumulate that many images and run one
        preprocess call (one DCT launch) per shape group
        (extractor.preprocess_many);
      * augment: a data.augment.Augmenter (or any (c,h,w)->(c,h,w) callable)
        applied after the size normalization and before the on-device DCT;
        shape-preserving.
    The port's own option: keep_key=True keeps each sample's tar ``__key__``
    as a column (it rides through packing like a caption), so that a tool
    can name its outputs after their sources.

    An image the extractor refuses (ValueError: smaller than one patch) is
    skipped with a warning, as JAX skips a failed preprocess; a failure of
    the DCT kernel's build or launch (RuntimeError) is raised.
    """
    min_res = dct_processor.patch_size * min_res_factor
    max_size = max(
        dct_processor.patch_size
        * max(dct_processor.max_patch_w, dct_processor.max_patch_h),
        768,
    )

    reader = WebDatasetReader(
        dataset_url,
        shuffle_buffer=shuffle_buffer,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )

    def image_stream():
        for sample in reader:
            try:
                meta = sample.get("json")
                im = None
                for k in ("jpg", "jpeg", "png"):
                    if k in sample:
                        im = sample[k]
                        break
                if im is None:
                    continue
                if meta is not None:
                    h, w = meta.get("height"), meta.get("width")
                    if h is None or w is None or h < min_res or w < min_res:
                        continue
                else:
                    if im.shape[1] < min_res or im.shape[2] < min_res:
                        continue
                if size_buckets is not None:
                    im = resize_to_bucket(im, size_buckets)
                else:
                    im = _resize_cap(im, max_size)
                if augment is not None:
                    im = augment(im)
                extra = {
                    k: v
                    for k, v in sample.items()
                    if k not in ("jpg", "jpeg", "png", "json", "__key__")
                }
                if keep_key:
                    extra["__key__"] = sample["__key__"]
                yield im, extra
            except Exception as e:
                if not warn_and_continue(e):
                    raise

    if preprocess_batch_size and preprocess_batch_size > 1:
        buf_ims: list = []
        buf_extra: list = []
        for im, extra in image_stream():
            buf_ims.append(im)
            buf_extra.append(extra)
            if len(buf_ims) == preprocess_batch_size:
                for d, e in zip(dct_processor.preprocess_many(buf_ims), buf_extra):
                    d.update(e)
                    yield d
                buf_ims, buf_extra = [], []
        if buf_ims:
            for d, e in zip(dct_processor.preprocess_many(buf_ims), buf_extra):
                d.update(e)
                yield d
        return

    for im, extra in image_stream():
        try:
            d = dct_processor.preprocess(im)
        except ValueError as e:
            if not warn_and_continue(e):
                raise
            continue
        d.update(extra)
        yield d


def load_preprocessed_dataset(
    dataset_url: str,
    shuffle_buffer: int = 0,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, Any]]:
    """Preprocessed shards -> per-image token dicts (reference dataset.py:27-33).

    Accepts both this framework's .npy fields and the reference's .pth fields.
    """
    reader = WebDatasetReader(
        dataset_url,
        shuffle_buffer=shuffle_buffer,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )
    for sample in reader:
        d: Optional[Dict[str, Any]] = None
        for suffix in ("npy", "pth"):
            if f"patches.{suffix}" in sample:
                d = dict(
                    patches=np.asarray(sample[f"patches.{suffix}"]),
                    positions=np.asarray(sample[f"positions.{suffix}"]),
                    channels=np.asarray(sample[f"channels.{suffix}"]),
                    original_sizes=tuple(sample["original_size.pyd"]),
                    patch_sizes=tuple(sample["patch_size.pyd"]),
                )
                break
        if d is not None:
            yield d
