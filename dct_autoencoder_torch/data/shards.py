"""Webdataset-compatible tar shard reader/writer (no webdataset dependency).

A copy of the JAX package's data/shards.py (numpy and the standard library
only): the two packages read and write the same shards.  The reference streams training data through the `webdataset` library and
writes preprocessed shards with `wds.ShardWriter` (reference: dataset.py:27-89,
preproc_dataset.py:64-84).  This module implements the same on-disk format —
tar archives whose members are `<key>.<ext>`, samples grouped by key — with a
plain-Python streaming reader (constant memory, skip-corrupt-and-continue
semantics matching wds.handlers.warn_and_continue) and a size-rolling writer.

Extension codecs: .npy (numpy), .json, .txt, .cls, .jpg/.jpeg/.png (PIL ->
float32 CHW in [0,1]), .pyd/.pickle (python pickle), .pth (torch.load, so the
reference's preprocessed shards remain readable).
"""
from __future__ import annotations

import glob as _glob
import gzip
import io
import json
import os
import pickle
import sys
import tarfile
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np


def _decode_npy(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b), allow_pickle=False)


def _decode_image(b: bytes) -> np.ndarray:
    from PIL import Image

    im = Image.open(io.BytesIO(b)).convert("RGB")
    arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def _decode_pth(b: bytes) -> Any:
    import torch

    t = torch.load(io.BytesIO(b), map_location="cpu", weights_only=True)
    return t.numpy() if hasattr(t, "numpy") else t


_DECODERS: Dict[str, Callable[[bytes], Any]] = {
    "npy": _decode_npy,
    "json": lambda b: json.loads(b.decode()),
    "txt": lambda b: b.decode(),
    "cls": lambda b: int(b.decode()),
    "jpg": _decode_image,
    "jpeg": _decode_image,
    "png": _decode_image,
    "pyd": pickle.loads,
    "pickle": pickle.loads,
    "pth": _decode_pth,
}


def _encode(ext: str, value: Any) -> bytes:
    if ext == "npy":
        buf = io.BytesIO()
        np.save(buf, np.asarray(value), allow_pickle=False)
        return buf.getvalue()
    if ext == "json":
        return json.dumps(value).encode()
    if ext == "txt":
        return str(value).encode()
    if ext == "cls":
        return str(int(value)).encode()
    if ext in ("pyd", "pickle"):
        return pickle.dumps(value)
    if isinstance(value, bytes):
        return value
    raise ValueError(f"don't know how to encode extension .{ext}")


def expand_urls(url: str) -> List[str]:
    """Expand a brace pattern `shard-{000000..000009}.tar` or glob or dir."""
    if "{" in url and ".." in url:
        head, rest = url.split("{", 1)
        rng, tail = rest.split("}", 1)
        lo, hi = rng.split("..")
        width = len(lo)
        return [f"{head}{i:0{width}d}{tail}" for i in range(int(lo), int(hi) + 1)]
    if any(c in url for c in "*?["):
        return sorted(_glob.glob(url))
    if os.path.isdir(url):
        return sorted(
            os.path.join(url, f)
            for f in os.listdir(url)
            if f.endswith(".tar") or f.endswith(".tar.gz") or f.endswith(".tgz")
        )
    return [url]


def warn_and_continue(exn: Exception) -> bool:
    print(f"[shards] skipping sample after error: {exn!r}", file=sys.stderr)
    return True


def iter_tar_samples(
    path: str, handler: Callable[[Exception], bool] = warn_and_continue
) -> Iterator[Dict[str, bytes]]:
    """Stream raw samples (key -> {ext: bytes}) from one tar shard."""
    open_kwargs: Dict[str, Any] = {"mode": "r|*"}  # streaming, auto-compression
    try:
        with tarfile.open(path, **open_kwargs) as tf:
            current_key: Optional[str] = None
            sample: Dict[str, bytes] = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = os.path.basename(member.name)
                if "." not in name:
                    continue
                key, ext = name.split(".", 1)
                if current_key is not None and key != current_key:
                    if sample:
                        yield dict(sample, __key__=current_key.encode())
                    sample = {}
                current_key = key
                f = tf.extractfile(member)
                if f is not None:
                    sample[ext] = f.read()
            if sample and current_key is not None:
                yield dict(sample, __key__=current_key.encode())
    except Exception as e:  # corrupt shard: warn and move on
        if not handler(e):
            raise


def decode_sample(
    raw: Dict[str, bytes], handler: Callable[[Exception], bool] = warn_and_continue
) -> Optional[Dict[str, Any]]:
    """Decode a raw sample by extension; None if any field fails to decode."""
    out: Dict[str, Any] = {}
    for ext, data in raw.items():
        if ext == "__key__":
            out["__key__"] = data.decode()
            continue
        base_ext = ext.split(".")[-1]
        dec = _DECODERS.get(base_ext)
        try:
            out[ext] = dec(data) if dec is not None else data
        except Exception as e:
            if not handler(e):
                raise
            return None
    return out


class WebDatasetReader:
    """Streaming reader over a list of shards with optional shuffling.

    Multi-host: pass `process_index`/`process_count` to give each host a
    disjoint subset of shards (the per-host ownership scheme of SURVEY §7).
    """

    def __init__(
        self,
        url: str,
        shuffle_buffer: int = 0,
        seed: int = 0,
        handler: Callable[[Exception], bool] = warn_and_continue,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.paths = expand_urls(url)[process_index::process_count]
        if not self.paths:
            raise FileNotFoundError(f"no shards match {url}")
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.handler = handler

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        paths = list(self.paths)
        if self.shuffle_buffer:
            rng.shuffle(paths)

        def raw_stream():
            for p in paths:
                yield from iter_tar_samples(p, self.handler)

        stream: Iterable = raw_stream()
        if self.shuffle_buffer > 1:
            stream = _buffer_shuffle(stream, self.shuffle_buffer, rng)

        for raw in stream:
            d = decode_sample(raw, self.handler)
            if d is not None:
                yield d


def _buffer_shuffle(stream: Iterable, buffer_size: int, rng) -> Iterator:
    buf: List[Any] = []
    for item in stream:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        i = int(rng.integers(0, buffer_size))
        yield buf[i]
        buf[i] = item
    rng.shuffle(buf)
    yield from buf


class ShardWriter:
    """Size-rolling tar shard writer (wds.ShardWriter-compatible).

    pattern: e.g. "out/%06d.tar"; rolls to a new shard when maxsize bytes
    exceeded.  compress=True writes gzip tars (reference preproc_dataset.py:64).
    """

    def __init__(self, pattern: str, maxsize: float = 1e9, compress: bool = False):
        self.pattern = pattern
        self.maxsize = maxsize
        self.compress = compress
        self.shard_index = 0
        self.size = 0
        self.count = 0
        self._tar: Optional[tarfile.TarFile] = None
        self._fileobj = None

    def _open_next(self):
        self._close_current()
        path = self.pattern % self.shard_index
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self.compress:
            self._fileobj = gzip.open(path, "wb")
            self._tar = tarfile.open(fileobj=self._fileobj, mode="w|")
        else:
            self._tar = tarfile.open(path, "w")
        self.shard_index += 1
        self.size = 0

    def _close_current(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None
        if self._fileobj is not None:
            self._fileobj.close()
            self._fileobj = None

    def write(self, sample: Dict[str, Any]) -> None:
        key = sample.get("__key__", f"{self.count:08d}")
        if self._tar is None or self.size >= self.maxsize:
            self._open_next()
        for field, value in sample.items():
            if field == "__key__":
                continue
            ext = field
            data = _encode(ext.split(".")[-1], value)
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
            self.size += len(data)
        self.count += 1

    def close(self):
        self._close_current()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
