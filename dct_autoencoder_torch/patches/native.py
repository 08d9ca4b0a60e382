"""ctypes bindings for the native packing runtime (the repository's ext/packing.cpp).

Counterpart of the JAX package's patches/native.py, with one difference:
there is no quiet fallback.  The shared library is built with g++ at first
use into the port's own build directory (kernels/build/, beside the CUDA
kernels; the source is only read), under a name that carries a hash of the
source and the flags.  ``available()`` reports whether it loaded; every
entry point raises a RuntimeError naming the library when it did not.

The port's packer (patches/packing.py) stays on numpy, which is as fast
for this memory-bound work; these entry points give the same arrays bit for
bit (tests/test_torch_native.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ..kernels._build import BUILD_DIR

SRC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "ext", "packing.cpp")
# no -march=native (the JAX package's flag): a build directory copied to
# another host must not hold code for this host's CPU alone
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def lib_path() -> str:
    """Where the library is built: kernels/build/libdctpack-<hash of source and flags>.so."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdctpack-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    run = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SRC_PATH], capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {run.returncode}):\n{run.stderr[-4000:]}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None (and the reason in _error) if it cannot be."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None

        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.dctpack_greedy_pack.restype = ctypes.c_int64
        lib.dctpack_greedy_pack.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p]
        lib.dctpack_fill_batch.restype = None
        lib.dctpack_fill_batch.argtypes = [
            f32p, i32p, i32p, i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, i32p, i32p, i32p, u8p,
        ]
        lib.dctpack_build_attn_mask.restype = None
        lib.dctpack_build_attn_mask.argtypes = [i32p, u8p, ctypes.c_int64, ctypes.c_int64, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library is built and loaded."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native packing library (libdctpack from ext/packing.cpp) is not available: {_error}")
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def greedy_pack(lengths: np.ndarray, max_seq_len: int) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """First-fit row assignment of per-image token counts.
    Returns (n_rows, row_ids, image_slot, row_offsets)."""
    lib = _require()
    n = len(lengths)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    row_ids = np.empty(n, dtype=np.int64)
    image_slot = np.empty(n, dtype=np.int64)
    row_offsets = np.empty(n, dtype=np.int64)
    n_rows = lib.dctpack_greedy_pack(
        _ptr(lengths, ctypes.c_int64), n, max_seq_len,
        _ptr(row_ids, ctypes.c_int64), _ptr(image_slot, ctypes.c_int64), _ptr(row_offsets, ctypes.c_int64),
    )
    return int(n_rows), row_ids, image_slot, row_offsets


def fill_batch(
    patches: np.ndarray,  # (total, pz) float32, image-major concatenation
    positions: np.ndarray,  # (total, 2) int32
    channels: np.ndarray,  # (total,) int32
    lengths: np.ndarray,
    row_ids: np.ndarray,
    image_slot: np.ndarray,
    row_offsets: np.ndarray,
    n_rows: int,
    max_seq_len: int,
):
    """Padded (b, S, ...) buffers from concatenated token streams and a
    greedy_pack assignment.  Returns (patches, positions, channels,
    image_ids, key_pad_mask)."""
    lib = _require()
    n = len(lengths)
    pz = patches.shape[1]
    out_patches = np.zeros((n_rows, max_seq_len, pz), dtype=np.float32)
    out_positions = np.zeros((n_rows, max_seq_len, 2), dtype=np.int32)
    out_channels = np.zeros((n_rows, max_seq_len), dtype=np.int32)
    out_image_ids = np.zeros((n_rows, max_seq_len), dtype=np.int32)
    out_pad = np.ones((n_rows, max_seq_len), dtype=np.uint8)

    patches = np.ascontiguousarray(patches, dtype=np.float32)
    positions = np.ascontiguousarray(positions, dtype=np.int32)
    channels = np.ascontiguousarray(channels, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    lib.dctpack_fill_batch(
        _ptr(patches, ctypes.c_float), _ptr(positions, ctypes.c_int32),
        _ptr(channels, ctypes.c_int32), _ptr(lengths, ctypes.c_int64),
        _ptr(np.ascontiguousarray(row_ids, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(image_slot, np.int64), ctypes.c_int64),
        _ptr(np.ascontiguousarray(row_offsets, np.int64), ctypes.c_int64),
        n, pz, max_seq_len,
        _ptr(out_patches, ctypes.c_float), _ptr(out_positions, ctypes.c_int32),
        _ptr(out_channels, ctypes.c_int32), _ptr(out_image_ids, ctypes.c_int32),
        _ptr(out_pad, ctypes.c_uint8),
    )
    return out_patches, out_positions, out_channels, out_image_ids, out_pad.astype(bool)


def build_attn_mask(image_ids: np.ndarray, key_pad_mask: np.ndarray) -> np.ndarray:
    """(b, s) ids and padding -> (b, s, s) bool mask,
    allowed(i, j) = ids[i] == ids[j] and not pad[j], in the C loop."""
    lib = _require()
    ids = np.ascontiguousarray(image_ids, dtype=np.int32)
    pad = np.ascontiguousarray(key_pad_mask, dtype=np.uint8)
    b, s = ids.shape
    out = np.empty((b, s, s), dtype=np.uint8)
    lib.dctpack_build_attn_mask(_ptr(ids, ctypes.c_int32), _ptr(pad, ctypes.c_uint8), b, s, _ptr(out, ctypes.c_uint8))
    return out.astype(bool)
