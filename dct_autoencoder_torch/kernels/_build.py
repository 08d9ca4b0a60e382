"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each library is one source (with its own defines) compiled into a shared
library with a plain C interface, for Hopper (sm_90a), at first use into
``kernels/build/``; attention_bwd.cu and attention_bwd_tf32x3.cu make two
each, one a kernel, so that the largest sources compile in halves at once.  A library's file name
carries a hash of its source, the headers it includes, the flags and the
defines, so an edited source is rebuilt and a stale one is never loaded.
``build_all`` starts one nvcc per library at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# kernel library name -> its .cu source (headers in csrc/ are hashed too)
SOURCES = {
    "attention_fwd": "attention_fwd.cu",
    "attention_fwd_tf32x3": "attention_fwd_tf32x3.cu",
    "attention_bwd_dq": "attention_bwd.cu",
    "attention_bwd_dkv": "attention_bwd.cu",
    "attention_bwd_tf32x3_dq": "attention_bwd_tf32x3.cu",
    "attention_bwd_tf32x3_dkv": "attention_bwd_tf32x3.cu",
    "dct_patchify": "dct_patchify.cu",
    "idct_unpatchify": "idct_unpatchify.cu",
}
# kernel library name -> the defines its source is compiled with
DEFINES = {
    "attention_bwd_dq": ["-DATTN_BWD_PART=0"],
    "attention_bwd_dkv": ["-DATTN_BWD_PART=1"],
    "attention_bwd_tf32x3_dq": ["-DATTN_BWD_PART=0"],
    "attention_bwd_tf32x3_dkv": ["-DATTN_BWD_PART=1"],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")
    return path


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + DEFINES.get(name, [])


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == SOURCES[name] or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> "subprocess.Popen | None":
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: "subprocess.Popen | None") -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)  # type: ignore[attr-defined]


def build_all(names: List[str] = None) -> None:
    """Compile every kernel library that is missing, all nvcc runs at once."""
    names = list(SOURCES) if names is None else names
    with _lock:
        procs = {n: _start(n) for n in names}
        try:
            for n, p in procs.items():
                _finish(n, p)
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(name))
                _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def host_floats(values) -> "ctypes.Array[ctypes.c_float]":
    flat = [float(v) for v in values]
    return (ctypes.c_float * len(flat))(*flat)
