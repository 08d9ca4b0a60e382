"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each module holds a wrapper that launches its kernel for CUDA tensors and
runs the plain version for CPU tensors, plus a launch counter per kernel.
The kernels are built from ../csrc at first use (see _build.py).
"""
from . import attention, dct_patchify, idct_unpatchify

# kernel name -> (module, name of its launch counter)
COUNTERS = {
    "attention": (attention, "LAUNCHES"),
    "attention_dq": (attention, "LAUNCHES_DQ"),
    "attention_dkv": (attention, "LAUNCHES_DKV"),
    "attention_causal": (attention, "LAUNCHES_CAUSAL"),
    "attention_dq_causal": (attention, "LAUNCHES_DQ_CAUSAL"),
    "attention_dkv_causal": (attention, "LAUNCHES_DKV_CAUSAL"),
    "attention_dropout": (attention, "LAUNCHES_DROPOUT"),
    "attention_dq_dropout": (attention, "LAUNCHES_DQ_DROPOUT"),
    "attention_dkv_dropout": (attention, "LAUNCHES_DKV_DROPOUT"),
    "dct_patchify": (dct_patchify, "LAUNCHES"),
    "idct_unpatchify": (idct_unpatchify, "LAUNCHES"),
}


def reset_launch_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    for counts in (attention.LAUNCHES_FWD_IMPL, attention.LAUNCHES_BWD_IMPL):
        for impl in counts:
            counts[impl] = 0
    attention.LAUNCHES_PAD = 0


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def fwd_impl_launch_counts() -> dict:
    """Launches of the attention forward kernel, causal or not, by implementation ("mma", "simt", "tf32x3")."""
    return dict(attention.LAUNCHES_FWD_IMPL)


def bwd_impl_launch_counts() -> dict:
    """Launches of the two attention backward kernels by implementation ("mma", "simt", "tf32x3")."""
    return dict(attention.LAUNCHES_BWD_IMPL)


def pad_copy_count() -> int:
    """Tensors the attention wrappers padded with zero columns (``attention.pad_head_dim``'s copies)."""
    return attention.LAUNCHES_PAD
