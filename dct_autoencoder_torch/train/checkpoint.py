"""Full training state for exact resume: parameters, optimizer moments, step, patchnorm.

The model alone (config, weights, patchnorm) is written by
`DCTAutoencoder.save_pretrained` in the JAX package's format; this file is
the trainer's own and is written with torch.save and read back with
weights_only=True: tensors and plain Python values only (AdamW's fp32
moments, or AdamW8bit's uint8 codes, fp32 absmax and int count).

A state on a mesh (TrainState.mesh) saves the same file: every rank joins
the gathers of the tensor-parallel parameters, of a pipeline's stage-owned
layers and of the ZeRO-1 slices, and rank 0 writes.  Loading keeps each
rank's blocks, layers and slices, on any mesh or on one device.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from ..models.patchnorm import PatchNormState


def _ckpt_file(path: str) -> str:
    return os.path.abspath(os.path.join(path, "train_state.pt"))


def save_train_state(path: str, state, patchnorm: PatchNormState) -> str:
    """Save the full training state for exact resume (on a mesh, a collective)."""
    from ..parallel.mesh import gather_params, is_main_process

    target = _ckpt_file(path)
    mesh = getattr(state, "mesh", None)
    payload = {
        "params": state.module.state_dict() if mesh is None else gather_params(state.module, mesh),
        "opt_state": state.adamw.state_dict(),
        "step": int(state.step),
        "patchnorm": {"n": patchnorm.n, "median": patchnorm.median, "b": patchnorm.b},
    }
    if is_main_process():
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = f"{target}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)
    if mesh is not None:
        torch.distributed.barrier()  # the file exists for every rank
    return target


def load_train_state(path: str, state, patchnorm_like: PatchNormState) -> Tuple[object, PatchNormState]:
    """Restore into `state` (in place: its module and optimizer give the
    structure and the device); returns (state, patchnorm)."""
    from ..parallel.mesh import load_full_state_dict

    device = patchnorm_like.n.device
    payload = torch.load(_ckpt_file(path), map_location=device, weights_only=True)
    load_full_state_dict(state.module, payload["params"], getattr(state, "mesh", None))
    state.adamw.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    pn = payload["patchnorm"]
    return state, PatchNormState(n=pn["n"], median=pn["median"], b=pn["b"]).to(device)


def has_train_state(path: str) -> bool:
    return os.path.isfile(_ckpt_file(path))
