"""Full training state for exact resume: parameters, optimizer moments, step, patchnorm.

The model alone (config, weights, patchnorm) is written by
`DCTAutoencoder.save_pretrained` in the JAX package's format; this file is
the trainer's own and is written with torch.save.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from ..models.patchnorm import PatchNormState


def _ckpt_file(path: str) -> str:
    return os.path.abspath(os.path.join(path, "train_state.pt"))


def save_train_state(path: str, state, patchnorm: PatchNormState) -> str:
    """Save the full training state for exact resume."""
    target = _ckpt_file(path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    payload = {
        "params": state.module.state_dict(),
        "opt_state": state.adamw.state_dict(),
        "step": int(state.step),
        "patchnorm": {"n": patchnorm.n, "median": patchnorm.median, "b": patchnorm.b},
    }
    tmp = f"{target}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return target


def load_train_state(path: str, state, patchnorm_like: PatchNormState) -> Tuple[object, PatchNormState]:
    """Restore into `state` (in place: its module and optimizer give the
    structure and the device); returns (state, patchnorm)."""
    device = patchnorm_like.n.device
    payload = torch.load(_ckpt_file(path), map_location=device, weights_only=True)
    state.module.load_state_dict(payload["params"])
    state.adamw.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    pn = payload["patchnorm"]
    return state, PatchNormState(n=pn["n"], median=pn["median"], b=pn["b"]).to(device)


def has_train_state(path: str) -> bool:
    return os.path.isfile(_ckpt_file(path))
