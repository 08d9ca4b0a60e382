"""Carry weights between the JAX package's params.npz and the port's state_dict.

The JAX package saves its flax parameter tree as flat '/'-joined paths,
e.g. ``encoder/layers_0/self_attn/q_proj/kernel``.  The port's module tree
uses the same names, so the mapping is mechanical:
  * '/' -> '.', and ``layers_N`` -> ``layers.N``;
  * a Dense ``kernel`` (in, out) -> ``weight`` (out, in), transposed;
  * a LayerNorm ``scale`` -> ``weight``;
  * the int8 serving form's ``kernel_q`` (int8, (in, out)) and
    ``kernel_scale`` (fp32) keep their names, layouts and types
    (models/quant.py holds them in the JAX layout).
`jax_arrays_from_state_dict` is the reverse map (a 2-d ``weight`` is a Dense
kernel, a 1-d ``weight`` a LayerNorm scale); it also carries a dict of
gradients keyed like the state_dict.  In both directions every key must be
consumed and every parameter filled, with matching shapes; anything else
raises.

The same two functions carry the autoregressive token model
(``ar_params.npz``, models/ar.py) when given an ``ARConfig``: its embedding
tables (``code_embed`` (C, z, h), the three position tables, ``bos``) keep
their names and layouts, since none of them is called ``kernel`` or
``weight``, and its bias-free ``head`` is a Dense like any other.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch


_LAYER = re.compile(r"^layers_(\d+)$")


def _port_key(jax_key: str) -> str:
    parts = []
    for part in jax_key.split("/"):
        m = _LAYER.match(part)
        parts.append(f"layers.{m.group(1)}" if m else part)
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def expected_shapes(config) -> Dict[str, torch.Size]:
    """The port's parameter names and shapes for `config`, a tokenizer's
    DCTAutoencoderConfig or an ARConfig (no allocation)."""
    from .ar import ARConfig, ARTokenModel
    from .autoencoder import DCTAutoencoderModule

    with torch.device("meta"):
        module = ARTokenModel(config) if isinstance(config, ARConfig) else DCTAutoencoderModule(config)
    return {k: v.shape for k, v in module.state_dict().items()}


def state_dict_from_jax_npz(
    npz_or_dict: Union[str, Mapping[str, np.ndarray]], config
) -> Dict[str, torch.Tensor]:
    """Map flat JAX parameter paths onto the port's fp32 state_dict."""
    if isinstance(npz_or_dict, str):
        with np.load(npz_or_dict) as f:
            arrays = {k: f[k] for k in f.files}
    else:
        arrays = dict(npz_or_dict)
    want = expected_shapes(config)
    out: Dict[str, torch.Tensor] = {}
    for jax_key, arr in arrays.items():
        key = _port_key(jax_key)
        if key not in want:
            raise KeyError(f"checkpoint key {jax_key!r} has no counterpart ({key!r}) in the port")
        if key in out:
            raise KeyError(f"two checkpoint keys map to {key!r}")
        t = torch.from_numpy(np.array(arr, dtype=np.int8 if np.asarray(arr).dtype == np.int8 else np.float32))
        if jax_key.endswith("/kernel"):
            t = t.T.contiguous()
        if t.shape != want[key]:
            raise ValueError(f"{jax_key}: shape {tuple(t.shape)} after mapping, port expects {tuple(want[key])}")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"port parameters not filled by the checkpoint: {missing}")
    return out


def _jax_key(port_key: str, ndim: int) -> str:
    parts = port_key.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if out[-1] == "weight":
        out[-1] = "kernel" if ndim == 2 else "scale"
    return "/".join(out)


def jax_arrays_from_state_dict(
    state_dict: Mapping[str, torch.Tensor], config
) -> Dict[str, np.ndarray]:
    """Map the port's state_dict (or gradients under the same names) onto the
    JAX package's flat parameter paths, as fp32 numpy arrays (int8 for the
    int8 serving form's ``kernel_q``)."""
    want = expected_shapes(config)
    out: Dict[str, np.ndarray] = {}
    for key, t in state_dict.items():
        if key not in want:
            raise KeyError(f"{key!r} is not a parameter of the port's module")
        if t.shape != want[key]:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, the module expects {tuple(want[key])}")
        arr = t.detach().to(torch.int8 if t.dtype == torch.int8 else torch.float32).cpu().numpy()
        jax_key = _jax_key(key, arr.ndim)
        if jax_key.endswith("/kernel"):
            arr = arr.T
        out[jax_key] = np.ascontiguousarray(arr)
    missing = sorted(set(want) - set(state_dict))
    if missing:
        raise KeyError(f"parameters missing from the state_dict: {missing}")
    return out


def jax_param_tree(state_dict: Mapping[str, torch.Tensor], config) -> Dict[str, Any]:
    """The JAX package's nested parameter tree (dicts of numpy arrays) of a
    state_dict, with the keys of every level sorted: the order in which
    jax.tree_util walks a dict, and the order of the tree of a checkpoint
    that the JAX package loaded (its ``from_pretrained`` rebuilds the tree
    with ``tree_unflatten``), so ``layers_10`` comes before ``layers_2``.
    Code that draws random numbers while it walks the tree draws them in
    the JAX package's order."""
    tree: Dict[str, Any] = {}
    for key, arr in jax_arrays_from_state_dict(state_dict, config).items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def ordered(node):
        return {k: ordered(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return ordered(tree)


def flatten_jax_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of ``jax_param_tree``: flat '/'-joined paths, as in params.npz."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_jax_tree(v, path))
        else:
            out[path] = v
    return out
