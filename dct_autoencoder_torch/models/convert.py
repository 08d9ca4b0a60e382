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

VQ's EMA statistics (buffers of ``vq_model`` named as in models/vq.py's
STAT_NAMES) are the JAX package's separate 'vq_stats' collection, saved to
vq_stats.npz under the same flat paths (``vq_model/batch_mean``, ...):
`jax_arrays_from_state_dict` leaves them out, `vq_stats_from_state_dict`
takes them, and `state_dict_from_jax_npz` / `load_jax_arrays` take them
back from a vq_stats.npz (or dict) given beside the parameters.

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


def is_vq_stat(port_key: str) -> bool:
    """Whether a state_dict key is one of VQ's EMA statistics (vq_stats.npz)."""
    from .vq import STAT_NAMES

    parts = port_key.split(".")
    return len(parts) == 2 and parts[0] == "vq_model" and parts[1] in STAT_NAMES


def _load_npz(npz_or_dict) -> Dict[str, np.ndarray]:
    if isinstance(npz_or_dict, str):
        with np.load(npz_or_dict) as f:
            return {k: f[k] for k in f.files}
    return dict(npz_or_dict)


def expected_shapes(config) -> Dict[str, torch.Size]:
    """The port's parameter names and shapes for `config`, a tokenizer's
    DCTAutoencoderConfig or an ARConfig (no allocation)."""
    from .ar import ARConfig, ARTokenModel
    from .autoencoder import DCTAutoencoderModule

    with torch.device("meta"):
        module = ARTokenModel(config) if isinstance(config, ARConfig) else DCTAutoencoderModule(config)
    return {k: v.shape for k, v in module.state_dict().items()}


def state_dict_from_jax_npz(
    npz_or_dict: Union[str, Mapping[str, np.ndarray]], config,
    vq_stats: Union[None, str, Mapping[str, np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """Map flat JAX parameter paths (and, if given, vq_stats paths) onto the
    port's fp32 state_dict.  Without vq_stats the statistics are left out
    of the result (load it with `load_jax_arrays`)."""
    arrays = _load_npz(npz_or_dict)
    stats = _load_npz(vq_stats) if vq_stats is not None else {}
    if set(arrays) & set(stats):
        raise KeyError(f"keys in both the parameters and vq_stats: {sorted(set(arrays) & set(stats))}")
    for key in arrays:
        if is_vq_stat(_port_key(key)):
            raise KeyError(f"{key!r} is a vq_stats entry, not a parameter")
    for key in stats:
        if not is_vq_stat(_port_key(key)):
            raise KeyError(f"vq_stats key {key!r} is not one of VQ's statistics")
    arrays.update(stats)
    want = expected_shapes(config)
    if vq_stats is None:
        want = {k: v for k, v in want.items() if not is_vq_stat(k)}
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


def load_jax_arrays(module: torch.nn.Module, params, config, vq_stats=None) -> None:
    """Load JAX parameter arrays (a params.npz path or a flat dict) and, if
    given, vq_stats arrays into `module`; without vq_stats, VQ's statistics
    keep the module's values.  Every parameter must be filled."""
    sd = state_dict_from_jax_npz(params, config, vq_stats)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    if unexpected or any(not is_vq_stat(k) for k in missing):
        raise KeyError(f"state_dict mismatch: missing {missing}, unexpected {unexpected}")


def vq_stats_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """VQ's EMA statistics of a state_dict under JAX's vq_stats paths, as
    fp32 numpy arrays ({} for an LFQ model)."""
    return {
        key.replace(".", "/"): np.ascontiguousarray(t.detach().float().cpu().numpy())
        for key, t in state_dict.items() if is_vq_stat(key)
    }


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
    int8 serving form's ``kernel_q``).  VQ's statistics are left out (see
    `vq_stats_from_state_dict`)."""
    want = {k: v for k, v in expected_shapes(config).items() if not is_vq_stat(k)}
    out: Dict[str, np.ndarray] = {}
    for key, t in state_dict.items():
        if is_vq_stat(key):
            continue
        if key not in want:
            raise KeyError(f"{key!r} is not a parameter of the port's module")
        if t.shape != want[key]:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, the module expects {tuple(want[key])}")
        t = t.detach().to(torch.int8 if t.dtype == torch.int8 else torch.float32)
        jax_key = _jax_key(key, t.ndim)
        if jax_key.endswith("/kernel"):
            t = t.T  # transposed by torch's copy, several times faster than numpy's for these sizes
        out[jax_key] = t.contiguous().cpu().numpy()
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
