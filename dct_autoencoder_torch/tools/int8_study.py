"""The noise-equivalence probe of the int8 study, which the relative int8 gate runs.

Counterpart of ``_noise_equiv_model`` in dct_autoencoder_tpu/tools/int8_study.py
(the rest of that study is not ported).  The probe perturbs the float
model's stack kernels by uniform noise of the int8 rounding's magnitude: if
that flips as many tokens as the int8 form does, the flips are a property
of the model's LFQ sign margins, not of the quantizer
(tools/quantize_checkpoint.py's relative gate).
"""
from __future__ import annotations

import copy

import numpy as np


def _noise_equiv_model(model, seed: int, skip_layers=()):
    """Float sibling of `model` whose stack kernels carry uniform noise of
    +-scale/2, scale = per-output-channel amax / 127 (the int8 rounding's
    magnitude), on the same device and compute type.

    skip_layers: layer indices left unperturbed (pass the int8 form's bf16
    layers, so that the probe perturbs exactly the weights it rounds).

    The noise comes from ``np.random.default_rng(seed)``, one draw per
    kernel, in the order in which the JAX package's walk meets the kernels:
    the encoder, then the decoder, and inside each the keys in the order of
    the JAX tree of a loaded checkpoint (models/convert.py::jax_param_tree).
    So the same seed perturbs the same weights by the same amounts as in the
    JAX package."""
    from ..models.autoencoder import DCTAutoencoder
    from ..models.convert import flatten_jax_tree, jax_param_tree, load_jax_arrays, vq_stats_from_state_dict

    rng = np.random.default_rng(seed)
    skip = set(skip_layers)

    def walk(node):
        if isinstance(node, dict):
            if "kernel" in node and np.ndim(node["kernel"]) == 2:
                w = np.asarray(node["kernel"], np.float32)
                scale = np.abs(w).max(axis=0) / 127.0
                noise = rng.uniform(-0.5, 0.5, size=w.shape).astype(np.float32)
                return {**node, "kernel": (w + noise * scale).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        return node

    def walk_stack(stack_params):
        out = {}
        for k, v in stack_params.items():
            index = k.split("_")[-1]
            out[k] = v if k.startswith("layers_") and index.isdigit() and int(index) in skip else walk(v)
        return out

    m = DCTAutoencoder(copy.deepcopy(model.config), dtype=model.dtype, device=model.device)
    params = jax_param_tree(model.module.state_dict(), model.config)
    for stack in ("encoder", "decoder"):
        if stack in params:
            params[stack] = walk_stack(params[stack])
    load_jax_arrays(m.module, flatten_jax_tree(params), m.config, vq_stats_from_state_dict(model.module.state_dict()) or None)
    m.patchnorm = model.patchnorm
    return m
