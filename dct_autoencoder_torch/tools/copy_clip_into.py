"""CLIP-L vision weight transplant for warm-starting (reference: copy_clip_into_.py).

Counterpart of the JAX package's tools/copy_clip_into.py, with the same
flags and defaults, plus --device (the card by default).  Copies the
vision transformer layers of `openai/clip-vit-large-patch14` (or of any
CLIPVisionModel directory) into the encoder (layers 0..n_enc-1) and the
decoder (layers n_enc..n_enc+n_dec-1) of a fresh model.  HF's torch layout
is the port's, so nothing is transposed: each fp32 master is copied in
place.  The checkpoint is written in the JAX package's format, as every
checkpoint of the port is.

Only `main` needs the `transformers` package (and, for a hub name, its
cache or the network); without it `main` raises SystemExit naming it.
`transplant` reads attributes only: `clip_vision_standin` builds a module
with the same attribute layout from plain torch.nn modules.

Usage:
  python -m dct_autoencoder_torch.tools.copy_clip_into \
      --model_config_path conf/patch14-l.json --output_path out/warm_start
"""
from __future__ import annotations

import argparse
import operator

import torch
from torch import nn

from ..models.autoencoder import DCTAutoencoder
from ..models.config import DCTAutoencoderConfig

# (the port's name inside an EncoderLayer, HF's name inside a CLIPEncoderLayer)
LAYER_TENSORS = tuple(
    (f"{dst}.{kind}", f"{src}.{kind}")
    for dst, src in (
        ("self_attn.q_proj", "self_attn.q_proj"), ("self_attn.k_proj", "self_attn.k_proj"),
        ("self_attn.v_proj", "self_attn.v_proj"), ("self_attn.out_proj", "self_attn.out_proj"),
        ("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
        ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"),
    )
    for kind in ("weight", "bias")
)


def layer_tensors(src_layer) -> dict:
    """An HF CLIPEncoderLayer's tensors under the port's EncoderLayer names
    (a tensor the layer does not have is left out)."""
    out = {}
    for dst, src in LAYER_TENSORS:
        try:
            t = operator.attrgetter(src)(src_layer)
        except AttributeError:
            continue
        if t is not None:
            out[dst] = t
    return out


@torch.no_grad()
def _copy_layer(dst_layer: nn.Module, src_layer, where: str) -> None:
    src = layer_tensors(src_layer)
    params = dict(dst_layer.named_parameters())
    for name, _ in LAYER_TENSORS:
        if name not in params:
            raise ValueError(f"{where}.{name} is not a float parameter of the model (an int8 serving form?)")
        if name not in src:
            raise ValueError(f"{where}: the CLIP layer has no tensor for {name}")
        dst = params[name]
        if tuple(src[name].shape) != tuple(dst.shape):
            raise ValueError(f"{where}.{name}: CLIP's shape {tuple(src[name].shape)}, the model's {tuple(dst.shape)}")
        dst.copy_(src[name])


def transplant(model: DCTAutoencoder, clip_vision_model) -> DCTAutoencoder:
    """Layerwise transplant (reference copy_clip_into_.py:21-27): CLIP layers
    [0, n_enc) -> encoder, [n_enc, n_enc + n_dec) -> decoder, in place.
    Raises ValueError where CLIP has too few layers or a width differs."""
    n_enc = model.config.encoder_config.num_hidden_layers
    n_dec = model.config.decoder_config.num_hidden_layers
    src_layers = clip_vision_model.vision_model.encoder.layers
    if len(src_layers) < n_enc + n_dec:
        raise ValueError(f"CLIP has {len(src_layers)} layers; need {n_enc + n_dec} ({n_enc} encoder + {n_dec} decoder)")
    for i in range(n_enc):
        _copy_layer(model.module.encoder.layers[i], src_layers[i], f"encoder.layers.{i}")
    for i in range(n_dec):
        _copy_layer(model.module.decoder.layers[i], src_layers[n_enc + i], f"decoder.layers.{i}")
    return model


def clip_layer(hidden_size: int, intermediate_size: int, layer_norm_eps: float = 1e-5) -> nn.Module:
    """A module with an HF CLIPEncoderLayer's attribute layout and tensors (no forward)."""
    layer = nn.Module()
    layer.self_attn = nn.Module()
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        setattr(layer.self_attn, proj, nn.Linear(hidden_size, hidden_size))
    layer.layer_norm1 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
    layer.layer_norm2 = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
    layer.mlp = nn.Module()
    layer.mlp.fc1 = nn.Linear(hidden_size, intermediate_size)
    layer.mlp.fc2 = nn.Linear(intermediate_size, hidden_size)
    return layer


@torch.no_grad()
def randomize_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter, in the order of parameters(), from a seeded
    normal draw of std 0.02 around 1 (LayerNorm weights) or 0 (the rest)."""
    g = torch.Generator().manual_seed(seed)
    norm_weights = {id(m.weight) for m in module.modules() if isinstance(m, nn.LayerNorm)}
    for p in module.parameters():
        p.copy_((1.0 if id(p) in norm_weights else 0.0) + 0.02 * torch.randn(p.shape, generator=g))
    return module


def clip_vision_standin(
    hidden_size: int = 1024, intermediate_size: int = 4096, num_hidden_layers: int = 24,
    layer_norm_eps: float = 1e-5, seed: int = 0,
) -> nn.Module:
    """A random-init stand-in for CLIPVisionModel's vision tower (the
    defaults are CLIP-L/14's published widths), built from plain torch.nn
    modules with HF's attribute names (``.vision_model.encoder.layers[i]``,
    as `transplant` reads it), for machines without `transformers`.  It has
    the tensors only, no forward."""
    clip = nn.Module()
    clip.vision_model = nn.Module()
    clip.vision_model.encoder = nn.Module()
    clip.vision_model.encoder.layers = nn.ModuleList(
        clip_layer(hidden_size, intermediate_size, layer_norm_eps) for _ in range(num_hidden_layers)
    )
    return randomize_(clip, seed)


def main(
    model_config_path: str = "./conf/patch14-l.json",
    clip_model_name: str = "openai/clip-vit-large-patch14",
    output_path: str = "./out/warm_start",
    device: str = "cuda",
):
    try:
        from transformers import CLIPVisionModel
    except ImportError as e:
        raise SystemExit(f"transformers unavailable: {e}")

    cfg = DCTAutoencoderConfig.from_json_file(model_config_path)
    model = DCTAutoencoder(cfg, device=device)
    clip = CLIPVisionModel.from_pretrained(clip_model_name)
    model = transplant(model, clip)
    model.save_pretrained(output_path)
    print("saved warm-started model to", output_path)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_config_path", default="./conf/patch14-l.json")
    p.add_argument("--clip_model_name", default="openai/clip-vit-large-patch14")
    p.add_argument("--output_path", default="./out/warm_start")
    p.add_argument("--device", default="cuda", help="where the model is built ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
