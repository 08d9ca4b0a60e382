"""Convert a reference (PyTorch) DCTAutoencoder checkpoint to the port.

Counterpart of the JAX package's tools/convert_reference_weights.py, with
the same flags, plus --device (the card by default); --reference_dir has no
default (JAX's names a tree outside the repository).  Maps the reference
model's tensors (reference: dct_autoencoder/modeling_dct_autoencoder.py:19-88
— HF CLIPEncoder stacks, factorized pos embeds, Linear+LN patch embed, LFQ
projections, patchnorm buffers) onto the port's state_dict.  Both are torch
layouts, so nothing is transposed; a LayerNorm's weight is JAX's scale.  The
converted model keeps the reference's attention semantics
(`attn_mask_mode='bias'`), and `save_pretrained` writes it in the JAX
package's format.

The converter reads attributes only and needs no `transformers`;
`reference_standin` builds a module with the same attribute layout.  Only
`main` imports the reference package (through tools/parity_vs_reference.py's
shims).

Usage (with a reference checkpoint directory):
  python -m dct_autoencoder_torch.tools.convert_reference_weights \
      --reference_model_path /path/to/ref_ckpt --output_path out/converted \
      --reference_dir <directory holding the dct_autoencoder package>
"""
from __future__ import annotations

import argparse
import math
import types
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models.autoencoder import DCTAutoencoder
from ..models.config import DCTAutoencoderConfig, TransformerConfig
from ..models.convert import expected_shapes, is_vq_stat
from ..models.patchnorm import PatchNormState
from .copy_clip_into import clip_layer, layer_tensors, randomize_


def _f32(t) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32)


def convert_state_dict(ref_model, config: DCTAutoencoderConfig) -> Dict[str, torch.Tensor]:
    """Reference torch module -> the port's state_dict (fp32, on the CPU).
    A tensor the reference does not have (a Linear without bias) is left
    out, for `convert` to name."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, t):
        if t is not None:
            sd[key] = _f32(t)

    # factorized pos embeds (reference modeling...py:41-59)
    for side in ("encoder", "decoder"):
        for axis in ("channel", "height", "width"):
            put(f"{side}_pos_embed_{axis}", getattr(ref_model, f"{side}_pos_embed_{axis}"))

    # patch embed: Sequential(Linear(no bias), LayerNorm) (reference :61-64)
    put("patch_embed_linear.weight", ref_model.to_patch_embedding[0].weight)
    put("patch_embed_norm.weight", ref_model.to_patch_embedding[1].weight)
    put("patch_embed_norm.bias", ref_model.to_patch_embedding[1].bias)

    # transformer stacks (HF CLIPEncoder layers)
    for side in ("encoder", "decoder"):
        for i, layer in enumerate(getattr(ref_model, side).layers):
            for name, t in layer_tensors(layer).items():
                put(f"{side}.layers.{i}.{name}", t)

    # LFQ projections (reference lfq.py:61-62), only where the reference has them
    if config.vq_type == "lfq" and hasattr(ref_model.vq_model.project_in, "weight"):
        for proj in ("project_in", "project_out"):
            linear = getattr(ref_model.vq_model, proj)
            put(f"vq_model.{proj}.weight", linear.weight)
            put(f"vq_model.{proj}.bias", linear.bias)

    # proj_out: Sequential(LayerNorm, Linear(no bias)) (reference :85-88)
    put("proj_out_norm.weight", ref_model.proj_out[0].weight)
    put("proj_out_norm.bias", ref_model.proj_out[0].bias)
    put("proj_out_linear.weight", ref_model.proj_out[1].weight)
    return sd


def convert_patchnorm(ref_model) -> PatchNormState:
    pn = ref_model.patchnorm
    return PatchNormState(n=_f32(pn.n), median=_f32(pn.median), b=_f32(pn.b))


def config_from_reference(ref_config) -> DCTAutoencoderConfig:
    """Reference HF config object -> the port's config (same field names)."""

    def tc(c) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=c.hidden_size,
            intermediate_size=c.intermediate_size,
            num_hidden_layers=c.num_hidden_layers,
            num_attention_heads=c.num_attention_heads,
            layer_norm_eps=getattr(c, "layer_norm_eps", 1e-5),
            hidden_act=getattr(c, "hidden_act", "quick_gelu"),
        )

    return DCTAutoencoderConfig(
        image_channels=ref_config.image_channels,
        patch_size=ref_config.patch_size,
        max_patch_h=ref_config.max_patch_h,
        max_patch_w=ref_config.max_patch_w,
        vq_codebook_size=ref_config.vq_codebook_size,
        vq_num_codebooks=ref_config.vq_num_codebooks,
        vq_type=ref_config.vq_type,
        encoder_config=tc(ref_config.encoder_config),
        decoder_config=tc(ref_config.decoder_config),
        # replicate the reference's effective attention semantics exactly
        attn_mask_mode="bias",
    )


def check_state_dict(sd: Mapping[str, torch.Tensor], config: DCTAutoencoderConfig) -> None:
    """Raise ValueError naming the port's parameters that `sd` leaves out,
    the keys it has that the port does not, and the shapes that differ."""
    want = {k: tuple(v) for k, v in expected_shapes(config).items() if not is_vq_stat(k)}
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing:
        raise ValueError(f"unconverted params: {missing}")
    if extra:
        raise ValueError(f"unexpected params: {extra}")
    bad = [f"{k}: {want[k]} vs {tuple(sd[k].shape)}" for k in sorted(want) if tuple(sd[k].shape) != want[k]]
    if bad:
        raise ValueError(f"params of another shape (the port's vs the reference's): {bad}")


def convert(ref_model, dtype: torch.dtype = torch.float32, device="cuda") -> DCTAutoencoder:
    """Reference torch model instance -> ready-to-use DCTAutoencoder on `device`."""
    config = config_from_reference(ref_model.config)
    sd = convert_state_dict(ref_model, config)
    check_state_dict(sd, config)
    model = DCTAutoencoder(config, dtype=dtype, device=device)
    model.module.load_state_dict(sd)
    model.patchnorm = convert_patchnorm(ref_model).to(model.device)
    return model


def _transformer_namespace(c: TransformerConfig) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        hidden_size=c.hidden_size, intermediate_size=c.intermediate_size, num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads, layer_norm_eps=c.layer_norm_eps, hidden_act=c.hidden_act,
    )


@torch.no_grad()
def reference_standin(
    config: DCTAutoencoderConfig, seed: int = 0, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    patchnorm: Optional[PatchNormState] = None,
) -> nn.Module:
    """A stand-in for the reference's DCTAutoencoder: plain torch.nn modules
    with the attribute layout that `convert_state_dict` reads, and a
    ``.config`` with the reference config's fields.  Random-init from `seed`,
    or holding a port state_dict's tensors (and `patchnorm`'s), so that
    `convert` gives them back."""
    dim = config.encoder_config.hidden_size
    c, mh, mw, pz = config.image_channels, config.max_patch_h, config.max_patch_w, config.patch_dim
    ref = nn.Module()
    ref.config = types.SimpleNamespace(
        image_channels=c, patch_size=config.patch_size, max_patch_h=mh, max_patch_w=mw,
        vq_codebook_size=config.vq_codebook_size, vq_num_codebooks=config.vq_num_codebooks, vq_type=config.vq_type,
        encoder_config=_transformer_namespace(config.encoder_config),
        decoder_config=_transformer_namespace(config.decoder_config),
    )
    for side in ("encoder", "decoder"):
        for axis, n in (("channel", c), ("height", mh), ("width", mw)):
            setattr(ref, f"{side}_pos_embed_{axis}", nn.Parameter(torch.zeros(n, dim)))
    ref.to_patch_embedding = nn.Sequential(nn.Linear(pz, dim, bias=False), nn.LayerNorm(dim))
    for side in ("encoder", "decoder"):
        tc = getattr(config, f"{side}_config")
        stack = nn.Module()
        stack.layers = nn.ModuleList(
            clip_layer(tc.hidden_size, tc.intermediate_size, tc.layer_norm_eps) for _ in range(tc.num_hidden_layers)
        )
        setattr(ref, side, stack)
    ref.vq_model = nn.Module()
    codebook_dims = int(math.log2(config.vq_codebook_size)) * config.vq_num_codebooks
    projections = config.vq_type == "lfq" and dim != codebook_dims
    ref.vq_model.project_in = nn.Linear(dim, codebook_dims) if projections else nn.Identity()
    ref.vq_model.project_out = nn.Linear(codebook_dims, dim) if projections else nn.Identity()
    ref.proj_out = nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, pz, bias=False))
    ref.patchnorm = nn.Module()
    if state_dict is None:
        randomize_(ref, seed)
        g = torch.Generator().manual_seed(seed + 1)
        ref.patchnorm.register_buffer("n", torch.randint(1, 1000, (c, mh, mw), generator=g).float())
        ref.patchnorm.register_buffer("median", 0.1 * torch.randn((c, mh, mw, pz), generator=g))
        ref.patchnorm.register_buffer("b", 0.5 + torch.rand((c, mh, mw, pz), generator=g))
        return ref
    for key, t in convert_state_dict(ref, config).items():
        t.copy_(state_dict[key])  # the stand-in's own fp32 CPU tensors, which _f32 hands back uncopied
    pn = patchnorm or PatchNormState.create(c, mh, mw, pz)
    for name in ("n", "median", "b"):
        ref.patchnorm.register_buffer(name, getattr(pn, name).detach().to("cpu", torch.float32).clone())
    return ref


def main(reference_model_path: str, output_path: str, reference_dir: str, device: str = "cuda"):
    from .parity_vs_reference import import_reference

    import_reference(reference_dir)
    from dct_autoencoder.modeling_dct_autoencoder import DCTAutoencoder as RefModel  # the reference's package

    ref = RefModel.from_pretrained(reference_model_path)
    model = convert(ref, device=device)
    model.save_pretrained(output_path)
    print("converted checkpoint saved to", output_path)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reference_model_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--reference_dir", required=True,
                   help="the directory that holds the reference's dct_autoencoder package")
    p.add_argument("--device", default="cuda", help="where the converted model is built ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
