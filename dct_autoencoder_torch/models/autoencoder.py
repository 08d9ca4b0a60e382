"""DCT autoencoder: patch embed -> CLIP encoder -> LFQ or VQ -> CLIP decoder -> proj_out.

`DCTAutoencoderModule` is the nn.Module; its parameter names follow the
JAX package's flax tree (see models/convert.py).  `DCTAutoencoder` wraps it
with the patchnorm state and the reference API (normalize_, encode, decode,
decode_from_codes, forward, from_pretrained, save_pretrained).

Types: every parameter is an fp32 master.  The transformer and the
patch-embed / proj_out projections cast their weights at use and run in the
model dtype (bf16 on the card); LayerNorms keep fp32 statistics; position
embeddings are gathered and summed in fp32 and then cast; LFQ, VQ and
their projections run in fp32, as in the JAX model.

VQ (`vq_type='vq'`, models/vq.py) is built with the reference's settings.
Its EMA statistics (JAX's 'vq_stats' collection) are buffers of
`vq_model`; `save_pretrained` writes them to vq_stats.npz in JAX's format
and `from_pretrained` reads them back.

The module's parameters are trainable (train/loop.py updates them in
place); the wrapper's serving methods run without autograd.

Under a pipeline (parallel/pipeline.py's make_pipelined_module) both stacks
run through pipeline_stack_apply and hold their stage's layers only;
everything between and after them (LFQ or VQ, the decoder's embeddings,
proj_out) runs on every model rank on the stacks' broadcast output, as JAX
runs it on the psum'd output.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import obs
from ..patches.container import DCTPatches
from .config import DCTAutoencoderConfig
from .lfq import LFQ
from .vq import VectorQuantize
from .patchnorm import PatchNormState, apply_patchnorm, inverse_patchnorm
from .transformer import Dense, LayerNorm, TransformerEncoder


def resolve_device(device) -> torch.device:
    """The torch.device for `device`; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: dct_autoencoder_torch runs on the GPU by "
            "default; pass device='cpu' to run its plain PyTorch path on the CPU"
        )
    return device


class DCTAutoencoderModule(nn.Module):
    def __init__(self, config: DCTAutoencoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if config.vq_type not in ("lfq", "vq"):
            raise ValueError(config.vq_type)
        self.config = config
        self.dtype = dtype
        dim = config.encoder_config.hidden_size
        c, mh, mw = config.image_channels, config.max_patch_h, config.max_patch_w
        for prefix in ("encoder", "decoder"):
            setattr(self, f"{prefix}_pos_embed_channel", nn.Parameter(torch.randn(c, dim)))
            setattr(self, f"{prefix}_pos_embed_height", nn.Parameter(torch.randn(mh, dim)))
            setattr(self, f"{prefix}_pos_embed_width", nn.Parameter(torch.randn(mw, dim)))
        self.patch_embed_linear = Dense(config.patch_dim, dim, bias=False, dtype=dtype)
        self.patch_embed_norm = LayerNorm(dim, 1e-4)
        self.encoder = TransformerEncoder(config.encoder_config, dtype)
        self.decoder = TransformerEncoder(config.decoder_config, dtype)
        if config.vq_type == "lfq":
            self.vq_model = LFQ(dim, config.vq_codebook_size, config.vq_num_codebooks)
        else:
            # the reference's settings (modeling_dct_autoencoder.py:77): k-means
            # init, gumbel sampling at temperature 20, 16-dim codes, a gradient
            # codebook, affine statistics, dead codes below an EMA usage of 15
            self.vq_model = VectorQuantize(
                dim, config.vq_codebook_size, heads=config.vq_num_codebooks, codebook_dim=16,
                sample_codebook_temp=20.0, affine_param=True, kmeans_init=True, threshold_ema_dead_code=15.0,
            )
        self.proj_out_norm = LayerNorm(dim, 1e-4)
        self.proj_out_linear = Dense(dim, config.patch_dim, bias=False, dtype=dtype)

    def _pos_embedding(self, prefix: str, x: DCTPatches) -> torch.Tensor:
        # F.embedding, not table[ids]: the same gather, but its gradient is the
        # embedding scatter-add, not the general (sorting) indexing backward
        c = F.embedding(x.patch_channels.long(), getattr(self, f"{prefix}_pos_embed_channel"))
        h = F.embedding(x.h_indices.long(), getattr(self, f"{prefix}_pos_embed_height"))
        w = F.embedding(x.w_indices.long(), getattr(self, f"{prefix}_pos_embed_width"))
        return (c + h + w).to(self.dtype)

    def _stack(self, stack: nn.Module, feats: torch.Tensor, x: DCTPatches, training=False, generator=None, row0=0):
        return stack(
            feats, x.batched_image_ids, x.key_pad_mask, self.config.attn_mask_mode, training, generator, row0=row0
        )

    def encode(
        self, x: DCTPatches, training: bool = False, generator: Optional[torch.Generator] = None,
        vq_generator: Optional[torch.Generator] = None, update_vq_stats: bool = False, shard=None,
    ):
        """Normalized patches -> (x with quantized fp32 features, codes (b, s, c),
        commit_loss, distances, vq_z); commit_loss and distances are zeros
        unless training, and distances are zeros for VQ.  vq_z is VQ's
        projection before quantization (b, s, heads, 16), None for LFQ.

        VQ only: in training, vq_generator samples the codes with gumbel
        noise (temperature 20) and update_vq_stats=True updates the EMA
        statistics (JAX: apply with rngs={'vq': key}, mutable=['vq_stats']).

        shard (parallel/mesh.py's DataShard): x is this rank's rows of a
        data-parallel batch, and the quantizer's statistics are summed over
        the shard's group, and the encoder's attention dropout draws the
        single-device mask's block of the shard's rows."""
        with obs.span("dct.model.encoder"):
            feats = self.patch_embed_norm(self.patch_embed_linear(x.patches.to(self.dtype)))
            feats = feats + self._pos_embedding("encoder", x)
            feats = self._stack(self.encoder, feats, x, training, generator, 0 if shard is None else shard.row_start)
        mask = ~x.key_pad_mask
        with obs.span("dct.model.quantize"):
            if self.config.vq_type == "vq":
                quantized, codes, commit_loss, vq_z = self.vq_model(
                    feats, mask=mask, training=training, generator=vq_generator, update_stats=update_vq_stats,
                    shard=shard,
                )
                return x.replace(patches=quantized), codes, commit_loss, quantized.new_zeros(()), vq_z
            quantized, codes, commit_loss, distances = self.vq_model(
                feats, mask=mask, training=training, group=None if shard is None else shard.group
            )
        return x.replace(patches=quantized), codes, commit_loss, distances, None

    def decode(self, x: DCTPatches) -> DCTPatches:
        """Quantized features -> DCT patch predictions (model dtype).

        Runs the decoder stack without dropout, in training too, as the JAX
        module does."""
        with obs.span("dct.model.decoder"):
            feats = x.patches.to(self.dtype) + self._pos_embedding("decoder", x)
            feats = self._stack(self.decoder, feats, x)
            return x.replace(patches=self.proj_out_linear(self.proj_out_norm(feats)))

    def decode_from_codes(self, codes: torch.Tensor, x: DCTPatches) -> DCTPatches:
        return self.decode(x.replace(patches=self.vq_model.indices_to_codes(codes)))

    def forward(
        self, x: DCTPatches, training: bool = False, generator: Optional[torch.Generator] = None,
        vq_generator: Optional[torch.Generator] = None, update_vq_stats: bool = False, shard=None,
    ) -> Dict[str, Any]:
        q, codes, commit_loss, distances, vq_z = self.encode(
            x, training, generator, vq_generator, update_vq_stats, shard
        )
        out = dict(dct_patches=self.decode(q), commit_loss=commit_loss, codes=codes, distances=distances)
        if vq_z is not None:
            out["vq_z"] = vq_z
        return out

    def vq_stats(self) -> Dict[str, torch.Tensor]:
        """VQ's EMA statistics by name (JAX: vq_stats['vq_model']); {} for LFQ."""
        return self.vq_model.stats() if self.config.vq_type == "vq" else {}


class DCTAutoencoder:
    """Module + patchnorm state with the reference's API surface."""

    def __init__(
        self,
        config: DCTAutoencoderConfig,
        patchnorm: Optional[PatchNormState] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        seed: int = 0,
    ):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            module = DCTAutoencoderModule(config, dtype)
        self.module = module.to(self.device)
        self.patchnorm = (patchnorm or PatchNormState.create(
            config.image_channels, config.max_patch_h, config.max_patch_w, config.patch_dim
        )).to(self.device)

    @property
    def n_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def normalize_(self, x: DCTPatches) -> DCTPatches:
        return x.replace(patches=apply_patchnorm(self.patchnorm, x))

    def inv_normalize_(self, x: DCTPatches) -> DCTPatches:
        return x.replace(patches=inverse_patchnorm(self.patchnorm, x))

    def forward(self, batch: DCTPatches, training: bool = False) -> Dict[str, Any]:
        """dct_patches, codes, commit_loss, distances (and vq_z for VQ).
        training=True runs the training path under autograd (VQ: the argmin,
        the statistics left as they are, as JAX's apply without an rng or
        mutable); otherwise nothing is recorded."""
        with torch.set_grad_enabled(training):
            return self.module(batch.to(self.device), training=training)

    __call__ = forward

    def encode(self, batch: DCTPatches, training: bool = False):
        """(quantized batch, codes); with training=True also (commit_loss,
        distances, vq_z).  Nothing updates the VQ statistics here (JAX: apply
        without mutable)."""
        with torch.set_grad_enabled(training):
            out = self.module.encode(batch.to(self.device), training=training)
        return out if training else out[:2]

    @torch.no_grad()
    def decode(self, batch: DCTPatches) -> DCTPatches:
        return self.module.decode(batch.to(self.device))

    @torch.no_grad()
    def decode_from_codes(self, codes: torch.Tensor, **dct_patches_kwargs) -> DCTPatches:
        x = DCTPatches(patches=torch.zeros(()), **dct_patches_kwargs).to(self.device)
        return self.module.decode_from_codes(torch.as_tensor(codes, device=self.device), x)

    def save_pretrained(self, path: str, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Write config.json, params.npz (flat '/' paths), patchnorm.npz and,
        for VQ, vq_stats.npz in the JAX package's checkpoint format, so either
        package loads it.  `state_dict` replaces the module's (the whole
        weights of a tensor-parallel or pipelined module, parallel.gather_params)."""
        from .convert import jax_arrays_from_state_dict, vq_stats_from_state_dict

        os.makedirs(path, exist_ok=True)
        self.config.to_json_file(os.path.join(path, "config.json"))
        state = self.module.state_dict() if state_dict is None else state_dict
        np.savez(os.path.join(path, "params.npz"), **jax_arrays_from_state_dict(state, self.config))
        stats = vq_stats_from_state_dict(state)
        if stats:
            np.savez(os.path.join(path, "vq_stats.npz"), **stats)
        pn = self.patchnorm
        np.savez(
            os.path.join(path, "patchnorm.npz"),
            n=pn.n.detach().cpu().numpy(), median=pn.median.detach().cpu().numpy(), b=pn.b.detach().cpu().numpy(),
        )

    @classmethod
    def from_pretrained(cls, path: str, dtype: torch.dtype = torch.float32, device="cuda") -> "DCTAutoencoder":
        """Load a checkpoint written by the JAX package's save_pretrained
        (config.json, params.npz, patchnorm.npz, and vq_stats.npz if there
        is one) through models/convert.py.  A VQ checkpoint without
        vq_stats.npz keeps the initial statistics, as in JAX."""
        from .convert import load_jax_arrays

        config = DCTAutoencoderConfig.from_json_file(os.path.join(path, "config.json"))
        model = cls(config, dtype=dtype, device=device)
        vq_path = os.path.join(path, "vq_stats.npz")
        load_jax_arrays(
            model.module, os.path.join(path, "params.npz"), config, vq_path if os.path.exists(vq_path) else None
        )
        pn_path = os.path.join(path, "patchnorm.npz")
        if os.path.exists(pn_path):
            model.patchnorm = PatchNormState.load(pn_path, model.device)
        return model
