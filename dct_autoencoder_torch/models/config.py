"""Model configuration, JSON-compatible with the JAX package's config.

Nested `encoder_config` / `decoder_config` blocks use CLIPVisionConfig
field names, so conf/*.json and saved checkpoints load unchanged.
`sequence_parallel` acts under tensor parallelism (models/transformer.py,
parallel/mesh.py); `attention_impl` is kept so a config round-trips, and the
port runs its attention kernel on the card whatever it says.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class TransformerConfig:
    """CLIP-vision-style transformer stack config (subset of CLIPVisionConfig)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    dropout: float = 0.0
    attention_dropout: float = 0.0
    remat: bool = False
    sequence_parallel: bool = False
    quantize_int8: bool = False
    quantize_int8_mode: str = "weight_only"
    quantize_int8_bf16_layers: tuple = ()
    quantize_int8_group_size: int = 0

    def __post_init__(self):
        self.quantize_int8_bf16_layers = tuple(self.quantize_int8_bf16_layers)

    @classmethod
    def from_dict(cls, d: dict) -> "TransformerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_type"] = "clip_vision_model"
        return d


@dataclasses.dataclass
class DCTAutoencoderConfig:
    image_channels: int = 3
    patch_size: int = 16
    max_patch_h: int = 32
    max_patch_w: int = 32
    vq_codebook_size: int = 4096
    # codes per patch
    vq_num_codebooks: int = 8
    # 'lfq' (the port has no 'vq' yet)
    vq_type: str = "lfq"
    encoder_config: TransformerConfig = dataclasses.field(default_factory=TransformerConfig)
    decoder_config: TransformerConfig = dataclasses.field(default_factory=TransformerConfig)
    # 'block': packed block-diagonal mask; 'bias': +1 logit inside the block
    # (the reference's effective behaviour)
    attn_mask_mode: str = "block"
    attention_impl: str = "auto"

    def __post_init__(self):
        if isinstance(self.encoder_config, dict):
            self.encoder_config = TransformerConfig.from_dict(self.encoder_config)
        if isinstance(self.decoder_config, dict):
            self.decoder_config = TransformerConfig.from_dict(self.decoder_config)

    @property
    def patch_dim(self) -> int:
        return self.patch_size**2

    @classmethod
    def from_dict(cls, d: dict) -> "DCTAutoencoderConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str) -> "DCTAutoencoderConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["encoder_config"] = self.encoder_config.to_dict()
        d["decoder_config"] = self.decoder_config.to_dict()
        return d

    def to_json_file(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)


def with_sequence_parallel(cfg: DCTAutoencoderConfig) -> DCTAutoencoderConfig:
    """The config with Megatron sequence parallelism on in both transformer
    stacks (JAX: models/config.py's with_sequence_parallel)."""
    return dataclasses.replace(
        cfg,
        encoder_config=dataclasses.replace(cfg.encoder_config, sequence_parallel=True),
        decoder_config=dataclasses.replace(cfg.decoder_config, sequence_parallel=True),
    )
