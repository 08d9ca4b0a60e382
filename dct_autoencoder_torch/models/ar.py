"""Autoregressive model over DCT token records: the downstream the tokenizer exists for.

Counterpart of dct_autoencoder_tpu/models/ar.py.  Each timestep is one
tokenizer token: its LFQ codebook indices plus its (channel, row, col) grid
position.  The model conditions on the position layout (known at decode
time from the record being completed) and predicts the code indices:

  logits_t = f(codes_<t, positions_<=t)          # teacher-forced training
  p(codes_t) = prod_c softmax(logits_t[c])       # independent per codebook

The stack is the tokenizer's TransformerEncoder with causal + block masking,
so packed rows of several images work unchanged.  Every full-sequence
attention goes through kernels/attention.py (the causal mode of the CUDA
kernels on the card, their plain versions on the CPU); ``attention_impl`` is
read from the config, kept and ignored.

Where the JAX functions take ``(config, params)`` these take the
``ARTokenModel``, which holds both.  Random draws take an explicit
``torch.Generator`` on the model's device, never the global one; ``fold_in``
derives the generator of one row of a batch.  JAX's and torch's random
streams differ, so only temperature-0 samples are comparable between the
two packages.

Sampling.  ``sample_codes`` re-runs the whole prefix for every token (the
demonstration path).  ``sample_codes_cached`` takes one KV-cached decode step
per token, each step launched from the host.  ``sample_codes_scan`` and
``sample_codes_scan_batched`` are the serving samplers: the JAX package puts
the whole loop into one ``lax.scan`` program; here one decode step
(embedding, every layer against the cache, the draw, prefix forcing, the
write of the token) is captured once in a CUDA graph and replayed s times,
with the step index, the cache index and the prefix lengths as device
tensors, so no token costs a host round trip.  The uniform noise of a step
is drawn from the generators into a static buffer just before the replay,
outside the graph, so all samplers consume their generators alike and give
the same codes bit for bit from the same logits.  A captured runner, with
its graph and its static cache buffers, is kept in a bounded cache keyed by
everything that changes the program.  On a CPU model the same loop runs
eagerly.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .autoencoder import resolve_device
from .config import TransformerConfig
from .transformer import Dense, KVCache, LayerNorm, TransformerEncoder


@dataclasses.dataclass
class ARConfig:
    codebook_size: int = 8192
    num_codebooks: int = 16
    image_channels: int = 3
    max_patch_h: int = 32
    max_patch_w: int = 32
    transformer: TransformerConfig = dataclasses.field(
        default_factory=lambda: TransformerConfig(
            hidden_size=512, intermediate_size=2048, num_hidden_layers=6, num_attention_heads=8,
        )
    )
    # kept so that a config round-trips; the port has one attention path
    attention_impl: str = "auto"

    def __post_init__(self):
        if isinstance(self.transformer, dict):
            self.transformer = TransformerConfig.from_dict(self.transformer)

    @classmethod
    def from_dict(cls, d: dict) -> "ARConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict:
        """The JAX package's ar_config.json: plain dataclass fields, nothing added."""
        return dataclasses.asdict(self)


class ARTokenModel(nn.Module):
    """Decoder-only transformer over token records.  Parameters are fp32
    masters; `dtype` is the compute type of the stack and the head."""

    def __init__(self, config: ARConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        h = config.transformer.hidden_size
        emb = lambda *shape: nn.Parameter(torch.randn(*shape) * 0.02)
        # one embedding table per codebook (indices are per-codebook spaces)
        self.code_embed = emb(config.num_codebooks, config.codebook_size, h)
        self.pos_embed_channel = emb(config.image_channels, h)
        self.pos_embed_height = emb(config.max_patch_h, h)
        self.pos_embed_width = emb(config.max_patch_w, h)
        self.bos = emb(h)
        self.decoder = TransformerEncoder(config.transformer, dtype)
        self.out_norm = LayerNorm(h, 1e-6)
        self.head = Dense(h, config.num_codebooks * config.codebook_size, bias=False, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.bos.device

    def _embed_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(..., C) indices -> (..., h): per-codebook gathers, summed in the compute type.

        One gather from the (C * z, h) view of the tables with codebook c's
        indices moved by c * z.  F.embedding, not table[ids]: its gradient is
        the embedding scatter-add, not the sorting indexing backward."""
        C, z, h = self.code_embed.shape
        offsets = torch.arange(C, device=codes.device) * z
        e = F.embedding(codes + offsets, self.code_embed.reshape(C * z, h))  # (..., C, h)
        return e.to(self.dtype).sum(dim=-2)

    def _pos(self, channels: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return (
            F.embedding(channels, self.pos_embed_channel)
            + F.embedding(positions[..., 0], self.pos_embed_height)
            + F.embedding(positions[..., 1], self.pos_embed_width)
        ).to(self.dtype)

    def forward(
        self,
        codes: torch.Tensor,  # (b, s, C) int indices
        channels: torch.Tensor,  # (b, s)
        positions: torch.Tensor,  # (b, s, 2)
        key_pad_mask: torch.Tensor,  # (b, s) True where padding
        image_ids: Optional[torch.Tensor] = None,  # (b, s) packed-image ids
        training: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Teacher-forced logits (b, s, C, codebook_size) in fp32 for every position."""
        b, s, C = codes.shape
        codes, channels, positions = codes.long(), channels.long(), positions.long()
        x = self._embed_codes(codes)
        # shift right: position t sees codes < t and its own position
        # embedding.  BOS at t = 0 and at every packed-image boundary: the
        # block mask restricts what t attends to, not t's own input, so
        # without it the first token of image k > 0 would be conditioned on
        # the last codes of image k - 1, which sampling never is
        ids = image_ids if image_ids is not None else torch.zeros((b, s), dtype=torch.int32, device=codes.device)
        shifted = torch.cat([x.new_zeros((b, 1, x.shape[-1])), x[:, :-1]], dim=1)
        boundary = torch.cat([ids.new_ones((b, 1), dtype=torch.bool), ids[:, 1:] != ids[:, :-1]], dim=1)
        x = torch.where(boundary[..., None], self.bos.to(self.dtype), shifted)
        x = x + self._pos(channels, positions)
        x = self.decoder(x, ids, key_pad_mask, "block", training, generator, causal=True)
        logits = self.head(self.out_norm(x))
        return logits.reshape(b, s, C, self.config.codebook_size).float()

    def decode_step(
        self,
        prev_codes: torch.Tensor,  # (b, 1, C) codes at t - 1 (ignored at t = 0)
        channel: torch.Tensor,  # (b, 1) target-position channel at t
        position: torch.Tensor,  # (b, 1, 2) target grid position at t
        t: torch.Tensor,  # 0-d step index, on the model's device
        cache: KVCache,
    ) -> torch.Tensor:
        """One KV-cached decode step -> logits (b, C, codebook_size) in fp32.

        `cache` holds the keys and values of steps < t and is advanced in
        place.  Nothing here reads a device value on the host."""
        b = prev_codes.shape[0]
        x = self._embed_codes(prev_codes.long())
        x = torch.where(t == 0, self.bos.to(self.dtype), x)
        x = x + self._pos(channel.long(), position.long())
        x = self.decoder.decode_step(x, cache)
        logits = self.head(self.out_norm(x))
        return logits.reshape(b, self.config.num_codebooks, self.config.codebook_size).float()


def build_ar_model(config: ARConfig, dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0) -> ARTokenModel:
    """A randomly initialised (seeded) model for `config` on `device`."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ARTokenModel(config, dtype)
    return model.to(device)


def ar_loss(logits: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over valid tokens and codebooks."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.gather(logp, -1, codes.long()[..., None])[..., 0]  # (b, s, C)
    num = -(tgt * valid[..., None]).sum()
    return num / torch.clamp(valid.sum() * codes.shape[-1], min=1)


# ---------------------------------------------------------------- sampling


def fold_in(generator: torch.Generator, row: int) -> torch.Generator:
    """The generator of one row of a batch, a function of `generator`'s seed
    and the row alone (it neither reads nor advances `generator`'s state)."""
    seed = (generator.initial_seed() * 1000003 + row + 1) % (2**63 - 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _layout(model: ARTokenModel, channels, positions):
    dev = model.device
    return torch.as_tensor(channels, device=dev).long(), torch.as_tensor(positions, device=dev).long()


def _draw(logits: torch.Tensor, noise: Optional[torch.Tensor], temperature: float) -> torch.Tensor:
    """(..., C, z) logits -> (..., C) indices: argmax at temperature <= 0, else
    a categorical draw by the Gumbel maximum over uniform `noise` in [0, 1)."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    return (logits / temperature - torch.log(-torch.log(noise))).argmax(dim=-1)


def _need_generators(generators, temperature: float) -> None:
    if temperature > 0 and any(g is None for g in generators):
        raise ValueError("sampling at temperature > 0 draws from an explicit torch.Generator: pass one")


@torch.no_grad()
def sample_codes(
    model: ARTokenModel,
    channels,  # (1, s) target layout
    positions,  # (1, s, 2)
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
) -> torch.Tensor:
    """Sample a code sequence (1, s, C) for a given position layout.

    Greedy at temperature 0.  Every token re-runs the full prefix through
    the causal attention kernel: the demonstration path, not a serving
    engine."""
    channels, positions = _layout(model, channels, positions)
    s = channels.shape[1]
    C, z = model.config.num_codebooks, model.config.codebook_size
    codes = torch.zeros((1, s, C), dtype=torch.long, device=model.device)
    pad = torch.zeros((1, s), dtype=torch.bool, device=model.device)
    noise = torch.empty((C, z), device=model.device) if temperature > 0 else None
    _need_generators([generator], temperature)
    for t in range(s):
        if noise is not None:
            noise.uniform_(generator=generator)
        logits = model(codes, channels, positions, pad, training=False)
        codes[0, t] = _draw(logits[0, t], noise, temperature)
    return codes.to(torch.int32)


class DecodeLoop:
    """The KV-cached decode loop for one (model, s, temperature, batch): the
    static buffers a step reads and writes, and on a CUDA model with
    ``capture=True`` the CUDA graph of one step.

    A step takes no argument: it reads the step index, the layouts, the
    prefix, the previous token and the noise from the buffers, and leaves the
    token in `out`, the cache and the index advanced.  `captures` counts the
    graph captures made (at most one)."""

    def __init__(self, model: ARTokenModel, s: int, temperature: float, batch: int, capture: bool):
        cfg, dev = model.config, model.device
        C, z = cfg.num_codebooks, cfg.codebook_size
        self.model, self.s, self.temperature, self.batch = model, s, float(temperature), batch
        long = dict(dtype=torch.long, device=dev)
        self.cache = KVCache(cfg.transformer, batch, s, model.dtype, dev)
        self.t = torch.zeros((), **long)
        self.prev = torch.zeros((batch, 1, C), **long)
        self.channels = torch.zeros((batch, s), **long)
        self.positions = torch.zeros((batch, s, 2), **long)
        self.prefix_codes = torch.zeros((batch, s, C), **long)
        self.prefix_lens = torch.zeros((batch,), **long)
        self.out = torch.zeros((batch, s, C), **long)
        self.noise = torch.full((batch, C, z), 0.5, device=dev) if temperature > 0 else None
        self.graph = None
        self.captures = 0
        if capture and dev.type == "cuda":
            self._capture()

    def _rewind(self) -> None:
        self.cache.reset()
        self.t.zero_()
        self.prev.zero_()

    @torch.no_grad()
    def _step(self) -> None:
        at = self.t.reshape(1)
        logits = self.model.decode_step(
            self.prev, self.channels.index_select(1, at), self.positions.index_select(1, at), self.t, self.cache
        )
        nxt = _draw(logits, self.noise, self.temperature)  # (b, C)
        # a token before its row's prefix length is forced: it is what feeds the next step
        forced = self.prefix_codes.index_select(1, at)[:, 0]
        nxt = torch.where((self.t < self.prefix_lens)[:, None], forced, nxt)
        self.out.index_copy_(1, at, nxt[:, None])
        self.prev.copy_(nxt[:, None])
        self.t += 1

    @torch.no_grad()
    def _capture(self) -> None:
        # warm up on a side stream, as torch.cuda.graph asks, so that lazy
        # initialisation (cuBLAS handles, workspaces) is not part of the capture
        side = torch.cuda.Stream(device=self.model.device)
        side.wait_stream(torch.cuda.current_stream(self.model.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._rewind()
                self._step()
        torch.cuda.current_stream(self.model.device).wait_stream(side)
        self._rewind()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step()
        self.captures += 1

    @torch.no_grad()
    def run(self, channels, positions, generators: Sequence[Optional[torch.Generator]], prefix_codes=None, prefix_lens=None):
        """(b, s) layouts -> sampled codes (b, s, C) int32; one generator per row."""
        channels, positions = _layout(self.model, channels, positions)
        if tuple(channels.shape) != (self.batch, self.s) or len(generators) != self.batch:
            raise ValueError(f"this loop takes {(self.batch, self.s)} layouts and {self.batch} generators")
        _need_generators(generators, self.temperature)
        dev = self.model.device
        self.channels.copy_(channels)
        self.positions.copy_(positions)
        if prefix_codes is None:
            self.prefix_codes.zero_()
        else:
            self.prefix_codes.copy_(torch.as_tensor(prefix_codes, device=dev))
        if prefix_lens is None:
            self.prefix_lens.zero_()
        else:
            self.prefix_lens.copy_(torch.as_tensor(prefix_lens, device=dev).reshape(self.batch))
        self._rewind()
        for _ in range(self.s):
            if self.noise is not None:
                for row, g in enumerate(generators):
                    self.noise[row].uniform_(generator=g)
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
        return self.out.to(torch.int32)


def sample_codes_cached(
    model: ARTokenModel,
    channels,  # (1, s) target layout
    positions,  # (1, s, 2)
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
) -> torch.Tensor:
    """KV-cached sampling: one decode step per token instead of
    sample_codes' full-prefix re-forward, every step launched from the host.
    Same codes as sample_codes from the same generator (tested)."""
    s = np.shape(channels)[1]
    return DecodeLoop(model, s, temperature, 1, capture=False).run(channels, positions, [generator])


# Bounded LRU: each entry holds a captured graph, its private memory pool and
# the static KV cache of one shape, and keeps its model alive, so a cache
# keyed on client-chosen (temperature, s, batch) must not grow with every
# distinct value.  8 entries cover a serving bucket ladder.
_SCAN_RUNNERS_MAX = 8
_SCAN_RUNNERS: Dict[tuple, DecodeLoop] = {}  # insertion-ordered; oldest evicted first


def _scan_runner(model: ARTokenModel, s: int, temperature: float, batch: int) -> DecodeLoop:
    """The cached decode loop for one (config, seq_len, temperature, batch)
    of one model: built (and on the card captured) once, re-used by every
    later call at that shape."""
    # round the temperature so float jitter (a client sending 0.70000001)
    # cannot mint a new program; serving layers should also bucket s.  The
    # model's identity, device and type are part of the key because the
    # graph holds the addresses of its parameters; the entry keeps the model
    # alive, so its id cannot be re-used while the entry exists
    key = (repr(model.config), s, round(float(temperature), 6), batch, id(model), str(model.device), model.dtype)
    hit = _SCAN_RUNNERS.get(key)
    if hit is not None:
        _SCAN_RUNNERS[key] = _SCAN_RUNNERS.pop(key)  # refresh LRU order
        return hit
    loop = DecodeLoop(model, s, temperature, batch, capture=True)
    while len(_SCAN_RUNNERS) >= _SCAN_RUNNERS_MAX:
        _SCAN_RUNNERS.pop(next(iter(_SCAN_RUNNERS)))
    _SCAN_RUNNERS[key] = loop
    return loop


def sample_codes_scan(
    model: ARTokenModel,
    channels,  # (1, s) target layout
    positions,  # (1, s, 2)
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    prefix_codes=None,  # (1, s, C)
    prefix_len: int = 0,
) -> torch.Tensor:
    """KV-cached sampling with the decode step captured as device work: the
    serving sampler.

    prefix_codes + prefix_len force the first prefix_len tokens (teacher-
    forced conditioning) and sample the continuation; the prefix length is a
    device tensor, so any length re-uses the same captured step.  The runner
    is cached per (config, s, temperature, batch, model): serving layers
    must bucket s and quantize temperature, or every distinct value pays a
    fresh capture when it falls out of the 8-entry window."""
    s = np.shape(channels)[1]
    loop = _scan_runner(model, s, temperature, batch=1)
    return loop.run(channels, positions, [generator], prefix_codes, [prefix_len])


def sample_codes_scan_batched(
    model: ARTokenModel,
    channels,  # (b, s) per-image target layouts (same s bucket)
    positions,  # (b, s, 2)
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    generators: Optional[Sequence[torch.Generator]] = None,  # one per row
    prefix_codes=None,  # (b, s, C)
    prefix_lens=None,  # (b,)
) -> torch.Tensor:
    """Batched sampling of b independent layouts in one loop.

    Each row draws from its own generator (``fold_in(generator, row)``, or
    the explicit per-row `generators`: a serving batcher passes one per
    request, so a request's draw does not depend on the batch it landed in)
    and has its own rows of the KV cache.  Row i equals
    ``sample_codes_scan(..., fold_in(generator, i))`` wherever the batched
    and the single-row products give the same logits bit for bit (fp32 on
    the CPU: tested); in bf16 on the card a near-tie may fall the other way."""
    b, s = np.shape(channels)
    if generators is None:
        generators = [None if generator is None else fold_in(generator, row) for row in range(b)]
    loop = _scan_runner(model, s, temperature, batch=b)
    return loop.run(channels, positions, list(generators), prefix_codes, prefix_lens)


def canonical_layout(
    config: ARConfig,
    n_tokens: int,
    patch_h: Optional[int] = None,
    patch_w: Optional[int] = None,
    channel_importances=(8.0, 1.0, 1.0),
):
    """Static coarse-to-fine token layout for unconditional generation.

    Orders the (channel, row, col) grid by the static part of the
    extractor's importance score, -(h + w) / importance(c), descending, ties
    broken by (c, h, w).  Returns (channels (1, n), positions (1, n, 2))
    int32 numpy arrays ready for sample_codes_scan."""
    ph = patch_h or config.max_patch_h
    pw = patch_w or config.max_patch_w
    nc = config.image_channels
    ci = np.asarray(channel_importances[:nc], np.float64)
    cs, hs, ws = np.meshgrid(np.arange(nc), np.arange(ph), np.arange(pw), indexing="ij")
    cs, hs, ws = cs.ravel(), hs.ravel(), ws.ravel()
    score = -(hs + ws) / ci[cs]
    # primary: score descending; ties: (c, h, w) ascending (lexsort keys minor -> major)
    order = np.lexsort((ws, hs, cs, -score))
    if n_tokens > order.size:
        raise ValueError(f"{n_tokens} tokens asked of a grid of {order.size}")
    order = order[:n_tokens]
    channels = cs[order][None].astype(np.int32)
    positions = np.stack([hs[order], ws[order]], axis=-1)[None].astype(np.int32)
    return channels, positions


# ---------------------------------------------------------------- checkpoints


def save_ar_model(path: str, model: ARTokenModel) -> None:
    """Write ar_config.json + ar_params.npz in the JAX package's format
    (flat '/'-joined flax paths), so either package loads the checkpoint."""
    from .convert import jax_arrays_from_state_dict

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "ar_config.json"), "w") as f:
        json.dump(model.config.to_dict(), f, indent=2)
    np.savez(os.path.join(path, "ar_params.npz"), **jax_arrays_from_state_dict(model.state_dict(), model.config))


def load_ar_model(path: str, dtype: torch.dtype = torch.float32, device="cuda") -> ARTokenModel:
    """Inverse of save_ar_model, also for a checkpoint the JAX package wrote:
    the model (its config is ``model.config``) on `device`."""
    from .convert import state_dict_from_jax_npz

    device = resolve_device(device)
    with open(os.path.join(path, "ar_config.json")) as f:
        config = ARConfig.from_dict(json.load(f))
    with torch.device("meta"):
        model = ARTokenModel(config, dtype)
    model.load_state_dict(state_dict_from_jax_npz(os.path.join(path, "ar_params.npz"), config), assign=True)
    return model.to(device)
