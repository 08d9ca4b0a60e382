"""Classic vector quantization (the `vq_type='vq'` option), and its codebook surgery.

Counterpart of the JAX package's models/vq.py.  The reference instantiates
vector-quantize-pytorch's VectorQuantize with kmeans_init=True,
sample_codebook_temp=20, codebook_dim=16, learnable_codebook=True,
affine_param=True, ema_update=False, threshold_ema_dead_code=15; the model
builds it so (models/autoencoder.py).

  * Distances are JAX's: ``x2 + c2 - 2 x.C^T`` in fp32 (no torch.cdist),
    and ties go to the first index, as jnp.argmin gives them.  They only
    choose the ids (nothing differentiates them), so they are computed
    without autograd, a chunk of tokens at a time: at the full width of
    patch14-L (16,384 tokens x 16 heads x 8192 codes) the whole tensor
    would be 8.6 GB, and the gumbel noise as much again.  Each token is
    independent, so chunking gives the same ids (given the same gumbel
    noise: the draws follow the chunks' order).
  * The projections and the codebook run in fp32 whatever the model's type.
  * The EMA statistics that JAX keeps in its 'vq_stats' collection are
    buffers of this module, under the same names (`batch_mean`,
    `batch_variance`, `codebook_mean`, `codebook_variance`, `cluster_size`;
    `embed`, `embed_avg`, `ema_cluster_size` in the EMA-codebook mode).
    With `update_stats=True` in training they are updated as JAX's mutable
    apply updates them: the new affine statistics are autograd tensors of
    the encoder output and the codebook, used by this same forward (so
    gradient flows through them, as in JAX), and detached copies are
    stored.
  * Gumbel sampling (temperature `sample_codebook_temp`) draws from an
    explicit torch.Generator; without one the ids are the argmin.
  * The codebook surgery is functional, as in JAX: k-means init from a
    batch and dead-code expiry take their random draws as arguments (made
    by `draw_*` from a generator, or handed in, e.g. JAX's own draws in a
    test), so the arithmetic is separate from the stream.

Under data parallelism (JAX's `sync_axis`; here the `shard` that the
sharded step passes, parallel/mesh.py's DataShard) the affine statistics'
sums and counts, the EMA code usage and the EMA codebook's bins and sums are
summed over the data group, differentiably where JAX differentiates them,
and gumbel sampling
gives each rank's rows the noise that one process draws for those rows (the
draws of the whole micro-batch, sliced).  The surgery gathers the
projections of the whole batch (train/loop.py) and draws as one process
does.  The standalone `ema_codebook_update` takes the group as an argument.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import obs
from ..ops.stats import group_size, group_sum, group_sum_grad, masked_mean

# elements of one chunk of distances (and of gumbel noise): 2^27 fp32 = 512 MiB
_CHUNK_ELEMENTS = 1 << 27

AFFINE_STATS = ("batch_mean", "batch_variance", "codebook_mean", "codebook_variance")
EMA_STATS = ("embed", "embed_avg", "ema_cluster_size")
STAT_NAMES = AFFINE_STATS + ("cluster_size",) + EMA_STATS


def euclidean_sq_dist(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., d) x, (z, d) codebook -> (..., z) squared distances, fp32, as JAX writes them."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(codebook * codebook, dim=-1)
    xc = torch.matmul(x, codebook.T)
    return x2 + c2 - 2.0 * xc


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard gumbel noise, -log(-log(u)) with u uniform in [tiny, 1), as
    jax.random.gumbel makes it."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def choose_codes(
    z: torch.Tensor, codebook: torch.Tensor, temperature: float = 0.0,
    generator: Optional[torch.Generator] = None, shard=None,
) -> torch.Tensor:
    """Ids (b, n, h) of z (b, n, h, d) against a shared (z, d) or per-head
    (h, z, d) codebook: the argmin of the squared distances, or with a
    generator and temperature > 0 the argmax of -dist / temperature + gumbel.
    Computed a chunk of tokens at a time: 512 MiB of distances.

    Sampling with a `shard` (parallel/mesh.py's DataShard: z holds rows
    [row_start, row_start + b) of a micro-batch of total_rows) draws the
    noise of every chunk of the whole micro-batch up to this rank's last
    row, chunk by chunk as one process does, and uses the slice of this
    rank's tokens."""
    b, n, h, d = z.shape
    zsize = codebook.shape[-2]
    flat = z.reshape(b * n, h, d).float()
    cb = codebook.float()
    c2 = torch.sum(cb * cb, dim=-1)  # (z,) or (h, z)
    token_chunk = max(1, _CHUNK_ELEMENTS // (h * zsize))
    sample = generator is not None and temperature > 0.0
    out = torch.empty((b * n, h), dtype=torch.int64, device=z.device)

    def ids(x, noise):
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        if cb.ndim == 2:
            xc = torch.matmul(x, cb.T)
        else:
            xc = torch.einsum("thd,hzd->thz", x, cb)
        dists = x2 + c2 - 2.0 * xc
        if noise is None:
            return torch.argmin(dists, dim=-1)
        return torch.argmax(-dists / temperature + noise, dim=-1)

    shard = shard if sample else None
    lo, total = (shard.row_start * n, shard.total_rows * n) if shard is not None else (0, b * n)
    for s in range(0, min(total, lo + b * n), token_chunk):
        e = min(s + token_chunk, total)
        noise = _gumbel((e - s, h, zsize), generator, z.device) if sample else None
        a, c = max(s, lo), min(e, lo + b * n)  # this rank's tokens of the chunk
        if a < c:
            out[a - lo : c - lo] = ids(flat[a - lo : c - lo], None if noise is None else noise[a - s : c - s])
    return out.reshape(b, n, h)


def _gather_codes(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(..., h) ids -> (..., h, d) rows of a shared (z, d) or per-head (h, z, d) codebook."""
    if codebook.ndim == 2:
        return codebook[indices]
    heads = torch.arange(codebook.shape[0], device=indices.device)
    return codebook[heads, indices]


def code_bins(indices: torch.Tensor, mask: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """(h, z) fp32 counts of each head's ids over the valid tokens (exact:
    sums of 1.0, as JAX's one-hot sum)."""
    h = indices.shape[-1]
    ids = (indices + torch.arange(h, device=indices.device) * codebook_size)[mask]
    bins = torch.zeros(h * codebook_size, dtype=torch.float32, device=indices.device)
    bins.index_add_(0, ids.reshape(-1), torch.ones(ids.numel(), dtype=torch.float32, device=indices.device))
    return bins.reshape(h, codebook_size)


class VectorQuantize(nn.Module):
    def __init__(
        self,
        dim: int,
        codebook_size: int,
        heads: int = 1,
        codebook_dim: int = 16,
        use_cosine_sim: bool = False,
        sample_codebook_temp: float = 0.0,
        commitment_weight: float = 1.0,
        codebook_weight: float = 1.0,
        separate_codebook_per_head: bool = False,
        affine_param: bool = False,
        affine_param_batch_decay: float = 0.99,
        affine_param_codebook_decay: float = 0.9,
        kmeans_init: bool = False,
        threshold_ema_dead_code: float = 0.0,
        ema_cluster_decay: float = 0.8,
        ema_update: bool = False,
        ema_decay: float = 0.8,
        ema_eps: float = 1e-5,
        orthogonal_reg_weight: float = 0.0,
    ):
        super().__init__()
        self.dim, self.codebook_size, self.heads, self.codebook_dim = dim, codebook_size, heads, codebook_dim
        self.use_cosine_sim = use_cosine_sim
        self.sample_codebook_temp = sample_codebook_temp
        self.commitment_weight, self.codebook_weight = commitment_weight, codebook_weight
        self.separate_codebook_per_head = separate_codebook_per_head
        self.affine_param = affine_param
        self.affine_param_batch_decay = affine_param_batch_decay
        self.affine_param_codebook_decay = affine_param_codebook_decay
        self.kmeans_init = kmeans_init
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.ema_cluster_decay = ema_cluster_decay
        self.ema_update, self.ema_decay, self.ema_eps = ema_update, ema_decay, ema_eps
        self.orthogonal_reg_weight = orthogonal_reg_weight

        inner = codebook_dim * heads
        self.project_in = nn.Linear(dim, inner)
        self.project_out = nn.Linear(inner, dim)
        cb_shape = (heads, codebook_size, codebook_dim) if separate_codebook_per_head else (codebook_size, codebook_dim)
        if ema_update:
            embed = torch.randn(cb_shape)
            self.register_buffer("embed", embed)
            self.register_buffer("embed_avg", embed.clone())
            self.register_buffer("ema_cluster_size", torch.zeros(cb_shape[:-1]))
        else:
            self.codebook = nn.Parameter(torch.randn(cb_shape))
        if affine_param:
            d = codebook_dim
            self.register_buffer("batch_mean", torch.zeros(d))
            self.register_buffer("batch_variance", torch.ones(d))
            self.register_buffer("codebook_mean", torch.zeros(d))
            self.register_buffer("codebook_variance", torch.ones(d))
        if threshold_ema_dead_code > 0:
            self.register_buffer("cluster_size", torch.zeros(cb_shape[:-1]))

    # ------------------------------------------------------------- state

    def codebook_value(self) -> torch.Tensor:
        return self.embed if self.ema_update else self.codebook

    def stats(self) -> Dict[str, torch.Tensor]:
        """The buffers that JAX keeps in 'vq_stats/vq_model', by name."""
        return {k: v for k, v in self.named_buffers() if k in STAT_NAMES}

    def _normed_codebook(self, stats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The codebook after the affine transform (and cosine normalisation),
        from `stats` (new, differentiable values in training) or the buffers."""
        cb = self.codebook_value()
        if self.affine_param:
            s = stats if stats is not None else self.stats()
            eps = 1e-5
            cb_std = torch.sqrt(s["codebook_variance"] + eps)
            b_std = torch.sqrt(s["batch_variance"] + eps)
            cb = (cb - s["codebook_mean"]) / cb_std * b_std + s["batch_mean"]
        if self.use_cosine_sim:
            cb = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-8)
        return cb

    def _new_affine_stats(self, z: torch.Tensor, mask: torch.Tensor, group=None) -> Dict[str, torch.Tensor]:
        """EMA of the codebook's statistics (from the raw codebook), then of
        the batch's (from the masked encoder outputs, summed over `group`),
        as autograd tensors.  Variances are population variances (ddof 0),
        as JAX's."""

        def ema(old, new, decay):
            return old * decay + new.float() * (1 - decay)

        cb = self.codebook_value().reshape(-1, self.codebook_dim)
        cdec, bdec = self.affine_param_codebook_decay, self.affine_param_batch_decay
        out = {
            "codebook_mean": ema(self.codebook_mean, cb.mean(dim=0), cdec),
            "codebook_variance": ema(self.codebook_variance, cb.var(dim=0, correction=0), cdec),
        }
        m = mask[..., None, None].float()  # (b, n, 1, 1)
        denom = torch.clamp(group_sum(m.sum(), group) * self.heads, min=1.0)
        z32 = z.float()
        mean = group_sum_grad((z32 * m).sum(dim=(0, 1, 2)), group) / denom
        vsum = group_sum_grad((((z32 - mean) ** 2) * m).sum(dim=(0, 1, 2)), group)
        out["batch_mean"] = ema(self.batch_mean, mean, bdec)
        out["batch_variance"] = ema(self.batch_variance, vsum / denom, bdec)
        return out

    @torch.no_grad()
    def _update_cluster_size(self, indices: torch.Tensor, mask: torch.Tensor, group=None) -> None:
        """EMA code usage over the valid tokens (it feeds dead-code expiry)."""
        bins = code_bins(indices, mask, self.codebook_size)
        if not self.separate_codebook_per_head:
            bins = bins.sum(dim=0)  # a shared codebook counts every head
        bins = group_sum(bins, group)
        d = self.ema_cluster_decay
        self.cluster_size.copy_(self.cluster_size * d + bins * (1 - d))

    @torch.no_grad()
    def _ema_update_codebook(self, z: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor, group=None) -> None:
        """EMA codebook step (ema_update=True): cluster sizes and per-code
        sums of the assigned encoder outputs decay toward the batch's; the
        embed is their Laplace-smoothed ratio."""
        h, zs, d = self.heads, self.codebook_size, self.codebook_dim
        bins = code_bins(indices, mask, zs)  # (h, z)
        ids = (indices + torch.arange(h, device=indices.device) * zs)[mask].reshape(-1)
        sums = torch.zeros(h * zs, d, dtype=torch.float32, device=z.device)
        sums.index_add_(0, ids, z.float()[mask].reshape(-1, d))
        sums = sums.reshape(h, zs, d)
        if not self.separate_codebook_per_head:
            bins, sums = bins.sum(dim=0), sums.sum(dim=0)
        bins, sums = group_sum(bins, group), group_sum(sums, group)
        dec = self.ema_decay
        cluster = self.ema_cluster_size * dec + bins * (1 - dec)
        embed_avg = self.embed_avg * dec + sums * (1 - dec)
        n = cluster.sum(dim=-1, keepdim=True)
        smoothed = (cluster + self.ema_eps) / (n + zs * self.ema_eps) * n
        self.ema_cluster_size.copy_(cluster)
        self.embed_avg.copy_(embed_avg)
        self.embed.copy_(embed_avg / torch.clamp(smoothed[..., None], min=1e-9))

    # ----------------------------------------------------------- forward

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """(..., h) ids -> (..., dim) decoded fp32 features."""
        codes = _gather_codes(self._normed_codebook(), indices.long())
        return self.project_out(codes.reshape(*codes.shape[:-2], self.heads * self.codebook_dim))

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        update_stats: bool = False,
        shard=None,
    ):
        """x: (b, n, dim); mask: (b, n) bool, False where padding; with a
        `shard` (parallel/mesh.py's DataShard) x is this rank's rows of a
        data-parallel micro-batch.

        Returns (quantized (b, n, dim) fp32, ids (b, n, heads) int64, loss
        scalar (0 unless training), z (b, n, heads, codebook_dim), the
        projections before quantization, which feed the surgery).

        update_stats=True (with training) updates the EMA statistics, as
        JAX's apply with mutable=['vq_stats']; a generator (with training)
        samples the ids with gumbel noise at sample_codebook_temp."""
        b, n, _ = x.shape
        h, d = self.heads, self.codebook_dim
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
        z = self.project_in(x.float()).reshape(b, n, h, d)
        if self.use_cosine_sim:
            z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)

        group = None if shard is None else shard.group
        updating = training and update_stats
        new_stats = self._new_affine_stats(z, mask, group) if updating and self.affine_param else None
        codebook = self._normed_codebook(new_stats)
        temperature = self.sample_codebook_temp if training else 0.0
        with obs.span("dct.vq.choose"):
            indices = choose_codes(z, codebook, temperature, generator, shard)

        if new_stats is not None:
            with torch.no_grad():
                for k, v in new_stats.items():
                    getattr(self, k).copy_(v)
        if updating and self.threshold_ema_dead_code > 0:
            self._update_cluster_size(indices, mask, group)
        if updating and self.ema_update:
            self._ema_update_codebook(z.detach(), indices, mask, group)

        quantized = _gather_codes(codebook, indices)  # (b, n, h, d)
        if training:
            with obs.span("dct.loss.commit"):
                # commitment: pull the encoder output toward the frozen codes
                commit = masked_mean((z - quantized.detach()) ** 2, mask, dim=0, group=group).sum(dim=0).mean()
                loss = self.commitment_weight * commit
                if not self.ema_update:
                    # codebook: pull the codes toward the frozen encoder output
                    cb_loss = masked_mean((z.detach() - quantized) ** 2, mask, dim=0, group=group).sum(dim=0).mean()
                    loss = loss + self.codebook_weight * cb_loss
                if self.orthogonal_reg_weight > 0.0:
                    cb2 = codebook.reshape(-1, d)
                    cbn = cb2 / (torch.linalg.vector_norm(cb2, dim=-1, keepdim=True) + 1e-8)
                    gram = cbn @ cbn.T
                    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
                    # alike on every rank of a data group: each share takes its part
                    ortho = torch.sum((gram - eye) ** 2) / gram.shape[0] ** 2
                    loss = loss + self.orthogonal_reg_weight * ortho / group_size(group)
            zq = z + (quantized - z).detach()  # straight-through
        else:
            loss = x.new_zeros(())
            zq = quantized
        out = self.project_out(zq.reshape(b, n, h * d))
        return out, indices, loss, z


# --------------------------------------------------------------------------
# Functional codebook surgery (used by the train step, train/loop.py).  Each
# function takes its random draws as an argument; `draw_*` makes them.
# --------------------------------------------------------------------------


def draw_valid_indices(valid: torch.Tensor, m: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """m flat indices drawn uniformly, with replacement, from the set entries
    of `valid` (any shape, flattened row-major)."""
    probs = valid.reshape(-1).float()
    return torch.multinomial(probs, m, replacement=True, generator=generator)


def sample_valid_vectors(z: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of z (..., d), flattened, at the drawn flat indices."""
    return z.reshape(-1, z.shape[-1])[idx]


def kmeans_pool_size(z_shape, codebook_shape) -> int:
    """The pool of k-means samples: min(b n h, max(4 z, 4096)) for a shared
    codebook, min(b n, max(4 z, 4096)) per head."""
    b, n, h, _ = z_shape
    zsize = codebook_shape[-2]
    rows = b * n * h if len(codebook_shape) == 2 else b * n
    return min(rows, max(4 * zsize, 4096))


@dataclasses.dataclass
class KMeansDraws:
    """The random part of kmeans_init_from_batch: the pool's flat indices
    (m,) and the first means' positions in the pool (z,); one row of each
    per head for per-head codebooks."""

    pool: torch.Tensor
    perm: torch.Tensor


def draw_kmeans(z: torch.Tensor, mask: torch.Tensor, codebook_shape, generator: Optional[torch.Generator]) -> KMeansDraws:
    b, n, h, _ = z.shape
    m = kmeans_pool_size(z.shape, codebook_shape)
    zsize = codebook_shape[-2]
    perm = lambda: torch.randperm(m, generator=generator, device=z.device)[:zsize]  # noqa: E731
    if len(codebook_shape) == 2:
        valid = mask[..., None].expand(b, n, h)
        return KMeansDraws(draw_valid_indices(valid, m, generator), perm())
    pools, perms = [], []
    for _ in range(h):
        pools.append(draw_valid_indices(mask, m, generator))
        perms.append(perm())
    return KMeansDraws(torch.stack(pools), torch.stack(perms))


def kmeans_init_codebook(
    flat_x: torch.Tensor, codebook_size: int, perm: torch.Tensor, iters: int = 10, return_bins: bool = False
):
    """Lloyd's k-means over flat_x (m, d) from the means flat_x[perm % m];
    an empty cluster keeps its mean.  Sums by index_add_ (JAX: a one-hot
    product): the same sums up to fp32 rounding.  return_bins=True also
    returns the final assignment counts (z,)."""
    m, d = flat_x.shape
    x = flat_x.float()
    means = x[perm % m]
    for _ in range(iters):
        idx = torch.argmin(euclidean_sq_dist(x, means), dim=-1)
        bins = torch.bincount(idx, minlength=codebook_size).float()
        sums = torch.zeros(codebook_size, d, dtype=torch.float32, device=x.device).index_add_(0, idx, x)
        new_means = sums / torch.clamp(bins[:, None], min=1.0)
        means = torch.where(bins[:, None] > 0, new_means, means)
    if not return_bins:
        return means
    idx = torch.argmin(euclidean_sq_dist(x, means), dim=-1)
    return means, torch.bincount(idx, minlength=codebook_size).float()


@torch.no_grad()
def kmeans_init_from_batch(
    codebook: torch.Tensor,  # (z, d) or (h, z, d)
    z: torch.Tensor,  # (b, n, h, d)
    mask: torch.Tensor,  # (b, n) bool
    draws: KMeansDraws,
    iters: int = 10,
    return_bins: bool = False,
):
    """k-means-initialise the codebook from a batch's encoder projections:
    one k-means over a pool of valid samples of every head for a shared
    codebook, one per head for per-head codebooks.  return_bins=True also
    returns the assignment counts ((z,) or (h, z))."""
    zsize = codebook.shape[-2]
    if codebook.ndim == 2:
        pool = sample_valid_vectors(z, draws.pool)
        out = kmeans_init_codebook(pool, zsize, draws.perm, iters, return_bins)
    else:
        per_head = [
            kmeans_init_codebook(sample_valid_vectors(z[:, :, i], draws.pool[i]), zsize, draws.perm[i], iters, return_bins)
            for i in range(codebook.shape[0])
        ]
        out = tuple(torch.stack(parts) for parts in zip(*per_head)) if return_bins else torch.stack(per_head)
    if return_bins:
        return out[0].to(codebook.dtype), out[1]
    return out.to(codebook.dtype)


def draw_expiry(z: torch.Tensor, mask: torch.Tensor, codebook_shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flat indices of the replacement samples: (z,) over every head's valid
    projections for a shared codebook, (h, z) over each head's per head."""
    b, n, h, _ = z.shape
    zsize = codebook_shape[-2]
    if len(codebook_shape) == 2:
        return draw_valid_indices(mask[..., None].expand(b, n, h), zsize, generator)
    return torch.stack([draw_valid_indices(mask, zsize, generator) for _ in range(h)])


def _expiry_samples(z: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.ndim == 1:
        return sample_valid_vectors(z, idx)
    return torch.stack([sample_valid_vectors(z[:, :, i], idx[i]) for i in range(idx.shape[0])])


@torch.no_grad()
def expire_dead_codes_params(
    codebook: torch.Tensor,  # (z, d) or (h, z, d)
    cluster_size: torch.Tensor,  # (z,) or (h, z) EMA usage
    z: torch.Tensor,  # (b, n, h, d)
    idx: torch.Tensor,  # draw_expiry's draws
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace codes whose EMA usage is below threshold by the drawn valid
    samples and reset their usage to the threshold.  Returns (codebook,
    cluster_size)."""
    dead = cluster_size < threshold
    samples = _expiry_samples(z, idx).to(codebook.dtype)
    new_cb = torch.where(dead[..., None], samples, codebook)
    new_cs = torch.where(dead, torch.full_like(cluster_size, threshold), cluster_size)
    return new_cb, new_cs


@torch.no_grad()
def expire_dead_codes_ema_stats(
    stats: Dict[str, torch.Tensor],  # embed, embed_avg, ema_cluster_size, cluster_size (+ others)
    z: torch.Tensor,
    idx: torch.Tensor,
    threshold: float,
) -> Dict[str, torch.Tensor]:
    """Dead-code expiry in the EMA-codebook mode: dead rows of embed get the
    drawn samples, embed_avg sample x threshold, and both cluster sizes the
    threshold.  Other keys pass through."""
    dead = stats["cluster_size"] < threshold
    samples = _expiry_samples(z, idx)
    rep = lambda x, new: torch.where(dead[..., None], new.to(x.dtype), x)  # noqa: E731
    fill = lambda x: torch.where(dead, torch.full_like(x, threshold), x)  # noqa: E731
    return dict(
        stats,
        embed=rep(stats["embed"], samples),
        embed_avg=rep(stats["embed_avg"], samples * threshold),
        ema_cluster_size=fill(stats["ema_cluster_size"]),
        cluster_size=fill(stats["cluster_size"]),
    )


# --------------------------------------------------------------------------
# The standalone EMA-codebook machinery
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EMACodebookState:
    """EMA statistics of one codebook."""

    embed: torch.Tensor  # (z, d)
    cluster_size: torch.Tensor  # (z,)
    embed_avg: torch.Tensor  # (z, d)

    @staticmethod
    def create(codebook_size: int, dim: int, generator: Optional[torch.Generator] = None, device="cpu") -> "EMACodebookState":
        embed = torch.randn((codebook_size, dim), generator=generator, device=device)
        return EMACodebookState(embed=embed, cluster_size=torch.zeros(codebook_size, device=device), embed_avg=embed.clone())


@torch.no_grad()
def ema_codebook_update(
    state: EMACodebookState, flat_x: torch.Tensor, valid: torch.Tensor, decay: float = 0.8, eps: float = 1e-5,
    group=None,
) -> EMACodebookState:
    """One EMA codebook step over flat_x (m, d) with a (m,) validity mask;
    with a process `group` (JAX: sync_axis) the bins and sums are summed over
    it, so each rank's rows give the step of all the ranks' rows."""
    zsize = state.embed.shape[0]
    idx = torch.argmin(euclidean_sq_dist(flat_x, state.embed), dim=-1)
    w = valid.to(flat_x.dtype)
    bins = torch.zeros(zsize, dtype=flat_x.dtype, device=flat_x.device).index_add_(0, idx, w)
    embed_sum = torch.zeros_like(state.embed).index_add_(0, idx, flat_x * w[:, None])
    bins, embed_sum = group_sum(bins, group), group_sum(embed_sum, group)
    cluster_size = state.cluster_size * decay + bins * (1 - decay)
    embed_avg = state.embed_avg * decay + embed_sum * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + zsize * eps) * n
    return EMACodebookState(embed=embed_avg / smoothed[:, None], cluster_size=cluster_size, embed_avg=embed_avg)


@torch.no_grad()
def expire_dead_codes(
    state: EMACodebookState, flat_x: torch.Tensor, idx: torch.Tensor, threshold: float = 2.0
) -> EMACodebookState:
    """Replace codes whose EMA usage is below threshold by flat_x[idx]
    (idx (z,) drawn uniformly from [0, m), e.g. by torch.randint)."""
    dead = state.cluster_size < threshold
    samples = flat_x[idx]
    return EMACodebookState(
        embed=torch.where(dead[:, None], samples, state.embed),
        cluster_size=torch.where(dead, torch.full_like(state.cluster_size, threshold), state.cluster_size),
        embed_avg=torch.where(dead[:, None], samples * threshold, state.embed_avg),
    )
