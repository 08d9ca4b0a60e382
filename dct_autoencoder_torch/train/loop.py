"""Training loop: optimizer, train step, calibration, checkpoints, on one
device or over a (data, model) mesh of processes.

Counterpart of the JAX package's train/loop.py, for LFQ and VQ models:
  * AdamW(0.9, 0.99, eps 1e-8, weight decay 0.1 on every parameter) behind a
    global-norm clip at 5.0, under the warmup-cosine schedule of
    ``optax.warmup_cosine_decay_schedule`` reproduced step for step (the
    first update runs at learning rate 0 when there is a warmup); with
    opt_8bit the moments are stored blockwise in 8 bits (train/opt8bit.py);
  * one step = normalize -> forward -> losses (optionally the RGB pixel
    loss) -> backward -> update, with gradient accumulation over row
    micro-batches;
  * VQ mode: the EMA statistics (buffers of the module) update in every
    micro-batch's forward, gumbel sampling draws from a generator seeded
    by (seed, step, micro-batch), and after the update the codebook
    surgery runs on the last micro-batch's projections: k-means init at
    step 0, dead-code expiry every vq_expire_every steps, the Adam moments
    of replaced codes zeroed;
  * dynamic_hparams: per-trial loss weights and a learning-rate scale as
    step arguments, for the shared-step sweep (train/sweep.py);
  * the norm-calibration phase with beta forced to 0 and full sequences;
  * the loop itself: batch prefetch on a host thread, logging, image grids,
    periodic and final checkpoints, exact resume, NaN abort or restore, and
    the stall and host-RSS watchdogs;
  * over several processes (make_train_step(mesh=...), train() under
    torchrun): data, tensor and sequence parallelism and ZeRO-1 (JAX:
    make_sharded_train_step, model_state_sharding, zero1_state_sharding).
    Every rank gets the same global batch and runs its data block of each
    micro-batch; every batch statistic of the losses is summed over the data
    group (a parallel/mesh.py DataShard handed to the losses, JAX's
    sync_axis), so each rank's loss is its share
    of the global loss, the gradients are summed over the data group and the
    optimizer is parallel/optim.py's ShardedOptimizer.  Rank 0 alone logs,
    writes grids and writes checkpoints, which hold the whole state in the
    single-device files;
  * GPipe pipeline parallelism (pipeline_microbatches, JAX's
    make_pipelined_module): the model axis is the stage axis, each rank holds
    its stage's layers of both stacks and their moments, and each rank's rows
    of a micro-batch run as that many contiguous pipeline microbatches
    (parallel/pipeline.py).

Where JAX returns new pytrees, the port updates the module's fp32
parameters, its VQ statistics and the optimizer's moments in place.  The
port's random draws (gumbel, k-means, expiry) are its own, not JAX's
streams; each is a function of (seed, step), as JAX's fold_in is, so a
resumed run draws what the uninterrupted run drew.

Dropout, MLP and attention alike, draws from a generator seeded by `seed`
(the default generator under remat, whose state the recomputation
restores); JAX's own train step passes no dropout stream and raises on any
dropout rate.  A pipeline raises ValueError by name where JAX asserts:
n_model_parallel = 1, layers that do not divide into the stages, dropout in
a pipelined stack.
With sequence_parallel set, the pipelined stacks run without the token
split, which changes no number.  One default differs from JAX on purpose: the
RSS watchdog is off (rss_limit_gb=0), since it works around a memory leak
of the TPU client that this runtime does not have.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..models.autoencoder import DCTAutoencoder, DCTAutoencoderModule
from ..models.patchnorm import PatchNormState, apply_patchnorm, calibrate_patchnorm_batch
from ..parallel.mesh import DataShard, Mesh, all_gather_rows, pad_batch_rows, take_rows
from ..patches.container import DCTPatches
from ..patches.extractor import DCTAutoencoderFeatureExtractor
from .losses import step_autoencoder, weighted_total


@dataclasses.dataclass
class Optimizer:
    """AdamW + warmup-cosine + clip: the hyper-parameters and the schedule."""

    learning_rate: float = 1e-4
    warmup_steps: int = 200
    decay_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    grad_clip: float = 5.0
    opt_8bit: bool = False

    def schedule(self, count: int) -> float:
        """Learning rate of update number `count` (0 for the first)."""
        if count < self.warmup_steps:
            return self.learning_rate * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        t = min(float(count - self.warmup_steps), float(span))
        return self.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, module: torch.nn.Module) -> torch.optim.Optimizer:
        return self.init_params(list(module.parameters()))

    def init_params(self, params: List[torch.Tensor]) -> torch.optim.Optimizer:
        if self.opt_8bit:
            from .opt8bit import AdamW8bit

            return AdamW8bit(
                params, lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps, weight_decay=self.weight_decay,
            )
        return torch.optim.AdamW(
            params, lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps, weight_decay=self.weight_decay,
        )

    def apply(
        self, adamw: torch.optim.Optimizer, params: List[torch.Tensor], count: int, lr_scale: float = 1.0
    ) -> torch.Tensor:
        """Clip the parameters' gradients by their global norm, then take
        update number `count`; returns the norm before clipping.

        lr_scale multiplies the schedule's rate.  AdamW's update, decoupled
        weight decay included, is linear in the rate (in AdamW8bit too), so a
        unit-peak schedule scaled by s is the schedule with peak s: JAX's
        dynamic_hparams scales the whole update by s."""
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax.clip_by_global_norm: untouched below the limit, else g / norm * limit
        scale = torch.where(grad_norm < self.grad_clip, torch.ones_like(grad_norm), self.grad_clip / grad_norm)
        torch._foreach_mul_(grads, scale)
        for group in adamw.param_groups:
            group["lr"] = self.schedule(count) * lr_scale
        adamw.step()
        return grad_norm


def make_optimizer(
    learning_rate: float = 1e-4,
    max_iters: int = 10000,
    warmup_steps: int = 200,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.99,
    grad_clip: float = 5.0,
    opt_8bit: bool = False,
) -> Optimizer:
    """AdamW + warmup-cosine + clip, with the JAX package's defaults.

    opt_8bit=True stores the Adam moments blockwise in 8 bits
    (train/opt8bit.py, the reference's default PagedAdamW8bit): about 2
    bytes a parameter of optimizer state instead of 8."""
    warmup_steps = min(warmup_steps, max(max_iters - 1, 0))
    return Optimizer(
        learning_rate=learning_rate, warmup_steps=warmup_steps, decay_steps=max(max_iters, warmup_steps + 1),
        weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip, opt_8bit=opt_8bit,
    )


@dataclasses.dataclass
class TrainState:
    module: DCTAutoencoderModule  # its fp32 parameters (and VQ's statistics) are the trained state
    # first and second moments (AdamW or AdamW8bit; on a mesh, a ShardedOptimizer)
    adamw: torch.optim.Optimizer
    step: int = 0
    # VQ: the codebook rows that the last step's surgery replaced (bool,
    # the codebook's shape without its last dim), None if it replaced none
    vq_replaced: Optional[torch.Tensor] = None
    # the mesh the module is sharded on (parallel.shard_params), None on one device
    mesh: Optional[Mesh] = None

    @staticmethod
    def create(
        module: DCTAutoencoderModule, tx: Optimizer, mesh: Optional[Mesh] = None, zero1: bool = False,
        zero1_min_size: int = 2**13,
    ) -> "TrainState":
        """A fresh state; with a mesh the optimizer is a ShardedOptimizer
        (zero1: this rank updates its slices of the parameters that
        parallel.zero1_partition splits, JAX's min_size gating)."""
        if mesh is None:
            return TrainState(module=module, adamw=tx.init(module), step=0)
        from ..parallel.optim import ShardedOptimizer

        return TrainState(module=module, adamw=ShardedOptimizer(module, tx, mesh, zero1, zero1_min_size), mesh=mesh)

    @property
    def vq_stats(self) -> Dict[str, torch.Tensor]:
        """VQ's EMA statistics (JAX: TrainState.vq_stats['vq_model']), the
        module's buffers; {} for LFQ.  The module's state_dict carries them,
        so checkpoints and resume include them."""
        return self.module.vq_stats()


class RssLimitExceeded(RuntimeError):
    """Raised by train() when host RSS crosses rss_limit_gb after the state
    was checkpointed: the caller can restart the process and resume (the
    CLI re-executes itself, train/cli.py).  The JAX package added it for a
    TPU client that leaked every host-to-device transfer; here it is an
    option, off by default."""

    def __init__(self, step: int, rss_gb: float, out_dir: str):
        super().__init__(
            f"host RSS {rss_gb:.1f} GB exceeded the limit at step {step}; "
            f"train state checkpointed to {out_dir} for restart"
        )
        self.step = step
        self.rss_gb = rss_gb
        self.out_dir = out_dir


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return 0.0


def _auto_rss_limit_gb() -> float:
    """75% of MemTotal: headroom for the checkpoint write and the page cache."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    return 0.75 * int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return 0.0


def _start_stall_watchdog(stall_timeout_s: float, progress: dict, on_stall, log) -> None:
    """Daemon thread that fires on_stall when no step completes in time.

    Arms only after the first completed step (progress["t"] is None until
    then), so a first kernel build never trips it; progress["done"] retires
    it.  on_stall must act on the process (exec, exit): it runs off the main
    thread, which may be blocked inside a device call."""

    def watch():
        interval = max(min(stall_timeout_s / 4.0, 30.0), 0.05)
        while True:
            time.sleep(interval)
            if progress.get("done"):
                return
            t = progress.get("t")
            if t is None:
                continue
            if time.monotonic() - t > stall_timeout_s:
                log({"error": f"STALL: no training step completed in {stall_timeout_s:.0f}s: watchdog firing "
                              "(resume from the last checkpoint)"})
                if on_stall is not None:
                    on_stall()
                else:
                    os._exit(73)
                return

    threading.Thread(target=watch, daemon=True, name="stall-watchdog").start()


def prepare_train_batch(
    batch: DCTPatches, pixel_loss_max_images: int = 0, clip_grid: Optional[Tuple[int, int]] = None
):
    """Strip the per-image Python metadata the train step never reads.

    With pixel_loss_max_images > 0 the per-image patch grids are returned as
    a (max_images, 2) tensor on the batch's device for the pixel loss.
    Returns (stripped_batch, grid_sizes or None)."""
    grid_sizes = None
    if pixel_loss_max_images:
        from .pixel_loss import make_grid_sizes

        if clip_grid is None:
            raise ValueError("the pixel loss needs clip_grid, the config's (max_patch_h, max_patch_w)")
        grid_sizes = make_grid_sizes(batch, pixel_loss_max_images, clip_grid)
    return batch.replace(patch_sizes=(), original_sizes=(), _data=None), grid_sizes


# losses that are means over valid tokens: under accumulation each micro-batch
# re-weights them by its token share, so the uniform micro average gives the
# whole-batch mean (entropy_loss is left out: it is nonlinear in the split)
_TOKEN_MEAN_LOSSES = ("rec_loss", "rec_loss_unnormalized", "commit_loss")


def make_train_step(
    module: DCTAutoencoderModule,
    tx: Optimizer,
    loss_weights: Optional[Dict[str, float]] = None,
    warmup_dict: Optional[Dict[str, int]] = None,
    accum_steps: int = 1,
    use_pixel_loss: bool = False,
    seed: int = 0,
    vq_kmeans_init: bool = True,
    vq_expire_threshold: float = 15.0,
    vq_expire_every: int = 50,
    dynamic_hparams: bool = False,
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Build the train-step fn (state, patchnorm, batch[, grid_sizes[, hparams]]) -> (state, metrics).

    Normalization is done inside the step (frozen patchnorm).  The state's
    module and optimizer are updated in place and the same state object is
    returned with its step advanced.  Metrics are 0-d tensors on the
    module's device (reading one synchronises); 'grad_norm' is the global
    norm before clipping.  `seed` seeds the dropout masks when the config has
    dropout.

    use_pixel_loss=True adds the differentiable RGB pixel loss; pass the
    grid sizes that prepare_train_batch returns as the step's fourth
    argument.  Under accumulation each micro-batch owns the global image
    slots of its rows and re-weights its per-image mean by n_i * K / N (N the
    images the loss can average, at most the grid sizes' length), so that
    accum = K equals accum = 1 even when packing spreads images unevenly;
    the per-token means are re-weighted by their token share.

    dynamic_hparams=True: the step takes a fifth argument `hparams`, a dict
    of per-trial loss weights plus 'lr_scale' (Python numbers or 0-d
    tensors), so that one step serves every trial of a sweep.  Build `tx`
    with learning_rate=1.0: the update is then scaled by lr_scale, which is
    exact (see Optimizer.apply).  Weights in hparams override loss_weights.

    VQ mode (config.vq_type == 'vq'), as in JAX:
      * the EMA statistics update in every micro-batch's forward and thread
        from one micro-batch to the next;
      * gumbel sampling at temperature 20 draws from a generator seeded by
        (seed, step, micro-batch);
      * after the update, the codebook surgery runs on the last
        micro-batch's projections and valid tokens: k-means init from the
        batch at step 0 (vq_kmeans_init), and every vq_expire_every steps
        (when step % vq_expire_every == vq_expire_every - 1) codes whose
        EMA usage is below vq_expire_threshold are replaced by samples of
        the batch; replaced codes get their Adam moments zeroed (fp32 AdamW
        only: JAX finds the moments by the codebook's shape, which the
        8-bit state's blocks do not have).  With no valid token in that
        window the surgery does nothing.  state.vq_replaced holds the
        replaced rows.

    mesh (parallel.make_mesh; the state from TrainState.create(..., mesh))
    makes it the sharded step, JAX's make_sharded_train_step: every rank is
    given the same global batch, whose rows must divide by accum_steps x
    n_data (pad_batch_rows), and runs its data block of each micro-batch
    (micro-batch i is rows [i mb, (i + 1) mb) of the global batch, as JAX's
    dynamic_slice; rank d takes its d-th block of those) with a
    parallel.DataShard, whose group sums every batch statistic, and with the
    weights of the accumulation taken over the global rows.  The gradients are summed over the data group by the
    ShardedOptimizer, and the loss metrics too; the metrics and the
    grad norm are the global ones on every rank.  VQ's surgery runs on the
    projections of the whole last micro-batch, gathered, so every rank
    edits its codebook as one process does.

    A module whose stacks parallel.pipeline.make_pipelined_module(module,
    mesh, M) staged (before the state was made) makes it the pipelined step,
    on the same mesh: each rank's rows of a micro-batch, which must divide
    by M, run through the stacks as M contiguous pipeline microbatches, and
    everything between and after the stacks (the quantizer, the losses, VQ's
    surgery) runs on every model rank on the stacks' broadcast output.
    """
    from ..parallel.pipeline import staged_pipeline

    pipeline = staged_pipeline(module)
    if pipeline is not None and pipeline.mesh is not mesh:
        raise ValueError(
            "the module's stacks were staged for another mesh than the step's: stage it with "
            "parallel.pipeline.make_pipelined_module(module, mesh, M) and the step's mesh"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    generators: Dict[torch.device, torch.Generator] = {}

    def dropout_generator(device: torch.device) -> Optional[torch.Generator]:
        enc = module.config.encoder_config
        if (enc.dropout <= 0.0 and enc.attention_dropout <= 0.0) or enc.remat:
            return None  # remat redraws from the default generator
        if device not in generators:
            generators[device] = torch.Generator(device=device).manual_seed(seed)
        return generators[device]

    is_vq = module.config.vq_type == "vq"

    def backward(
        patchnorm, batch, step, micro, lw, grid_sizes=None, pixel_rows=None, pixel_weight=None, token_weight=None,
        shard=None,
    ):
        with obs.span("dct.train.forward"):
            normalized = batch.replace(patches=apply_patchnorm(patchnorm, batch))
            device = batch.patches.device
            losses = step_autoencoder(
                module, patchnorm, batch, normalized, training=True, generator=dropout_generator(device),
                pixel_grid_sizes=grid_sizes, pixel_rows=pixel_rows,
                vq_generator=step_generator(seed, step, micro, device) if is_vq else None, update_vq_stats=is_vq,
                shard=shard,
            )
            if pixel_weight is not None:
                losses["pixel_loss"] = losses["pixel_loss"] * pixel_weight
            if token_weight is not None:
                for k in _TOKEN_MEAN_LOSSES:
                    losses[k] = losses[k] * token_weight
            vq_z = losses.pop("vq_z", None)
            total = weighted_total(losses, lw, warmup_dict, float(step))
        with obs.span("dct.train.backward"):
            total.backward()
        metrics = {k: v.detach() for k, v in losses.items() if k not in ("codes", "rec_patches")}
        metrics["loss"] = total.detach()
        return metrics, vq_z

    def train_step(
        state: TrainState, patchnorm: PatchNormState, batch: DCTPatches, grid_sizes=None, hparams=None
    ):
        if state.module is not module:
            raise ValueError("the state belongs to another module than the step was built for")
        if use_pixel_loss != (grid_sizes is not None):
            raise ValueError("grid sizes (prepare_train_batch(pixel_loss_max_images=...)) go with use_pixel_loss, and only with it")
        if dynamic_hparams and (hparams is None or "lr_scale" not in hparams):
            raise ValueError("a step built with dynamic_hparams=True takes hparams with 'lr_scale'")
        lw = loss_weights
        if hparams is not None:
            lw = dict(loss_weights or {})
            lw.update({k: v for k, v in hparams.items() if k != "lr_scale"})
        if (state.mesh is None) != (mesh is None):
            raise ValueError("the state and the step must be made for the same mesh (TrainState.create(..., mesh))")
        params = [p for p in module.parameters() if p.requires_grad]
        state.adamw.zero_grad(set_to_none=True)
        if accum_steps == 1 and mesh is None:
            metrics, vq_z = backward(patchnorm, batch, state.step, 0, lw, grid_sizes)
            surgery_mask = ~batch.key_pad_mask
        else:
            b = batch.patches.shape[0]
            n_data, d = (mesh.n_data, mesh.data_rank) if mesh is not None else (1, 0)
            if b % (accum_steps * n_data):
                raise ValueError(
                    f"batch rows ({b}) must divide by accum_steps x n_data ({accum_steps} x {n_data}): "
                    "pad_batch_rows first"
                )
            mb = b // accum_steps
            local = mb // n_data  # this rank's rows of each micro-batch
            tokens_per_row = (~batch.key_pad_mask).sum(dim=1).float()
            total_tokens = torch.clamp(tokens_per_row.sum(), min=1.0)
            if grid_sizes is not None:
                from .pixel_loss import row_image_layout

                g_offsets, n_per_row = row_image_layout(batch)
                max_images = grid_sizes.shape[0]
                slots = torch.arange(max_images, device=grid_sizes.device)
                # images the pixel loss can average: slots past max_images are dropped
                total_images = torch.clamp(n_per_row.sum(), max=max_images).float()
            metrics = None
            for i in range(accum_steps):
                lo = i * mb + d * local
                mine = slice(lo, lo + local)
                token_weight = tokens_per_row[i * mb : (i + 1) * mb].sum() * accum_steps / total_tokens
                pixel_rows = pixel_weight = None
                if grid_sizes is not None:
                    row_off, counts = g_offsets[mine], n_per_row[mine]
                    start = row_off[0]
                    slot_mask = (slots >= start) & (slots < start + counts.sum())
                    pixel_rows = (row_off, slot_mask)
                    pixel_weight = slot_mask.sum().float() * accum_steps / torch.clamp(total_images, min=1.0)
                shard = None if mesh is None else DataShard(mesh.data_group, d * local, mb)
                m, vq_z = backward(
                    patchnorm, take_rows(batch, lo, lo + local), state.step, i, lw, grid_sizes, pixel_rows,
                    pixel_weight, token_weight, shard,
                )
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            metrics = {k: v / accum_steps for k, v in metrics.items()}
            torch._foreach_div_([p.grad for p in params if p.grad is not None], float(accum_steps))
            # the surgery samples from the last micro-batch, whose projections are vq_z
            surgery_mask = ~batch.key_pad_mask[(accum_steps - 1) * mb :]

        lr_scale = float(hparams["lr_scale"]) if dynamic_hparams else 1.0
        with obs.span("dct.train.optimizer"):
            if mesh is None:
                grad_norm = tx.apply(state.adamw, params, state.step, lr_scale=lr_scale)
            else:
                grad_norm = state.adamw.step(tx, state.step, lr_scale=lr_scale)
            state.adamw.zero_grad(set_to_none=True)
        if mesh is not None:
            metrics = _sum_loss_metrics(metrics, mesh)
        state.vq_replaced = None
        if is_vq:
            with obs.span("dct.train.vq_surgery"):
                if mesh is not None:
                    vq_z = all_gather_rows(vq_z, mesh.data_group, mesh.n_data)
                state.vq_replaced = _vq_codebook_surgery(
                    module.vq_model, state.adamw, vq_z, surgery_mask, state.step, seed,
                    vq_kmeans_init, vq_expire_threshold, vq_expire_every,
                )
        state.step += 1
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


def _sum_loss_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The loss metrics (each rank's share) summed over the data group;
    perplexity, of the global histogram, is global already."""
    import torch.distributed as dist

    keys = [k for k in metrics if k != "perplexity"]
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    return {**metrics, **{k: flat[j].to(metrics[k].dtype) for j, k in enumerate(keys)}}


# generator streams of one step: gumbel sampling uses the micro-batch index
_KMEANS_STREAM = 1 << 16
_EXPIRE_STREAM = (1 << 16) + 1


def step_generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    """A generator on `device` whose state is a function of (seed, step,
    stream) only (JAX: fold_in(PRNGKey(seed), step)), so that a resumed run
    draws what the uninterrupted run drew."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & ((1 << 63) - 1))


@torch.no_grad()
def _zero_codebook_moments(adamw: torch.optim.Optimizer, codebook: torch.Tensor, replaced: torch.Tensor) -> None:
    """Zero the Adam moment rows of codes that the surgery replaced, so a
    fresh code does not inherit the old one's momentum.  As in JAX, the
    moments are those shaped like the codebook: fp32 AdamW's exp_avg and
    exp_avg_sq.  AdamW8bit keeps its moments as (n_blocks, 256) codes and
    absmax, which JAX's search by shape does not find either, so they stay."""
    if hasattr(adamw, "zero_moment_rows"):  # a ShardedOptimizer: the moments may be slices
        adamw.zero_moment_rows(codebook, replaced)
        return
    state = adamw.state.get(codebook, {})
    keep = (~replaced).to(torch.float32)[..., None]
    for name in ("exp_avg", "exp_avg_sq"):
        moment = state.get(name)
        if isinstance(moment, torch.Tensor) and moment.shape == codebook.shape:
            moment.mul_(keep.to(moment.dtype))


@torch.no_grad()
def _vq_codebook_surgery(
    vq, adamw: torch.optim.Optimizer, vq_z: torch.Tensor, mask: torch.Tensor, step: int, seed: int,
    kmeans_init: bool, expire_threshold: float, expire_every: int,
) -> Optional[torch.Tensor]:
    """The codebook surgery after a VQ step's update (JAX: _vq_codebook_surgery).

    k-means init when step == 0, dead-code expiry when
    step % expire_every == expire_every - 1; in the EMA-codebook mode both
    edit the statistics (embed, embed_avg, the cluster sizes; k-means seeds
    the cluster sizes with its bins and embed_avg with embed x bins).  Does
    nothing when `mask` (the sampling window's valid tokens) is empty, or
    when neither is due.  Returns the replaced rows of the gradient codebook
    (None in the EMA mode or when nothing ran)."""
    from ..models.vq import (
        draw_expiry,
        draw_kmeans,
        expire_dead_codes_ema_stats,
        expire_dead_codes_params,
        kmeans_init_from_batch,
    )

    do_kmeans = kmeans_init and step == 0
    do_expire = expire_threshold > 0 and expire_every > 0 and step % expire_every == expire_every - 1
    if not (do_kmeans or do_expire) or not bool(mask.any()):
        return None
    device = vq_z.device
    if vq.ema_update:
        stats = vq.stats()
        if do_kmeans:
            gen = step_generator(seed, step, _KMEANS_STREAM, device)
            draws = draw_kmeans(vq_z, mask, stats["embed"].shape, gen)
            emb, bins = kmeans_init_from_batch(stats["embed"], vq_z, mask, draws, return_bins=True)
            vq.embed.copy_(emb)
            vq.embed_avg.copy_(emb * bins[..., None])
            vq.ema_cluster_size.copy_(bins)
            if "cluster_size" in stats:
                vq.cluster_size.copy_(bins)
        if do_expire and "cluster_size" in stats:
            gen = step_generator(seed, step, _EXPIRE_STREAM, device)
            new = expire_dead_codes_ema_stats(vq.stats(), vq_z, draw_expiry(vq_z, mask, vq.embed.shape, gen), expire_threshold)
            for k, v in new.items():
                getattr(vq, k).copy_(v)
        return None

    cb = vq.codebook
    replaced = torch.zeros(cb.shape[:-1], dtype=torch.bool, device=cb.device)
    if do_kmeans:
        gen = step_generator(seed, step, _KMEANS_STREAM, device)
        cb.copy_(kmeans_init_from_batch(cb, vq_z, mask, draw_kmeans(vq_z, mask, cb.shape, gen)))
        replaced[...] = True
    if do_expire:
        gen = step_generator(seed, step, _EXPIRE_STREAM, device)
        dead = vq.cluster_size < expire_threshold
        new_cb, new_cs = expire_dead_codes_params(
            cb, vq.cluster_size, vq_z, draw_expiry(vq_z, mask, cb.shape, gen), expire_threshold
        )
        cb.copy_(new_cb)
        vq.cluster_size.copy_(new_cs)
        replaced |= dead
    _zero_codebook_moments(adamw, cb, replaced)
    return replaced


def train_patch_norm(
    model: DCTAutoencoder,
    proc: DCTAutoencoderFeatureExtractor,
    data_iter: Iterable[dict],
    steps: int = 10,
    batch_size: Optional[int] = 32,
    log: Callable[[str], None] = print,
) -> PatchNormState:
    """Norm-calibration phase: beta forced to 0 (keep every patch) and
    max_seq_len to the full grid, so calibration sees unbiased per-position
    statistics; both are restored afterwards."""
    og_beta, og_max = proc.sample_patches_beta, proc.max_seq_len
    proc.sample_patches_beta = 0.0
    proc.max_seq_len = proc.max_patch_h * proc.max_patch_w * proc.channels

    state = model.patchnorm
    n_seen = 0
    try:
        for i, batch in enumerate(proc.iter_batches(data_iter, batch_size)):
            if i >= steps:
                break
            n_seen += 1
            state, out = calibrate_patchnorm_batch(state, batch.to(model.device))
            vals = out[~batch.key_pad_mask.to(out.device)].cpu().numpy()
            log(
                f"norm calib {i + 1:03d} median {np.median(vals):+.3f} "
                f"std {vals.std():.3f} min {vals.min():+.2f} max {vals.max():+.2f}"
            )
    finally:
        proc.sample_patches_beta = og_beta
        proc.max_seq_len = og_max
    if n_seen == 0:
        log("WARNING: norm calibration saw ZERO batches: the statistics are untrained")
    model.patchnorm = state
    return state


def check_pipeline(config, n_model_parallel: int, pipeline_microbatches: int) -> None:
    """Raise ValueError by name where train() cannot run this pipeline (JAX
    asserts): fewer than two stages or microbatches, then what
    parallel.pipeline.check_stackable refuses in training.  Before any
    process joins a group."""
    from ..parallel.pipeline import check_stackable

    if n_model_parallel <= 1:
        raise ValueError(
            f"pipeline_microbatches={pipeline_microbatches} needs n_model_parallel > 1 pipeline stages, "
            f"got n_model_parallel={n_model_parallel}"
        )
    if pipeline_microbatches < 1:
        raise ValueError(f"pipeline_microbatches={pipeline_microbatches}: 0 for no pipeline, else at least 1")
    check_stackable(config, n_model_parallel, training=True)


def train(
    model: DCTAutoencoder,
    proc: DCTAutoencoderFeatureExtractor,
    data_iter: Iterable[dict],
    batch_size: Optional[int] = 32,
    learning_rate: float = 1e-4,
    max_iters: int = 10000,
    grad_accumulation_steps: int = 1,
    loss_weights: Optional[Dict[str, float]] = None,
    warmup_dict: Optional[Dict[str, int]] = None,
    # tensor parallelism over this many ranks (the model axis; the data axis
    # is the rest of the world), and ZeRO-1 over the data axis; see below
    n_model_parallel: int = 1,
    # GPipe pipeline parallelism: > 0 runs both transformer stacks as a
    # pipeline of n_model_parallel stages with this many microbatches a step
    # (parallel/pipeline.py; needs n_model_parallel > 1 and layers that
    # divide into the stages)
    pipeline_microbatches: int = 0,
    zero1: bool = False,
    # 8-bit Adam moments (train/opt8bit.py; the reference's PagedAdamW8bit)
    opt_8bit: bool = False,
    use_pixel_loss: bool = False,
    pixel_loss_max_images: int = 64,
    # batches made ahead on a host thread (data/prefetch.py); 0 disables
    prefetch_batches: int = 2,
    # 'abort' stops on a non-finite loss; 'restore' rolls back to the last
    # saved train state and keeps consuming the stream (needs out_dir and
    # save_every; before the first save it aborts with an explanation)
    nan_policy: str = "abort",
    # host-RSS watchdog (RssLimitExceeded): checkpoint to out_dir and raise
    # when RSS crosses the limit. <0 = auto (75% of MemTotal); 0 disables,
    # the port's default (JAX's is auto, for its TPU client's leak)
    rss_limit_gb: float = 0.0,
    # stall watchdog: if no step completes for this many seconds after the
    # first, call on_stall from a daemon thread (os._exit(73) when None).
    # on_stall runs off the main thread and must act on the process. 0 disables
    stall_timeout_s: float = 0.0,
    on_stall: Optional[Callable[[], None]] = None,
    log_every: int = 50,
    save_every: int = 1000,
    # keep a model-only copy of each periodic save at out_dir/ckpt_<step>
    keep_checkpoints: bool = False,
    # every that many steps: an original-vs-reconstruction grid in out_dir
    # and the RGB pixel MSE of the batch as a metric
    log_images_every: int = 0,
    n_log_images: int = 10,
    out_dir: Optional[str] = None,
    resume_path: Optional[str] = None,
    seed: int = 0,
    # VQ: k-means init and dead-code expiry (see make_train_step)
    vq_kmeans_init: bool = True,
    vq_expire_threshold: float = 15.0,
    vq_expire_every: int = 50,
    log: Callable[[Dict], None] = print,
) -> Tuple[DCTAutoencoder, TrainState]:
    """Main training loop, on the model's device.

    `data_iter` yields dicts of per-image columns (as `proc.preprocess_many`
    gives them); the processor packs them into batches, on a host thread
    when prefetch_batches > 0.  max_iters counts total steps across
    restarts: a resumed state runs only the remainder.  The model's
    parameters are trained in place.

    use_pixel_loss=True trains with the differentiable RGB pixel loss in the
    objective, weighted by loss_weights.get('pixel_loss', 1.0); at most
    pixel_loss_max_images images of a batch enter it.

    Several processes: under torchrun (one process a card), or with
    n_model_parallel > 1, zero1 or a config with sequence_parallel, train()
    joins the process group (a world of one without torchrun, then torn
    down again), makes the (world // n_model_parallel, n_model_parallel)
    mesh, shards the module and trains with the sharded step.  Every rank
    must be given the same stream, with the same seeds: each packs the same
    global batch and runs its rows.  Rows are padded to a multiple of
    grad_accumulation_steps x n_data (JAX pads to their lcm; the port's
    ranks each hold an equal block of every micro-batch).  Rank 0 alone logs,
    writes grids and checkpoints (the single-device files); the NaN policy
    reads the global loss and the RSS watchdog the largest rank's, so all
    ranks act together.  On return the module holds the whole parameters
    on every rank again.

    pipeline_microbatches > 0 stages the stacks over the model axis instead
    of splitting their layers (parallel/pipeline.py): rows are padded to
    grad_accumulation_steps x n_data x pipeline_microbatches (JAX's
    loop.py:950), each rank holds its stage's layers and their moments, and
    checkpoints gather them into the single-device files.
    """
    if pipeline_microbatches:
        check_pipeline(model.config, n_model_parallel, pipeline_microbatches)
    if nan_policy not in ("abort", "restore"):
        raise ValueError(f"nan_policy must be 'abort' or 'restore', got {nan_policy!r}")
    from ..parallel import mesh as pm

    cfg = model.config
    sp_on = cfg.encoder_config.sequence_parallel or cfg.decoder_config.sequence_parallel
    mesh, own_group = None, False
    if zero1 or n_model_parallel > 1 or sp_on or pm.launched_by_torchrun():
        own_group = pm.initialize_distributed(model.device)
        try:
            mesh = pm.make_mesh(n_model_parallel, model.device)
            if pipeline_microbatches:
                from ..parallel.pipeline import make_pipelined_module

                make_pipelined_module(model.module, mesh, pipeline_microbatches)
            elif n_model_parallel > 1 or sp_on:
                pm.shard_params(model.module, mesh)
        except Exception:
            if own_group:
                torch.distributed.destroy_process_group()
            raise
    try:
        out = _train(
            model, proc, data_iter, mesh, zero1, batch_size, learning_rate, max_iters, grad_accumulation_steps,
            loss_weights, warmup_dict, opt_8bit, use_pixel_loss, pixel_loss_max_images, prefetch_batches, nan_policy,
            rss_limit_gb, stall_timeout_s, on_stall, log_every, save_every, keep_checkpoints, log_images_every,
            n_log_images, out_dir, resume_path, seed, vq_kmeans_init, vq_expire_threshold, vq_expire_every,
            log if pm.is_main_process() else (lambda _: None),
        )
        if mesh is not None:  # a collective: only on the way every rank takes
            pm.unshard_params(model.module, mesh)
        return out
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(
    model, proc, data_iter, mesh, zero1, batch_size, learning_rate, max_iters, grad_accumulation_steps,
    loss_weights, warmup_dict, opt_8bit, use_pixel_loss, pixel_loss_max_images, prefetch_batches, nan_policy,
    rss_limit_gb, stall_timeout_s, on_stall, log_every, save_every, keep_checkpoints, log_images_every,
    n_log_images, out_dir, resume_path, seed, vq_kmeans_init, vq_expire_threshold, vq_expire_every, log,
):
    """train()'s loop, on one device (mesh None) or on this rank of a mesh."""
    from ..parallel.mesh import gather_params, is_main_process
    from ..parallel.pipeline import staged_pipeline
    from .checkpoint import has_train_state, load_train_state, save_train_state

    tx = make_optimizer(learning_rate, max_iters, opt_8bit=opt_8bit)
    state = TrainState.create(model.module, tx, mesh=mesh, zero1=zero1)
    if resume_path is not None and has_train_state(resume_path):
        state, model.patchnorm = load_train_state(resume_path, state, model.patchnorm)
        log({"resumed_from": resume_path, "step": state.step})
    step_fn = make_train_step(
        model.module, tx, loss_weights, warmup_dict, grad_accumulation_steps, use_pixel_loss=use_pixel_loss, seed=seed,
        vq_kmeans_init=vq_kmeans_init, vq_expire_threshold=vq_expire_threshold, vq_expire_every=vq_expire_every,
        mesh=mesh,
    )
    clip_grid = (model.config.max_patch_h, model.config.max_patch_w)
    # rows divide by the micro-batches, in each by the data ranks, and each
    # rank's rows by the pipeline microbatches
    pipeline = staged_pipeline(model.module)
    n_data = mesh.n_data if mesh is not None else 1
    row_multiple = grad_accumulation_steps * n_data * (pipeline.n_microbatches if pipeline else 1)

    def save(gstep: Optional[int] = None) -> None:
        # every rank joins the gathers; rank 0 writes
        weights = gather_params(model.module, mesh) if mesh is not None else None
        save_train_state(out_dir, state, model.patchnorm)
        if is_main_process():
            model.save_pretrained(f"{out_dir}/model", state_dict=weights)
            if gstep is not None and keep_checkpoints:
                model.save_pretrained(f"{out_dir}/ckpt_{gstep:06d}", state_dict=weights)

    def host_rss_gb() -> float:
        rss = _rss_gb()
        if mesh is None:
            return rss
        # the largest of every rank's, so that all ranks act together
        t = torch.tensor([rss], dtype=torch.float64, device=model.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return float(t)

    if rss_limit_gb < 0:
        rss_limit_gb = _auto_rss_limit_gb()
    stall_progress = {"t": None, "done": False}
    if stall_timeout_s and stall_timeout_s > 0:
        _start_stall_watchdog(stall_timeout_s, stall_progress, on_stall, log)
    batch_iter = proc.iter_batches(data_iter, batch_size)
    if prefetch_batches > 0:
        from ..data.prefetch import prefetch

        batch_iter = prefetch(batch_iter, prefetch_batches)

    # sec_per_step: the wall time since the previous log line (the loop's start
    # before the first) over the steps since then, read after the log's floats
    # have waited for the step
    t_log, i_log = time.time(), -1
    i = -1
    start_step = state.step
    try:
        for i, raw_batch in enumerate(batch_iter):
            if i >= max_iters - start_step:
                break
            gstep = start_step + i  # global step across restarts
            with obs.span("dct.train.step"):
                batch, grid_sizes = prepare_train_batch(
                    raw_batch, pixel_loss_max_images if use_pixel_loss else 0, clip_grid
                )
                # padding rows are fully masked, so grid sizes built before the pad stay aligned
                batch = pad_batch_rows(batch.to(model.device), row_multiple)
                if grid_sizes is not None:
                    grid_sizes = grid_sizes.to(model.device)
                if mesh is not None and i % log_every == 0:
                    _check_same_batch(batch, mesh)
                state, metrics = step_fn(state, model.patchnorm, batch, grid_sizes)
            stall_progress["t"] = time.monotonic()

            if i % log_every == 0:
                with obs.span("dct.train.log"):
                    metrics = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
                now = time.time()
                sec_per_step = (now - t_log) / (i - i_log)
                t_log, i_log = now, i
                if not np.isfinite(metrics["loss"]):
                    if nan_policy == "restore":
                        if out_dir and has_train_state(out_dir):
                            state, model.patchnorm = load_train_state(out_dir, state, model.patchnorm)
                            log({"step": gstep, "warning": f"NAN LOSS: restored last checkpoint (step {state.step}), continuing"})
                            continue
                        log({"step": gstep, "error": "NAN LOSS: nan_policy='restore' needs a checkpoint (set out_dir + save_every); aborting"})
                        break
                    log({"step": gstep, "error": "NAN LOSS: aborting"})
                    break
                metrics.update(
                    step=gstep, sec_per_step=sec_per_step, images_per_batch=len(raw_batch.original_sizes)
                )
                log(metrics)

            if out_dir and log_images_every and gstep % log_images_every == 0:
                # the forward needs every rank of the model group; rank 0 writes
                _log_image_grid(model, proc, raw_batch, gstep, n_log_images, out_dir, log, write=is_main_process())

            if out_dir and save_every and i > 0 and gstep % save_every == 0:
                # never checkpoint a poisoned state: 'restore' would restore it forever
                if np.isfinite(float(metrics["loss"])):
                    save(gstep)
                else:
                    log({"step": gstep, "warning": "skipping checkpoint: non-finite loss"})

            # its own cadence, not log_every; i > 0: a restarted process makes
            # at least one step of progress before it may restart again
            if rss_limit_gb and i > 0 and i % min(log_every, 50) == 0:
                rss = host_rss_gb()
                if rss > rss_limit_gb:
                    if not out_dir:
                        log({"step": gstep, "warning": f"RSS {rss:.1f} GB over limit but no out_dir to checkpoint to: continuing at risk"})
                    elif not np.isfinite(float(metrics.get("loss", np.nan))):
                        log({"step": gstep, "warning": f"RSS {rss:.1f} GB over limit but loss is non-finite: skipping checkpoint, no restart"})
                    else:
                        save()
                        log({"step": gstep, "warning": f"RSS {rss:.1f} GB > {rss_limit_gb:.1f} GB: checkpointed; raising for restart"})
                        raise RssLimitExceeded(gstep, rss, out_dir)
    finally:
        # retire the watchdog and join the prefetch worker (its generator's finally)
        stall_progress["done"] = True
        if hasattr(batch_iter, "close"):
            batch_iter.close()

    if i < 0:
        log({"error": "training stream produced ZERO batches: check the resolution filter and the dataset paths"})
    if out_dir:
        save()
    return model, state


@torch.no_grad()
def _check_same_batch(batch: DCTPatches, mesh: Mesh) -> None:
    """Raise unless every rank holds the same global batch (a checksum of its
    rows, tokens and values, compared across the world): the sharded step
    takes each rank's rows of it, and ranks that read different streams would
    train on a batch no rank has."""
    import torch.distributed as dist

    valid = ~batch.key_pad_mask
    local = torch.stack([
        torch.tensor(float(batch.patches.shape[0]), dtype=torch.float64, device=batch.patches.device),
        valid.sum().double(), batch.patches.double().sum(), (batch.batched_image_ids.double() * valid).sum(),
    ])
    lo, hi = local.clone(), local.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not torch.equal(lo, hi):
        raise RuntimeError(
            "the ranks were given different batches: every rank must read the same stream with the same seeds"
        )


@torch.no_grad()
def _log_image_grid(model, proc, raw_batch, gstep, n_log_images, out_dir, log, write: bool = True) -> None:
    """Original-vs-reconstruction grid and the batch's RGB pixel MSE (a metric
    only: the host-side unpatch is not differentiated).  proc.postprocess
    launches the IDCT kernel on the card.  write=False runs the forward only
    (a rank other than 0 of a model group).  A pipelined module's forward
    takes the rows padded to its microbatches; the grid keeps the real rows."""
    from ..parallel.pipeline import staged_pipeline
    from ..tools.viz import make_image_grid

    rows = raw_batch.patches.shape[0]
    pipeline = staged_pipeline(model.module)
    batch = pad_batch_rows(raw_batch.to(model.device), pipeline.n_microbatches if pipeline else 1)
    out = model.forward(model.normalize_(batch), training=False)
    if not write:
        return
    os.makedirs(out_dir, exist_ok=True)
    rec = model.inv_normalize_(take_rows(out["dct_patches"], 0, rows))
    rec = rec.replace(patch_sizes=raw_batch.patch_sizes, original_sizes=raw_batch.original_sizes)
    rec_images = proc.postprocess(rec)
    orig_images = proc.postprocess(raw_batch)  # the input tokens
    pixel_loss = float(np.mean([np.mean((np.clip(r, 0, 1) - o) ** 2) for r, o in zip(rec_images, orig_images)]))
    log({"step": gstep, "pixel_loss": pixel_loss})
    make_image_grid(
        orig_images[:n_log_images],
        [np.clip(r, 0, 1) for r in rec_images[:n_log_images]],
        filename=f"{out_dir}/train_image_{gstep:06d}.png",
    )
