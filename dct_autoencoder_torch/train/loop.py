"""Training loop on one device: optimizer, train step, calibration, checkpoints.

Counterpart of the JAX package's train/loop.py for LFQ models:
  * AdamW(0.9, 0.99, eps 1e-8, weight decay 0.1 on every parameter) behind a
    global-norm clip at 5.0, under the warmup-cosine schedule of
    ``optax.warmup_cosine_decay_schedule`` reproduced step for step (the
    first update runs at learning rate 0 when there is a warmup); with
    opt_8bit the moments are stored blockwise in 8 bits (train/opt8bit.py);
  * one step = normalize -> forward -> losses (optionally the RGB pixel
    loss) -> backward -> update, with gradient accumulation over row
    micro-batches;
  * the norm-calibration phase with beta forced to 0 and full sequences;
  * the loop itself: batch prefetch on a host thread, logging, image grids,
    periodic and final checkpoints, exact resume, NaN abort or restore, and
    the stall and host-RSS watchdogs.

Where JAX returns new pytrees, the port updates the module's fp32
parameters and the optimizer's moments in place.

Not ported: VQ mode and its codebook surgery, shared-program sweeps
(dynamic_hparams), attention dropout and everything multi-device; they
raise NotImplementedError by name.  One default differs from JAX on
purpose: the RSS watchdog is off (rss_limit_gb=0), since it works around a
memory leak of the TPU client that this runtime does not have.
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

from ..models.autoencoder import DCTAutoencoder, DCTAutoencoderModule
from ..models.patchnorm import PatchNormState, apply_patchnorm, calibrate_patchnorm_batch
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
        if self.opt_8bit:
            from .opt8bit import AdamW8bit

            return AdamW8bit(
                list(module.parameters()), lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps,
                weight_decay=self.weight_decay,
            )
        return torch.optim.AdamW(
            list(module.parameters()), lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay,
        )

    def apply(self, adamw: torch.optim.Optimizer, params: List[torch.Tensor], count: int) -> torch.Tensor:
        """Clip the parameters' gradients by their global norm, then take
        update number `count`; returns the norm before clipping."""
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax.clip_by_global_norm: untouched below the limit, else g / norm * limit
        scale = torch.where(grad_norm < self.grad_clip, torch.ones_like(grad_norm), self.grad_clip / grad_norm)
        torch._foreach_mul_(grads, scale)
        for group in adamw.param_groups:
            group["lr"] = self.schedule(count)
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
    module: DCTAutoencoderModule  # its fp32 parameters are the trained state
    adamw: torch.optim.Optimizer  # first and second moments (AdamW or AdamW8bit)
    step: int = 0

    @staticmethod
    def create(module: DCTAutoencoderModule, tx: Optimizer) -> "TrainState":
        return TrainState(module=module, adamw=tx.init(module), step=0)


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


def _tensor_fields(batch: DCTPatches) -> List[str]:
    return [f.name for f in dataclasses.fields(batch) if isinstance(getattr(batch, f.name), torch.Tensor)]


def pad_batch_rows(batch: DCTPatches, multiple: int) -> DCTPatches:
    """Right-pad packed rows to a multiple; padding rows are fully masked."""
    b = batch.patches.shape[0]
    pad_rows = (-b) % multiple
    if pad_rows == 0:
        return batch
    padded = {}
    for name in _tensor_fields(batch):
        x = getattr(batch, name)
        padded[name] = torch.cat([x, x.new_zeros((pad_rows, *x.shape[1:]))], dim=0)
    padded["key_pad_mask"][b:] = True
    return batch.replace(**padded)


def _rows(batch: DCTPatches, start: int, stop: int) -> DCTPatches:
    return batch.replace(**{name: getattr(batch, name)[start:stop] for name in _tensor_fields(batch)})


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
    dynamic_hparams: bool = False,
) -> Callable:
    """Build the train-step fn (state, patchnorm, batch[, grid_sizes]) -> (state, metrics).

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
    """
    _refuse_attention_dropout(module.config)
    if dynamic_hparams:
        raise NotImplementedError("dynamic_hparams (shared-program sweeps) is not ported yet")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    generators: Dict[torch.device, torch.Generator] = {}

    def dropout_generator(device: torch.device) -> Optional[torch.Generator]:
        cfg = module.config
        if cfg.encoder_config.dropout <= 0.0 or cfg.encoder_config.remat:
            return None  # remat redraws from the default generator
        if device not in generators:
            generators[device] = torch.Generator(device=device).manual_seed(seed)
        return generators[device]

    def backward(patchnorm, batch, step, grid_sizes=None, pixel_rows=None, pixel_weight=None, token_weight=None):
        normalized = batch.replace(patches=apply_patchnorm(patchnorm, batch))
        losses = step_autoencoder(
            module, patchnorm, batch, normalized, training=True, generator=dropout_generator(batch.patches.device),
            pixel_grid_sizes=grid_sizes, pixel_rows=pixel_rows,
        )
        if pixel_weight is not None:
            losses["pixel_loss"] = losses["pixel_loss"] * pixel_weight
        if token_weight is not None:
            for k in _TOKEN_MEAN_LOSSES:
                losses[k] = losses[k] * token_weight
        total = weighted_total(losses, loss_weights, warmup_dict, float(step))
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items() if k not in ("codes", "rec_patches")}
        metrics["loss"] = total.detach()
        return metrics

    def train_step(state: TrainState, patchnorm: PatchNormState, batch: DCTPatches, grid_sizes=None):
        if state.module is not module:
            raise ValueError("the state belongs to another module than the step was built for")
        if use_pixel_loss != (grid_sizes is not None):
            raise ValueError("grid sizes (prepare_train_batch(pixel_loss_max_images=...)) go with use_pixel_loss, and only with it")
        params = [p for p in module.parameters() if p.requires_grad]
        state.adamw.zero_grad(set_to_none=True)
        if accum_steps == 1:
            metrics = backward(patchnorm, batch, state.step, grid_sizes)
        else:
            b = batch.patches.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch rows ({b}) must divide by accum_steps ({accum_steps}): pad_batch_rows first")
            mb = b // accum_steps
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
                rows = slice(i * mb, (i + 1) * mb)
                token_weight = tokens_per_row[rows].sum() * accum_steps / total_tokens
                pixel_rows = pixel_weight = None
                if grid_sizes is not None:
                    row_off, counts = g_offsets[rows], n_per_row[rows]
                    start = row_off[0]
                    slot_mask = (slots >= start) & (slots < start + counts.sum())
                    pixel_rows = (row_off, slot_mask)
                    pixel_weight = slot_mask.sum().float() * accum_steps / torch.clamp(total_images, min=1.0)
                m = backward(
                    patchnorm, _rows(batch, i * mb, (i + 1) * mb), state.step, grid_sizes, pixel_rows, pixel_weight,
                    token_weight,
                )
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            metrics = {k: v / accum_steps for k, v in metrics.items()}
            torch._foreach_div_([p.grad for p in params if p.grad is not None], float(accum_steps))

        grad_norm = tx.apply(state.adamw, params, state.step)
        state.adamw.zero_grad(set_to_none=True)
        state.step += 1
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


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


def _refuse_unported(**asked) -> None:
    for name, (value, off, part) in asked.items():
        if value != off:
            raise NotImplementedError(f"{name}={value!r}: {part} is not ported yet")


def _refuse_attention_dropout(config) -> None:
    """The JAX package drops attention weights in training on its XLA
    attention path only; the port's attention is the kernel, which has no
    dropout, so it refuses rather than train another function."""
    _refuse_unported(
        attention_dropout=(config.encoder_config.attention_dropout, 0.0, "attention dropout (the encoder's)")
    )


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
    n_model_parallel: int = 1,
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
    """
    _refuse_unported(
        n_model_parallel=(n_model_parallel, 1, "model parallelism"),
        pipeline_microbatches=(pipeline_microbatches, 0, "pipeline parallelism"),
        zero1=(zero1, False, "ZeRO-1 optimizer sharding"),
    )
    _refuse_attention_dropout(model.config)
    if nan_policy not in ("abort", "restore"):
        raise ValueError(f"nan_policy must be 'abort' or 'restore', got {nan_policy!r}")
    from .checkpoint import has_train_state, load_train_state, save_train_state

    tx = make_optimizer(learning_rate, max_iters, opt_8bit=opt_8bit)
    state = TrainState.create(model.module, tx)
    if resume_path is not None and has_train_state(resume_path):
        state, model.patchnorm = load_train_state(resume_path, state, model.patchnorm)
        log({"resumed_from": resume_path, "step": state.step})
    step_fn = make_train_step(
        model.module, tx, loss_weights, warmup_dict, grad_accumulation_steps, use_pixel_loss=use_pixel_loss, seed=seed
    )
    clip_grid = (model.config.max_patch_h, model.config.max_patch_w)

    def save(gstep: Optional[int] = None) -> None:
        model.save_pretrained(f"{out_dir}/model")
        save_train_state(out_dir, state, model.patchnorm)
        if gstep is not None and keep_checkpoints:
            model.save_pretrained(f"{out_dir}/ckpt_{gstep:06d}")

    if rss_limit_gb < 0:
        rss_limit_gb = _auto_rss_limit_gb()
    stall_progress = {"t": None, "done": False}
    if stall_timeout_s and stall_timeout_s > 0:
        _start_stall_watchdog(stall_timeout_s, stall_progress, on_stall, log)
    batch_iter = proc.iter_batches(data_iter, batch_size)
    if prefetch_batches > 0:
        from ..data.prefetch import prefetch

        batch_iter = prefetch(batch_iter, prefetch_batches)

    t0 = time.time()
    i = -1
    start_step = state.step
    try:
        for i, raw_batch in enumerate(batch_iter):
            if i >= max_iters - start_step:
                break
            gstep = start_step + i  # global step across restarts
            batch, grid_sizes = prepare_train_batch(raw_batch, pixel_loss_max_images if use_pixel_loss else 0, clip_grid)
            # padding rows are fully masked, so grid sizes built before the pad stay aligned
            batch = pad_batch_rows(batch.to(model.device), grad_accumulation_steps)
            if grid_sizes is not None:
                grid_sizes = grid_sizes.to(model.device)
            state, metrics = step_fn(state, model.patchnorm, batch, grid_sizes)
            stall_progress["t"] = time.monotonic()

            if i % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
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
                    step=gstep, sec_per_step=(time.time() - t0) / max(i, 1), images_per_batch=len(raw_batch.original_sizes)
                )
                log(metrics)

            if out_dir and log_images_every and gstep % log_images_every == 0:
                _log_image_grid(model, proc, raw_batch, gstep, n_log_images, out_dir, log)

            if out_dir and save_every and i > 0 and gstep % save_every == 0:
                # never checkpoint a poisoned state: 'restore' would restore it forever
                if np.isfinite(float(metrics["loss"])):
                    save(gstep)
                else:
                    log({"step": gstep, "warning": "skipping checkpoint: non-finite loss"})

            # its own cadence, not log_every; i > 0: a restarted process makes
            # at least one step of progress before it may restart again
            if rss_limit_gb and i > 0 and i % min(log_every, 50) == 0:
                rss = _rss_gb()
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
def _log_image_grid(model, proc, raw_batch, gstep, n_log_images, out_dir, log) -> None:
    """Original-vs-reconstruction grid and the batch's RGB pixel MSE (a metric
    only: the host-side unpatch is not differentiated).  proc.postprocess
    launches the IDCT kernel on the card."""
    from ..tools.viz import make_image_grid

    os.makedirs(out_dir, exist_ok=True)
    out = model.forward(model.normalize_(raw_batch.to(model.device)), training=False)
    rec = model.inv_normalize_(out["dct_patches"])
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
