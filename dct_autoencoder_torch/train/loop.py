"""Training loop on one device: optimizer, train step, calibration, checkpoints.

Counterpart of the JAX package's train/loop.py for LFQ models:
  * AdamW(0.9, 0.99, eps 1e-8, weight decay 0.1 on every parameter) behind a
    global-norm clip at 5.0, under the warmup-cosine schedule of
    ``optax.warmup_cosine_decay_schedule`` reproduced step for step (the
    first update runs at learning rate 0 when there is a warmup);
  * one step = normalize -> forward -> losses -> backward -> update, with
    gradient accumulation over row micro-batches;
  * the norm-calibration phase with beta forced to 0 and full sequences;
  * the loop itself: logging, periodic and final checkpoints, exact resume,
    NaN abort or restore.

Where JAX returns new pytrees, the port updates the module's fp32
parameters and the optimizer's moments in place.

Not ported: the pixel loss, VQ mode and its codebook surgery, 8-bit
optimizer moments, shared-program sweeps, the RSS and stall watchdogs,
prefetch, image-grid logging, attention dropout and everything
multi-device.  `train` raises NotImplementedError for an argument (or, for
attention dropout, a config) that asks for one of them.
"""
from __future__ import annotations

import dataclasses
import math
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

    def schedule(self, count: int) -> float:
        """Learning rate of update number `count` (0 for the first)."""
        if count < self.warmup_steps:
            return self.learning_rate * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        t = min(float(count - self.warmup_steps), float(span))
        return self.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, module: torch.nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            list(module.parameters()), lr=self.schedule(0), betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay,
        )


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
    """AdamW + warmup-cosine + clip, with the JAX package's defaults."""
    if opt_8bit:
        raise NotImplementedError("opt_8bit (blockwise-int8 Adam moments) is not ported yet")
    warmup_steps = min(warmup_steps, max(max_iters - 1, 0))
    return Optimizer(
        learning_rate=learning_rate, warmup_steps=warmup_steps, decay_steps=max(max_iters, warmup_steps + 1),
        weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip,
    )


@dataclasses.dataclass
class TrainState:
    module: DCTAutoencoderModule  # its fp32 parameters are the trained state
    adamw: torch.optim.AdamW  # first and second moments
    step: int = 0

    @staticmethod
    def create(module: DCTAutoencoderModule, tx: Optimizer) -> "TrainState":
        return TrainState(module=module, adamw=tx.init(module), step=0)


def prepare_train_batch(
    batch: DCTPatches, pixel_loss_max_images: int = 0, clip_grid: Optional[Tuple[int, int]] = None
):
    """Strip the per-image Python metadata the train step never reads.
    Returns (stripped_batch, None); the second slot is the pixel loss's."""
    if pixel_loss_max_images:
        raise NotImplementedError("the pixel loss (pixel_loss_max_images) is not ported yet")
    return batch.replace(patch_sizes=(), original_sizes=(), _data=None), None


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
    """Build the train-step fn (state, patchnorm, batch) -> (state, metrics).

    Normalization is done inside the step (frozen patchnorm).  The state's
    module and optimizer are updated in place and the same state object is
    returned with its step advanced.  Metrics are 0-d tensors on the
    module's device (reading one synchronises); 'grad_norm' is the global
    norm before clipping.  `seed` seeds the dropout masks when the config has
    dropout.
    """
    if use_pixel_loss:
        raise NotImplementedError("the pixel loss (use_pixel_loss) is not ported yet")
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

    def backward(patchnorm, batch, step, token_weight=None) -> Dict[str, torch.Tensor]:
        normalized = batch.replace(patches=apply_patchnorm(patchnorm, batch))
        losses = step_autoencoder(
            module, patchnorm, batch, normalized, training=True, generator=dropout_generator(batch.patches.device)
        )
        if token_weight is not None:
            for k in _TOKEN_MEAN_LOSSES:
                losses[k] = losses[k] * token_weight
        total = weighted_total(losses, loss_weights, warmup_dict, float(step))
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items() if k not in ("codes", "rec_patches")}
        metrics["loss"] = total.detach()
        return metrics

    def train_step(state: TrainState, patchnorm: PatchNormState, batch: DCTPatches):
        if state.module is not module:
            raise ValueError("the state belongs to another module than the step was built for")
        params = [p for p in module.parameters() if p.requires_grad]
        state.adamw.zero_grad(set_to_none=True)
        if accum_steps == 1:
            metrics = backward(patchnorm, batch, state.step)
        else:
            b = batch.patches.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch rows ({b}) must divide by accum_steps ({accum_steps}): pad_batch_rows first")
            mb = b // accum_steps
            tokens_per_row = (~batch.key_pad_mask).sum(dim=1).float()
            total_tokens = torch.clamp(tokens_per_row.sum(), min=1.0)
            metrics = None
            for i in range(accum_steps):
                token_weight = tokens_per_row[i * mb : (i + 1) * mb].sum() * accum_steps / total_tokens
                m = backward(patchnorm, _rows(batch, i * mb, (i + 1) * mb), state.step, token_weight)
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            metrics = {k: v / accum_steps for k, v in metrics.items()}
            torch._foreach_div_([p.grad for p in params if p.grad is not None], float(accum_steps))

        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax.clip_by_global_norm: untouched below the limit, else g / norm * limit
        scale = torch.where(grad_norm < tx.grad_clip, torch.ones_like(grad_norm), tx.grad_clip / grad_norm)
        torch._foreach_mul_(grads, scale)
        for group in state.adamw.param_groups:
            group["lr"] = tx.schedule(state.step)
        state.adamw.step()
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
    opt_8bit: bool = False,
    use_pixel_loss: bool = False,
    prefetch_batches: int = 0,
    # 'abort' stops on a non-finite loss; 'restore' rolls back to the last
    # saved train state and keeps consuming the stream (needs out_dir and
    # save_every; before the first save it aborts with an explanation)
    nan_policy: str = "abort",
    rss_limit_gb: float = 0.0,
    stall_timeout_s: float = 0.0,
    log_every: int = 50,
    save_every: int = 1000,
    # keep a model-only copy of each periodic save at out_dir/ckpt_<step>
    keep_checkpoints: bool = False,
    log_images_every: int = 0,
    out_dir: Optional[str] = None,
    resume_path: Optional[str] = None,
    seed: int = 0,
    log: Callable[[Dict], None] = print,
) -> Tuple[DCTAutoencoder, TrainState]:
    """Main training loop, on the model's device.

    `data_iter` yields dicts of per-image columns (as `proc.preprocess_many`
    gives them); the processor packs them into batches.  max_iters counts
    total steps across restarts: a resumed state runs only the remainder.
    The model's parameters are trained in place.
    """
    _refuse_unported(
        n_model_parallel=(n_model_parallel, 1, "model parallelism"),
        pipeline_microbatches=(pipeline_microbatches, 0, "pipeline parallelism"),
        zero1=(zero1, False, "ZeRO-1 optimizer sharding"),
        opt_8bit=(opt_8bit, False, "opt_8bit (blockwise-int8 Adam moments)"),
        use_pixel_loss=(use_pixel_loss, False, "the pixel loss"),
        prefetch_batches=(prefetch_batches, 0, "batch prefetch"),
        rss_limit_gb=(rss_limit_gb, 0.0, "the RSS watchdog"),
        stall_timeout_s=(stall_timeout_s, 0.0, "the stall watchdog"),
        log_images_every=(log_images_every, 0, "image-grid logging"),
    )
    _refuse_attention_dropout(model.config)
    if nan_policy not in ("abort", "restore"):
        raise ValueError(f"nan_policy must be 'abort' or 'restore', got {nan_policy!r}")
    from .checkpoint import has_train_state, load_train_state, save_train_state

    tx = make_optimizer(learning_rate, max_iters)
    state = TrainState.create(model.module, tx)
    if resume_path is not None and has_train_state(resume_path):
        state, model.patchnorm = load_train_state(resume_path, state, model.patchnorm)
        log({"resumed_from": resume_path, "step": state.step})
    step_fn = make_train_step(model.module, tx, loss_weights, warmup_dict, grad_accumulation_steps, seed=seed)

    def save(gstep: Optional[int] = None) -> None:
        model.save_pretrained(f"{out_dir}/model")
        save_train_state(out_dir, state, model.patchnorm)
        if gstep is not None and keep_checkpoints:
            model.save_pretrained(f"{out_dir}/ckpt_{gstep:06d}")

    t0 = time.time()
    i = -1
    start_step = state.step
    for i, raw_batch in enumerate(proc.iter_batches(data_iter, batch_size)):
        if i >= max_iters - start_step:
            break
        gstep = start_step + i  # global step across restarts
        batch, _ = prepare_train_batch(raw_batch)
        batch = pad_batch_rows(batch.to(model.device), grad_accumulation_steps)
        state, metrics = step_fn(state, model.patchnorm, batch)

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

        if out_dir and save_every and i > 0 and gstep % save_every == 0:
            # never checkpoint a poisoned state: 'restore' would restore it forever
            if np.isfinite(float(metrics["loss"])):
                save(gstep)
            else:
                log({"step": gstep, "warning": "skipping checkpoint: non-finite loss"})

    if i < 0:
        log({"error": "training stream produced ZERO batches: check the resolution filter and the dataset paths"})
    if out_dir:
        save()
    return model, state
