"""LFQ autoencoder training on one device: losses (the pixel loss included),
optimizers (AdamW, 8-bit AdamW), step, loop, checkpoints, and the CLI."""
from .checkpoint import has_train_state, load_train_state, save_train_state
from .loop import (
    Optimizer,
    RssLimitExceeded,
    TrainState,
    make_optimizer,
    make_train_step,
    prepare_train_batch,
    train,
    train_patch_norm,
)
from .losses import DEFAULT_LOSS_WEIGHTS, masked_l1, step_autoencoder, weighted_total
from .opt8bit import AdamW8bit, opt_state_bytes

__all__ = [
    "AdamW8bit",
    "DEFAULT_LOSS_WEIGHTS",
    "Optimizer",
    "RssLimitExceeded",
    "TrainState",
    "has_train_state",
    "load_train_state",
    "make_optimizer",
    "make_train_step",
    "masked_l1",
    "opt_state_bytes",
    "prepare_train_batch",
    "save_train_state",
    "step_autoencoder",
    "train",
    "train_patch_norm",
    "weighted_total",
]
