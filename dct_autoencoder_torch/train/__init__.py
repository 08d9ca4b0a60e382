"""LFQ autoencoder training on one device: losses, optimizer, step, loop, checkpoints."""
from .checkpoint import has_train_state, load_train_state, save_train_state
from .loop import (
    Optimizer,
    TrainState,
    make_optimizer,
    make_train_step,
    prepare_train_batch,
    train,
    train_patch_norm,
)
from .losses import DEFAULT_LOSS_WEIGHTS, masked_l1, step_autoencoder, weighted_total

__all__ = [
    "DEFAULT_LOSS_WEIGHTS",
    "Optimizer",
    "TrainState",
    "has_train_state",
    "load_train_state",
    "make_optimizer",
    "make_train_step",
    "masked_l1",
    "prepare_train_batch",
    "save_train_state",
    "step_autoencoder",
    "train",
    "train_patch_norm",
    "weighted_total",
]
