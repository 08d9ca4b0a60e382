"""Faults planted under the timed path, to show that `correct` comes out false
(the tests and calibrate.py plant them; a benchmark run never does):

* unchanged: the optimizer's update is skipped, so a step leaves the state as it was;
* half: each step's losses and gradients come from half of its rows, the mean over the rest;
* answer: each call's first image is brightened by a tenth where the pixels are made.
"""
from __future__ import annotations

import torch

FAULTS = ("unchanged", "half", "answer")


class Fault:
    def __init__(self, name: str):
        if name not in FAULTS:
            raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
        self.name = name
        self._undo = []

    def _swap(self, owner, attr: str, new) -> None:
        old = getattr(owner, attr)
        setattr(owner, attr, new)
        self._undo.append((owner, attr, old))

    def plant(self) -> None:
        from dct_autoencoder_torch.train import loop

        if self.name == "unchanged":
            def apply(tx, adamw, params, count, lr_scale=1.0):
                grads = [p.grad for p in params if p.grad is not None]
                return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

            self._swap(loop.Optimizer, "apply", apply)
        elif self.name == "half":
            from dct_autoencoder_torch.parallel.mesh import take_rows

            inner = loop.step_autoencoder

            def half(module, patchnorm, batch, normalized, *a, **k):
                n = batch.patches.shape[0] // 2
                return inner(module, patchnorm, take_rows(batch, 0, n), take_rows(normalized, 0, n), *a, **k)

            self._swap(loop, "step_autoencoder", half)
        elif self.name == "answer":
            from dct_autoencoder_torch import pipeline

            inner = pipeline.DCTPipeline._fused_reconstruct

            def brighter(pipe, decoded, grid, orig, max_images, as_uint8):
                out = inner(pipe, decoded, grid, orig, max_images, False).copy()
                out[0] = (out[0] + 0.1).clip(0.0, 1.0)
                return (out * 255.0 + 0.5).astype("uint8") if as_uint8 else out

            self._swap(pipeline.DCTPipeline, "_fused_reconstruct", brighter)

    def remove(self) -> None:
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)
