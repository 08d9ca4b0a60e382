"""The 1F1B pipeline schedule: forward and backward interleaved, activation
memory bounded by the stage count (JAX: parallel/pipeline_1f1b.py).

GPipe (parallel/pipeline.py) runs every microbatch's forward, then their
backwards, so all M microbatches' activations are alive at once.  Here, on
tick t of T = M + 2S - 2, stage s runs

  * the forward of microbatch  mf = t - s            (when 0 <= mf < M), and
  * the backward of microbatch mb = t - (2S - 2) + s (when 0 <= mb < M);

on the last stage mf == mb, so a microbatch's loss seeds its own backward
while later microbatches are still on their way forward.  Each stage keeps
its inputs in a 2S-slot ring (in flight at stage s: 2(S - 1 - s) < 2S) and
recomputes its layers inside the backward (torch.autograd.grad on the
recomputed graph), so its memory is O(S) microbatches whatever M.  The loss
is evaluated on the last stage, seeded with 1 / (M n_data); activations go
downstream and gradients upstream in one batched point-to-point call a tick
(parallel/mesh.py's hop).  Bubble ticks do nothing, and only activations and
gradients travel: every rank slices the image ids and padding of the
microbatches it runs from its own rows.

A library primitive, as in JAX: the train step runs GPipe.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import broadcast_from_stage, hop, sync_model_group
from .pipeline import PipelineSpec, check_rows, tree_leaves, tree_unflatten


def _block(layer_apply, stage_params, x, ids, pad):
    for p in stage_params:
        x = layer_apply(p, x, ids, pad)
    return x


def pipeline_1f1b_loss_and_grad(
    layer_apply: Callable,
    loss_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: Sequence[Any],
    x: torch.Tensor,
    image_ids: torch.Tensor,
    key_pad_mask: torch.Tensor,
    spec: PipelineSpec,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """1F1B value and gradient of the mean over microbatches of
    loss_fn(stack(x_m), ids_m, pad_m).

    layer_apply(layer_params, x, ids, pad) -> x applies one layer;
    stage_params are this stage's layers' parameters (as for
    pipeline_stack_apply); loss_fn(y, ids, pad) -> scalar is one
    microbatch's objective on the last stage's output.  x, image_ids and
    key_pad_mask are this data rank's rows, split into spec.n_microbatches
    contiguous microbatches.  Every rank of the mesh calls it.

    Returns (loss, grads, dx): the loss, the mean over every microbatch of
    every data rank, on every rank; the gradients of this stage's
    parameters in the structure of stage_params (a module's as a list),
    summed over the data group; the gradient of x, on every model rank."""
    mesh = spec.mesh
    S, M, s = spec.n_stages, spec.n_microbatches, spec.stage
    k = check_rows(x.shape[0], spec)
    params = tree_leaves(stage_params)
    if not all(p.requires_grad for p in params):  # differentiate plain tensors through leaves of their own
        params = [p if p.requires_grad else p.detach().requires_grad_(True) for p in params]
        stage_params = tree_unflatten(stage_params, params)
    ids, pads = image_ids.split(k), key_pad_mask.split(k)
    nslots = 2 * S  # more than the 2S - 2 inputs a stage holds in flight
    ring: List[Any] = [None] * nslots
    seed = 1.0 / (M * spec.n_data)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    grads = [torch.zeros_like(p) for p in params]  # results, accumulated in place
    dx = torch.zeros_like(x)
    fwd_recv = bwd_recv = None
    sync_model_group(mesh)
    for t in range(M + 2 * S - 2):
        mf, mb = t - s, t - (2 * S - 2) + s
        y = dxin = None
        if 0 <= mf < M:
            xin = x[mf * k : (mf + 1) * k] if s == 0 else fwd_recv
            ring[mf % nslots] = xin
            if s < S - 1:  # the last stage's forward is the backward's recompute, below
                with torch.no_grad():
                    y = _block(layer_apply, stage_params, xin, ids[mf], pads[mf])
        if 0 <= mb < M:
            xin = ring[mb % nslots].detach().requires_grad_(True)
            ring[mb % nslots] = None
            with torch.enable_grad():
                yb = _block(layer_apply, stage_params, xin, ids[mb], pads[mb])
                if s == S - 1:
                    lb = loss_fn(yb, ids[mb], pads[mb])
                    loss += lb.detach().float() * seed
                    out, cot = lb, torch.full_like(lb, seed)
                else:
                    out, cot = yb, bwd_recv
                d = torch.autograd.grad(out, [xin] + params, cot, allow_unused=True)
            dxin = d[0]
            pairs = [(acc, g) for acc, g in zip(grads, d[1:]) if g is not None]
            torch._foreach_add_([a for a, _ in pairs], [g for _, g in pairs])
            if s == 0:
                dx[mb * k : (mb + 1) * k] = dxin
        # what arrives on this tick: stage s - 1's forward output and stage s + 1's input gradient
        fwd_recv = x.new_empty((k, *x.shape[1:])) if s > 0 and 0 <= t - (s - 1) < M else None
        bwd_recv = x.new_empty((k, *x.shape[1:])) if s < S - 1 and 0 <= t - (2 * S - 2) + s + 1 < M else None
        sends = ([(y, s + 1)] if y is not None else []) + ([(dxin, s - 1)] if dxin is not None and s > 0 else [])
        recvs = ([(fwd_recv, s - 1)] if fwd_recv is not None else []) + ([(bwd_recv, s + 1)] if bwd_recv is not None else [])
        hop(mesh, sends, recvs)

    # the loss lives on the last stage and dx on stage 0: share them over the
    # model group, then sum the loss and the stage's gradients over the data group
    broadcast_from_stage(loss, mesh, S - 1)
    broadcast_from_stage(dx, mesh, 0)
    if spec.n_data > 1:
        flat = torch.cat([loss.reshape(1)] + [g.float().reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.data_group)
        loss, off = flat[0], 1
        for i, g in enumerate(grads):
            grads[i] = flat[off : off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
    return loss, tree_unflatten(stage_params, grads), dx
