"""GPipe pipeline parallelism over the transformer stacks, with torch.distributed.

Counterpart of the JAX package's parallel/pipeline.py.  The layers of each
stack are split into S contiguous stages over the mesh's model axis
(parallel/mesh.py's `stage_layers`: stage s owns layers [s L / S, (s + 1) L / S)),
one process a card, and M microbatches of each rank's rows stream through
them: on tick t of M + S - 1, stage s runs microbatch t - s, and activations
hop to the next stage (`mesh.hop`, one batch_isend_irecv a tick with matched
pairs).  The last stage collects the outputs and broadcasts them over the
model group, so every model rank holds the (b, s, d) output that the
sequential stack gives (JAX: a psum over the model axis).

The backward is one torch.autograd.Function around the schedule.  Its
forward keeps each microbatch's graph through the stage (with remat, each
layer checkpointed inside it, as JAX's jax.checkpoint per layer).  Its
backward takes the output's gradient as the last stage holds it (every
model rank ran the same graph after the stack on the broadcast output, so
the copies are one gradient, not S to sum), runs the microbatches'
backwards in reverse order, each stage sending its input's gradient
upstream, and broadcasts stage 0's input gradient over the model group: the
embeddings that feed the stack get their gradient on every model rank.  The
stage's parameter gradients are those of its layers only.

Differences from JAX, on purpose: bubble ticks do nothing (JAX computes on
garbage, branchless); only activations travel, because every rank holds the
whole batch and slices the image ids and padding of the microbatch it runs;
a stage's parameters are its layers' own, at rest and in the optimizer
(parallel/optim.py), not a stacked view gathered each step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.utils.checkpoint

from .mesh import Mesh, broadcast_from_stage, hop, stage_layers, sync_model_group


@dataclasses.dataclass(frozen=True, eq=False)
class PipelineSpec:
    """A pipeline over `mesh`'s model axis with n_microbatches microbatches
    of each data rank's rows (JAX's PipelineSpec: the stage axis is the
    model axis)."""

    mesh: Mesh
    n_microbatches: int = 4

    @property
    def n_stages(self) -> int:
        return self.mesh.n_model

    @property
    def stage(self) -> int:
        return self.mesh.model_rank

    @property
    def n_data(self) -> int:
        return self.mesh.n_data


def check_stackable(config, n_stages: int, training: bool = False) -> None:
    """Raise ValueError by name where a model's stacks cannot run as a
    pipeline of n_stages stages (JAX's asserts): layers that do not divide,
    a per-layer int8/bf16 mix, and with training=True dropout in either
    stack.  train() and the CLI call it before any process joins a group."""
    for stack in (config.encoder_config, config.decoder_config):
        stage_layers(stack.num_hidden_layers, n_stages, 0)
        if stack.quantize_int8 and stack.quantize_int8_bf16_layers:
            raise ValueError(
                f"quantize_int8_bf16_layers={stack.quantize_int8_bf16_layers}: a pipeline needs homogeneous "
                "layers (no per-layer int8/bf16 mix)"
            )
        if training:
            check_no_dropout(stack)


def check_no_dropout(stack_config) -> None:
    """A pipelined stack trains without dropout: it threads no dropout
    generators through its stages (JAX's assert)."""
    if stack_config.dropout > 0.0 or stack_config.attention_dropout > 0.0:
        raise ValueError(
            f"dropout={stack_config.dropout!r}, attention_dropout={stack_config.attention_dropout!r}: a pipelined "
            "stack does not thread dropout generators through its stages"
        )


def staged_pipeline(module: torch.nn.Module) -> Optional[PipelineSpec]:
    """The PipelineSpec that make_pipelined_module staged `module`'s stacks
    with, or None for a module that is not staged."""
    from .mesh import staged_stacks

    specs = {id(st.pipeline): st.pipeline for st in staged_stacks(module).values()}
    if len(specs) > 1:
        raise ValueError("the module's stacks were staged by different pipelines: use make_pipelined_module")
    return next(iter(specs.values()), None)


def make_pipelined_module(module: torch.nn.Module, mesh: Mesh, n_microbatches: int) -> torch.nn.Module:
    """Run both transformer stacks of `module` (a DCTAutoencoderModule) as
    GPipe pipelines over `mesh`'s model axis, in place: each stack keeps the
    layers of this rank's stage, under their single-device keys.  Returns
    the module.  parallel.unshard_params undoes it; gather_params gives the
    single-device state_dict."""
    from .mesh import _stacks

    if n_microbatches < 1:
        raise ValueError(f"n_microbatches={n_microbatches}: a pipeline needs at least one microbatch")
    check_stackable(module.config, mesh.n_model)
    spec = PipelineSpec(mesh, n_microbatches)
    for stack in _stacks(module):
        stack.set_pipeline(spec)
    return module


# ---------------------------------------------------------------- parameter trees


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a stage's parameters: nn.Modules (their parameters),
    dicts, lists and tuples of them, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    raise TypeError(f"a stage's parameters are tensors, modules, dicts, lists or tuples, not {type(tree).__name__}")


def tree_unflatten(tree, leaves: Sequence):
    """`leaves` in the structure of `tree` (a module's become a list)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, torch.nn.Module):
            return [next(it) for _ in t.parameters()]
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return type(t)(build(v) for v in t)

    return build(tree)


# ---------------------------------------------------------------- the schedule


def check_rows(b: int, spec: PipelineSpec) -> int:
    """The rows of one microbatch of a data rank's `b` rows."""
    if b % spec.n_microbatches:
        raise ValueError(
            f"batch of {b} rows on a data rank not divisible by {spec.n_microbatches} microbatches "
            f"(data shards x microbatches: {spec.n_data} x {spec.n_microbatches})"
        )
    return b // spec.n_microbatches


class _GPipe:
    """One pipelined stack call on this rank: its stage's layers, the
    microbatches' metadata, and the graphs its forward keeps for the backward."""

    def __init__(self, layer_apply, stage_params, image_ids, key_pad_mask, spec: PipelineSpec, remat: bool, micro: int):
        self.layer_apply, self.stage_params, self.spec, self.remat = layer_apply, list(stage_params), spec, remat
        self.params = tree_leaves(stage_params)
        self.micro = micro
        self.ids = image_ids.split(micro)
        self.pad = key_pad_mask.split(micro)
        self.saved: List[Any] = []

    def block(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """This stage's layers on microbatch m."""
        for p in self.stage_params:
            if self.remat:
                x = torch.utils.checkpoint.checkpoint(
                    self.layer_apply, p, x, self.ids[m], self.pad[m], use_reentrant=False
                )
            else:
                x = self.layer_apply(p, x, self.ids[m], self.pad[m])
        return x

    def forward(self, x: torch.Tensor, keep: bool, need_dx: bool) -> torch.Tensor:
        """The stack's output on every model rank; keep=True keeps each
        microbatch's graph (input, output) for backward()."""
        spec, mesh = self.spec, self.spec.mesh
        S, M, s, k = spec.n_stages, spec.n_microbatches, spec.stage, self.micro
        out = torch.empty_like(x)
        self.saved = [None] * M
        sync_model_group(mesh)
        recv = None
        for t in range(M + S - 1):
            m, y = t - s, None
            if 0 <= m < M:
                xin = x[m * k : (m + 1) * k] if s == 0 else recv
                if keep:
                    # a later stage always sends its input's gradient upstream
                    xin = xin.detach().requires_grad_(s > 0 or need_dx)
                    with torch.enable_grad():
                        y = self.block(xin, m)
                    self.saved[m] = (xin, y)
                else:
                    y = self.block(xin, m)
                if s == S - 1:
                    out[m * k : (m + 1) * k] = y.detach()
            # stage s - 1 runs microbatch t - (s - 1) on this tick: its output arrives now
            recv = x.new_empty((k, *x.shape[1:])) if s > 0 and 0 <= t - s + 1 < M else None
            hop(mesh, [(y.detach(), s + 1)] if y is not None and s < S - 1 else [],
                [(recv, s - 1)] if recv is not None else [])
        return broadcast_from_stage(out, mesh, S - 1)

    def backward(self, g: torch.Tensor, params: List[torch.Tensor], need_dx: bool):
        """(gradient of the stack's input on every model rank or None, this
        stage's parameter gradients), from the output gradient `g`."""
        spec, mesh = self.spec, self.spec.mesh
        S, M, s, k = spec.n_stages, spec.n_microbatches, spec.stage, self.micro
        dx = torch.empty_like(g) if need_dx else None
        grads: List[Any] = []
        recv = None
        for t in range(M + S - 1):
            # the forward's ticks mirrored: stage S - 1 starts on microbatch M - 1
            m, dxin = M - 1 - (t - (S - 1 - s)), None
            if 0 <= m < M:
                gy = g[m * k : (m + 1) * k] if s == S - 1 else recv
                xin, y = self.saved[m]
                self.saved[m] = None
                inputs = ([xin] if xin.requires_grad else []) + params
                out = torch.autograd.grad(y, inputs, gy, allow_unused=True)
                if xin.requires_grad:
                    dxin, out = out[0], out[1:]
                if not grads:
                    grads = list(out)
                else:  # in fused launches, and not in place: a gradient may alias g
                    live = [i for i, d in enumerate(out) if d is not None]
                    for i, a in zip(live, torch._foreach_add([grads[i] for i in live], [out[i] for i in live])):
                        grads[i] = a
                if s == 0 and need_dx:
                    dx[m * k : (m + 1) * k] = dxin
            # stage s + 1 runs microbatch m + 1's backward on this tick: its input gradient arrives now
            m_next = M - 1 - (t - (S - 2 - s))
            recv = g.new_empty((k, *g.shape[1:])) if s < S - 1 and 0 <= m_next < M else None
            hop(mesh, [(dxin, s - 1)] if dxin is not None and s > 0 else [],
                [(recv, s + 1)] if recv is not None else [])
        if need_dx:
            broadcast_from_stage(dx, mesh, 0)
        return dx, grads


class _GPipeFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _GPipe, x, *params):
        ctx.run = run
        return run.forward(x, keep=True, need_dx=x.requires_grad)

    @staticmethod
    def backward(ctx, g):
        params = [p for p, need in zip(ctx.run.params, ctx.needs_input_grad[2:]) if need]
        dx, grads = ctx.run.backward(g.contiguous(), params, ctx.needs_input_grad[1])
        it = iter(grads)
        return (None, dx, *[next(it) if need else None for need in ctx.needs_input_grad[2:]])


def pipeline_stack_apply(
    layer_apply: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    stage_params: Sequence[Any],
    x: torch.Tensor,
    image_ids: torch.Tensor,
    key_pad_mask: torch.Tensor,
    spec: PipelineSpec,
    remat: bool = False,
) -> torch.Tensor:
    """Run a homogeneous layer stack as a GPipe pipeline.

    layer_apply(layer_params, x, image_ids, key_pad_mask) -> x applies one
    layer; stage_params are this stage's layers' parameters, in order (the
    layers `mesh.stage_layers(L, S, stage)` names: tensors, modules, dicts
    or lists of them).  x (b, s, d), image_ids and key_pad_mask (b, s) are
    this data rank's rows; b must divide by spec.n_microbatches, which split
    them into contiguous microbatches.  Returns, on every model rank, the
    (b, s, d) output that the sequential stack gives; its backward is the
    sequential stack's.  Every rank of the model group calls it."""
    micro = check_rows(x.shape[0], spec)
    run = _GPipe(layer_apply, stage_params, image_ids, key_pad_mask, spec, remat, micro)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in run.params)):
        return _GPipeFunction.apply(run, x, *run.params)
    with torch.no_grad():
        return run.forward(x, keep=False, need_dx=False)
