"""The optimizer of one rank of a (data, model) mesh: gradients summed, the
global norm and clip, and the update of this rank's share of the parameters
(JAX: train/loop.py's model_state_sharding, zero1_state_sharding and the
sharded step's update).

A tensor-parallel parameter is updated on this rank's block, with moments
of the block's size, as JAX splits the moments on the model axis: the
update is elementwise, and AdamW8bit's 256-value blocks of a block split on
dim 0 whose size is a multiple of 256 are blocks of the whole parameter.
The rest of AdamW8bit's tensor-parallel parameters (those split on dim 1,
and the small column-parallel biases) are updated whole on every model
rank, from gathered gradients, so that their codes are those of one device.
Under ZeRO-1 each data rank updates one slice of the flattened value
(`zero1_partition`'s choice of parameters, a multiple of 256 values for
AdamW8bit), a view of its own parameter where the value is its block.
Each step:

  1. model group: the gradients of the parameters updated whole are
     all-gathered, and the partial gradients of the row-parallel biases
     (and, under sequence parallelism, of the LayerNorms) are summed;
  2. data group: gradients are all-reduced (summed: each rank's loss is
     already its share of the global loss); under ZeRO-1 the sliced ones
     are reduce-scattered instead, each rank receiving the sum of its slice;
  3. the global norm: per-parameter norms, those of blocks and slices
     summed in square over the model and data groups, combined as
     Optimizer.apply combines them on one device (where the two paths meet,
     sqrt(x * x) == x keeps the bits); then optax's clip and the inner
     optimizer's update (AdamW or AdamW8bit);
  4. the slices are all-gathered over the data group, and each rank keeps
     its tensor-parallel block of a parameter updated whole.

Under a pipeline (parallel/pipeline.py) a stage-owned layer's parameters
and moments exist on its stage only.  The replicated parameters (the
embeddings, the quantizer, proj_out) get the same gradients on every model
rank, which are not summed over the model group; the squares of the
stage-owned norms are summed over it (every stage holds the same number of
layers of one structure, so the sum of position i over the stages adds the
squares of the same parameter of each stage's layers) and the replicated
ones counted once.  A stage-owned parameter is updated whole on its stage,
so AdamW8bit's codes are one device's; ZeRO-1 slices it over the data group
as any other.

Copies (a slice of a parameter updated whole) are refreshed from the
module's parameters before each update, so an edit of a parameter between
steps (VQ's codebook surgery, a restore) is seen.  state_dict /
load_state_dict give and take the single-device optimizer's state_dict: one
file serves any mesh and the single-device port.  Both, and every step, are
collectives: every rank calls them.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from .mesh import (
    Mesh,
    _stacks,
    all_gather_flat,
    all_gather_shards,
    full_keys,
    gather_stages,
    param_spec,
    reduce_scatter_flat,
    model_partial,
    stage_key,
    staged_stacks,
    zero1_chunk,
    zero1_partition,
)


def _parallel_names(module: torch.nn.Module):
    """(tensor parallel?, names of the parameters whose gradients are partial
    sums over the model group) for a module after shard_params."""
    prefix = {id(m): n for n, m in module.named_modules()}
    tp, partial = False, set()
    for stack in _stacks(module):
        if stack.mp is None:
            continue
        tp = True
        head = prefix[id(stack)] + "."
        sp = stack.mp.sequence_parallel
        partial |= {n for n, _ in module.named_parameters() if n.startswith(head) and model_partial(n, sp)}
    return tp, partial


class ShardedOptimizer:
    """AdamW or AdamW8bit (train/loop.py's Optimizer) over a module sharded on a mesh."""

    def __init__(self, module: torch.nn.Module, tx, mesh: Mesh, zero1: bool = False, min_size: int = 2**13):
        self.mesh = mesh
        self.names = [n for n, _ in module.named_parameters()]
        self.params = [p for _, p in module.named_parameters()]
        tp, self.partial = _parallel_names(module)
        self.split = [param_spec([n], tp)[n] for n in self.names]
        # pipeline stages: which parameters this stage owns, and each one's
        # index in the single-device optimizer (the module's order with every layer)
        self.stacks = staged_stacks(module)
        self.staged = [stage_key(n, self.stacks, 0) is not None for n in self.names]
        self.full_names = full_keys(self.names, self.stacks, mesh.n_model) if self.stacks else list(self.names)
        index = {n: j for j, n in enumerate(self.full_names)}
        self.global_index = [index[n] for n in self.names]
        nm, nd, dr = mesh.n_model, mesh.n_data, mesh.data_rank
        self.block = 256 if tx.opt_8bit else 1
        self.full_shapes = []
        for p, d in zip(self.params, self.split):
            shape = list(p.shape)
            if d is not None:
                shape[d] *= nm
            self.full_shapes.append(torch.Size(shape))
        # updated whole on every model rank: AdamW8bit's blocks of a
        # tensor-parallel block that is not a run of the whole parameter's blocks
        self.whole = [
            d is not None and nm > 1 and self.block > 1 and not (d == 0 and p.numel() % self.block == 0)
            for p, d in zip(self.params, self.split)
        ]
        # what the inner optimizer updates of each parameter: its block, or the whole value
        self.shapes = [f if w else p.shape for p, f, w in zip(self.params, self.full_shapes, self.whole)]
        chosen = zero1_partition(self.full_shapes, nd, min_size, self.block) if zero1 else [None] * len(self.params)
        self.chunks = [None if c is None else zero1_chunk(s.numel(), nd, self.block) for c, s in zip(chosen, self.shapes)]
        self.ranges = []
        self.tensors: List[torch.Tensor] = []  # one per parameter
        for p, shape, chunk, whole in zip(self.params, self.shapes, self.chunks, self.whole):
            if chunk is None:
                self.ranges.append(None)
                self.tensors.append(torch.zeros(shape, dtype=p.dtype, device=p.device) if whole else p)
                continue
            numel = shape.numel()
            lo = min(dr * chunk, numel)
            hi = min(lo + chunk, numel)
            self.ranges.append((lo, hi))
            if whole:
                self.tensors.append(torch.zeros(hi - lo, dtype=p.dtype, device=p.device))
            else:  # the slice of this rank's own value: updated in place
                self.tensors.append(p.detach().view(-1)[lo:hi])
        self.inner = tx.init_params(self.tensors)

    # ------------------------------------------------------------ helpers

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _tp_block(self, i: int) -> bool:
        """Whether parameter i is updated on this rank's tensor-parallel block."""
        return self.split[i] is not None and self.mesh.n_model > 1 and not self.whole[i]

    def _whole(self, values: List[torch.Tensor], idx: List[int]) -> List[torch.Tensor]:
        """Whole values of parameters `idx` that are updated whole, from this
        rank's blocks (values of the module's shapes)."""
        out = list(values)
        gather = [i for i in idx if self.whole[i]]
        if gather:
            full = all_gather_shards([values[i] for i in gather], [self.split[i] for i in gather],
                                     self.mesh.model_group, self.mesh.n_model)
            for i, w in zip(gather, full):
                out[i] = w
        return out

    def _block(self, i: int, value: torch.Tensor) -> torch.Tensor:
        """This rank's tensor-parallel block of what the inner optimizer updates of parameter i."""
        if not self.whole[i]:
            return value
        d, k = self.split[i], self.params[i].shape[self.split[i]]
        return value.narrow(d, self.mesh.model_rank * k, k)

    def _padded_rows(self, i: int, flat: torch.Tensor) -> torch.Tensor:
        """A value's flat form as (n_data, chunk), zero-padded."""
        chunk, nd = self.chunks[i], self.mesh.n_data
        return torch.cat([flat, flat.new_zeros(nd * chunk - flat.numel())]).view(nd, chunk)

    def _gather_slices(self, slices: List[torch.Tensor], per_rank: List[int], totals: List[int]) -> List[torch.Tensor]:
        """Concatenations over the data group of each rank's slice (dim 0),
        each rank's padded to per_rank rows, cut to totals; one all-gather."""
        nd = self.mesh.n_data
        if not slices:
            return []
        rows = [
            torch.cat([s, s.new_zeros((k - s.shape[0], *s.shape[1:]))]).reshape(-1) for s, k in zip(slices, per_rank)
        ]
        gathered = all_gather_flat(torch.cat(rows), self.mesh.data_group, nd)
        out, off = [], 0
        for s, r, k, total in zip(slices, rows, per_rank, totals):
            part = gathered[:, off : off + r.numel()].reshape(nd * k, *s.shape[1:])
            out.append(part[:total])
            off += r.numel()
        return out

    # ------------------------------------------------------------ the step

    def zero_grad(self, set_to_none: bool = True) -> None:
        for t in self.params + self.tensors:
            t.grad = None

    @torch.no_grad()
    def _refresh(self) -> None:
        """The copies that the inner optimizer updates, from the module's parameters."""
        need = [i for i in range(len(self.params)) if self.whole[i]]
        whole = self._whole([p.detach() for p in self.params], need)
        for i in need:
            if self.ranges[i] is None:
                self.tensors[i].copy_(whole[i])
            else:
                lo, hi = self.ranges[i]
                self.tensors[i].copy_(whole[i].reshape(-1)[lo:hi])

    @torch.no_grad()
    def step(self, tx, count: int, lr_scale: float = 1.0) -> torch.Tensor:
        """Sync the gradients, clip them by their global norm and take update
        number `count` (Optimizer.apply on one device); returns the norm
        before clipping, the same on every rank."""
        mesh = self.mesh
        self._refresh()
        for i, p in enumerate(self.params):
            if p.grad is None and self.names[i] in self.partial:
                # a row-parallel bias has no gradient on model ranks other than 0
                p.grad = torch.zeros_like(p)
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        grads = [p.grad for p in self.params]
        # 1. the model group: whole gradients of what is updated whole, summed partials
        grads = self._whole(grads, live)
        partial = [i for i in live if self.names[i] in self.partial]
        if partial and mesh.n_model > 1:
            flat = torch.cat([grads[i].reshape(-1) for i in partial])
            dist.all_reduce(flat, group=mesh.model_group)
            grads = self._unflatten(grads, partial, flat)
        # 2. the data group: sum the gradients, reduce-scatter ZeRO-1 slices
        summed = [i for i in live if self.chunks[i] is None]
        if summed:
            flat = torch.cat([grads[i].reshape(-1) for i in summed])
            dist.all_reduce(flat, group=mesh.data_group)
            grads = self._unflatten(grads, summed, flat)
        sliced = [i for i in live if self.chunks[i] is not None]
        if sliced:
            rows = torch.cat([self._padded_rows(i, grads[i].reshape(-1)) for i in sliced], dim=1)
            mine = reduce_scatter_flat(rows, mesh.data_group)
            off = 0
            for i in sliced:
                lo, hi = self.ranges[i]
                grads[i] = mine[off : off + hi - lo]
                off += self.chunks[i]
        for i in live:
            t = self.tensors[i]
            t.grad = grads[i] if self.ranges[i] is not None else grads[i].view(t.shape)
        # 3. the global norm, the clip, the update
        opt_grads = [self.tensors[i].grad for i in live]
        norms = torch.stack(torch._foreach_norm(opt_grads))
        over_data = [k for k, i in enumerate(live) if self.chunks[i] is not None]
        over_model = [k for k, i in enumerate(live) if self._tp_block(i) or self.staged[i]]
        if over_data or over_model:
            sq = norms * norms
            for pos, group in ((over_data, mesh.data_group), (over_model, mesh.model_group)):
                if pos:
                    part = sq[pos]
                    dist.all_reduce(part, group=group)
                    sq[pos] = part
            pos = sorted(set(over_data) | set(over_model))
            norms[pos] = torch.sqrt(sq[pos])
        grad_norm = torch.linalg.vector_norm(norms)
        scale = torch.where(grad_norm < tx.grad_clip, torch.ones_like(grad_norm), tx.grad_clip / grad_norm)
        torch._foreach_mul_(opt_grads, scale)
        for group in self.inner.param_groups:
            group["lr"] = tx.schedule(count) * lr_scale
        self.inner.step()
        # 4. the updated values back into the module
        zl = [i for i, c in enumerate(self.chunks) if c is not None]
        if zl:
            full = self._gather_slices([self.tensors[i] for i in zl], [self.chunks[i] for i in zl],
                                       [self.shapes[i].numel() for i in zl])
            for i, f in zip(zl, full):
                self.params[i].copy_(self._block(i, f.view(self.shapes[i])))
        for i, t in enumerate(self.tensors):
            if self.ranges[i] is None and self.whole[i]:
                self.params[i].copy_(self._block(i, t))
        return grad_norm

    @staticmethod
    def _unflatten(grads, idx, flat):
        out, off = list(grads), 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off : off + n].view(grads[i].shape)
            off += n
        return out

    # ------------------------------------------------------------ VQ surgery

    @torch.no_grad()
    def zero_moment_rows(self, param: torch.Tensor, replaced: torch.Tensor) -> None:
        """Zero the fp32 Adam moments of the codebook rows `replaced` (train/
        loop.py's _zero_codebook_moments); AdamW8bit's are left, as on one
        device."""
        i = next(k for k, p in enumerate(self.params) if p is param)
        state = self.inner.state.get(self.tensors[i], {})
        keep = (~replaced).to(torch.float32)[..., None].expand(self.shapes[i])
        if self.ranges[i] is not None:
            lo, hi = self.ranges[i]
            keep = keep.reshape(-1)[lo:hi]
        for name in ("exp_avg", "exp_avg_sq"):
            moment = state.get(name)
            if isinstance(moment, torch.Tensor) and moment.shape == keep.shape:
                moment.mul_(keep.to(moment.dtype))

    # ------------------------------------------------------------ state

    def _state_dim(self, j: int) -> int:
        """The dim of a moment of parameter j that its tensor-parallel blocks
        split: AdamW's moments have the parameter's shape, AdamW8bit's are
        blocks, split on their first dim."""
        return 0 if self.block > 1 else self.split[j]

    def _moments(self, state: Dict, j: int):
        return [k for k in sorted(state[j]) if isinstance(state[j][k], torch.Tensor) and state[j][k].ndim > 0]

    def state_dict(self) -> Dict:
        """The single-device optimizer's state_dict (a collective)."""
        sd = self.inner.state_dict()
        state = {j: dict(st) for j, st in sd["state"].items()}
        # the data group: ZeRO-1 slices into what the rank updates (its block or the whole value)
        todo = []  # (j, key, slice, per-rank rows, total rows, shape)
        for j in sorted(state):
            if self.chunks[j] is None:
                continue
            numel = self.shapes[j].numel()
            for key in self._moments(state, j):
                v = state[j][key]
                if self.block > 1:
                    todo.append((j, key, v, self.chunks[j] // self.block, -(-numel // self.block), None))
                else:
                    todo.append((j, key, v, self.chunks[j], numel, self.shapes[j]))
        for dtype in sorted({t[2].dtype for t in todo}, key=str):
            group = [t for t in todo if t[2].dtype == dtype]
            whole = self._gather_slices([t[2] for t in group], [t[3] for t in group], [t[4] for t in group])
            for (j, key, _, _, _, shape), w in zip(group, whole):
                state[j][key] = w if shape is None else w.reshape(shape)
        # the model group: tensor-parallel blocks into whole moments
        blocks = [(j, key) for j in sorted(state) if self._tp_block(j) for key in self._moments(state, j)]
        for dtype in sorted({state[j][k].dtype for j, k in blocks}, key=str):
            group = [(j, k) for j, k in blocks if state[j][k].dtype == dtype]
            whole = all_gather_shards([state[j][k] for j, k in group], [self._state_dim(j) for j, _ in group],
                                      self.mesh.model_group, self.mesh.n_model)
            for (j, k), w in zip(group, whole):
                state[j][k] = w
        if self.stacks:
            state = self._gather_stages(state)
        groups = [dict(g, params=list(range(len(self.full_names)))) for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def _gather_stages(self, state: Dict) -> Dict:
        """Every stage's moments of its stage-owned parameters, keyed by their
        single-device indices (a collective over the model group)."""
        index = {n: j for j, n in enumerate(self.full_names)}
        owned = [(j, key) for j in sorted(state) if self.staged[j] for key in self._moments(state, j)]
        parts = gather_stages([state[j][key] for j, key in owned], self.mesh)
        out = {self.global_index[j]: st for j, st in state.items() if not self.staged[j]}
        for r, part in enumerate(parts):
            for (j, key), v in zip(owned, part):
                g = index[stage_key(self.names[j], self.stacks, r)]
                out.setdefault(g, {k: w for k, w in state[j].items() if k not in self._moments(state, j)})[key] = v
        return {g: out[g] for g in sorted(out)}

    def load_state_dict(self, sd: Dict) -> None:
        """Take a single-device optimizer's state_dict, keeping this rank's
        blocks and slices."""
        nm, r = self.mesh.n_model, self.mesh.model_rank
        state = {}
        given = {int(j): st for j, st in sd["state"].items()}
        for j, g in enumerate(self.global_index):
            if g not in given:
                continue
            st = dict(given[g])
            for key in self._moments({j: st}, j):
                v = st[key]
                if self._tp_block(j):
                    d = self._state_dim(j)
                    k = v.shape[d] // nm
                    v = v.narrow(d, r * k, k)
                if self.chunks[j] is not None:
                    lo, hi = self.ranges[j]
                    v = v[lo // self.block : -(-hi // self.block)] if self.block > 1 else v.reshape(-1)[lo:hi]
                st[key] = v
            state[j] = st
        groups = [dict(g, params=list(range(len(self.params)))) for g in sd["param_groups"]]
        self.inner.load_state_dict({"state": state, "param_groups": groups})
