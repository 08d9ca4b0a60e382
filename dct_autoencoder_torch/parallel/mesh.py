"""The (data, model) mesh, the row and parameter layouts, and the collectives of
data, tensor and sequence parallelism and ZeRO-1, with torch.distributed.

Counterpart of the JAX package's parallel/mesh.py.  JAX annotates shardings
and lets XLA insert the collectives; here each rank is one process (one a
card under torchrun) and the collectives are explicit:

  data   each rank runs the whole model on a contiguous block of the packed
         rows (JAX's ``P("data")``); gradients, and every batch statistic of
         the losses, are summed over the data group (a `DataShard` handed
         down the step, JAX's ``sync_axis``);
  model  Megatron tensor parallelism: q/k/v and fc1 are column-parallel
         (their ``weight`` and ``bias`` split on dim 0), out_proj and fc2
         row-parallel (``weight`` split on dim 1, ``bias`` whole, entering
         the reduction once: model rank 0 adds it to its partial product, so
         a group of one is the single-device layer, bit for bit).  A port
         Dense is an nn.Linear, whose
         ``weight`` is JAX's ``kernel`` transposed, so these are JAX's
         ``_TP_RULES``.  With sequence parallelism the residual stream
         between the blocks is split on the token axis.

  stage  pipeline parallelism (parallel/pipeline.py) uses the model axis
         as the stage axis instead: stage s of S owns layers
         [s L / S, (s + 1) L / S) of each stack (`stage_layers`) and holds
         only their parameters; activations hop between neighbouring model
         ranks (`hop`) and a stack's output is broadcast from the last stage
         (`broadcast_from_stage`).  Layers are then not split by the
         tensor-parallel rules, as in JAX.  gather_params and
         load_full_state_dict gather and re-slice the stage-owned layers, so
         checkpoints are the single-device files.

Rank r sits at mesh coordinates (r // n_model, r % n_model): the model axis
is the inner one, as in JAX's reshape of the device list.  The backend is
NCCL for CUDA tensors and gloo for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
import socket
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


# ---------------------------------------------------------------- process group and mesh


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_distributed(
    device="cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group and return whether this call created it (the
    caller then destroys it).

    Under torchrun the group is the one RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR/PORT describe, and a CUDA rank takes card LOCAL_RANK.
    Otherwise, unless `init_method`, `world_size` and `rank` are given, it is
    a world of one process at a free localhost port.  NCCL for a CUDA
    `device`, gloo for the CPU.  Does nothing if a group exists."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if init_method is None and launched_by_torchrun():
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    else:
        if init_method is None:
            init_method, world_size, rank = f"tcp://127.0.0.1:{free_port()}", 1, 0
        if world_size is None or rank is None:
            raise ValueError("init_method needs world_size and rank beside it")
        local_rank = device.index if device.index is not None else 0
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method, world_size=world_size, rank=rank,
        **kwargs,
    )
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass
class Mesh:
    """A (data, model) torch DeviceMesh and this rank's place in it."""

    device_mesh: "torch.distributed.device_mesh.DeviceMesh"
    device: torch.device

    @property
    def n_data(self) -> int:
        return self.device_mesh.size(0)

    @property
    def n_model(self) -> int:
        return self.device_mesh.size(1)

    @property
    def data_group(self):
        return self.device_mesh.get_group(DATA_AXIS)

    @property
    def model_group(self):
        return self.device_mesh.get_group(MODEL_AXIS)

    @property
    def data_rank(self) -> int:
        return self.device_mesh.get_local_rank(DATA_AXIS)

    @property
    def model_rank(self) -> int:
        return self.device_mesh.get_local_rank(MODEL_AXIS)


def check_model_parallel(n_model: int, world: int) -> None:
    """Raise ValueError naming n_model_parallel unless it divides the world."""
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model_parallel={n_model} does not divide the world of {world} processes")


def make_mesh(n_model: int = 1, device="cuda") -> Mesh:
    """The (data, model) mesh of shape (world // n_model, n_model) over the
    whole world (every rank calls it).  Raises ValueError naming
    n_model_parallel when n_model does not divide the world, as JAX's
    make_mesh asserts."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    world = dist.get_world_size()
    check_model_parallel(n_model, world)
    device = torch.device(device)
    layout = torch.arange(world, dtype=torch.int64).reshape(world // n_model, n_model)
    return Mesh(DeviceMesh(device.type, layout, mesh_dim_names=(DATA_AXIS, MODEL_AXIS)), device)


# ---------------------------------------------------------------- rows


def _tensor_fields(batch) -> List[str]:
    return [f.name for f in dataclasses.fields(batch) if isinstance(getattr(batch, f.name), torch.Tensor)]


def pad_batch_rows(batch, multiple: int):
    """Right-pad packed rows to a multiple; the padding rows are zeros and
    fully masked (key_pad_mask True), so they add nothing to a masked loss or
    statistic (JAX: parallel/mesh.py's pad_batch_rows, the same bits)."""
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


def take_rows(batch, start: int, stop: int):
    """Rows [start, stop) of every tensor field of a packed batch."""
    return batch.replace(**{name: getattr(batch, name)[start:stop] for name in _tensor_fields(batch)})


def row_block(n_rows: int, data_index: int, n_data: int) -> slice:
    """The contiguous rows that JAX's P("data") gives one data index."""
    if n_rows % n_data:
        raise ValueError(f"{n_rows} rows do not divide over {n_data} data ranks: pad_batch_rows first")
    per = n_rows // n_data
    return slice(data_index * per, (data_index + 1) * per)


def batch_rows(batch, data_index: int, n_data: int):
    """The block of packed rows that data index `data_index` of `n_data` holds."""
    rows = row_block(batch.patches.shape[0], data_index, n_data)
    return take_rows(batch, rows.start, rows.stop)


# ---------------------------------------------------------------- parameter layout

# Megatron tensor parallelism for the transformer stacks, by state_dict name:
# the dim of each split parameter (JAX's _TP_RULES, whose kernels are these
# weights transposed); everything else is replicated
_TP_RULES = [
    (re.compile(r".*self_attn\.(q_proj|k_proj|v_proj)\.(weight|bias)$"), 0),
    (re.compile(r".*self_attn\.out_proj\.weight$"), 1),
    (re.compile(r".*\.fc1\.(weight|bias)$"), 0),
    (re.compile(r".*\.fc2\.weight$"), 1),
]
# parameters whose gradients are partial sums over the model group: the
# row-parallel biases (model rank 0 adds them) and, under sequence
# parallelism, the LayerNorms, which act on this rank's tokens only
_ROW_BIAS = re.compile(r".*layers\.\d+\.(self_attn\.out_proj|fc2)\.bias$")
_SP_PARTIAL = re.compile(r".*layers\.\d+\.layer_norm[12]\.(weight|bias)$")


def param_spec(names: Iterable[str], tensor_parallel: bool = True) -> Dict[str, Optional[int]]:
    """For each parameter name, the dim it is split on over the model axis,
    or None where it is replicated (all None without tensor parallelism)."""
    spec = {}
    for name in names:
        spec[name] = None
        if tensor_parallel:
            for pat, dim in _TP_RULES:
                if pat.match(name):
                    spec[name] = dim
                    break
    return spec


def model_partial(name: str, sequence_parallel: bool) -> bool:
    """Whether a parameter's gradient is a partial sum over the model group
    under tensor parallelism (the row-parallel biases; with sequence
    parallelism also the LayerNorms of the layers)."""
    return bool(_ROW_BIAS.match(name)) or (sequence_parallel and bool(_SP_PARTIAL.match(name)))


@dataclasses.dataclass
class ModelParallel:
    """What a transformer layer needs to run on its share of heads and hidden
    units: the model group, its size and this rank's index, and whether the
    residual stream is split on tokens."""

    group: object
    size: int
    rank: int
    sequence_parallel: bool = False


def _stacks(module: torch.nn.Module):
    """The transformer stacks of a module (models/transformer.py's
    TransformerEncoder: what takes a ModelParallel)."""
    return [m for m in module.modules() if hasattr(m, "set_model_parallel")]


def is_sharded(module: torch.nn.Module) -> bool:
    """Whether shard_params split, or pipeline.make_pipelined_module staged,
    this module's transformer stacks."""
    return any(stack.mp is not None or stack.pipeline is not None for stack in _stacks(module))


def shard_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Split the tensor-parallel parameters in place (each rank keeps its
    block of the split dim) and hand every transformer stack the model
    group, so that each layer runs on num_heads // n_model heads and
    intermediate_size // n_model hidden units.  Sequence parallelism follows
    each stack's config.  Raises ValueError by name where a width does not
    divide."""
    n, r = mesh.n_model, mesh.model_rank
    for stack in _stacks(module):
        cfg = stack.config
        for what, width in (("num_attention_heads", cfg.num_attention_heads),
                            ("intermediate_size", cfg.intermediate_size)):
            if width % n:
                raise ValueError(f"{what}={width} does not divide over n_model_parallel={n}")
        if cfg.quantize_int8:
            raise ValueError("tensor parallelism takes float weights, not the int8 serving form")
        stack.set_model_parallel(ModelParallel(mesh.model_group, n, r, cfg.sequence_parallel))
    with torch.no_grad():
        for name, p in module.named_parameters():
            dim = param_spec([name])[name]
            if dim is not None:
                k = p.shape[dim] // n
                p.data = p.data.narrow(dim, r * k, k).clone()
    return module


def gather_params(module: torch.nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full state_dict of a module sharded by shard_params or staged by
    make_pipelined_module (the same keys and shapes as the unsharded
    module's); a collective over the model group."""
    state = module.state_dict()
    stacks = staged_stacks(module)
    if stacks:
        return _gather_stages(state, stacks, mesh)
    spec = param_spec(state, is_sharded(module))
    split = [k for k, d in spec.items() if d is not None]
    full = all_gather_shards([state[k] for k in split], [spec[k] for k in split], mesh.model_group, mesh.n_model)
    out = dict(state)
    out.update(zip(split, full))
    return out


def load_full_state_dict(module: torch.nn.Module, state: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Load a full (single-device) state_dict into a module that may be sharded."""
    if mesh is None or not is_sharded(module):
        module.load_state_dict(state)
        return
    if staged_stacks(module):  # the stage-owned layers keep their single-device keys
        module.load_state_dict({k: state[k] for k in module.state_dict()})
        return
    spec = param_spec(state)
    n, r = mesh.n_model, mesh.model_rank
    local = {}
    for k, v in state.items():
        d = spec[k]
        local[k] = v if d is None else v.narrow(d, r * (v.shape[d] // n), v.shape[d] // n)
    module.load_state_dict(local)


def unshard_params(module: torch.nn.Module, mesh: Mesh) -> None:
    """Undo shard_params or make_pipelined_module: every rank gets the full
    parameters and the stacks run on one device again."""
    full = gather_params(module, mesh)
    stacks = staged_stacks(module)
    if stacks:
        for stack in stacks.values():
            stack.set_pipeline(None)
        module.load_state_dict(full)
        return
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.shape != full[name].shape:
                p.data = full[name].clone()
    for stack in _stacks(module):
        stack.set_model_parallel(None)


def all_gather_shards(shards: List[torch.Tensor], dims: List[int], group, n: int) -> List[torch.Tensor]:
    """Whole tensors from each rank's shard (split on `dims`), in one all-gather."""
    if not shards:
        return []
    flat = torch.cat([s.reshape(-1) for s in shards])
    gathered = all_gather_flat(flat, group, n)
    out, off = [], 0
    for s, d in zip(shards, dims):
        parts = gathered[:, off : off + s.numel()].reshape(n, *s.shape)
        out.append(torch.cat(list(parts.unbind(0)), dim=d))
        off += s.numel()
    return out


# ---------------------------------------------------------------- pipeline stages


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The layers of a stack that pipeline stage `stage` of `n_stages` owns,
    [stage L / S, (stage + 1) L / S).  Raises ValueError naming the stage
    count where L does not divide (JAX's pipeline_stack_apply check)."""
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} pipeline stages")
    k = n_layers // n_stages
    return range(stage * k, (stage + 1) * k)


def staged_stacks(module: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The module's pipelined transformer stacks by the prefix of their
    layers' keys ('encoder.layers.')."""
    return {
        f"{name}.layers." if name else "layers.": m
        for name, m in module.named_modules() if getattr(m, "pipeline", None) is not None
    }


def stage_key(name: str, stacks: Dict[str, torch.nn.Module], stage: int) -> Optional[str]:
    """For the key of an entry of a stage-owned layer, the key of the same
    entry at the same place among stage `stage`'s layers (its own key for
    this rank's stage); None for a key outside the staged layers.  Every
    stage of a stack holds the same number of layers of one structure."""
    for head, stack in stacks.items():
        if name.startswith(head):
            index, rest = name[len(head):].split(".", 1)
            own = stack.layers.indices
            return f"{head}{int(index) - own.start + stage * len(own)}.{rest}"
    return None


def full_keys(keys: Sequence[str], stacks: Dict[str, torch.nn.Module], n_stages: int) -> List[str]:
    """The keys of the whole (single-device) module in its order, from this
    rank's keys of a staged module: each stack's block of stage-owned keys is
    replaced by every stage's block, stage after stage."""
    out, done = [], set()
    for k in keys:
        head = next((h for h in stacks if k.startswith(h)), None)
        if head is None:
            out.append(k)
        elif head not in done:
            done.add(head)
            block = [j for j in keys if j.startswith(head)]
            out += [stage_key(j, stacks, r) for r in range(n_stages) for j in block]
    return out


def gather_stages(values: List[torch.Tensor], mesh: Mesh) -> List[List[torch.Tensor]]:
    """For each model rank, its `values` (tensors of the same shapes and
    dtypes on every rank: a stage's share of homogeneous layers), in one
    all-gather a dtype over the model group."""
    out = [[None] * len(values) for _ in range(mesh.n_model)]
    for dtype in sorted({v.dtype for v in values}, key=str):
        idx = [i for i, v in enumerate(values) if v.dtype == dtype]
        whole = all_gather_shards([values[i][None] for i in idx], [0] * len(idx), mesh.model_group, mesh.n_model)
        for i, w in zip(idx, whole):
            for r in range(mesh.n_model):
                out[r][i] = w[r]
    return out


def _gather_stages(state: Dict[str, torch.Tensor], stacks, mesh: Mesh) -> Dict[str, torch.Tensor]:
    owned = [k for k in state if stage_key(k, stacks, 0) is not None]
    parts = gather_stages([state[k] for k in owned], mesh)
    whole = dict(state)
    for r in range(mesh.n_model):
        whole.update({stage_key(k, stacks, r): v for k, v in zip(owned, parts[r])})
    return {k: whole[k] for k in full_keys(list(state), stacks, mesh.n_model)}


def model_peer(mesh: Mesh, model_rank: int) -> int:
    """The global rank of model index `model_rank` in this rank's model group."""
    return dist.get_global_rank(mesh.model_group, model_rank)


def hop(mesh: Mesh, sends: Sequence, recvs: Sequence) -> None:
    """One tick of point-to-point traffic between neighbouring model ranks:
    sends and recvs are (tensor, model rank) pairs, posted together in one
    batch_isend_irecv and waited for.  A pipeline schedule posts, on every
    rank and tick, the sends and receives that match its neighbours' (each
    a function of the tick, the stage and the microbatch count), so NCCL
    pairs them and cannot deadlock.  The differentiable pipeline is one
    autograd function around the whole schedule (parallel/pipeline.py),
    whose backward hops the gradients upstream with this same call."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), model_peer(mesh, r), mesh.model_group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, model_peer(mesh, r), mesh.model_group) for t, r in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def broadcast_from_stage(x: torch.Tensor, mesh: Mesh, stage: int) -> torch.Tensor:
    """x of model rank `stage` on every model rank, in place (JAX: the psum
    of the collected outputs over the model axis)."""
    if mesh.n_model > 1:
        dist.broadcast(x, src=model_peer(mesh, stage), group=mesh.model_group)
    return x


def sync_model_group(mesh: Mesh) -> None:
    """A one-value all-reduce over the model group: with NCCL the first call
    of a group must include all its ranks, and a pipeline's first tick sends
    between two of them only."""
    if mesh.n_model > 1:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.model_group)


# ---------------------------------------------------------------- collectives with their gradients


def all_gather_flat(flat: torch.Tensor, group, n: int) -> torch.Tensor:
    """(m,) on each rank -> (n, m) in rank order (gloo and NCCL both take a flat output)."""
    out = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out.view(n, flat.numel())


def reduce_scatter_flat(rows: torch.Tensor, group) -> torch.Tensor:
    """(n, m) on each rank -> row r of their sum on rank r."""
    out = rows.new_empty(rows.shape[1])
    dist.reduce_scatter_tensor(out, rows.contiguous().view(-1), group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather_tokens(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(b, s / n, ...) per rank -> (b, s, ...), rank order along the tokens."""
    parts = all_gather_flat(x.reshape(-1), group, n).view(n, *x.shape)
    return parts.movedim(0, 1).reshape(x.shape[0], n * x.shape[1], *x.shape[2:])


def _reduce_scatter_tokens(x: torch.Tensor, group, n: int, rank: int) -> torch.Tensor:
    """(b, s, ...) partial sums per rank -> this rank's (b, s / n, ...) block of their sum."""
    b, s = x.shape[:2]
    blocks = x.reshape(b, n, s // n, *x.shape[2:]).movedim(1, 0)
    return reduce_scatter_flat(blocks.reshape(n, -1), group).view(b, s // n, *x.shape[2:])


def _token_block(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    k = x.shape[1] // n
    return x[:, rank * k : (rank + 1) * k].contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the model group."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mp.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mp):
        return _all_reduce(x, mp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SpGather(torch.autograd.Function):
    """All-gather on the token axis; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _gather_tokens(x, mp.group, mp.size)

    @staticmethod
    def backward(ctx, g):
        mp = ctx.mp
        return _reduce_scatter_tokens(g, mp.group, mp.size, mp.rank), None


class _SpScatter(torch.autograd.Function):
    """Reduce-scatter on the token axis; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _reduce_scatter_tokens(x, mp.group, mp.size, mp.rank)

    @staticmethod
    def backward(ctx, g):
        return _gather_tokens(g, ctx.mp.group, ctx.mp.size), None


class _SplitTokens(torch.autograd.Function):
    """This rank's block of tokens of a replicated stream; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _token_block(x, mp.size, mp.rank)

    @staticmethod
    def backward(ctx, g):
        return _gather_tokens(g, ctx.mp.group, ctx.mp.size), None


class _GatherTokens(torch.autograd.Function):
    """All-gather of the token blocks into a replicated stream; the backward
    keeps this rank's block (the consumers are replicated, so every rank
    holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return _gather_tokens(x, mp.group, mp.size)

    @staticmethod
    def backward(ctx, g):
        return _token_block(g, ctx.mp.size, ctx.mp.rank), None


def copy_to_model(x, mp: ModelParallel):
    return _CopyToModel.apply(x, mp)


def reduce_from_model(x, mp: ModelParallel):
    return _ReduceFromModel.apply(x, mp)


def sp_gather(x, mp: ModelParallel):
    """Gather the token axis back to full length before attention and the
    column-parallel products (JAX: sp_gather, an all-gather)."""
    return _SpGather.apply(x, mp)


def sp_scatter(x, mp: ModelParallel):
    """Sum the row-parallel partial products and keep this rank's tokens
    (JAX: sp_scatter, lowered to a reduce-scatter)."""
    return _SpScatter.apply(x, mp)


def split_tokens(x, mp: ModelParallel):
    return _SplitTokens.apply(x, mp)


def gather_tokens(x, mp: ModelParallel):
    return _GatherTokens.apply(x, mp)


# ---------------------------------------------------------------- the data group of a step


@dataclasses.dataclass
class DataShard:
    """This rank's share of one (micro-)batch of the sharded step: the data
    group that every batch statistic of the losses is summed over (JAX:
    sync_axis), and where this rank's rows start in the total_rows of the
    micro-batch (VQ's gumbel draws follow the global rows).  The step hands
    it down: train/losses.py's step_autoencoder(shard=...)."""

    group: object
    row_start: int
    total_rows: int


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(b, ...) per rank, the same b on each -> (n b, ...) in rank order."""
    return all_gather_flat(x.reshape(-1), group, n).view(n * x.shape[0], *x.shape[1:])


# ---------------------------------------------------------------- ZeRO-1


def zero1_partition(
    shapes: Sequence[Sequence[int]], n_data: int, min_size: int = 2**13, block: int = 1
) -> List[Optional[int]]:
    """For each parameter shape, the elements of its flattened value that each
    data rank updates under ZeRO-1 (a multiple of `block`; rank r takes
    [r * chunk, min((r + 1) * chunk, numel))), or None where every rank
    updates the whole parameter.

    The parameters split are those JAX's zero1_opt_spec shards: at least
    min_size elements and a dim that n_data divides.  block=256 for
    AdamW8bit keeps each slice on the edges of its 256-value blocks, so the
    slices quantize as the whole parameter does."""
    out: List[Optional[int]] = []
    for shape in shapes:
        shape = tuple(int(s) for s in shape)
        numel = int(np.prod(shape)) if shape else 1
        splits = bool(shape) and numel >= max(min_size, 1) and any(d >= n_data and d % n_data == 0 for d in shape)
        out.append(zero1_chunk(numel, n_data, block) if splits else None)
    return out


def zero1_chunk(numel: int, n_data: int, block: int = 1) -> int:
    """The elements of a flattened value of `numel` that each of n_data ranks
    updates under ZeRO-1: a multiple of `block`, the last rank's slice the
    shortest."""
    n_blocks = -(-numel // block)
    return -(-n_blocks // n_data) * block
