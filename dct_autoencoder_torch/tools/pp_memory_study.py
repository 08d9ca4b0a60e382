"""Pipeline-schedule memory study: GPipe (pipeline_stack_apply + autograd)
against 1F1B (pipeline_1f1b_loss_and_grad), with the microbatch size held
fixed while the microbatch count M grows (JAX: tools/pp_memory_study.py).

GPipe's backward keeps every microbatch's saved activations alive, so its
temporary memory grows with M; 1F1B keeps at most its 2S-slot ring of stage
inputs and one microbatch's recomputed graph, flat in M.  `temp` is the
schedule's working memory, without its arguments (x, the parameters: the
`*_arg_mb` columns) and its results (the gradients, dx):

  * on the card, torch.cuda.max_memory_allocated above the memory allocated
    at entry, less the results still held at the end;
  * on the CPU, the peak bytes of the tensors autograd saves for backward
    (torch.autograd.graph.saved_tensors_hooks), each storage once, the
    arguments left out.

`backend` says which.  It runs at any stage count S, S = 1 on one card
included (then GPipe keeps M microbatches of activations and 1F1B a 2-slot
ring):

  python -m dct_autoencoder_torch.tools.pp_memory_study --out results.json
  torchrun --nproc_per_node 2 -m dct_autoencoder_torch.tools.pp_memory_study --n_model 2
  python -m dct_autoencoder_torch.tools.pp_memory_study --device cpu

Rank 0 prints one JSON line a microbatch count and writes --out.
"""
from __future__ import annotations

import argparse
import json
import os
import weakref
from typing import Dict, List, Optional, Sequence

import torch


class _Held:
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


class SavedBytes:
    """Peak bytes of the tensors that autograd saves for backward inside the
    context, each storage counted once, the storages of `exclude` left out."""

    def __init__(self, exclude: Sequence[torch.Tensor]):
        self.skip = {t.untyped_storage().data_ptr() for t in exclude}
        self.live: Dict[int, List[int]] = {}
        self.now = self.peak = 0

    def _pack(self, t):
        key = t.untyped_storage().data_ptr()
        if key in self.skip:
            return t
        entry = self.live.setdefault(key, [t.untyped_storage().nbytes(), 0])
        if entry[1] == 0:
            self.now += entry[0]
            self.peak = max(self.peak, self.now)
        entry[1] += 1
        held = _Held(t)
        weakref.finalize(held, self._release, key)
        return held

    def _release(self, key):
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]

    @staticmethod
    def _unpack(held):
        return held.t if isinstance(held, _Held) else held

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _measure(fn, args: Sequence[torch.Tensor], device: torch.device):
    """(temp bytes, argument bytes) of fn() on `device`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        entry = torch.cuda.memory_allocated(device)
        results = fn()
        torch.cuda.synchronize(device)
        temp = torch.cuda.max_memory_allocated(device) - entry - _nbytes(results)
    else:
        with SavedBytes(args) as saved:
            results = fn()
        temp = saved.peak
    del results
    return temp, _nbytes(args)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None)
    ap.add_argument("--n_model", type=int, default=0, help="pipeline stages (0: the whole world)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--micro_rows", type=int, default=8, help="rows per microbatch per data shard")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--microbatches", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--device", default="cuda", help="cuda (one card a process) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..models.autoencoder import resolve_device
    from ..parallel import mesh as pm
    from ..parallel.pipeline import PipelineSpec, pipeline_stack_apply
    from ..parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grad

    device = resolve_device(args.device)
    own_group = pm.initialize_distributed(device)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        world = dist.get_world_size()
        mesh = pm.make_mesh(args.n_model or world, device)
        L, s, d = args.layers, args.seq, args.dim
        gen = torch.Generator(device="cpu").manual_seed(0)
        w = torch.randn(L, d, d, generator=gen) * 0.2
        params = [
            {"w": w[i].to(device).requires_grad_(), "b": torch.zeros(d, device=device, requires_grad=True)}
            for i in pm.stage_layers(L, mesh.n_model, mesh.model_rank)
        ]
        leaves = [t for p in params for t in p.values()]

        def layer_apply(p, xm, ids_m, pad_m):
            gate = (~pad_m)[..., None].to(xm.dtype)
            return torch.tanh(xm @ p["w"] + p["b"]) * gate

        def loss_fn(y, ids_m, pad_m):
            return (y * y).mean()

        rows_out = []
        for M in args.microbatches:
            b = M * args.micro_rows  # this data rank's rows: fixed microbatch size, growing batch
            x = torch.randn(b, s, d, generator=gen).to(device)
            ids = torch.zeros(b, s, dtype=torch.int32, device=device)
            pad = torch.zeros(b, s, dtype=torch.bool, device=device)
            spec = PipelineSpec(mesh, M)

            def gpipe():
                y = pipeline_stack_apply(layer_apply, params, x, ids, pad, spec)
                # the mean over the same microbatches that the 1F1B loss averages
                loss = torch.stack([loss_fn(c, None, None) for c in y.split(args.micro_rows)]).mean()
                return torch.autograd.grad(loss, leaves)

            def f1b():
                loss, grads, dx = pipeline_1f1b_loss_and_grad(layer_apply, loss_fn, params, x, ids, pad, spec)
                return [loss, dx, *[t for g in grads for t in g.values()]]

            g_temp, g_arg = _measure(gpipe, [x, *leaves], device)
            f_temp, f_arg = _measure(f1b, [x, *leaves], device)
            row = {
                "M": M,
                "batch_rows": mesh.n_data * b,
                "gpipe_temp_mb": round(g_temp / 2**20, 1),
                "f1b_temp_mb": round(f_temp / 2**20, 1),
                "gpipe_arg_mb": round(g_arg / 2**20, 1),
                "f1b_arg_mb": round(f_arg / 2**20, 1),
            }
            rows_out.append(row)
            if pm.is_main_process():
                print(json.dumps(row), flush=True)
        payload = {
            "mesh": {"data": mesh.n_data, "model": mesh.n_model},
            "shape": {"layers": L, "seq": s, "dim": d, "micro_rows": args.micro_rows},
            "backend": (
                f"{torch.cuda.get_device_name(device)}: max_memory_allocated above entry, less the results"
                if device.type == "cuda" else "cpu: peak bytes saved for backward (saved_tensors_hooks)"
            ),
            "rows": rows_out,
        }
        if args.out and pm.is_main_process():
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=2)
            print(f"wrote {args.out}")
        return payload
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
