"""Training cells: the port's own trainer, `train/loop.py::train`, as the CLI
calls it (fp32 AdamW, lr 1e-4, the CLI's loss weights, prefetch 2, a log
every 200 steps), on a pool of images that the port's extractor preprocessed
once at set-up and whose columns are fed round-robin, so that the packer runs
in the window.

One call of train() is the whole run: its first steps are set-up (the first
three are the ones the reference follows), then the window, then, with
--trace 1, a few traced steps.  A forward pre-hook on the model marks the
steps: it counts each step's batch on the device (valid tokens, allowed
attention pairs, images), opens the window after the warm-up, and ends the
run with an exception once the window has lasted `seconds`.  The checked
steps' loss terms are the step function's own outputs, kept as it returns
them (`_CheckedSteps`), so that no step waits for the host; a global
optimizer hook reads the Adam moments after the first update, which give
the first gradient.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from .. import flops, inputs
from ..common import Cell
from ..faults import Fault
from ..reference import compare
from ..reference import frontend as ref_front
from ..reference import model as ref_model
from ..trace import Trace

BETA1 = 0.9  # AdamW's first-moment decay, which the configuration states


class _WindowClosed(Exception):
    pass


def pool_plan(traffic: dict, seed: int):
    """(sizes, draws) of the pool in feed order: the same sizes and token-budget
    draws, paired alike and in the same order, for every seed, so that every
    seed packs the same rows (the seed draws the images and the weights).  A
    seed's own order changed the images a step by ~2 % (PERF.md)."""
    n = traffic["pool_images"]
    sizes = [tuple(traffic["image_sizes"][i % len(traffic["image_sizes"])]) for i in range(n)]
    mids = inputs.stratified(n)
    pairing = inputs.shuffled(n, 0)
    order = inputs.shuffled(n, 1)
    return [sizes[i] for i in order], [float(mids[pairing[i]]) for i in order]


def pool_images(traffic: dict, seed: int, device) -> List[torch.Tensor]:
    sizes, _ = pool_plan(traffic, seed)
    return inputs.make_images(sizes, inputs.image_generator(seed, device), device)


def preprocess_pool(proc, images: List[torch.Tensor], draws: List[float]) -> List[dict]:
    """The port's extractor over the pool, one call for each image size, with the pool's draws."""
    groups: Dict[tuple, List[int]] = {}
    for i, im in enumerate(images):
        groups.setdefault(tuple(im.shape), []).append(i)
    out: List[Optional[dict]] = [None] * len(images)
    for idx in groups.values():
        proc.rng = inputs.Draws([draws[i] for i in idx])
        host = [images[i].cpu().numpy() for i in idx]
        for i, d in zip(idx, proc.preprocess_many(host)):
            out[i] = d
    return out  # type: ignore[return-value]


def feed(pool: List[dict], chunk: int):
    """Columns of `chunk` images at a time, round-robin over the pool, without end."""
    j = 0
    while True:
        items = [pool[(j + i) % len(pool)] for i in range(chunk)]
        j = (j + chunk) % len(pool)
        with torch.profiler.record_function("portbench.feed"):
            yield {k: [d[k] for d in items] for k in items[0]}


class _Steps:
    """The forward pre-hook that marks the steps, opens and closes the window and the traced span."""

    def __init__(self, cell: Cell, device: torch.device, snapshot_at: int):
        tr = cell.traffic
        self.cell, self.device = cell, device
        self.warmup, self.trace_steps, self.snapshot_at = tr["warmup_steps"], tr["trace_steps"], snapshot_at
        self.n = 0
        self.t_first = None  # the second step's start: the first one done
        self.counters: List[torch.Tensor] = []
        self.t_start = self.t_end = None
        self.window_steps = 0
        self.peak_setup = 0
        self.snapshot: Dict[str, torch.Tensor] = {}
        self.trace: Optional[Trace] = None
        self.trace_first = self.trace_last = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def __call__(self, module, args, kwargs):
        n = self.n
        self.n += 1
        batch = args[0]
        valid = ~batch.key_pad_mask
        b, s = valid.shape
        ids = torch.where(valid, batch.batched_image_ids.long(), s)
        counts = torch.zeros((b, s + 1), dtype=torch.int64, device=ids.device).scatter_add_(
            1, ids, torch.ones_like(ids))[:, :s]
        self.counters.append(torch.stack([valid.sum(), (counts * counts).sum(), (counts > 0).sum()]))
        if n == 1:
            self._sync()
            self.t_first = time.perf_counter()
        if n == self.snapshot_at:
            # on the host, so that the device's peak is the program's alone
            self.snapshot = {k: p.detach().to("cpu", copy=True) for k, p in module.named_parameters()}
        if n == self.warmup:
            self._sync()
            if self.device.type == "cuda":
                self.peak_setup = torch.cuda.max_memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            self.t_start = time.perf_counter()
        elif n > self.warmup and self.t_end is None:
            if time.perf_counter() - self.t_start >= self.cell.seconds:
                self._sync()
                self.t_end = time.perf_counter()
                self.window_steps = n - self.warmup
                if not self.cell.trace:
                    raise _WindowClosed
                self.trace = Trace(self.device)
                self.trace.start()
                self.trace_first, self.trace_last = n, n + self.trace_steps
        elif self.trace is not None and n == self.trace_last:
            self.trace.stop()
            raise _WindowClosed


class _FirstMoments:
    """A global optimizer hook: after the first update, each weight's first-moment norm by name."""

    def __init__(self, module: torch.nn.Module):
        self.names = {id(p): k for k, p in module.named_parameters()}
        self.norms: Dict[str, torch.Tensor] = {}
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.handle = register_optimizer_step_post_hook(self)

    @torch.no_grad()
    def __call__(self, opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                m = opt.state.get(p, {}).get("exp_avg")
                if id(p) in self.names and m is not None:
                    self.norms[self.names[id(p)]] = torch.linalg.vector_norm(m.double()) / (1 - BETA1)
        self.handle.remove()


class _CheckedSteps:
    """Wraps the trainer's step function (`loop.make_train_step`): keeps the first `n` steps' scalar
    outputs (the loss, its terms, the gradient's norm) as device tensors, read once the window has closed."""

    def __init__(self, n: int):
        from dct_autoencoder_torch.train import loop

        self.n, self.loop, self.inner = n, loop, loop.make_train_step
        self.metrics: List[Dict[str, torch.Tensor]] = []
        loop.make_train_step = self._make

    def _make(self, *a, **k):
        step_fn = self.inner(*a, **k)

        def step(*sa, **sk):
            state, metrics = step_fn(*sa, **sk)
            if len(self.metrics) < self.n:
                self.metrics.append({key: v for key, v in metrics.items() if v.ndim == 0})
            return state, metrics

        return step

    def remove(self) -> None:
        self.loop.make_train_step = self.inner

    def read(self) -> List[Dict[str, float]]:
        return [{k: float(v) for k, v in m.items()} for m in self.metrics]


def reference_batches(cell: Cell, n_steps: int, device) -> List[dict]:
    """The first `n_steps` global batches as the reference packs them, from its own front end."""
    tr, cfg = cell.traffic, cell.config
    rows, seq = tr["rows"], tr["max_seq_len"]
    p, mh, mw = cfg["patch_size"], cfg["max_patch_h"], cfg["max_patch_w"]
    sizes, draws = pool_plan(tr, cell.seed)
    lengths = [ref_front.token_budget(u, tr["beta"], min(h // p, mh) * min(w // p, mw) * 3, seq)
               for (h, w), u in zip(sizes, draws)]
    # the feed's stream, the pool round-robin, packed greedily: an image has at least one token, so
    # this many images close every row the batches take
    stream = [i % len(sizes) for i in range((rows * n_steps + 1) * seq)]
    packed = ref_front.pack([lengths[i] for i in stream], seq)
    images = pool_images(tr, cell.seed, device)
    tokens: Dict[int, tuple] = {}
    batches = []
    for j in range(n_steps):
        group = packed[j * rows : (j + 1) * rows]
        members = sorted({stream[k] for row in group for k in row} - set(tokens))
        for size in sorted({tuple(images[i].shape) for i in members}):
            idx = [i for i in members if tuple(images[i].shape) == size]
            toks, pos, chans = ref_front.ranked_tokens(torch.stack([images[i] for i in idx]), p, mh, mw)
            for m, i in enumerate(idx):
                k = lengths[i]
                tokens[i] = (toks[m, :k].float(), pos[m, :k], chans[m, :k])
        b = dict(
            patches=torch.zeros((rows, seq, p * p), device=device),
            ids=torch.zeros((rows, seq), dtype=torch.long, device=device),
            pad=torch.ones((rows, seq), dtype=torch.bool, device=device),
            chans=torch.zeros((rows, seq), dtype=torch.long, device=device),
            pos=torch.zeros((rows, seq, 2), dtype=torch.long, device=device),
            images=sum(len(row) for row in group),
        )
        for r, row in enumerate(group):
            off = 0
            for slot, k in enumerate(row):
                t, ps, cs = tokens[stream[k]]
                n = t.shape[0]
                b["patches"][r, off : off + n] = t
                b["ids"][r, off : off + n] = slot
                b["pad"][r, off : off + n] = False
                b["chans"][r, off : off + n] = cs
                b["pos"][r, off : off + n] = ps
                off += n
        batches.append(b)
    return batches


def run(cell: Cell) -> dict:
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.models.patchnorm import PatchNormState
    from dct_autoencoder_torch.train.loop import train

    tr, cfg = cell.traffic, cell.config
    device = torch.device(cell.device if cell.device == "cpu" else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    phases = {"import": time.perf_counter() - cell.t0}
    config = dt.DCTAutoencoderConfig.from_dict(cfg)
    model, proc = dt.get_model_and_processor(
        config, dtype=getattr(torch, cfg["dtype"]), sample_patches_beta=tr["beta"], seed=cell.seed, device=device)
    if proc.max_seq_len != tr["max_seq_len"]:
        raise RuntimeError(f"the extractor packs rows of {proc.max_seq_len} tokens, the traffic {tr['max_seq_len']}")
    weights = inputs.make_weights(cfg, cell.seed, device)
    with torch.no_grad():
        for k, p in model.module.named_parameters():
            p.copy_(weights[k])
    del weights
    norm = inputs.make_norm(cfg, tr["norm_side"], device)
    c, mh, mw = cfg["image_channels"], cfg["max_patch_h"], cfg["max_patch_w"]
    model.patchnorm = PatchNormState(n=torch.ones((c, mh, mw), device=device), median=norm["median"], b=norm["b"])
    phases["model"] = time.perf_counter() - cell.t0

    _, draws = pool_plan(tr, cell.seed)
    images = pool_images(tr, cell.seed, device)
    phases["images"] = time.perf_counter() - cell.t0
    pool = preprocess_pool(proc, images, draws)
    del images
    phases["preprocess"] = time.perf_counter() - cell.t0

    checked = tr["checked_steps"]
    steps = _Steps(cell, device, snapshot_at=checked)
    hook = model.module.register_forward_pre_hook(steps, with_kwargs=True)
    moments = _FirstMoments(model.module)
    checked_steps = _CheckedSteps(checked)
    log: Dict[int, dict] = {}
    program_faults = Fault(cell.fault) if cell.fault else None
    if program_faults is not None:
        program_faults.plant()
    try:
        with torch.profiler.record_function("portbench.train"):
            train(
                model, proc, feed(pool, tr["feed_images"]), batch_size=tr["rows"],
                learning_rate=tr["learning_rate"], max_iters=tr["max_iters"], prefetch_batches=tr["prefetch_batches"],
                log_every=tr["log_every"], seed=cell.seed,
                log=lambda d: log.setdefault(d["step"], d) if "images_per_batch" in d else None,
            )
        raise RuntimeError("the trainer returned before the window closed")
    except _WindowClosed:
        pass
    finally:
        hook.remove()
        moments.handle.remove()
        checked_steps.remove()
        if program_faults is not None:
            program_faults.remove()
    if steps.t_end is None:
        raise RuntimeError("the window never closed")

    counters = torch.stack(steps.counters).cpu().numpy()  # (steps seen, 3): tokens, pairs, images
    w0, w1 = steps.warmup, steps.warmup + steps.window_steps
    peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = {
        "window_s": steps.t_end - steps.t_start,
        "window_steps": steps.window_steps,
        "setup_s": steps.t_start - cell.t0,
        "tokens": int(counters[w0:w1, 0].sum()), "pairs": int(counters[w0:w1, 1].sum()),
        "images": int(counters[w0:w1, 2].sum()), "images_per_step": [int(x) for x in counters[w0:w1, 2]],
        "logged_images": {i: int(d["images_per_batch"]) for i, d in log.items()},
        "peak_window_bytes": int(peak_window), "peak_bytes": int(max(peak_window, steps.peak_setup)),
        "phases": dict(phases, first_step=steps.t_first - cell.t0, warmup=steps.t_start - cell.t0),
    }
    if steps.trace is not None:
        a, b = steps.trace_first, steps.trace_last
        out["trace"] = steps.trace.summary()
        out["trace"].update(tokens=int(counters[a:b, 0].sum()), pairs=int(counters[a:b, 1].sum()), steps=b - a)

    terms = checked_steps.read()
    program = {
        "losses": [t["loss"] for t in terms],
        "terms": terms,
        "images": [int(x) for x in counters[:checked, 2]],
        "first_grad": {k: float(v) for k, v in moments.norms.items()},
        "snapshot": steps.snapshot,
    }
    del model, proc, pool, steps, moments, checked_steps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(cell, program, device)
    return out


def check(cell: Cell, program: dict, device) -> dict:
    """The reference's first steps against the program's: each compared number beside its limit."""
    tr, cfg = cell.traffic, cell.config
    checked = tr["checked_steps"]
    weights = inputs.make_weights(cfg, cell.seed, device)
    change = {k: float((v.to(device).double() - weights[k].double()).norm()) for k, v in program.pop("snapshot").items()}
    program["change"] = change
    batches = reference_batches(cell, checked, device)
    norm = inputs.make_norm(cfg, tr["norm_side"], device)
    ref = ref_model.train_steps(weights, cfg, batches, norm, tr["block_rows"])
    ref["images"] = [b["images"] for b in batches]
    return compare.train_checks(program, ref, cell.limits)


def result(cell: Cell, r: dict) -> dict:
    """The run's numbers: the end-to-end metrics and what the per-layer readers read."""
    e2e = {
        "setup_s": {"value": r["setup_s"], "unit": "s"},
        "train_images_per_s": {"value": r["images"] / r["window_s"], "unit": "images/s"},
    }
    counters = {
        "window_s": r["window_s"], "window_steps": r["window_steps"], "images": r["images"],
        "images_per_step": r["images_per_step"], "tokens": r["tokens"], "pairs": r["pairs"],
        "model_flops": flops.model_flops(cell.config, r["tokens"], r["pairs"], train=True),
        "peak_window_bytes": r["peak_window_bytes"],
    }
    if "trace" in r:
        counters["trace"] = r["trace"]
    return {"e2e": e2e, "counters": counters, "peak_bytes": r["peak_bytes"],
            "attempted": r["window_steps"], "failed": 0, "checks": r["checks"], "phases": r["phases"]}
