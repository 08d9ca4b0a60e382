"""Serving cells: one caller in a closed loop of `DCTPipeline.reconstruct_direct`
(the daemon's /reconstruct), each call a group of same-size uint8 images
taken in turn from a pool made from the seed, from images on the host to
uint8 pixels on the host.

Every answer of the window is kept and, once the window has closed and the
program is freed, held against the reference's pixels for the same image
(repeats of one pool image that came back equal are judged once).
"""
from __future__ import annotations

import gc
import hashlib
import time
from typing import List

import numpy as np
import torch

from .. import flops, inputs
from ..common import Cell
from ..faults import Fault
from ..reference import compare
from ..reference import frontend as ref_front
from ..reference import model as ref_model
from ..trace import Trace


def pool(cell: Cell, device) -> List[torch.Tensor]:
    tr = cell.traffic
    return inputs.make_images([tuple(tr["image_size"])] * tr["pool_images"], inputs.image_generator(cell.seed, device), device)


def _call_images(host: List[np.ndarray], j: int, per_call: int) -> List[np.ndarray]:
    return [host[(j * per_call + i) % len(host)] for i in range(per_call)]


def run(cell: Cell) -> dict:
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.models.patchnorm import PatchNormState

    tr, cfg = cell.traffic, cell.config
    device = torch.device(cell.device if cell.device == "cpu" else "cuda:0")
    phases = {"import": time.perf_counter() - cell.t0}
    pipe = dt.DCTPipeline.from_config(
        dt.DCTAutoencoderConfig.from_dict(cfg), sample_patches_beta=tr["beta"], dtype=getattr(torch, cfg["dtype"]), seed=cell.seed,
        device=device)
    weights = inputs.make_weights(cfg, cell.seed, device)
    with torch.no_grad():
        for k, p in pipe.model.module.named_parameters():
            p.copy_(weights[k])
    del weights
    norm = inputs.make_norm(cfg, tr["norm_side"], device)
    c, mh, mw = cfg["image_channels"], cfg["max_patch_h"], cfg["max_patch_w"]
    pipe.model.patchnorm = PatchNormState(n=torch.ones((c, mh, mw), device=device), median=norm["median"], b=norm["b"])
    phases["model"] = time.perf_counter() - cell.t0
    host = [im.cpu().numpy() for im in pool(cell, device)]
    phases["images"] = time.perf_counter() - cell.t0
    per_call = tr["images_per_call"]
    program_faults = Fault(cell.fault) if cell.fault else None
    if program_faults is not None:
        program_faults.plant()

    def call(j: int):
        with torch.profiler.record_function("portbench.reconstruct_direct"):
            return pipe.reconstruct_direct(_call_images(host, j, per_call), as_uint8=True)

    try:
        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
        for j in range(tr["warmup_calls"]):
            call(j)
            sync()
            phases.setdefault("first_call", time.perf_counter() - cell.t0)
        peak_setup = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times: List[float] = []
        answers: List[tuple] = []
        t_start = time.perf_counter()
        j = 0
        while time.perf_counter() - t_start < cell.seconds:
            t = time.perf_counter()
            out = call(j)
            times.append(time.perf_counter() - t)
            answers.append((j, out))
            j += 1
        t_end = time.perf_counter()
        peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        result = {
            "setup_s": t_start - cell.t0, "window_s": t_end - t_start, "calls": len(times), "times": times,
            "call_ms": {f"p{q}": float(np.percentile(times, q) * 1e3) for q in (50, 90, 95, 99, 100)},
            "peak_window_bytes": int(peak_window), "peak_bytes": int(max(peak_window, peak_setup)),
            "phases": dict(phases, warmup=t_start - cell.t0),
        }
        if cell.trace:
            trace = Trace(device)
            trace.start()
            for k in range(tr["trace_calls"]):
                call(j + k)
            trace.stop()
            result["trace"] = trace.summary()
            result["trace"]["calls"] = tr["trace_calls"]
    finally:
        if program_faults is not None:
            program_faults.remove()
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"], result["failed"] = check(cell, host, answers, device)
    return result


def reference_pixels(cell: Cell, images: List[torch.Tensor], device, quant=None) -> List[torch.Tensor]:
    """The reference's uint8 answer for each image: all its tokens (one row each), the model, the back end."""
    tr, cfg = cell.traffic, cell.config
    p, mh, mw = cfg["patch_size"], cfg["max_patch_h"], cfg["max_patch_w"]
    weights = inputs.make_weights(cfg, cell.seed, device)
    norm = inputs.make_norm(cfg, tr["norm_side"], device)
    out = []
    for lo in range(0, len(images), tr["block_rows"]):
        ims = torch.stack(images[lo : lo + tr["block_rows"]])
        toks, pos, chans = ref_front.ranked_tokens(ims, p, mh, mw)
        n = toks.shape[1]
        batch = dict(patches=toks.float(), ids=torch.zeros(toks.shape[:2], dtype=torch.long, device=device),
                     pad=torch.zeros(toks.shape[:2], dtype=torch.bool, device=device), chans=chans, pos=pos)
        dec = ref_model.reconstruct(weights, cfg, batch, norm, tr["block_rows"], quant).double()
        h, w = ims.shape[-2:]
        grid = (min(h // p, mh), min(w // p, mw))
        planes = torch.stack([ref_front.unpatch_planes(dec[i], pos[i], chans[i], grid, p) for i in range(len(ims))])
        out += list(ref_front.to_uint8(ref_front.planes_to_rgb(planes, h, w)))
        del batch, dec, planes, toks
    return out


def pixel_error(a, b) -> tuple:
    """(mean squared, root mean squared) difference of two uint8 images, in units of the full range."""
    d = (np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)) / 255.0
    mse = float(np.mean(d * d))
    return mse, mse**0.5


def check(cell: Cell, host: List[np.ndarray], answers: List[tuple], device):
    """(checks, failed calls): every answer of the window against the reference's pixels."""
    per_call = cell.traffic["images_per_call"]
    ref = [t.cpu().numpy() for t in reference_pixels(cell, [torch.from_numpy(h).to(device) for h in host], device)]
    failed, seen, errors = 0, {}, []
    for j, out in answers:
        bad = len(out) != per_call
        for i, im in enumerate(out[:per_call]):
            src = (j * per_call + i) % len(host)
            if im.shape != ref[src].shape or im.dtype != np.uint8:
                bad = True
                continue
            key = (src, hashlib.blake2b(im.tobytes(), digest_size=16).digest())
            if key not in seen:
                seen[key] = pixel_error(im, ref[src])
            errors.append(seen[key])
        failed += bad
    return compare.pixel_checks(errors, failed, cell.limits), failed


def result(cell: Cell, r: dict) -> dict:
    """The run's numbers: the end-to-end metrics and what the per-layer readers read."""
    tr, cfg = cell.traffic, cell.config
    h, w = tr["image_size"]
    per_call = tr["images_per_call"]
    p = cfg["patch_size"]
    tokens_per_image = min(h // p, cfg["max_patch_h"]) * min(w // p, cfg["max_patch_w"]) * 3
    times = sorted(r["times"])
    e2e = {
        "setup_s": {"value": r["setup_s"], "unit": "s"},
        "recon_images_per_s": {"value": r["calls"] * per_call / r["window_s"], "unit": "images/s"},
        "recon_call_p95_ms": {"value": percentile(times, 0.95) * 1e3, "unit": "ms"},
    }
    calls = r["calls"]
    counters = {
        "window_s": r["window_s"], "calls": calls, "images": calls * per_call,
        "tokens": calls * per_call * tokens_per_image, "pairs": calls * per_call * tokens_per_image**2,
        "model_flops": flops.model_flops(cfg, calls * per_call * tokens_per_image,
                                         calls * per_call * tokens_per_image**2, train=False),
        "peak_window_bytes": r["peak_window_bytes"],
    }
    if "trace" in r:
        t = dict(r["trace"])
        n = t["calls"] * per_call
        t.update(tokens=n * tokens_per_image, pairs=n * tokens_per_image**2, images=n, image_hw=(h, w))
        counters["trace"] = t
    return {"e2e": e2e, "counters": counters, "peak_bytes": r["peak_bytes"], "attempted": calls,
            "failed": r["failed"], "checks": r["checks"], "phases": dict(r["phases"], call_ms=r["call_ms"])}


def percentile(sorted_values: List[float], q: float) -> float:
    """The q-quantile of every value, by linear interpolation between the order statistics."""
    return float(np.quantile(np.asarray(sorted_values), q))
