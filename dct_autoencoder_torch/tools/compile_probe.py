"""First-call and steady-state latency probe of the forward (JAX:
tools/compile_probe.py, whose reference is test_compile.py).

Builds a model from a config at random init and runs its forward on a
packed batch of random tokens (patches/synthetic.py), each call's output
patches fed to the next.  The port compiles nothing ahead of time: the
first call's seconds include the hand kernels' build or load at first use
(dct_autoencoder_torch/kernels).  Then the steady ms a batch and images/s,
and with --profile_dir a torch.profiler trace (trace.json, for Perfetto or
chrome://tracing) of three more calls, outside the timed ones.

  python -m dct_autoencoder_torch.tools.compile_probe \\
      --model_config_path conf/patch14-l.json --rows 16 --profile_dir /tmp/trace
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional


def main(
    model_config_path: str = "./conf/patch14-l.json",
    rows: int = 16,
    seq_len: int = 256,
    iters: int = 10,
    dtype: str = "bfloat16",
    profile_dir: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    import torch

    from ..models.config import DCTAutoencoderConfig
    from ..models.factory import get_model_and_processor
    from ..patches.synthetic import packed_batch

    cfg = DCTAutoencoderConfig.from_json_file(model_config_path)
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    model, _ = get_model_and_processor(cfg, dtype=tdtype, sample_patches_beta=0.0, device=device)
    batch, n_images = packed_batch(cfg, max_seq_len=seq_len, rows=rows, device=model.device)
    on_card = model.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(model.device)

    @torch.no_grad()
    def fwd(patches):
        out = model.module(batch.replace(patches=patches), training=False)
        return out["dct_patches"].patches.float()

    t0 = time.perf_counter()
    p = fwd(batch.patches)
    sync()
    first_s = time.perf_counter() - t0
    print(f"first call (the kernels' build or load at first use included): {first_s:.1f}s")

    t0 = time.perf_counter()
    for _ in range(iters):
        p = fwd(p)
    sync()
    dt = (time.perf_counter() - t0) / iters
    trace = None
    if profile_dir:  # a window of its own: the profiler slows the calls it records
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(min(iters, 3)):
                p = fwd(p)
            sync()
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print("trace written to", trace)

    print(
        f"time taken per batch: {dt * 1e3:.1f}ms  "
        f"({rows} rows x {seq_len} tokens, {n_images} images -> {n_images / dt:.0f} images/s)"
    )
    return {"first_call_s": first_s, "ms_per_batch": dt * 1e3, "images_per_s": n_images / dt, "images": n_images,
            "rows": rows, "seq_len": seq_len, "dtype": dtype, "device": str(model.device), "trace": trace}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_config_path", default="./conf/patch14-l.json")
    p.add_argument("--rows", type=int, default=16)
    p.add_argument("--seq_len", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain PyTorch path")
    main(**vars(p.parse_args()))
