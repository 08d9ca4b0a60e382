"""Drive the PyTorch/CUDA port's serving, training and AR paths on one NVIDIA GPU.

    python3 chip_smoke.py            # add --profile for device-time breakdowns

Builds the five hand-written CUDA kernels from dct_autoencoder_torch/csrc
(nvcc, sm_90a), holds each, and the causal mode of the three attention
kernels, against its plain PyTorch version at the shapes the main paths give
it (the bfloat16 attention kernels, forward and backward, which multiply on
the tensor cores, also against their CUDA-core versions, `impl="simt"`,
timed beside them; the DCT and IDCT kernels, 3xTF32 on the tensor cores,
also against a float64 plain version), and then drives the paths themselves:
  * the serving round trip with the trained checkpoint in
    docs/calibrated_run_r3b/model (its gated int8 sibling, and the same
    batch through the port on the CPU in fp32), timed warm beside the float
    model, and a lossless no-model round trip;
  * one forward of a random-init patch14-L model at full width on a 64 x 256
    packed batch;
  * train() for 20 steps on that checkpoint (bf16 compute, fp32 masters) on
    one fixed packed batch, its first step held against the port's fp32 CPU
    run;
  * train() at the full width of patch14-L on 64 x 256 batches, then timed
    train steps;
  * train steps of the 33.6 M-parameter AR token model on packed 8 x 1024
    rows (bf16 compute, fp32 masters), through the causal kernels;
  * the AR example's loop on records that the trained tokenizer makes:
    train, save, load, the KV-cached decode step against the kernel path,
    sample, decode to pixels;
  * the samplers of the 33.6 M model: the captured decode step beside the
    eager per-token loop, at b = 1 and b = 8;
  * reconstruct_direct of 16 448 x 448 images at the full width of patch14-L
    beside reconstruct on the same tokens (one IDCT launch against 16), and on
    the model's int8 forms (weight_only; dynamic, whose products run as
    torch._int_mm);
  * the int8 gate (tools/quantize_checkpoint.py, relative mode) on a copy of
    the trained checkpoint;
  * the serving daemon (tools/serve.py) on the trained checkpoint's int8
    sibling with the shape buckets: binary /reconstruct from the load client
    (tools/bench_serving.py) at concurrency 1 and 8 under max_batch 16 and 1,
    JSON /encode + /decode, and /generate over the AR example's model;
  * AdamW8bit over patch14-L's ~205 M parameters: 3 updates on the card and
    on the CPU (the same codes and absmax), timed beside fp32 AdamW;
  * train() on the trained checkpoint with the pixel loss and 8-bit moments,
    step 0 against the fp32 CPU step (and accumulation 2 against it too);
  * the training CLI (train/cli.py) at the full width of patch14-L on PNG tar
    shards written in a temporary directory: 8-bit moments, the pixel loss,
    prefetch, augmentation, image grids (the IDCT kernel) and checkpoints for
    8 steps, timed, with the device-busy share of steps 1-4 under the
    profiler, then the same 4 steps without prefetch.
The kernels' phase also runs the fp32 attention backward 20 times in each
mask mode after filling the allocator's free memory with NaN, and requires
the same bits every time.
Every phase prints one JSON line; any failed check raises and the script
exits non-zero.  The line before the last lists the kernels with their
launches on the main paths, errors, times and bounds; the last line is
{"ok": true, "device": {...}}.

`--kernels-only` stops after the kernels' phase (no result line);
`--kernels-only=dct` runs only its DCT and IDCT cases: the quick loop while
one of those sources is being changed (the build's hash follows the source).

Needs a CUDA device, and exits non-zero without one.  Imports no JAX.
"""
import io
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
R3B = os.path.join(HERE, "docs", "calibrated_run_r3b", "model")
PATCH14_L = os.path.join(HERE, "conf", "patch14-l.json")

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

# forward: o against the plain version, which rounds p to bf16 before P.V as the
# tensor-core kernel does; against impl="simt" (p kept in fp32) the limit is the
# larger of this and one bf16 ulp of max |o| (`simt_tol`), as for the backward
ATTN_ATOL_BF16 = 2e-2
# backward: dq, dk, dv reach ~4, where half a bf16 ulp is 1.6e-2.  The tensor-core
# kernels and the plain version both round p and ds to bf16 before the second
# products, sum in fp32 and round once at the store.  The CUDA-core kernels
# (impl="simt") keep p and ds in fp32, so against them the sums differ by ~1e-3
# before the store and the two roundings can fall to different sides: one whole
# ulp of the value, which from |g| = 4 on is 3.1e-2.  `simt_tol` is therefore the
# larger of this limit and one bf16 ulp of the largest gradient of the case.
ATTN_BWD_ATOL_BF16 = 3e-2
# launches between two CUDA events when a kernel faster than the host's launch is timed
TIMED_LAUNCHES = 10
DCT_REL_TOL = 1e-5
# against float64 on the same fp32 inputs, a DCT kernel's largest error may be
# this many times the fp32 plain version's (cuBLAS SGEMM), over the whole output
# and over the high-frequency quarter alone; 3xTF32 keeps ~22 bits and passes,
# one TF32 product (11 bits) fails by orders of magnitude
DCT_F64_RATIO = 8.0
MIN_CODE_AGREEMENT = 0.95
MAX_PSNR_DELTA_DB = 0.5
MIN_LOSSLESS_PSNR_DB = 100.0
# reconstruct_direct (uint8) against reconstruct on the same tokens: the JAX
# package's figure for its two paths (its pipeline.py docstring); the uint8
# rounding alone leaves ~59 dB
MIN_DIRECT_VS_ROUNDTRIP_PSNR_DB = 40.0
# bf16 training step on the card against the port's fp32 step on the CPU, same batch
MAX_TRAIN_LOSS_REL = 0.05
MAX_TRAIN_GRAD_NORM_REL = 0.30
# the AR example trains in fp32 on the card; its step 0 against the port's fp32 CPU step
MAX_AR_STEP0_LOSS_REL = 1e-3
# decode_step logits against the teacher-forced forward of the same sequence
# (another order of sums; in bf16 the cached path also rounds the softmax
# weights to bf16 where the kernel keeps them in fp32)
MAX_CACHED_VS_KERNEL_FP32 = 2e-3
MAX_CACHED_VS_KERNEL_BF16 = 0.25
MAX_AR_LOSS0_FROM_LN_Z = 0.7


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 25, inner: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn(), after two warm-up calls.
    With inner > 1 each timing spans `inner` calls and is divided by it: the
    queue stays full, so a call shorter than the host's launch is not timed
    by the host."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def simt_tol(limit: float, largest: float) -> float:
    """The limit between a tensor-core kernel and its CUDA-core version: two bf16
    results that were each rounded once can land one ulp of the value apart."""
    return max(limit, bf16_ulp(largest))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM rate and operations over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from dct_autoencoder_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    emit({
        "phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "kernel_build_s": build_s,
    })
    return smi


# ---------------------------------------------------------------- phase 2


def _attention_inputs(b, h, s, d, dtype, gen, n_tensors):
    """n random (b, h, s, d) tensors on the card, and packed rows: sorted image ids, a padded tail."""
    from dct_autoencoder_torch.kernels import attention as A

    dev = torch.device("cuda")
    tensors = tuple(torch.randn(b, h, s, d, generator=gen).to(dtype).to(dev) for _ in range(n_tensors))
    ids = torch.sort(torch.randint(0, 6, (b, s), generator=gen), dim=1).values.int().to(dev)
    lens = torch.randint(max(1, s // 2), s + 1, (b,), generator=gen).to(dev)
    pad = torch.arange(s, device=dev)[None] >= lens[:, None]
    return tensors, pad, *A.segment_ids(ids, pad)


def _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype, causal=False):
    """The mask that makes scaled_dot_product_attention compute the same
    function, and the (query, key) pairs whose products the function needs.
    With causal=True in 'block' mode the mask is boolean: same image AND
    k <= q (`is_causal` alone cannot express packing); the diagonal is
    allowed for padded queries too, so that no row of the library's softmax
    is empty."""
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    if causal:
        s = q_ids.shape[1]
        allowed = allowed & torch.ones(s, s, dtype=torch.bool, device=q_ids.device).tril()
        if mode == "block":
            return allowed | torch.eye(s, dtype=torch.bool, device=q_ids.device), allowed.sum().item()
    if mode == "bias":
        return allowed.to(dtype), allowed.numel()
    return torch.where(allowed, 0.0, -1e9).to(dtype), allowed.sum().item()  # only pairs inside an image


def _attention_case(b, h, s, d, dtype, mode, gen):
    import torch.nn.functional as F

    from dct_autoencoder_torch.kernels import attention as A

    (q, k, v), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, dtype, gen, 3)
    scale = d**-0.5

    kernel = lambda: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode)
    plain = lambda: A.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode)
    o, lse = kernel()
    torch.cuda.synchronize()
    o_ref, lse_ref = plain()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    tol = ATTN_ATOL_BF16 if dtype == torch.bfloat16 else 1e-5
    what = f"attention {mode} {(b, h, s, d)}"
    check(err <= tol, f"{what}: max|diff| {err} > {tol}")
    check(torch.isfinite(o).all().item(), "attention output not finite")
    if mode == "block":
        pad_max = o.transpose(1, 2)[pad].abs().max().item() if pad.any() else 0.0
        check(pad_max == 0.0, f"attention block mode: padded queries not 0 ({pad_max})")
    check(all(torch.equal(x, y) for x, y in zip((o, lse), kernel())), f"{what}: two launches on the same inputs differ")
    simt = lambda: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, impl="simt")
    simt_row = _fwd_against_simt(A, q, d, o, simt, what)

    sdpa_mask, pairs = _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype)
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask, scale=scale)

    elt = q.element_size()
    nbytes = 4 * b * h * s * d * elt + 2 * b * s * 4 + b * h * s * 4
    flops = 4 * h * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {
        "shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode,
        "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": tol,
        "ms": time_ms(kernel, inner=TIMED_LAUNCHES), "plain_ms": time_ms(plain),
        "library_ms": time_ms(library, inner=TIMED_LAUNCHES),
        "bound_ms": bound_ms, "bound_by": bound_by, **simt_row,
    }


def _fwd_against_simt(A, q, d, o, simt, what):
    """For bfloat16: the tensor-core forward's o against the CUDA-core kernel's
    on the same inputs, the CUDA-core kernel's time, and what the compiler made
    of both instantiations.  For float32 (one implementation): the kernel info."""
    info = lambda impl: A.attention_kernel_info("fwd", impl, q.dtype, d)
    if q.dtype != torch.bfloat16:
        return {"impl": "simt", "simt_ms": None, "kernel_info": info("simt")}
    o_simt, _ = simt()
    torch.cuda.synchronize()
    diff = (o.float() - o_simt.float()).abs().max().item()
    top = o_simt.float().abs().max().item()
    tol = simt_tol(ATTN_ATOL_BF16, top)
    check(diff <= tol, f"{what}: o of impl mma and impl simt differ by {diff} > {tol}")
    return {
        "impl": "mma", "simt_tol": tol, "max_abs_o": top, "simt_max_abs_diff": diff,
        "simt_ms": time_ms(simt, reps=10), "kernel_info": info("mma"), "simt_kernel_info": info("simt"),
    }


def _bwd_against_simt(A, q, d, got, dq_simt, dkv_simt, what):
    """For bfloat16: the tensor-core kernels' results `got` = (dq, dk, dv)
    against the CUDA-core kernels on the same inputs, the CUDA-core kernels'
    times, and what the compiler made of both instantiations.  For float32
    (one implementation): only the kernel info."""
    info = lambda kernel, impl: A.attention_kernel_info(kernel, impl, q.dtype, d)
    if q.dtype != torch.bfloat16:
        rows = {name: {"impl": "simt", "simt_ms": None, "kernel_info": info(name, "simt")} for name in ("dq", "dkv")}
        return rows["dq"], rows["dkv"]
    dq_s, delta_s = dq_simt()
    dk_s, dv_s = dkv_simt(delta_s)
    torch.cuda.synchronize()
    diffs, top = {}, 0.0
    for name, new, old in (("dq", got[0], dq_s), ("dk", got[1], dk_s), ("dv", got[2], dv_s)):
        diffs[name] = (new.float() - old.float()).abs().max().item()
        top = max(top, old.float().abs().max().item())
    tol = simt_tol(ATTN_BWD_ATOL_BF16, top)
    for name, diff in diffs.items():
        check(diff <= tol, f"{what}: {name} of impl mma and impl simt differ by {diff} > {tol}")
    common = {"impl": "mma", "simt_tol": tol, "max_abs_grad": top}
    return (
        {**common, "simt_max_abs_diff": diffs["dq"], "simt_ms": time_ms(dq_simt, reps=10),
         "kernel_info": info("dq", "mma"), "simt_kernel_info": info("dq", "simt")},
        {**common, "simt_max_abs_diff": max(diffs["dk"], diffs["dv"]), "simt_ms": time_ms(lambda: dkv_simt(delta_s), reps=10),
         "kernel_info": info("dkv", "mma"), "simt_kernel_info": info("dkv", "simt")},
    )


def _attention_bwd_case(b, h, s, d, dtype, mode, gen):
    """The dq and dk/dv kernels against attention_bwd_plain (and, in bfloat16,
    against their CUDA-core versions); o and lse come from the forward kernel."""
    import torch.nn.functional as F

    from dct_autoencoder_torch.kernels import attention as A

    (q, k, v, do), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, dtype, gen, 4)
    scale = d**-0.5
    o, lse = A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode)

    dq_kernel = lambda: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode)
    dq, delta = dq_kernel()
    dkv_kernel = lambda: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode)
    dk, dv = dkv_kernel()
    torch.cuda.synchronize()
    plain = lambda: A.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode)
    dq_ref, dk_ref, dv_ref = plain()
    tol = ATTN_BWD_ATOL_BF16 if dtype == torch.bfloat16 else 1e-5
    errs = {}
    for name, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        errs[name] = (got.float() - ref.float()).abs().max().item()
        check(torch.isfinite(got).all().item(), f"attention backward {name} not finite")
        check(errs[name] <= tol, f"attention backward {name} {mode} {(b, h, s, d)}: max|diff| {errs[name]} > {tol}")
    delta_err = (delta - (do.float() * o.float()).sum(-1)).abs().max().item()
    check(delta_err <= 1e-3, f"delta from the dq kernel: max|diff| {delta_err}")
    if mode == "block" and pad.any():
        pad_max = dq.transpose(1, 2)[pad].abs().max().item()
        check(pad_max == 0.0, f"attention backward block mode: dq of padded queries not 0 ({pad_max})")
    again = (*dq_kernel(), *dkv_kernel())
    check(all(torch.equal(x, y) for x, y in zip((dq, delta, dk, dv), again)),
          f"attention backward {mode} {(b, h, s, d)}: two launches on the same inputs differ")
    del again
    dq_simt = lambda: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, impl="simt")
    dkv_simt = lambda dl: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, dl, do, scale, mode, impl="simt")
    dq_row, dkv_row = _bwd_against_simt(A, q, d, (dq, dk, dv), dq_simt, dkv_simt, f"attention backward {mode} {(b, h, s, d)}")

    sdpa_mask, pairs = _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=sdpa_mask, scale=scale)
    # the library's whole backward (dq, dk and dv in one call), timed alone
    library = lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)

    elt, n = q.element_size(), b * h * s * d
    vec = b * h * s * 4  # one fp32 row vector: lse or delta
    ids_bytes = 2 * b * s * 4
    # dq: q, k, v, o, do read, lse read, dq and delta written; three products
    dq_bound = bound(6 * n * elt + 2 * vec + ids_bytes, 6 * h * d * pairs, dtype)
    # dk/dv: q, k, v, do, lse, delta read, dk and dv written; four products
    dkv_bound = bound(6 * n * elt + 2 * vec + ids_bytes, 8 * h * d * pairs, dtype)
    plain_ms, library_ms = time_ms(plain, reps=10), time_ms(library, inner=TIMED_LAUNCHES)
    common = {
        "shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode, "tol": tol,
        "plain_ms": plain_ms, "plain_computes": "dq, dk and dv", "library_ms": library_ms,
        "library_computes": "dq, dk and dv (backward of scaled_dot_product_attention)",
    }
    return {
        "attention_dq": {
            **common, "max_abs_err": errs["dq"], "delta_max_abs_err": delta_err,
            "ms": time_ms(dq_kernel, inner=TIMED_LAUNCHES), "bound_ms": dq_bound[0], "bound_by": dq_bound[1], **dq_row,
        },
        "attention_dkv": {
            **common, "max_abs_err": max(errs["dk"], errs["dv"]),
            "ms": time_ms(dkv_kernel, inner=TIMED_LAUNCHES), "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1], **dkv_row,
        },
    }


def _poison_allocator(n_bytes: int = 384 << 20) -> None:
    """Fill memory that the caching allocator will hand out next with NaN: one
    large block and many small ones (the allocator keeps blocks of up to 1 MB
    in a pool of their own), all freed at once.  A kernel that reads memory
    nothing wrote then gives NaN or a large error, not a rare small one."""
    small = [torch.full((n,), float("nan"), device="cuda") for n in (1 << 12, 1 << 15, 1 << 18) for _ in range(96)]
    large = torch.full((n_bytes // 4,), float("nan"), device="cuda")
    torch.cuda.synchronize()
    del small, large


def attention_grads_f64(q, k, v, ids, pad, scale, mode):
    """Gradients of sum(o^2) with respect to q, k, v of the kernels' function
    (segment mask, the row max clamped at -5e8, the denominator at 1e-9),
    computed in float64 on the CPU: the yardstick both fp32 sides are read against."""
    from dct_autoencoder_torch.kernels.attention import NEG_INF, segment_ids

    q_ids, kv_ids = segment_ids(ids, pad)
    qq, kk, vv = (t.detach().double().cpu().requires_grad_(True) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * scale
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    logits = logits + allowed.double() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, NEG_INF))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF * 0.5).detach()
    p = torch.exp(logits - m)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv) / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    (o**2).sum().backward()
    return [t.grad for t in (qq, kk, vv)]


def _attention_bwd_determinism(mode: str, runs: int = 20):
    """The fp32 backward kernels through packed_flash_attention's autograd at
    (2, 4, 173, 32) (a ragged last tile, the head merge's transposed
    grad_output; the inputs of tests/test_torch_cuda.py::test_attention_gradients_match_cpu),
    `runs` times, each after poisoning the allocator.  Checks: every run gives
    the same bits, within 1e-5 (+ 1e-5 relative) of the plain versions
    (attention_fwd_plain, attention_bwd_plain) on the card and of a float64
    computation.  The plain versions on the CPU are read and reported beside
    them; a disagreement with them emits the places where it lies, so that
    an occurrence names the side that moved."""
    from dct_autoencoder_torch.kernels import attention as A

    b, h, s, d = 2, 4, 173, 32
    scale = d**-0.5
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(b, h, s, d, generator=g) for _ in range(3))
    ids = torch.sort(torch.randint(0, 4, (b, s), generator=g), dim=1).values.int()
    lens = torch.randint(max(1, s // 2), s + 1, (b,), generator=g)
    pad = torch.arange(s)[None] >= lens[:, None]

    def grads(dev):
        qq, kk, vv = (t.clone().to(dev).requires_grad_(True) for t in (q, k, v))
        o = A.packed_flash_attention(qq, kk, vv, ids.to(dev), pad.to(dev), scale, mode)
        (o.transpose(1, 2).reshape(b, s, h * d) ** 2).sum().backward()
        return [t.grad.cpu() for t in (qq, kk, vv)]

    def plain(dev):
        qq, kk, vv = (t.to(dev) for t in (q, k, v))
        q_ids, kv_ids = A.segment_ids(ids.to(dev), pad.to(dev))
        o, lse = A.attention_fwd_plain(qq, kk, vv, q_ids, kv_ids, scale, mode)
        return [t.cpu() for t in A.attention_bwd_plain(qq, kk, vv, q_ids, kv_ids, o, lse, 2 * o, scale, mode)]

    outside = lambda got, ref: sum(int(((x - r).abs() > 1e-5 + 1e-5 * r.abs()).sum()) for x, r in zip(got, ref))
    max_err = lambda got, ref: max((x.double() - r.double()).abs().max().item() for x, r in zip(got, ref))
    ref = plain("cuda")
    ref64 = attention_grads_f64(q, k, v, ids, pad, scale, mode)
    first, differing = None, 0
    for _ in range(runs):
        _poison_allocator()
        got = grads("cuda")
        if first is None:
            first = got
        differing += not all(torch.equal(x, y) for x, y in zip(first, got))
    cpu_kernel_path = grads("cpu")  # the same autograd path, which runs the plain versions on the CPU
    row = {"mode": mode, "shape": [b, h, s, d], "runs": runs, "runs_differing": differing,
           "max_abs_err": max_err(first, ref), "max_abs_err_vs_f64": max_err(first, ref64), "tol": "1e-5 + 1e-5 |ref|",
           "plain_on_card_vs_f64": max_err(ref, ref64), "cpu_plain_vs_f64": max_err(cpu_kernel_path, ref64),
           "max_abs_err_vs_cpu_plain": max_err(first, cpu_kernel_path), "max_abs_grad": max(r.abs().max().item() for r in ref64)}
    if differing or outside(first, ref) or outside(first, ref64) or outside(first, cpu_kernel_path):
        where = {}
        for name, x, r in zip(("dq", "dk", "dv"), first, cpu_kernel_path):
            bad = ((x - r).abs() > 1e-5 + 1e-5 * r.abs()).nonzero()
            where[name] = {"elements": int(bad.shape[0]), "batch_head_pairs": sorted({(int(i), int(j)) for i, j, _, _ in bad.tolist()}),
                           "rows": sorted({int(t) for t in bad[:, 2].tolist()})[:40]}
        emit({"phase": "attention_bwd_fp32_disagreement", **row, "card_vs_cpu_plain_where": where,
              "cpu_plain_again_vs_f64": max_err(grads("cpu"), ref64), "threads": torch.get_num_threads()})
    what = f"fp32 attention backward {mode} {(b, h, s, d)}"
    check(differing == 0, f"{what}: {differing} of {runs} runs after poisoning differ from the first")
    check(outside(first, ref) == 0, f"{what}: off the plain versions on the card by more than 1e-5 (max {row['max_abs_err']})")
    check(outside(first, ref64) == 0, f"{what}: off float64 by more than 1e-5 (max {row['max_abs_err_vs_f64']})")
    return row


def _attention_causal_case(b, h, s, d, dtype, mode, gen, reps=10):
    """The causal mode of the forward, dq and dk/dv kernels against the plain
    versions; in 'block' mode also timed without the tile skipping, held to the
    same bits, and checked for leakage from later keys."""
    import torch.nn.functional as F

    from dct_autoencoder_torch.kernels import attention as A

    (q, k, v, do), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, dtype, gen, 4)
    scale = d**-0.5
    bf16 = dtype == torch.bfloat16
    fwd = lambda skip=True: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, True, skip)
    o, lse = fwd()
    dq_k = lambda skip=True: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, True, skip)
    dq, delta = dq_k()
    dkv_k = lambda skip=True: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, True, skip)
    dk, dv = dkv_k()
    torch.cuda.synchronize()

    fwd_plain = lambda: A.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, True)
    bwd_plain = lambda: A.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, True)
    o_ref, lse_ref = fwd_plain()
    refs = dict(zip(("dq", "dk", "dv"), bwd_plain()))
    what = f"causal attention {mode} {(b, h, s, d)}"
    tol_f, tol_b = (ATTN_ATOL_BF16, ATTN_BWD_ATOL_BF16) if bf16 else (1e-5, 1e-5)
    errs = {"o": (o.float() - o_ref.float()).abs().max().item()}
    check(errs["o"] <= tol_f, f"{what}: o max|diff| {errs['o']} > {tol_f}")
    lse_err = (lse - lse_ref).abs().max().item()
    check(lse_err <= 1e-4, f"{what}: lse max|diff| {lse_err}")
    check(all(torch.equal(x, y) for x, y in zip((o, lse), fwd())), f"{what}: two forward launches differ")
    fwd_row = _fwd_against_simt(A, q, d, o, lambda: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, True, impl="simt"), what)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        errs[name] = (got.float() - refs[name].float()).abs().max().item()
        check(torch.isfinite(got).all().item(), f"{what}: {name} not finite")
        check(errs[name] <= tol_b, f"{what}: {name} max|diff| {errs[name]} > {tol_b}")
    del o_ref, lse_ref, refs
    if mode == "block":
        if pad.any():
            check(o.transpose(1, 2)[pad].abs().max().item() == 0.0, f"{what}: padded queries not 0")
            check(dq.transpose(1, 2)[pad].abs().max().item() == 0.0, f"{what}: dq of padded queries not 0")
        # every tile, no skipping: the same bits
        o_all, lse_all = fwd(False)
        dq_all, delta_all = dq_k(False)
        dk_all, dv_all = dkv_k(False)
        same = all(torch.equal(x, y) for x, y in ((o, o_all), (lse, lse_all), (dq, dq_all), (dk, dk_all), (dv, dv_all)))
        check(same, f"{what}: skipping the tiles above the diagonal changed a bit")
        # no leakage: later keys and values moved, earlier outputs stay
        cut = s // 2 + 5
        k2, v2 = k.clone(), v.clone()
        k2[:, :, cut:] += 3.0
        v2[:, :, cut:] += 100.0
        o2, _ = A.attention_fwd_cuda(q, k2, v2, q_ids, kv_ids, scale, mode, True)
        leak = (o2[:, :, :cut].float() - o[:, :, :cut].float()).abs().max().item()
        check(leak <= 1e-5, f"{what}: outputs before {cut} moved by {leak} with later keys")
        check((o2[:, :, cut:].float() - o[:, :, cut:].float()).abs().max().item() > 1, f"{what}: later outputs did not move")
        del o_all, lse_all, dq_all, delta_all, dk_all, dv_all, k2, v2, o2
    again = (*dq_k(), *dkv_k())
    check(all(torch.equal(x, y) for x, y in zip((dq, delta, dk, dv), again)), f"{what}: two launches on the same inputs differ")
    del again
    dq_simt = lambda: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, True, impl="simt")
    dkv_simt = lambda dl: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, dl, do, scale, mode, True, impl="simt")
    dq_row, dkv_row = _bwd_against_simt(A, q, d, (dq, dk, dv), dq_simt, dkv_simt, what)

    mask, pairs = _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype, causal=True)
    lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
    lib_bwd = lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)

    elt, n = q.element_size(), b * h * s * d
    vec, ids_bytes = b * h * s * 4, 2 * b * s * 4
    bounds = {
        "attention_causal": bound(4 * n * elt + ids_bytes + vec, 4 * h * d * pairs, dtype),
        "attention_dq_causal": bound(6 * n * elt + 2 * vec + ids_bytes, 6 * h * d * pairs, dtype),
        "attention_dkv_causal": bound(6 * n * elt + 2 * vec + ids_bytes, 8 * h * d * pairs, dtype),
    }
    plain_fwd_ms, plain_bwd_ms = time_ms(fwd_plain, reps=5), time_ms(bwd_plain, reps=5)
    lib_fwd_ms = time_ms(lib_fwd, reps=reps, inner=TIMED_LAUNCHES)
    lib_bwd_ms = time_ms(lib_bwd, reps=reps, inner=TIMED_LAUNCHES)
    common = {
        "shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode, "causal": True,
        "allowed_pairs_share": pairs / (b * s * s),
    }
    bwd_notes = {
        "plain_computes": "dq, dk and dv",
        "library_computes": "dq, dk and dv (backward of scaled_dot_product_attention)",
    }
    rows = {
        "attention_causal": {**common, "tol": tol_f, "max_abs_err": errs["o"], "lse_max_abs_err": lse_err,
                             "plain_ms": plain_fwd_ms, "library_ms": lib_fwd_ms, **fwd_row},
        "attention_dq_causal": {**common, "tol": tol_b, "max_abs_err": errs["dq"], "plain_ms": plain_bwd_ms,
                                "library_ms": lib_bwd_ms, **bwd_notes, **dq_row},
        "attention_dkv_causal": {**common, "tol": tol_b, "max_abs_err": max(errs["dk"], errs["dv"]),
                                 "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms, **bwd_notes, **dkv_row},
    }
    for name, kernel in (("attention_causal", fwd), ("attention_dq_causal", dq_k), ("attention_dkv_causal", dkv_k)):
        rows[name]["ms"] = time_ms(kernel, reps=reps, inner=TIMED_LAUNCHES)
        # 'bias' mode may skip nothing: there is one time
        rows[name]["ms_every_tile"] = (
            time_ms(lambda: kernel(False), reps=reps, inner=TIMED_LAUNCHES) if mode == "block" else None
        )
        rows[name]["bound_ms"], rows[name]["bound_by"] = bounds[name]
    return rows


def graph_ms(fn, launches: int = TIMED_LAUNCHES, reps: int = 25) -> float:
    """Device time of one fn() call: `launches` calls captured in one CUDA
    graph, the median of `reps` timed replays divided by `launches`.  The
    host's cost (Python, ctypes, allocation) stays out of the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = time_ms(graph.replay, reps=reps) / launches
    del graph
    return ms


def _planes(tokens, ch, cw, p):
    """(b, ph*pw, 3, p*p) patch tokens -> (b, 3, ch, cw) planes."""
    b = tokens.shape[0]
    return tokens.reshape(b, ch // p, cw // p, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(b, 3, ch, cw).contiguous()


def _f64_errors(got, ref64, hf):
    """Largest |got - ref64| over the whole output and where `hf` (a boolean
    mask broadcast over it) is set."""
    diff = (got.double() - ref64).abs()
    return diff.max().item(), diff.masked_select(hf).max().item()


def _hold_to_plain_and_f64(what, out, plain, ref64, hf):
    """Criteria 1 and 2: within DCT_REL_TOL x max|plain| of the fp32 plain
    version, and against float64 within DCT_F64_RATIO x the plain version's
    error, whole and in the high-frequency part `hf`.  Returns the numbers."""
    vmax = plain.abs().max().item()
    plain64, plain64_hf = _f64_errors(plain, ref64, hf)
    err = (out - plain).abs().max().item()
    e64, e64_hf = _f64_errors(out, ref64, hf)
    check(err <= DCT_REL_TOL * vmax, f"{what}: max|diff| {err} > {DCT_REL_TOL} x {vmax}")
    check(e64 <= DCT_F64_RATIO * plain64, f"{what}: float64 error {e64} > {DCT_F64_RATIO} x {plain64}")
    check(e64_hf <= DCT_F64_RATIO * plain64_hf,
          f"{what}: float64 error {e64_hf} > {DCT_F64_RATIO} x {plain64_hf} in the high frequencies")
    return {"max_abs_value": vmax, "plain_f64_err": plain64, "plain_f64_err_hf": plain64_hf, "max_abs_err": err,
            "f64_err": e64, "f64_err_hf": e64_hf, "f64_ratio": e64 / plain64, "f64_ratio_hf": e64_hf / plain64_hf}


def _dct_bounds(b, flops, nbytes):
    """The three bounds of a DCT kernel: the bytes; its products on the tensor
    cores in 3xTF32 (three TF32 products a multiply-add); the same products in
    fp32 on the CUDA cores.  `bound_ms` is the larger of the first two."""
    bytes_ms, _ = bound(nbytes, 0.0, torch.float32)
    tf32_ms = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    return {
        "bound_ms": max(bytes_ms, tf32_ms), "bound_by": "operations" if tf32_ms > bytes_ms else "bytes",
        "bound_bytes_ms": bytes_ms, "bound_tf32x3_ms": tf32_ms,
        "bound_fp32_cuda_cores_ms": flops / PEAK_FLOPS[torch.float32] * 1e3, "flops": flops, "bytes": nbytes,
    }


def _dct_case(b, h, w, p, crop, gen, timed, profile):
    """Both DCT kernels on one shape: held to the fp32 plain version and to
    float64, the round trip, same bits twice; when `timed`, the kernels from
    a CUDA graph (device time), the wrappers as the extractor calls them, the
    plain versions."""
    from dct_autoencoder_torch.kernels import dct_patchify as P
    from dct_autoencoder_torch.kernels import idct_unpatchify as I

    ch, cw = crop
    x = torch.rand(b, 3, h, w, generator=gen).cuda()
    what = f"dct_patchify {(b, 3, h, w)} crop {crop}"
    dct = lambda: P.fused_ipt_dct_patchify_cuda(x, p, ch, cw)
    y = dct()
    torch.cuda.synchronize()
    y_plain = P.fused_ipt_dct_patchify_plain(x, p, ch, cw)
    hf = torch.zeros(ch, cw, dtype=torch.bool, device=x.device)
    hf[ch // 2 :, cw // 2 :] = True
    plane = _planes(y, ch, cw, p)
    y64 = _planes(P.fused_ipt_dct_patchify_plain(x, p, ch, cw, torch.float64), ch, cw, p)
    dct_row = _hold_to_plain_and_f64(what, plane, _planes(y_plain, ch, cw, p), y64, hf)
    del y64
    check(torch.equal(y, dct()), f"{what}: two launches on the same inputs differ")

    y_in = _planes(y_plain, ch, cw, p)
    what_i = f"idct_unpatchify {(b, 3, ch, cw)} -> {(h, w)}"
    hf_in = y_in * hf  # the high-frequency quarter alone: small pixel values
    idct = lambda: I.fused_idct_unpatchify_rgb_cuda(y_in, h, w)
    r = idct()
    r_hf = I.fused_idct_unpatchify_rgb_cuda(hf_in, h, w)
    torch.cuda.synchronize()
    everywhere = torch.ones((), dtype=torch.bool, device=x.device)
    plain = lambda y, dtype=torch.float32: I.fused_idct_unpatchify_rgb_plain(y, h, w, dtype)
    idct_row = _hold_to_plain_and_f64(what_i, r, plain(y_in), plain(y_in, torch.float64), everywhere)
    idct_row["high_frequency_input"] = _hold_to_plain_and_f64(
        f"{what_i}, high frequencies only", r_hf, plain(hf_in), plain(hf_in, torch.float64), everywhere)
    check(torch.equal(r, idct()), f"{what_i}: two launches on the same inputs differ")
    if (ch, cw) == (h, w):
        err = (I.fused_idct_unpatchify_rgb_cuda(plane, h, w) - x).abs().max().item()
        check(err < 1e-3, f"DCT kernel -> IDCT kernel does not give the image back: {err}")
        dct_row["roundtrip_max_abs_err"] = err
    del y, plane, r, r_hf

    def info(lib):
        return {f"pass{k}": P.kernel_info(lib, k) for k in (1, 2)}

    flops = b * 3 * (2 * ch * h * w + 2 * ch * w * cw)
    nbytes = 4 * (b * 3 * h * w + b * 3 * ch * cw + ch * h + cw * w)  # the images, the tokens, the two matrices
    rows = {
        "dct": {"shape": [b, 3, h, w], "crop": [ch, cw], "patch": p, "impl": "mma", "timed": timed, **dct_row,
                "library_ms": None, "library_computes": "none: no single PyTorch call computes IPT->DCT->crop->patchify",
                **_dct_bounds(b, flops, nbytes), "kernel_info": info("dct_patchify")},
        "idct": {"shape": [b, 3, ch, cw], "out": [h, w], "impl": "mma", "timed": timed, **idct_row,
                 "library_ms": None, "library_computes": "none: no single PyTorch call computes IDCT->RGB",
                 **_dct_bounds(b, b * 3 * (2 * h * ch * cw + 2 * h * cw * w), nbytes),
                 "kernel_info": info("idct_unpatchify")},
    }
    wrappers = {
        "dct": lambda: P.fused_ipt_dct_patchify(x, p, ch, cw),
        "idct": lambda: I.fused_idct_unpatchify_rgb(y_in, h, w),
    }
    plains = {
        "dct": lambda: P.fused_ipt_dct_patchify_plain(x, p, ch, cw),
        "idct": lambda: I.fused_idct_unpatchify_rgb_plain(y_in, h, w),
    }
    for name, kernel in (("dct", dct), ("idct", idct)):
        row = rows[name]
        if not timed:
            row.update(ms=None, wrapper_ms=None, plain_ms=None)
            continue
        row["ms"] = graph_ms(kernel)
        row["wrapper_ms"] = time_ms(wrappers[name], inner=TIMED_LAUNCHES)
        row["plain_ms"] = time_ms(plains[name])
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        if profile:
            # device time by kernel of one call: the DCT's IPT pre-pass and the two products
            row["profile"] = profile_device(kernel, reps=5, top=4)
    return rows


# (b, h, w, p, crop, timed): the serving batch first (the kernel table's row),
# one served request, reconstruct_direct's launch (5 to 8 images of one size in
# 8 slots), ragged edges at an area the TPU kernel refused, odd widths with
# ragged K slices
DCT_CASES = [
    (16, 448, 448, 14, (448, 448), True),
    (1, 448, 448, 14, (448, 448), True),
    (8, 448, 448, 14, (448, 448), True),
    (2, 1000, 700, 14, (994, 700), True),
    (3, 333, 447, 8, (320, 432), False),
    (1, 700, 1000, 14, (700, 994), False),  # IDCT planes 994 wide: 4-byte copies
]


def _dct_cases(gen):
    out = {"dct": [], "idct": []}
    for b, h, w, p, crop, timed in DCT_CASES:
        rows = _dct_case(b, h, w, p, crop, gen, timed, profile=(b, h, w) == (16, 448, 448))
        out["dct"].append(rows["dct"])
        out["idct"].append(rows["idct"])
        torch.cuda.empty_cache()
    return out


def kernels_only(argv) -> "str | None":
    """What `--kernels-only` asks for: None (every phase), "all" (stop after
    the kernels' phase) or "dct" (only its DCT and IDCT cases, then stop)."""
    for arg in argv:
        if arg == "--kernels-only":
            return "all"
        if arg.startswith("--kernels-only="):
            which = arg.split("=", 1)[1]
            if which not in ("all", "dct"):
                raise SystemExit(f"--kernels-only takes 'all' or 'dct', not {which!r}")
            return which
    return None


def phase_kernels(which: str = "all"):
    gen = torch.Generator().manual_seed(0)
    if which == "dct":
        cases = _dct_cases(gen)
        for name, rows in cases.items():
            for row in rows:
                emit({"phase": "kernel_vs_plain", "kernel": name, **row})
        return cases
    attn = [
        _attention_case(64, 16, 256, 64, torch.bfloat16, "block", gen),
        _attention_case(64, 16, 256, 64, torch.bfloat16, "bias", gen),
        _attention_case(64, 8, 256, 32, torch.bfloat16, "block", gen),
        _attention_case(1, 8, 173, 32, torch.bfloat16, "block", gen),
        _attention_case(3, 8, 173, 64, torch.float32, "bias", gen),
    ]
    bwd = [
        _attention_bwd_case(64, 16, 256, 64, torch.bfloat16, "block", gen),
        _attention_bwd_case(64, 16, 256, 64, torch.bfloat16, "bias", gen),
        _attention_bwd_case(64, 8, 256, 32, torch.bfloat16, "block", gen),
        _attention_bwd_case(1, 8, 173, 32, torch.float32, "block", gen),
        _attention_bwd_case(3, 8, 173, 64, torch.bfloat16, "bias", gen),  # a ragged end in the tensor-core kernels
    ]
    causal = [
        _attention_causal_case(8, 8, 1024, 64, torch.bfloat16, "block", gen),  # the AR train step's shape
        _attention_causal_case(8, 16, 1024, 64, torch.bfloat16, "block", gen),
        _attention_causal_case(2, 16, 3072, 64, torch.bfloat16, "block", gen),
        _attention_causal_case(8, 4, 128, 64, torch.float32, "block", gen),  # the AR example's shape
        _attention_causal_case(2, 8, 384, 32, torch.float32, "block", gen),
        _attention_causal_case(2, 8, 384, 32, torch.float32, "bias", gen),
        _attention_causal_case(1, 8, 173, 32, torch.float32, "block", gen),
        _attention_causal_case(1, 8, 173, 32, torch.bfloat16, "block", gen),  # ragged, causal, tensor cores
    ]
    for mode in ("block", "bias"):
        emit({"phase": "attention_bwd_fp32_determinism", **_attention_bwd_determinism(mode)})
    torch.cuda.empty_cache()
    cases = {
        "attention": attn,
        "attention_dq": [c["attention_dq"] for c in bwd],
        "attention_dkv": [c["attention_dkv"] for c in bwd],
        **{name: [c[name] for c in causal] for name in causal[0]},
        **_dct_cases(gen),
    }
    for name, rows in cases.items():
        for row in rows:
            emit({"phase": "kernel_vs_plain", "kernel": name, **row})
    return cases


# ---------------------------------------------------------------- phase 3


def smooth_images(n, size, seed):
    """Seeded smooth random RGB fields in [0, 1]: a few low-frequency waves per channel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    ims = []
    for _ in range(n):
        im = np.full((3, size, size), 0.5)
        for c in range(3):
            for _ in range(6):
                fy, fx = rng.uniform(-4, 4, size=2)
                im[c] += rng.uniform(0.03, 0.12) * np.cos(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        ims.append(np.clip(im, 0.0, 1.0).astype(np.float32))
    return ims


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def code_agreement(recs_a, recs_b) -> float:
    """Share of (token, codebook) codes equal between two record lists; a token
    present in only one of them counts as disagreeing."""
    same = total = 0
    for ra, rb in zip(recs_a, recs_b):
        ca = {(d["c"], d["h"], d["w"]): d["data"] for d in ra["codes"]}
        cb = {(d["c"], d["h"], d["w"]): d["data"] for d in rb["codes"]}
        n = len(next(iter(ca.values())))
        for key in ca.keys() | cb.keys():
            total += n
            if key in ca and key in cb:
                same += sum(x == y for x, y in zip(ca[key], cb[key]))
    return same / total


def _warm_roundtrip_s(pipes: dict, ims, reps: int = 3) -> dict:
    """Median wall seconds of one encode + decode of `ims` by each pipeline,
    once warm; the pipelines take turns."""
    def once(pipe):
        pipe.processor.rng = random.Random(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.decode(pipe.encode(ims))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for pipe in pipes.values():
        once(pipe)
    times = {name: [] for name in pipes}
    for _ in range(reps):
        for name, pipe in pipes.items():
            times[name].append(once(pipe))
    return {name: statistics.median(t) for name, t in times.items()}


def phase_serving():
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K

    ims = smooth_images(8, 448, seed=0)

    pipe = dt.DCTPipeline.from_pretrained(R3B)  # bf16 on the card; the gated int8 sibling, as in JAX
    check(pipe.model.device.type == "cuda", "pipeline did not land on the card")
    check(pipe.model.config.encoder_config.quantize_int8, "from_pretrained did not follow the int8 gate's record")
    pipe.processor.rng = random.Random(0)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    records = pipe.encode(ims)
    recon = pipe.decode(records)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = path_launches()
    check(all(launches[k] > 0 for k in SERVING_KERNELS), f"a kernel was not launched on the serving path: {launches}")
    check(launches["attention_dq"] == launches["attention_dkv"] == 0, f"serving ran a backward kernel: {launches}")
    check(len(recon) == len(ims) and all(r.shape == im.shape and np.isfinite(r).all() for r, im in zip(recon, ims)),
          "reconstructions have the wrong shape or are not finite")
    gpu_psnr = statistics.mean(psnr(r, im) for r, im in zip(recon, ims))

    cpu = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu")  # the same int8 sibling
    check(cpu.model.config.encoder_config.quantize_int8, "the CPU reference did not load the int8 sibling")
    cpu.processor.rng = random.Random(0)
    cpu_records = cpu.encode(ims)
    cpu_psnr = statistics.mean(psnr(r, im) for r, im in zip(cpu.decode(cpu_records), ims))
    agree = code_agreement(records, cpu_records)
    check(agree >= MIN_CODE_AGREEMENT, f"code agreement with the CPU fp32 run {agree} < {MIN_CODE_AGREEMENT}")
    check(abs(gpu_psnr - cpu_psnr) <= MAX_PSNR_DELTA_DB, f"PSNR {gpu_psnr} vs CPU fp32 {cpu_psnr}")
    # what serving the int8 sibling costs: the float model it was gated against, on the same batch
    float_pipe = dt.DCTPipeline.from_pretrained(R3B, prefer_int8="never")
    check(not float_pipe.model.config.encoder_config.quantize_int8, "prefer_int8='never' loaded the int8 sibling")
    warm_s = _warm_roundtrip_s({"int8": pipe, "float": float_pipe}, ims)
    del float_pipe
    emit({
        "phase": "serving_roundtrip_r3b", "images": len(ims), "size": 448, "dtype": "bfloat16",
        "weights": "int8 weight-only sibling (model-int8-wo), as from_pretrained's gate picks",
        "tokens": sum(len(r["codes"]) for r in records), "psnr_db": gpu_psnr, "cpu_fp32_psnr_db": cpu_psnr,
        "psnr_delta_db": gpu_psnr - cpu_psnr, "code_agreement_vs_cpu_fp32": agree,
        "launches": launches, "wall_s": wall_s, "warm_wall_s": warm_s,
    })

    # no model: beta 0 and the full 32 x 32 x 3 grid keep every token
    proc = dt.DCTPipeline.from_pretrained(R3B, sample_patches_beta=0.0).processor
    ds = proc.preprocess_many(ims)
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    out = []
    for batch in proc.iter_batches(iter([cols]), batch_size=None):
        out.extend(proc.postprocess(batch))
    lossless = min(psnr(o, im) for o, im in zip(out, ims))
    check(lossless > MIN_LOSSLESS_PSNR_DB, f"no-model round trip {lossless} dB <= {MIN_LOSSLESS_PSNR_DB}")
    emit({"phase": "no_model_roundtrip", "images": len(ims), "max_seq_len": proc.max_seq_len, "min_psnr_db": lossless})
    return launches


# ---------------------------------------------------------------- phase 4


def token_items(cfg, max_seq_len, rows, beta, rng, nprng):
    """Random tokens of images with TruncExp(beta) token counts, a little more than `rows` rows' worth."""
    items, total = [], 0
    while total < rows * max_seq_len * 1.05:
        k = min(max(1, round(-1.0 / beta * math.log(rng.random()))), max_seq_len)
        items.append((
            nprng.standard_normal((k, cfg.patch_dim)).astype(np.float32),
            nprng.integers(0, 32, size=(k, 2)).astype(np.int32),
            nprng.integers(0, 3, size=(k,)).astype(np.int32),
        ))
        total += k
    return items


def packed_batch(cfg, max_seq_len=256, rows=64, beta=0.02, seed=0, device="cuda"):
    """TruncExp(beta) token counts packed into `rows` rows by the port's packer."""
    from dct_autoencoder_torch.patches.packing import batch_groups, group_patches_by_max_seq_len

    items = token_items(cfg, max_seq_len, rows, beta, random.Random(seed), np.random.default_rng(seed))
    groups = group_patches_by_max_seq_len(items, max_seq_len).groups[:rows]
    n_images = sum(len(g) for g in groups)
    batch = batch_groups(
        groups, max_seq_len, patch_sizes=((32, 32),) * n_images, original_sizes=((448, 448),) * n_images,
        device=device,
    )
    return batch, n_images


def device_rows(prof) -> list:
    """The profiler's device events by name, without user annotations: an
    annotation such as "Optimizer.step#AdamW.step" spans kernels that are
    listed on their own, and counting it too would count them twice."""
    return [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]


def profile_device(forward, reps=3, top=12):
    """Device time by kernel over `reps` calls of forward() (torch.profiler), per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps) for e in device_rows(prof)]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    check(busy > 0, "the profiler saw no device time")
    as_dict = lambda r: {"kernel": r[0][:120], "ms_per_call": r[1], "launches_per_call": r[2]}
    return {
        "wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy,
        "device_idle_share": max(0.0, 1 - busy / wall_ms),
        "top_kernels": [as_dict(r) for r in rows[:top]],
        # the hand-written attention kernels, wherever they rank
        "attention_kernels": [as_dict(r) for r in rows if "attn_" in r[0]],
    }


def phase_full_width(profile: bool):
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K

    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    pipe = dt.DCTPipeline.from_config(cfg, seed=0)  # bf16, random init, on the card
    model = pipe.model
    batch, n_images = packed_batch(cfg)
    nb = model.normalize_(batch)
    check(tuple(nb.patches.shape) == (64, 256, cfg.patch_dim), f"batch shape {tuple(nb.patches.shape)}")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    out = model.forward(nb)
    torch.cuda.synchronize()
    launches = path_launches()
    attn_launches = launches["attention"]
    n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
    check(attn_launches == n_layers, f"{attn_launches} attention launches for {n_layers} layers")
    codes = out["codes"]
    valid = ~nb.key_pad_mask
    check(codes.shape == (64, 256, cfg.vq_num_codebooks), f"codes shape {tuple(codes.shape)}")
    check(bool(((codes >= 0) & (codes < cfg.vq_codebook_size)).all()), "codes out of range")
    check(bool(torch.isfinite(out["dct_patches"].patches[valid]).all()), "decoded patches not finite")

    ms = time_ms(lambda: model.forward(nb), reps=10)
    emit({
        "phase": "full_width_patch14l", "dtype": "bfloat16", "rows": 64, "seq_len": 256, "images": n_images,
        "ms_per_batch": ms, "images_per_s": n_images / ms * 1e3, "attention_launches_per_forward": attn_launches,
        "params": model.n_params,
    })
    if profile:
        emit({"phase": "profile_patch14l", **profile_device(lambda: model.forward(nb))})
    return launches


# ---------------------------------------------------------------- phase 5


def _columns(ds):
    return {k: [d[k] for d in ds] for k in ds[0]}


def phase_train_r3b(steps=20, learning_rate=3e-4):
    """train() on the trained checkpoint, one fixed packed batch; step 0 against the fp32 CPU step."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T

    model, proc = dt.get_model_and_processor(resume_path=R3B, dtype=torch.bfloat16)  # on the card
    check(model.device.type == "cuda", "the model did not land on the card")
    check(all(p.dtype == torch.float32 for p in model.module.parameters()), "master weights are not fp32")
    proc.rng = random.Random(0)
    cols = _columns(proc.preprocess_many(smooth_images(16, 448, seed=1)))
    n_layers = model.config.encoder_config.num_hidden_layers + model.config.decoder_config.num_hidden_layers

    logs = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    model, state = T.train(
        model, proc, iter([cols] * steps), batch_size=None, learning_rate=learning_rate, max_iters=steps,
        log_every=1, log=logs.append,
    )
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = path_launches()
    check(state.step == steps and len(logs) == steps, f"{state.step} steps, {len(logs)} log lines for {steps}")
    for name in ("attention", "attention_dq", "attention_dkv"):
        check(launches[name] == n_layers * steps, f"{launches[name]} {name} launches for {n_layers} layers x {steps} steps")
    loss_keys = ("loss", "rec_loss", "rec_loss_unnormalized", "commit_loss", "entropy_loss", "grad_norm", "perplexity")
    check(all(math.isfinite(m[k]) for m in logs for k in loss_keys), "a loss of the training run is not finite")
    check(logs[-1]["loss"] < logs[0]["loss"], f"loss did not fall: {logs[0]['loss']} -> {logs[-1]['loss']}")
    check(all(torch.isfinite(p).all().item() for p in model.module.parameters()), "a parameter is not finite")

    # the same batch through the port on the CPU in fp32: one step (its rate is 0, as on the card)
    cpu_model, cpu_proc = dt.get_model_and_processor(resume_path=R3B, dtype=torch.float32, device="cpu")
    tx = T.make_optimizer(learning_rate, steps)
    batch = next(cpu_proc.iter_batches(iter([cols]), batch_size=None))
    _, cpu = T.make_train_step(cpu_model.module, tx)(
        T.TrainState.create(cpu_model.module, tx), cpu_model.patchnorm, T.prepare_train_batch(batch)[0]
    )
    cpu = {k: float(v) for k, v in cpu.items()}
    loss_rel = abs(logs[0]["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(logs[0]["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    check(loss_rel <= MAX_TRAIN_LOSS_REL, f"step-0 loss {logs[0]['loss']} vs CPU fp32 {cpu['loss']}")
    check(norm_rel <= MAX_TRAIN_GRAD_NORM_REL, f"step-0 grad norm {logs[0]['grad_norm']} vs CPU fp32 {cpu['grad_norm']}")
    emit({
        "phase": "train_r3b", "steps": steps, "dtype": "bfloat16 compute, float32 masters",
        "images": len(cols["patches"]),
        "rows": int(batch.patches.shape[0]), "tokens": int((~batch.key_pad_mask).sum()),
        "learning_rate": learning_rate, "loss_first": logs[0]["loss"], "loss_last": logs[-1]["loss"],
        "step0": {k: logs[0][k] for k in loss_keys}, "step0_cpu_fp32": {k: cpu[k] for k in loss_keys},
        "step0_loss_rel_diff": loss_rel, "step0_grad_norm_rel_diff": norm_rel,
        "launches": launches, "wall_s": wall_s,
    })
    return launches


# ---------------------------------------------------------------- phase 6


def phase_train_full_width(profile: bool, train_steps=4, timed_steps=5):
    """patch14-L at random init: train() on 64 x 256 batches, then timed train steps on one batch."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T

    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
    rng, nprng = random.Random(1), np.random.default_rng(1)

    def pulls(rows, n):
        for _ in range(n):
            items = token_items(cfg, 256, rows, 0.02, rng, nprng)
            yield {
                "patches": [it[0] for it in items], "positions": [it[1] for it in items],
                "channels": [it[2] for it in items], "original_sizes": [(448, 448)] * len(items),
                "patch_sizes": [(32, 32)] * len(items),
            }

    result = None
    for rows in (64, 48, 32, 16):  # rows are cut if the batch does not fit; widths never
        model, proc = dt.get_model_and_processor(cfg, dtype=torch.bfloat16, sample_patches_beta=0.02, seed=0)
        check(proc.max_seq_len == 256, f"max_seq_len {proc.max_seq_len}")
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        try:
            model, state = T.train(
                model, proc, pulls(rows, train_steps + 1), batch_size=rows, max_iters=train_steps, log_every=1,
                log=logs.append,
            )
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            del model, proc
            torch.cuda.empty_cache()
            continue
        result = rows
        break
    check(result is not None, "the patch14-L train step fits at no row count down to 16")
    launches = path_launches()
    for name in ("attention", "attention_dq", "attention_dkv"):
        check(launches[name] == n_layers * train_steps, f"{launches[name]} {name} launches for {n_layers} layers x {train_steps} steps")
    check(len(logs) == train_steps and all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in logs),
          f"train() at full width: {logs}")
    check(all(torch.isfinite(p).all().item() for p in model.module.parameters()), "a parameter is not finite")

    # timed steps of make_train_step on one fixed batch, the moments carried on
    batch = next(proc.iter_batches(pulls(rows, 1), batch_size=rows))
    n_images = len(batch.original_sizes)
    check(tuple(batch.patches.shape) == (rows, 256, cfg.patch_dim), f"batch shape {tuple(batch.patches.shape)}")
    batch = T.prepare_train_batch(batch)[0]
    tx = T.make_optimizer(1e-4, 10000)
    step = T.make_train_step(model.module, tx)
    for _ in range(2):
        state, metrics = step(state, model.patchnorm, batch)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, metrics = step(state, model.patchnorm, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed_steps
    per_step = {k: v / timed_steps for k, v in K.launch_counts().items() if k.startswith("attention")}
    check(all(v == (0 if k.endswith("_causal") else n_layers) for k, v in per_step.items()),
          f"attention launches per step {per_step} for {n_layers} non-causal layers")
    check(math.isfinite(float(metrics["loss"])), "timed steps: loss not finite")
    emit({
        "phase": "train_full_width_patch14l", "dtype": "bfloat16 compute, float32 masters", "rows": rows,
        "seq_len": 256, "images": n_images, "train_steps": train_steps, "loss_first": logs[0]["loss"],
        "loss_last": logs[-1]["loss"], "ms_per_step": ms, "images_per_s": n_images / ms * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches_per_step": per_step,
        "launches_in_train": launches, "params": model.n_params,
    })
    if profile:
        emit({"phase": "profile_train_step_patch14l", **profile_device(lambda: step(state, model.patchnorm, batch), reps=2, top=24)})
    return launches


# ---------------------------------------------------------------- phase 7


def ar_33m_config():
    """The repo's 33.6 M-parameter AR decoder over the r3b tokenizer's code space (8 codebooks x 1024)."""
    from dct_autoencoder_torch.models.ar import ARConfig
    from dct_autoencoder_torch.models.config import TransformerConfig

    return ARConfig(
        codebook_size=1024, num_codebooks=8, image_channels=3, max_patch_h=32, max_patch_w=32,
        transformer=TransformerConfig(hidden_size=512, intermediate_size=2048, num_hidden_layers=8, num_attention_heads=8),
    )


def packed_ar_rows(cfg, rows, seq_len, seed, device):
    """Random codes and layouts in packed rows: several images a row (64-400 tokens each), a padded tail."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((rows, seq_len), np.int32)
    pad = np.ones((rows, seq_len), bool)
    n_images = 0
    for r in range(rows):
        at, image = 0, 0
        while True:
            n = int(rng.integers(64, 401))
            if at + n > seq_len:
                break
            ids[r, at : at + n] = image
            pad[r, at : at + n] = False
            at, image, n_images = at + n, image + 1, n_images + 1
    arrays = (
        rng.integers(0, cfg.codebook_size, (rows, seq_len, cfg.num_codebooks)).astype(np.int32),
        rng.integers(0, cfg.image_channels, (rows, seq_len)).astype(np.int32),
        np.stack([rng.integers(0, cfg.max_patch_h, (rows, seq_len)), rng.integers(0, cfg.max_patch_w, (rows, seq_len))], -1).astype(np.int32),
        pad, ids,
    )
    return [torch.from_numpy(a).to(device) for a in arrays], n_images


def cached_vs_kernel(model, codes, chans, poss):
    """Largest |decode_step logits - teacher-forced forward logits| along one forced sequence (1, s)."""
    from dct_autoencoder_torch.models.transformer import KVCache

    s = codes.shape[1]
    with torch.no_grad():
        full = model(codes, chans, poss, torch.zeros_like(chans, dtype=torch.bool), training=False)
        cache = KVCache(model.config.transformer, 1, s, model.dtype, model.device)
        worst = torch.zeros((), device=model.device)
        for t in range(s):
            prev = codes[:, t - 1 : t] if t else torch.zeros_like(codes[:, :1])
            step = model.decode_step(prev, chans[:, t : t + 1], poss[:, t : t + 1], torch.tensor(t, device=model.device), cache)
            worst = torch.maximum(worst, (step - full[:, t]).abs().max())
    return worst.item(), full.abs().max().item()


CAUSAL_KERNELS = ("attention_causal", "attention_dq_causal", "attention_dkv_causal")


def phase_ar_train_full_width(profile: bool, warmup_steps=3, timed_steps=10):
    """Teacher-forced train steps of the 33.6 M AR decoder on packed 8 x 1024 rows of random codes."""
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.models.ar import build_ar_model
    from dct_autoencoder_torch.tools.train_ar_example import ar_train_step, make_ar_optimizer

    cfg = ar_33m_config()
    rows, seq_len = 8, 1024
    n_layers = cfg.transformer.num_hidden_layers
    model = build_ar_model(cfg, dtype=torch.bfloat16, seed=0)  # on the card
    check(model.device.type == "cuda", "the AR model did not land on the card")
    check(all(p.dtype == torch.float32 for p in model.parameters()), "master weights are not fp32")
    n_params = sum(p.numel() for p in model.parameters())
    (codes, chans, poss, pad, ids), n_images = packed_ar_rows(cfg, rows, seq_len, seed=0, device=model.device)
    check(n_images > rows and bool(pad.any()), "rows are not packed with several images and padding")
    tokens = int((~pad).sum())
    tx = make_ar_optimizer(3e-4, 1000)
    adamw = tx.init(model)
    step = lambda i: ar_train_step(model, adamw, tx.schedule(i), codes, chans, poss, pad, image_ids=ids)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses = [float(step(i)) for i in range(warmup_steps)]
    launches = K.launch_counts()
    for name in CAUSAL_KERNELS:
        check(launches[name] == n_layers * warmup_steps, f"{launches[name]} {name} launches for {n_layers} layers x {warmup_steps} steps")
    check(abs(losses[0] - math.log(cfg.codebook_size)) <= MAX_AR_LOSS0_FROM_LN_Z,
          f"step-0 loss {losses[0]} is not near ln {cfg.codebook_size} = {math.log(cfg.codebook_size)}")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    timed = [step(warmup_steps + i) for i in range(timed_steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed_steps
    timed_launches = path_launches()
    per_step = {k: v / timed_steps for k, v in timed_launches.items() if k.startswith("attention")}
    check(all(per_step[k] == n_layers for k in CAUSAL_KERNELS), f"causal launches per step {per_step} for {n_layers} layers")
    check(all(v == 0 for k, v in per_step.items() if k not in CAUSAL_KERNELS), f"a non-causal kernel ran in the AR step: {per_step}")
    losses += [float(x) for x in timed]
    check(all(math.isfinite(x) for x in losses), f"an AR train loss is not finite: {losses}")
    check(all(torch.isfinite(p).all().item() for p in model.parameters()), "an AR parameter is not finite")
    emit({
        "phase": "ar_train_full_width", "dtype": "bfloat16 compute, float32 masters", "rows": rows, "seq_len": seq_len,
        "images": n_images, "tokens": tokens, "params": n_params, "loss_first": losses[0], "loss_last": losses[-1],
        "ln_codebook_size": math.log(cfg.codebook_size), "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches_per_step": per_step,
        "fwd_impl_launches": timed_launches["fwd_impl"], "bwd_impl_launches": timed_launches["bwd_impl"],
    })
    if profile:
        emit({"phase": "profile_ar_train_step", **profile_device(lambda: step(warmup_steps + timed_steps), reps=2, top=24)})

    # the KV-cached step against the kernel path in bf16, on one unpadded sequence of 256
    (c1, ch1, po1, _, _), _ = packed_ar_rows(cfg, 1, 256, seed=3, device=model.device)
    worst, scale = cached_vs_kernel(model, c1, ch1, po1)
    check(worst <= MAX_CACHED_VS_KERNEL_BF16, f"decode_step vs forward in bf16: max|diff| {worst} > {MAX_CACHED_VS_KERNEL_BF16}")
    emit({"phase": "ar_cached_vs_kernel_bf16", "seq_len": 256, "max_abs_diff": worst, "max_abs_logit": scale,
          "tol": MAX_CACHED_VS_KERNEL_BF16})
    return timed_launches, model


# ---------------------------------------------------------------- phase 8


def phase_ar_example_r3b(steps=200):
    """The AR example's loop on the card, on records the trained tokenizer makes from smooth 448 x 448 fields."""
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.models import ar as AR
    from dct_autoencoder_torch.tools import train_ar_example as EX

    pipe = dt.DCTPipeline.from_pretrained(R3B, sample_patches_beta=0.02)  # bf16 tokenizer on the card
    images = smooth_images(8, 448, seed=2)
    batch_size, max_len, seed = 8, 128, 0
    logs = []
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = EX.train_ar(pipe, images, steps=steps, batch_size=batch_size, max_len=max_len, out=out, seed=seed, log=logs.append)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = path_launches()
        check(sorted(os.listdir(out)) == ["ar_metrics.jsonl", "ar_model"], f"the example wrote {os.listdir(out)}")
        loaded = AR.load_ar_model(os.path.join(out, "ar_model"))  # on the card
    model, losses, records = result["model"], result["losses"], result["records"]
    n_layers = model.config.transformer.num_hidden_layers
    check(model.device.type == "cuda" and loaded.device.type == "cuda", "the AR model did not land on the card")
    for name in CAUSAL_KERNELS:
        check(launches[name] == n_layers * steps, f"{launches[name]} {name} launches for {n_layers} layers x {steps} steps")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), "a loss of the AR example is not finite")
    check(losses[-1] < losses[0], f"the AR loss did not fall: {losses[0]} -> {losses[-1]}")

    # step 0 again by the port in fp32 on the CPU: same records, same seeded init, same batch
    arrays = EX.records_to_arrays(records, max_len)
    idx = np.random.default_rng(seed).integers(0, arrays[0].shape[0], batch_size)
    cpu_model = AR.build_ar_model(model.config, dtype=torch.float32, device="cpu", seed=seed)
    codes, chans, poss, pad = (torch.from_numpy(a[idx]) for a in arrays)
    with torch.no_grad():
        cpu_loss = float(AR.ar_loss(cpu_model(codes, chans, poss, pad, training=True), codes, ~pad))
    loss_rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    check(loss_rel <= MAX_AR_STEP0_LOSS_REL, f"step-0 loss {losses[0]} vs CPU fp32 {cpu_loss}")

    dev = model.device
    codes, chans, poss, pad = (torch.from_numpy(a[:8]).to(dev) for a in arrays)
    with torch.no_grad():
        same = torch.equal(model(codes, chans, poss, pad, training=False), loaded(codes, chans, poss, pad, training=False))
    check(same, "save_ar_model -> load_ar_model changed the logits")

    # the KV-cached path against the kernel path, along the longest of these records (fp32)
    row = int((~pad).sum(dim=1).argmax())
    n = int((~pad[row]).sum())
    codes, chans, poss = codes[row : row + 1, :n], chans[row : row + 1, :n], poss[row : row + 1, :n]
    worst, scale = cached_vs_kernel(model, codes, chans, poss)
    check(worst <= MAX_CACHED_VS_KERNEL_FP32, f"decode_step vs forward in fp32: max|diff| {worst} > {MAX_CACHED_VS_KERNEL_FP32}")

    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    forced = AR.sample_codes_scan(model, chans, poss, gen(0), prefix_codes=codes, prefix_len=n)
    check(torch.equal(forced.long(), codes.long()), "sample_codes_scan with prefix_len = s did not return the prefix")
    scanned = AR.sample_codes_scan(model, chans, poss, gen(5))
    cached = AR.sample_codes_cached(model, chans, poss, gen(5))
    agree = (scanned == cached).float().mean().item()
    check(agree == 1.0, f"the captured sampler and the eager one disagree under one generator (fp32): {agree}")

    # timed steps at the example's shape, at learning rate 0 (the moments move, the weights do not)
    tx = EX.make_ar_optimizer(3e-4, steps)
    adamw = tx.init(model)
    batch = [torch.from_numpy(a[idx]).to(dev) for a in arrays]
    for _ in range(3):
        EX.ar_train_step(model, adamw, 0.0, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        EX.ar_train_step(model, adamw, 0.0, *batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 20

    img = result["image"]
    check(img.shape == (3, 448, 448) and np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1,
          f"the decoded sample is not a finite {(3, 448, 448)} image in [0, 1]")
    emit({
        "phase": "ar_example_r3b", "steps": steps, "dtype": "float32", "records": len(records), "batch": [batch_size, max_len],
        "params": sum(p.numel() for p in model.parameters()), "loss_first": losses[0], "loss_last": losses[-1],
        "step0_cpu_fp32_loss": cpu_loss, "step0_loss_rel_diff": loss_rel, "tol_step0": MAX_AR_STEP0_LOSS_REL,
        "cached_vs_kernel_max_abs_diff": worst, "max_abs_logit": scale, "tol_cached_vs_kernel": MAX_CACHED_VS_KERNEL_FP32,
        "forced_and_sampled_tokens": n, "captured_equals_eager": agree, "decoded_sample_tokens": len(result["sampled_record"]["codes"]),
        "ms_per_step": step_ms, "valid_tokens_per_step": int((~batch[3]).sum()), "sample_mean": float(img.mean()),
        "launches": launches, "wall_s": wall_s,
    })
    return launches, loaded


# ---------------------------------------------------------------- phase 9


def phase_ar_sampling(model, s=256):
    """tokens/s of the captured sampler beside the eager per-token loop, best of 3 after a warm-up call."""
    from dct_autoencoder_torch.models import ar as AR

    cfg, dev = model.config, model.device
    rng = np.random.default_rng(0)
    out = {"phase": "ar_sampling", "seq_len": s, "dtype": "bfloat16", "params": sum(p.numel() for p in model.parameters())}
    for b in (1, 8):
        chans = rng.integers(0, 3, (b, s)).astype(np.int32)
        poss = rng.integers(0, 32, (b, s, 2)).astype(np.int32)
        gens = lambda seed: [torch.Generator(device=dev).manual_seed(seed * 100 + i) for i in range(b)]
        if b == 1:
            captured = lambda seed: AR.sample_codes_scan(model, chans, poss, gens(seed)[0])
            eager = lambda seed: AR.sample_codes_cached(model, chans, poss, gens(seed)[0])
        else:
            captured = lambda seed: AR.sample_codes_scan_batched(model, chans, poss, None, generators=gens(seed))
            eager = AR.DecodeLoop(model, s, 1.0, b, capture=False)
            eager = lambda seed, loop=eager: loop.run(chans, poss, gens(seed))
        best = {}
        for name, fn in (("captured", captured), ("eager", eager)):
            codes = fn(0)  # warm-up: builds the loop, and captures its graph
            torch.cuda.synchronize()
            times = []
            for i in range(3):
                t0 = time.perf_counter()
                codes = fn(1 + i)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            check(codes.shape == (b, s, cfg.num_codebooks) and bool(((codes >= 0) & (codes < cfg.codebook_size)).all()),
                  f"{name} sampler, b = {b}: codes of the wrong shape or out of range")
            best[name] = b * s / min(times)
        runner = AR._scan_runner(model, s, 1.0, b)
        check(runner.graph is not None and runner.captures == 1, f"b = {b}: the runner was captured {runner.captures} times over 4 calls")
        out[f"b{b}"] = {
            "captured_tokens_per_s": best["captured"], "eager_tokens_per_s": best["eager"],
            "captured_over_eager": best["captured"] / best["eager"], "captures": runner.captures,
        }
    emit(out)


# ---------------------------------------------------------------- phase 10


def _timed(fn):
    """(result, wall seconds) of fn() on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _warm_wall_ms(fns: dict, reps: int = 3) -> dict:
    """Median wall ms of each fn() once warm; the fns take turns."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(_timed(fn)[1] * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def phase_reconstruct_direct_patch14l(n_images=16, size=448):
    """reconstruct_direct at the full width of patch14-L (random init, bf16)
    beside reconstruct (encode + decode of token records) on the same tokens,
    and on the int8 forms of the same model."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.models import quant as Q

    t_phase = time.perf_counter()
    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    pipe = dt.DCTPipeline.from_config(cfg, sample_patches_beta=0.02, seed=0)  # bf16, random init, on the card
    ims = smooth_images(n_images, size, seed=3)

    def call(p, fn, **kw):
        def run():
            p.processor.rng = random.Random(0)  # the same token budgets on every path
            return getattr(p, fn)(ims, **kw)
        return run

    runs = {}
    for name, fn, kw in (("reconstruct", "reconstruct", {}), ("direct_uint8", "reconstruct_direct", {"as_uint8": True}),
                         ("direct_float", "reconstruct_direct", {})):
        K.reset_launch_counts()
        out, wall = _timed(call(pipe, fn, **kw))
        runs[name] = (out, path_launches(), wall)
    recon, launches_rt, _ = runs["reconstruct"]
    direct, launches, _ = runs["direct_uint8"]
    check(len(direct) == n_images and all(d.dtype == np.uint8 and d.shape == (3, size, size) for d in direct),
          "reconstruct_direct(as_uint8=True) did not give uint8 images of the input size")
    check(all(np.isfinite(r).all() for r in recon), "reconstruct gave non-finite pixels")
    psnr_paths = statistics.mean(psnr(d.astype(np.float32) / 255.0, r) for d, r in zip(direct, recon))
    psnr_float = statistics.mean(psnr(d, r) for d, r in zip(runs["direct_float"][0], recon))
    check(psnr_paths > MIN_DIRECT_VS_ROUNDTRIP_PSNR_DB,
          f"reconstruct_direct (uint8) vs reconstruct: {psnr_paths} dB <= {MIN_DIRECT_VS_ROUNDTRIP_PSNR_DB}")
    check(launches["idct_unpatchify"] == 1 and launches_rt["idct_unpatchify"] == n_images,
          f"IDCT launches: {launches['idct_unpatchify']} for reconstruct_direct (want 1), "
          f"{launches_rt['idct_unpatchify']} for reconstruct (want {n_images})")
    n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
    check(launches["dct_patchify"] == 1 and launches["attention"] == n_layers, f"reconstruct_direct launches {launches}")
    check(launches["attention_dq"] == launches["attention_dkv"] == 0, f"reconstruct_direct ran a backward kernel: {launches}")

    forms = {"float": pipe}
    quantize_s = {}
    for mode, bf16 in (("weight_only", ()), ("dynamic", (0, 1))):
        q, quantize_s[mode] = _timed(lambda: Q.quantize_model_for_serving(
            pipe.model, mode=mode, encoder_bf16_layers=bf16, decoder_bf16_layers=bf16))
        forms[mode] = dt.DCTPipeline(q, pipe.processor)
    dynamic_layers = [m for m in forms["dynamic"].model.module.modules() if isinstance(m, Q.Int8Dense)]
    check(len(dynamic_layers) == 2 * 6 * (8 - 2) and all(m.mode == "dynamic" for m in dynamic_layers),
          f"{len(dynamic_layers)} dynamic int8 layers, not 72")
    before = Q.INT_MM_CALLS
    dyn_out, _ = _timed(call(forms["dynamic"], "reconstruct_direct", as_uint8=True))
    int_mm = Q.INT_MM_CALLS - before
    # every dynamic layer ran its int8 product once for the one packed batch: none fell back
    check(int_mm == len(dynamic_layers), f"{int_mm} torch._int_mm calls for {len(dynamic_layers)} dynamic int8 layers")
    wo_out, _ = _timed(call(forms["weight_only"], "reconstruct_direct", as_uint8=True))
    as_float = lambda imgs: [d.astype(np.float32) / 255.0 for d in imgs]
    # where a call's time goes: device busy time by kernel against the wall
    profiles = {name: profile_device(fn, reps=3, top=6) for name, fn in (
        ("reconstruct_direct", call(pipe, "reconstruct_direct", as_uint8=True)), ("reconstruct", call(pipe, "reconstruct")))}
    wall_ms = _warm_wall_ms({
        "reconstruct": call(pipe, "reconstruct"),
        "reconstruct_direct": call(pipe, "reconstruct_direct", as_uint8=True),
        "reconstruct_direct_int8_weight_only": call(forms["weight_only"], "reconstruct_direct", as_uint8=True),
        "reconstruct_direct_int8_dynamic": call(forms["dynamic"], "reconstruct_direct", as_uint8=True),
    })
    emit({
        "phase": "reconstruct_direct_patch14l", "images": n_images, "size": size, "dtype": "bfloat16",
        "sample_patches_beta": 0.02,
        "psnr_direct_uint8_vs_reconstruct_db": psnr_paths, "psnr_direct_float_vs_reconstruct_db": psnr_float,
        "tol_psnr_db": MIN_DIRECT_VS_ROUNDTRIP_PSNR_DB,
        "idct_launches": {"reconstruct": launches_rt["idct_unpatchify"], "reconstruct_direct": launches["idct_unpatchify"]},
        "launches": launches, "launches_reconstruct": launches_rt, "wall_ms": wall_ms,
        "int8_dynamic": {"layers": len(dynamic_layers), "bf16_layers": [0, 1], "int_mm_calls_per_call": int_mm,
                         "psnr_vs_float_direct_db": statistics.mean(psnr(a, b) for a, b in zip(as_float(dyn_out), as_float(direct)))},
        "int8_weight_only": {"psnr_vs_float_direct_db": statistics.mean(psnr(a, b) for a, b in zip(as_float(wo_out), as_float(direct)))},
        "quantize_s": quantize_s, "profile": profiles, "phase_s": time.perf_counter() - t_phase,
    })
    return launches


def phase_quantize_gate_r3b(n_images=6):
    """The port's quantize_checkpoint --gate --gate_mode relative --mode
    weight_only on a copy of the r3b checkpoint (never on docs/), with seeded
    .npy validation images."""
    import shutil
    import tempfile

    from dct_autoencoder_torch.tools import quantize_checkpoint as QC

    t_phase = time.perf_counter()
    with open(os.path.join(R3B, "int8_serving.json")) as f:
        jax_record = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        src, out, imgs = (os.path.join(tmp, d) for d in ("model", "model-int8-wo", "images"))
        shutil.copytree(R3B, src)
        os.makedirs(imgs)
        for i, im in enumerate(smooth_images(n_images, 448, seed=4)):
            np.save(os.path.join(imgs, f"{i}.npy"), im)
        record = QC.cli([
            "--model_path", src, "--out_path", out, "--validate_images", imgs,
            "--gate", "--gate_mode", "relative", "--mode", "weight_only",
        ])
        with open(os.path.join(src, "int8_serving.json")) as f:
            check(json.load(f) == record, "int8_serving.json is not the gate's record")
        check(os.path.isfile(os.path.join(out, "params.npz")) and os.path.isfile(os.path.join(out, "int8_gate.json")),
              "the gate wrote no int8 model or no int8_gate.json")
    keys = {"agreement", "gate_mode", "int8_flips_per_10k", "noise_floor_flips_per_10k", "flip_ratio", "psnr_delta", "pass"}
    check(keys <= set(record) and record["n_validation_images"] == n_images, f"gate record keys {sorted(record)}")
    emit({
        "phase": "quantize_gate_r3b", "images": f"{n_images} seeded smooth fields, 448 x 448, .npy",
        "record": {k: v for k, v in record.items() if k not in ("source_model", "int8_model")},
        "jax_tpu_record_other_images": {k: jax_record.get(k) for k in ("flip_ratio", "psnr_delta", "pass", "n_validation_images")},
        "phase_s": time.perf_counter() - t_phase,
    })


def _post(port, path, body, headers):
    """(status, body) of one POST to the daemon on 127.0.0.1."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _healthz(port) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
        return json.loads(r.read())


class _Daemon:
    """The port's serve() on 127.0.0.1, port 0, in a thread; stopped and joined on exit."""

    def __init__(self, pipe, max_batch, ar_model=None):
        import threading

        from dct_autoencoder_torch.tools import serve as S

        self.httpd = S.serve(pipe, port=0, max_batch=max_batch, batch_timeout_ms=5.0 if max_batch > 1 else 0.0,
                             ar_model=ar_model, host="127.0.0.1")
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.batcher.shutdown()
        self.thread.join(timeout=10)
        check(not self.thread.is_alive() and not self.httpd.batcher._worker.is_alive(), "the daemon did not shut down")


def phase_serving_daemon_r3b(ar_model, n_requests=64):
    """The port's daemon with from_pretrained(R3B) (the gated int8 sibling),
    pad_rows_to 8 and pad_tokens_to 128: binary /reconstruct from the ported
    load client at concurrency 1 and 8 under max_batch 16 and 1, JSON
    /encode + /decode, /generate over the AR example's model, and a served
    /reconstruct held bit for bit to the in-process call."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.models.factory import get_max_seq_length
    from dct_autoencoder_torch.tools.bench_serving import fire, npy_bytes

    t_phase = time.perf_counter()
    base = dt.DCTPipeline.from_pretrained(R3B)  # bf16 on the card, the gated int8 sibling
    check(base.model.config.encoder_config.quantize_int8, "from_pretrained did not follow the int8 gate's record")
    pipe = dt.DCTPipeline(base.model, base.processor, pad_rows_to=8, pad_tokens_to=128)
    ims = smooth_images(4, 448, seed=5)
    as_u8 = lambda im: (im * 255.0 + 0.5).astype(np.uint8)
    bin_hdr, json_hdr = {"Content-Type": "application/octet-stream"}, {"Content-Type": "application/json"}
    body = npy_bytes(as_u8(ims[0]))

    # one request's work in this process, without HTTP: its wall time and the device's share of it
    direct = lambda: pipe.reconstruct_direct([ims[0]], as_uint8=True)
    in_process_ms = _warm_wall_ms({"reconstruct_direct_1_image": direct}, reps=5)
    in_process_profile = profile_device(direct, reps=5, top=6)

    torch.cuda.synchronize()
    K.reset_launch_counts()
    load, per_batch_idct, generated = {}, None, []
    for max_batch in (16, 1):
        with _Daemon(pipe, max_batch, ar_model) as d:
            fire(d.port, body, bin_hdr, 16, 8)  # warm-up
            for conc in (1, 8):
                h0, idct0 = _healthz(d.port), K.launch_counts()["idct_unpatchify"]
                r = fire(d.port, body, bin_hdr, n_requests, conc)
                h1 = _healthz(d.port)
                batches, served = h1["batches"] - h0["batches"], h1["served"] - h0["served"]
                check(r["requests"] == served == n_requests, f"{r['requests']} answered, {served} served of {n_requests}")
                load[f"max_batch_{max_batch}_concurrency_{conc}"] = {**r, "batches": batches}
                if (max_batch, conc) == (16, 8):
                    check(batches < served, f"no micro-batching at concurrency 8: {batches} batches for {served}")
                    per_batch_idct = (K.launch_counts()["idct_unpatchify"] - idct0) / batches
            if max_batch == 16:
                for im in ims:
                    status, raw = _post(d.port, "/encode", json.dumps({"image": im.tolist()}).encode(), json_hdr)
                    check(status == 200, f"/encode answered {status}: {raw[:200]}")
                    status, raw = _post(d.port, "/decode", raw, json_hdr)
                    check(status == 200, f"/decode answered {status}: {raw[:200]}")
                    check(np.asarray(json.loads(raw)["image"]).shape == im.shape, "/decode gave the wrong shape")
                for temperature, seed in ((0.0, 0), (0.0, 1), (1.0, 2), (1.0, 3)):
                    t0 = time.perf_counter()
                    status, raw = _post(d.port, "/generate", json.dumps(
                        {"n_tokens": 256, "temperature": temperature, "seed": seed, "return_codes": True}).encode(), json_hdr)
                    check(status == 200, f"/generate answered {status}: {raw[:200]}")
                    out = json.loads(raw)
                    img = np.asarray(out["image"])
                    check(img.ndim == 3 and img.shape[0] == 3 and np.isfinite(img).all(), "/generate gave no finite image")
                    check(len(out["record"]["codes"]) == 256, "/generate did not sample 256 tokens")
                    generated.append({"temperature": temperature, "wall_ms": (time.perf_counter() - t0) * 1e3})
    torch.cuda.synchronize()
    launches = path_launches()
    check(all(launches[k] > 0 for k in SERVING_KERNELS), f"a kernel was not launched by the daemon: {launches}")
    check(all(launches[k] == 0 for k in BWD_KERNELS), f"the daemon ran a backward kernel: {launches}")

    # at a budget of every token, a served /reconstruct is the in-process call, bit for bit
    cfg = base.model.config
    proc0 = dt.DCTAutoencoderFeatureExtractor(
        channels=cfg.image_channels, patch_size=cfg.patch_size, sample_patches_beta=0.0, max_patch_h=cfg.max_patch_h,
        max_patch_w=cfg.max_patch_w, max_seq_len=get_max_seq_length(cfg, 0.0),
    )
    pipe0 = dt.DCTPipeline(base.model, proc0, pad_rows_to=8, pad_tokens_to=128)
    with _Daemon(pipe0, 16) as d:
        status, raw = _post(d.port, "/reconstruct", npy_bytes(as_u8(ims[1])), bin_hdr)
    check(status == 200, f"/reconstruct answered {status}")
    served = np.load(io.BytesIO(raw))
    local = pipe0.reconstruct_direct([as_u8(ims[1]).astype(np.float32) / 255.0], as_uint8=True)[0]
    check(served.dtype == np.uint8 and np.array_equal(served, local), "a served /reconstruct differs from reconstruct_direct")
    emit({
        "phase": "serving_daemon_r3b", "weights": "int8 weight-only sibling (model-int8-wo)", "pad_rows_to": 8,
        "pad_tokens_to": 128, "image": [3, 448, 448], "codec": "npy uint8", "requests_per_config": n_requests,
        "load": load, "idct_launches_per_batch_max_batch_16_concurrency_8": per_batch_idct,
        "in_process_ms": in_process_ms, "in_process_profile": in_process_profile,
        "generate": generated, "served_equals_in_process_at_beta_0": True, "launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    })
    return launches


# ---------------------------------------------------------------- phase 11


def phase_opt8bit_card_vs_cpu(updates=3, timed=5):
    """AdamW8bit over patch14-L's parameters at random init: 3 updates from
    synthetic gradients on the card and on the CPU (same codes and absmax, bit
    for bit; parameters within 1e-6), then ms an update beside fp32 AdamW."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.train.opt8bit import AdamW8bit, opt_state_bytes

    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    cpus = list(dt.DCTAutoencoder(cfg, device="cpu", seed=0).module.parameters())
    cards = [torch.nn.Parameter(p.detach().to("cuda")) for p in cpus]
    n_params = sum(p.numel() for p in cards)
    opt_card, opt_cpu = AdamW8bit(cards, lr=1e-4), AdamW8bit(cpus, lr=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cpu_s = []
    for _ in range(updates):
        for pc, pg in zip(cpus, cards):
            pg.grad = torch.randn(pg.shape, device="cuda", generator=gen) * 1e-3
            pc.grad = pg.grad.cpu()
        opt_card.step()
        t0 = time.perf_counter()
        opt_cpu.step()
        cpu_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    codes_equal = all(
        torch.equal(opt_card.state[pg][k].cpu(), opt_cpu.state[pc][k])
        for pg, pc in zip(cards, cpus) for k in ("mu_codes", "nu_codes", "mu_absmax", "nu_absmax")
    )
    param_err = max((pg.detach().cpu() - pc.detach()).abs().max().item() for pg, pc in zip(cards, cpus))
    check(codes_equal, "8-bit codes or absmax differ between the card and the CPU")
    check(param_err <= 1e-6, f"parameters after {updates} updates differ by {param_err} between the card and the CPU")
    del opt_cpu, cpus

    ms_8bit = time_ms(opt_card.step, reps=timed)
    bytes_8bit = opt_state_bytes(opt_card)
    del opt_card
    fp32 = torch.optim.AdamW(cards, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.1)  # the default foreach
    ms_fp32 = time_ms(fp32.step, reps=timed)
    bytes_fp32 = opt_state_bytes(fp32)
    check(bytes_8bit < bytes_fp32 / 3.5 and bytes_8bit / n_params < 2.5,
          f"8-bit state {bytes_8bit} B against fp32 {bytes_fp32} B for {n_params} parameters")
    emit({
        "phase": "opt8bit_card_vs_cpu", "params": n_params, "tensors": len(cards), "updates": updates,
        "codes_and_absmax_equal": codes_equal, "max_param_diff": param_err,
        "ms_per_update_8bit": ms_8bit, "ms_per_update_fp32_adamw_foreach": ms_fp32,
        "cpu_s_per_update_8bit": statistics.median(cpu_s),
        "state_bytes_8bit": bytes_8bit, "state_bytes_fp32": bytes_fp32,
        "state_bytes_per_param_8bit": bytes_8bit / n_params, "state_ratio_fp32_over_8bit": bytes_fp32 / bytes_8bit,
    })
    del fp32, cards
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 12


def phase_train_pixel_r3b(steps=4, learning_rate=3e-4, n_images=16):
    """train() on the trained checkpoint with the pixel loss and 8-bit moments
    (16 x 448^2, one fixed batch); step 0 against the fp32 CPU step with the
    same flags, and accumulation 2 against it too."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T

    flags = dict(use_pixel_loss=True, pixel_loss_max_images=n_images, opt_8bit=True)
    model, proc = dt.get_model_and_processor(resume_path=R3B, dtype=torch.bfloat16)
    proc.rng = random.Random(0)
    cols = _columns(proc.preprocess_many(smooth_images(n_images, 448, seed=2)))
    n_layers = model.config.encoder_config.num_hidden_layers + model.config.decoder_config.num_hidden_layers

    logs = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    model, state = T.train(model, proc, iter([cols] * steps), batch_size=None, learning_rate=learning_rate,
                           max_iters=steps, log_every=1, log=logs.append, **flags)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = path_launches()
    check(state.step == steps and len(logs) == steps, f"{state.step} steps, {len(logs)} log lines for {steps}")
    check(isinstance(state.adamw, T.AdamW8bit), "train(opt_8bit=True) did not build AdamW8bit")
    for name in ("attention", "attention_dq", "attention_dkv"):
        check(launches[name] == n_layers * steps, f"{launches[name]} {name} launches for {n_layers} layers x {steps} steps")
    keys = ("loss", "pixel_loss", "rec_loss", "rec_loss_unnormalized", "commit_loss", "entropy_loss", "grad_norm")
    check(all(math.isfinite(m[k]) for m in logs for k in keys), f"a loss of the pixel-loss run is not finite: {logs}")

    cpu_model, cpu_proc = dt.get_model_and_processor(resume_path=R3B, dtype=torch.float32, device="cpu")
    tx = T.make_optimizer(learning_rate, steps, opt_8bit=True)
    batch = next(cpu_proc.iter_batches(iter([cols]), batch_size=None))
    batch, grid_sizes = T.prepare_train_batch(batch, n_images, (model.config.max_patch_h, model.config.max_patch_w))
    _, cpu = T.make_train_step(cpu_model.module, tx, use_pixel_loss=True)(
        T.TrainState.create(cpu_model.module, tx), cpu_model.patchnorm, batch, grid_sizes
    )
    cpu = {k: float(v) for k, v in cpu.items()}

    accum_logs = []
    model2, proc2 = dt.get_model_and_processor(resume_path=R3B, dtype=torch.bfloat16)
    T.train(model2, proc2, iter([cols]), batch_size=None, learning_rate=learning_rate, max_iters=1,
            grad_accumulation_steps=2, log_every=1, log=accum_logs.append, **flags)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    loss_rel, norm_rel = rel(logs[0]["loss"], cpu["loss"]), rel(logs[0]["grad_norm"], cpu["grad_norm"])
    accum_rel = rel(accum_logs[0]["loss"], cpu["loss"])
    check(loss_rel <= MAX_TRAIN_LOSS_REL, f"step-0 loss {logs[0]['loss']} vs CPU fp32 {cpu['loss']}")
    check(norm_rel <= MAX_TRAIN_GRAD_NORM_REL, f"step-0 grad norm {logs[0]['grad_norm']} vs CPU fp32 {cpu['grad_norm']}")
    check(accum_rel <= MAX_TRAIN_LOSS_REL, f"accumulation 2: step-0 loss {accum_logs[0]['loss']} vs CPU fp32 {cpu['loss']}")
    emit({
        "phase": "train_pixel_r3b", "steps": steps, "dtype": "bfloat16 compute, float32 masters",
        "flags": flags, "images": n_images, "rows": int(batch.patches.shape[0]),
        "tokens": int((~batch.key_pad_mask).sum()), "learning_rate": learning_rate,
        "step0": {k: logs[0][k] for k in keys}, "step0_cpu_fp32": {k: cpu[k] for k in keys},
        "step0_accum2": {k: accum_logs[0][k] for k in keys},
        "step0_loss_rel_diff": loss_rel, "step0_grad_norm_rel_diff": norm_rel, "step0_accum2_loss_rel_diff": accum_rel,
        "loss_last": logs[-1]["loss"], "launches": launches, "wall_s": wall_s,
    })
    del model2, proc2
    return launches


# ---------------------------------------------------------------- phase 13


# raw-image sizes (h, w) of the CLI phase's shards: 336 to 768 px, mostly
# small (the host decodes and augments one image at a time: ~33 ms an image
# on an H100 machine's host when 5 of these 14 sizes were 640 px or more), a
# few distinct preprocess shapes; one over the 768 cap and one under the
# resolution floor (12 x 14 px) too
CLI_IMAGE_SIZES = [(336, 336), (448, 448), (336, 448), (448, 336), (384, 384), (336, 336), (384, 512), (336, 336),
                   (448, 448), (512, 384), (768, 576), (336, 384), (900, 600), (128, 128)]


def write_image_shards(folder, n, seed=0):
    """Tar shards of n PNG images (smooth fields, bicubic from a random 6 x 6
    grid) with json sizes, through the port's ShardWriter."""
    from PIL import Image

    from dct_autoencoder_torch.data.shards import ShardWriter

    rng = np.random.default_rng(seed)
    with ShardWriter(os.path.join(folder, "%06d.tar"), maxsize=16e6) as w:
        for i in range(n):
            h, wd = CLI_IMAGE_SIZES[i % len(CLI_IMAGE_SIZES)]
            seed_im = Image.fromarray(rng.integers(40, 216, size=(6, 6, 3), dtype=np.uint8))
            buf = io.BytesIO()
            seed_im.resize((wd, h), Image.BICUBIC).save(buf, format="PNG", compress_level=1)
            w.write({"__key__": f"{i:08d}", "png": buf.getvalue(), "json": {"height": h, "width": wd}})


class StepClock:
    """Wraps train/loop.py's make_train_step while a CLI run trains: the end
    time of every step (after a synchronize), the last state, and a
    torch.profiler window from the end of step `window[0] - 1` to the end of
    step `window[1] - 1`."""

    def __init__(self, window):
        self.window = window
        self.ends, self.state, self.prof, self.prof_running = [], None, None, False

    def __enter__(self):
        from dct_autoencoder_torch.train import loop

        self.loop, self.orig = loop, loop.make_train_step
        loop.make_train_step = self._make
        return self

    def __exit__(self, *exc):
        self.loop.make_train_step = self.orig
        if self.prof_running:
            self.prof.stop()

    def _make(self, *args, **kwargs):
        from torch.profiler import ProfilerActivity, profile

        step = self.orig(*args, **kwargs)

        def timed(state, *rest):
            out = step(state, *rest)
            torch.cuda.synchronize()
            self.ends.append(time.perf_counter())
            self.state = out[0]
            done = len(self.ends)
            if done == self.window[0]:
                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.start()
                self.prof_running = True
            elif done == self.window[1]:
                self.prof.stop()
                self.prof_running = False
            return out

        return timed

    def busy(self) -> dict:
        """Device time in the window over its wall time."""
        wall_ms = (self.ends[self.window[1] - 1] - self.ends[self.window[0] - 1]) * 1e3
        rows = device_rows(self.prof)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        check(busy_ms > 0, "the profiler saw no device time in the CLI run")
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
        return {
            "window_steps": list(range(*self.window)), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "top_kernels": [{"kernel": e.key[:100], "ms": e.self_device_time_total / 1e3, "launches": e.count}
                            for e in top],
        }


def _run_cli(flags, window):
    """cli.main with the CLI's output captured (printed to stderr if it fails)."""
    import contextlib

    from dct_autoencoder_torch.train import cli

    out = io.StringIO()
    with StepClock(window) as clock:
        try:
            with contextlib.redirect_stdout(out):
                model = cli.main(**flags)
        except BaseException:
            print(out.getvalue()[-6000:], file=sys.stderr)
            raise
    return model, clock, out.getvalue()


def phase_train_cli_patch14l(rows=64, steps=8, n_unique_images=96):
    """The CLI (train/cli.py main) at patch14-L width on PNG shards: 8-bit
    moments, the pixel loss, prefetch, augmentation, image grids, checkpoints;
    then the same flags with prefetch 0 for the device-busy share."""
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.models.factory import get_max_seq_length
    from dct_autoencoder_torch.train.opt8bit import opt_state_bytes

    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="train_cli_")
    try:
        t0 = time.perf_counter()
        write_image_shards(os.path.join(tmp, "raw"), n_unique_images)
        shard_s = time.perf_counter() - t0
        base = dict(
            image_dataset_path_or_url=os.path.join(tmp, "raw", "*.tar"), model_config_path=PATCH14_L, dtype="bfloat16",
            epochs=1000, sample_patches_beta=0.02, train_norm_iters=2, learning_rate=1e-4, seed=42, log_every=1,
            opt_8bit=True, use_pixel_loss=True, pixel_loss_max_images=64, augment=True, log_images_every=4,
            save_every=4, keep_checkpoints=True, stall_timeout_s=600.0,
        )
        window = (1, 5)  # steps 1..4: after step 0's warm-up, before the checkpoint that follows step 4
        result = None
        for rows_try in (rows, 48, 32):  # rows are cut only if the batch does not fit; widths never
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                model, clock, text = _run_cli(
                    dict(base, batch_size=rows_try, max_iters=steps, prefetch_batches=2,
                         out_base=os.path.join(tmp, f"out{rows_try}")), window)
            except torch.cuda.OutOfMemoryError:
                continue
            result = rows_try
            break
        check(result is not None, "the CLI's patch14-L step fits at no row count down to 32")
        rows = result
        wall_s = time.perf_counter() - t0
        launches = path_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        (out_dir,) = [os.path.join(tmp, f"out{rows}", d) for d in os.listdir(os.path.join(tmp, f"out{rows}"))]
        lines = [json.loads(x) for x in open(os.path.join(out_dir, "metrics.jsonl"))]
        step_lines = [d for d in lines if "loss" in d]
        grid_lines = [d for d in lines if "pixel_loss" in d and "loss" not in d]
        n_grids = len(grid_lines)
        check([d["step"] for d in step_lines] == list(range(steps)), f"logged steps {[d['step'] for d in step_lines]}")
        check(all(math.isfinite(d[k]) for d in step_lines for k in ("loss", "pixel_loss", "grad_norm")),
              "a logged loss of the CLI run is not finite")
        check(n_grids == len(range(0, steps, 4)) and all(math.isfinite(d["pixel_loss"]) for d in grid_lines),
              f"image-grid metrics {grid_lines}")
        names = set(os.listdir(out_dir))
        check({"train_image_000000.png", "train_image_000004.png", "ckpt_000004", "model", "train_state.pt"} <= names,
              f"the CLI's output directory holds {sorted(names)}")
        check(launches["dct_patchify"] > 0, "the data path launched no DCT kernel")
        check(launches["idct_unpatchify"] > 0, "the image grids launched no IDCT kernel")
        for name in ("attention_dq", "attention_dkv"):
            check(launches[name] == n_layers * steps, f"{launches[name]} {name} launches for {n_layers} x {steps} steps")
        # the grids' forwards run the attention forward too
        check(launches["attention"] == n_layers * (steps + n_grids),
              f"{launches['attention']} attention launches for {n_layers} x ({steps} steps + {n_grids} grids)")
        state_bytes = opt_state_bytes(clock.state.adamw)
        ends = clock.ends
        check(len(ends) == steps, f"{len(ends)} timed steps")
        intervals = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]  # interval k-1: the end of step k-1 to that of k
        timed = intervals[1:]  # steps 2..7
        images = [d["images_per_batch"] for d in step_lines]
        busy = clock.busy()
        del model, clock

        served = dt.DCTPipeline.from_pretrained(os.path.join(out_dir, "model"))  # the trained checkpoint, on the card
        check(served.model.device.type == "cuda", "the trained checkpoint did not load on the card")
        recs = served.encode(smooth_images(2, 448, seed=4))
        check(len(recs) == 2 and all(len(r["codes"]) > 0 for r in recs), "the trained checkpoint encoded nothing")
        del served

        torch.cuda.empty_cache()
        # the same flags but prefetch; no periodic checkpoint (it would come after the window)
        _, clock0, _ = _run_cli(dict(base, batch_size=rows, max_iters=window[1], prefetch_batches=0, save_every=0,
                                     keep_checkpoints=False, out_base=os.path.join(tmp, "out_prefetch0")), window)
        busy0 = clock0.busy()
        intervals0 = [(b - a) * 1e3 for a, b in zip(clock0.ends, clock0.ends[1:])]
        del clock0
        emit({
            "phase": "train_cli_patch14l", "dtype": "bfloat16 compute, float32 masters", "rows": rows,
            "max_seq_len": get_max_seq_length(cfg, base["sample_patches_beta"]), "steps": steps, "flags": {k: v for k, v in base.items() if k not in (
                "image_dataset_path_or_url", "model_config_path")},
            "unique_images": n_unique_images, "image_sizes": CLI_IMAGE_SIZES, "shard_write_s": shard_s,
            "images_per_step": images, "loss": [d["loss"] for d in step_lines],
            "pixel_loss": [d["pixel_loss"] for d in step_lines], "grid_pixel_mse": [d["pixel_loss"] for d in grid_lines],
            "step_interval_ms": intervals, "ms_per_step_median_steps_2_7": statistics.median(timed),
            "ms_per_step_mean_steps_2_7": statistics.mean(timed),
            "images_per_s_steps_2_7": sum(images[2:]) / (ends[-1] - ends[1]),
            "peak_memory_gb": peak_gb, "optimizer_state_bytes": state_bytes, "wall_s": wall_s,
            "prefetch2": busy, "prefetch0": dict(busy0, step_interval_ms=intervals0),
            "launches": launches,
        })
        return launches
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- main


# (cases key, name, source, TPU kernel, launch counter, the main path its count is read from;
# every path's count is in launches_by_path, and the training CLI phase checks all five kernels itself)
KERNEL_TABLE = [
    ("attention", "packed_attention_fwd", "dct_autoencoder_torch/csrc/attention_fwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:91", "attention", "serving_daemon"),
    ("attention_dq", "packed_attention_bwd_dq", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:194", "attention_dq", "train_patch14l"),
    ("attention_dkv", "packed_attention_bwd_dkv", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:236", "attention_dkv", "train_patch14l"),
    ("attention_causal", "packed_attention_fwd_causal", "dct_autoencoder_torch/csrc/attention_fwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:80", "attention_causal", "ar_train"),
    ("attention_dq_causal", "packed_attention_bwd_dq_causal", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:80", "attention_dq_causal", "ar_train"),
    ("attention_dkv_causal", "packed_attention_bwd_dkv_causal", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:80", "attention_dkv_causal", "ar_train"),
    ("dct", "fused_ipt_dct_patchify", "dct_autoencoder_torch/csrc/dct_patchify.cu",
     "dct_autoencoder_tpu/kernels/dct_patchify.py:43", "dct_patchify", "serving_daemon"),
    ("idct", "fused_idct_unpatchify_rgb", "dct_autoencoder_torch/csrc/idct_unpatchify.cu",
     "dct_autoencoder_tpu/kernels/idct_unpatchify.py:47", "idct_unpatchify", "serving_daemon"),
]
SERVING_KERNELS = ("attention", "dct_patchify", "idct_unpatchify")
FWD_KERNELS = ("attention", "attention_causal")
BWD_KERNELS = ("attention_dq", "attention_dkv", "attention_dq_causal", "attention_dkv_causal")
# path -> (impl of its non-causal attention launches, impl of its causal ones):
# bfloat16 runs on the tensor cores; the AR example tokenizes in bfloat16 and
# trains its AR model in float32, on the CUDA-core kernels
PATH_IMPLS = {
    "serving": ("mma", "mma"), "reconstruct_direct": ("mma", "mma"), "serving_daemon": ("mma", "mma"),
    "full_width": ("mma", "mma"), "train_r3b": ("mma", "mma"),
    "train_patch14l": ("mma", "mma"), "ar_train": ("mma", "mma"), "ar_example": ("mma", "simt"),
    "train_pixel_r3b": ("mma", "mma"), "train_cli": ("mma", "mma"),
}


def path_launches() -> dict:
    """The launch counts of every kernel, and of the attention kernels by implementation."""
    from dct_autoencoder_torch import kernels as K

    return {**K.launch_counts(), "fwd_impl": K.fwd_impl_launch_counts(), "bwd_impl": K.bwd_impl_launch_counts()}


def check_impl_launches(launches: dict, impl: str, causal_impl: str) -> None:
    """Every attention launch of one path, forward and backward, was counted
    under `impl`, or under `causal_impl` for a causal one."""
    for kind, kernels in (("fwd", FWD_KERNELS), ("bwd", BWD_KERNELS)):
        want = {name: 0 for name in launches[f"{kind}_impl"]}
        for k in kernels:
            want[causal_impl if k.endswith("_causal") else impl] += launches[k]
        got = launches[f"{kind}_impl"]
        check(got == want, f"{kind} attention launches counted by impl as {got}, not {want}")
    check(sum(launches[k] for k in FWD_KERNELS) > 0, "the path launched no attention forward kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    smi = phase_environment()
    only = kernels_only(sys.argv[1:])
    cases = phase_kernels(only or "all")
    if only:
        return 0
    profile = "--profile" in sys.argv[1:]
    launches = {"serving": phase_serving()}
    launches["reconstruct_direct"] = phase_reconstruct_direct_patch14l()
    torch.cuda.empty_cache()
    phase_quantize_gate_r3b()
    launches["full_width"] = phase_full_width(profile)
    torch.cuda.empty_cache()
    launches["train_r3b"] = phase_train_r3b()
    torch.cuda.empty_cache()
    launches["train_patch14l"] = phase_train_full_width(profile)
    torch.cuda.empty_cache()
    phase_opt8bit_card_vs_cpu()
    launches["train_pixel_r3b"] = phase_train_pixel_r3b()
    torch.cuda.empty_cache()
    launches["train_cli"] = phase_train_cli_patch14l()
    torch.cuda.empty_cache()
    launches["ar_train"], ar_model = phase_ar_train_full_width(profile)
    launches["ar_example"], example_ar_model = phase_ar_example_r3b()
    phase_ar_sampling(ar_model)
    launches["serving_daemon"] = phase_serving_daemon_r3b(example_ar_model)

    for path, impls in PATH_IMPLS.items():
        check_impl_launches(launches[path], *impls)

    kernels = []
    for key, name, source, replaces, counter, path in KERNEL_TABLE:
        head = cases[key][0]  # the main path's shape
        check(launches[path][counter] > 0, f"{name} was not launched on the {path} path")
        check(head["impl"] == "mma", f"{name}: the main path's shape was held with impl {head['impl']}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[path][counter], "launches_on": path,
            "launches_by_path": {p: n.get(counter, 0) for p, n in launches.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases[key]),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "ms_every_tile": head.get("ms_every_tile"), "shape": head["shape"], "card": smi,
            "impl": head.get("impl"), "simt_ms": head.get("simt_ms"), "kernel_info": head.get("kernel_info"),
            **{k: head[k] for k in ("wrapper_ms", "bound_tf32x3_ms", "bound_fp32_cuda_cores_ms", "bound_bytes_ms") if k in head},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
