"""Drive the PyTorch/CUDA port's serving, training, AR and offline-tool paths on one NVIDIA GPU.

    python3 chip_smoke.py            # add --profile for device-time breakdowns

Builds the five hand-written CUDA kernels from dct_autoencoder_torch/csrc
(nvcc, sm_90a), holds each, and the causal mode of the three attention
kernels, against its plain PyTorch version at the shapes the main paths give
it (the bfloat16 attention kernels, forward and backward, which multiply on
the tensor cores, also against their CUDA-core versions, `impl="simt"`,
timed beside them; the float32 forward, dq and dk/dv kernels, 3xTF32 on the
tensor cores, `impl="tf32x3"`, also against their CUDA-core versions and a
float64 plain version, and timed with them and SDPA's fp32 forward and
backward at rows 1-3's, the sweep's and the AR example's shapes; the DCT
and IDCT kernels, 3xTF32 on the tensor cores, also against a float64 plain
version), and then drives
the paths themselves:
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
    profiler, then the same 4 steps without prefetch;
  * VQ mode (models/vq.py) at the full width of patch14-L with vq_type 'vq'
    (16 heads x 8192 codes x 16 dims): 8 train steps on 64 x 256 packed rows
    with k-means at step 0 and dead-code expiry at steps 3 and 7, timed,
    then encode and reconstruct_direct of 16 448 x 448 images with the
    trained model;
  * VQ at r3b's widths: the eval forward on the card against the CPU, step 0
    against the fp32 CPU step, save_pretrained / from_pretrained;
  * the training CLI with a VQ config at r3b's widths on PNG shards (8-bit
    moments, expiry every 2 steps), its checkpoint served by DCTPipeline;
  * the sweep's shared-step campaign (train/sweep.py run_onchip) over the same
    shards with conf/small-448.json in fp32, as `--onchip` runs it (the
    attention kernels in 3xTF32), both methods, 5
    trials each, under torch.profiler: its device time a step by kernel;
  * the AR token dump (tools/prepare_autoregressive_dataset.py) at the full
    width of patch14-L (random init, saved and loaded, bf16) over 64 PNG
    images with captions, with JAX's defaults: records in key order with
    their captions, each decoded on the card; two processes split the keys
    of one; then tools/eval.py on that checkpoint over 16 of the images;
  * tools/eval.py on the trained checkpoint in fp32, on the card against the
    CPU, and --scan over two copies of it (one pipeline, equal rows);
  * decode_gif, diagnose (fp32: the 3xTF32 attention forward) and
    testpipe (no model), each on the card against the CPU;
  * the int8 study (tools/int8_study.py) at its defaults: patch14-L at
    random init, bf16, 16 x 256 synthetic patches, every variant;
  * the native packing library (ext/packing.cpp, built with g++) against
    the port's numpy packing, bit for bit, on 1,000 images' token counts;
  * the CLIP warm start (tools/copy_clip_into.py): a random-init stand-in of
    CLIP-L/14's vision tower at its published widths transplanted into
    patch14-L, checked bit for bit, saved and loaded, then an encode +
    decode of 16 448 x 448 images in bf16; without transformers, the tool's
    main must refuse by name;
  * the reference tools (tools/convert_reference_weights.py,
    tools/parity_vs_reference.py): a stand-in of the reference model at
    patch14-L's widths converted and run on the same 16 images in the
    reference's 'bias' attention mode (its encode timed beside the warm
    start's 'block' one), a stand-in holding r3b's trained weights
    converted and held to the CPU fp32 run, and the harness's round trip
    (the DCT and IDCT kernels) on the card against the CPU;
  * data, tensor and sequence parallelism at world 1: a process group of one
    over NCCL and a (1, 1) mesh, 8 patch14-L train steps (64 x 256, bf16)
    through the sharded step with ZeRO-1 and sequence parallelism beside 8
    unsharded steps from the same init and batches (the same bits: the
    largest loss and parameter differences are printed and must be 0);
    DCTPipeline(data_parallel=True) on r3b against data_parallel=False; the
    two-process check (parallel/multiproc_check.py) over NCCL where there
    are two cards, else a line that says why it did not run;
  * pipeline parallelism at world 1: 8 patch14-L train steps as a pipeline
    of one stage with 4 microbatches (ZeRO-1, 8-bit moments) beside 8
    unsharded steps (the largest loss and parameter differences within
    stated limits, ms a step, peak GB, device time), 1F1B against GPipe on
    one patch14-L stack, tools/pp_memory_study.py and tools/compile_probe.py;
    the two-process check as a two-stage pipeline where there are two cards;
  * on four cards only: the sharded and pipelined steps of several layouts
    against one card, patch14-L's pipelines timed, and the training CLI
    under torch.distributed.run, tensor-parallel and pipelined.
The kernels' phase also runs the fp32 attention backward 20 times in each
mask mode after filling the allocator's free memory with NaN, and requires
the same bits every time; and it holds the attention kernels' dropout mode
(rates 0.1 and 0.3, both mask modes, causal or not, every implementation)
and the head dims 16, 24, 48, 80 and 128 (those between the instantiations
16, 32, 64 and 128 run in place in the tensor-core kernels, with no pad copy,
and padded in the CUDA-core ones) against the plain versions, reads the keep
bits each kernel drew off its outputs and holds them to the plain twin of
the random stream bit for bit, and times the dropout mode at patch14-L's
shape beside the kernels without it and SDPA with dropout_p, and head dims
16, 48 and 128 at (64, 8, 256, d).  Two phases drive those on the paths:
patch14-L train steps with the encoder's attention dropout at 0.1 beside
the same steps without it, and the AR example at head dims 48 and 16.
Every phase prints one JSON line; any failed check raises and the script
exits non-zero.  The line before the last lists the kernels with their
launches on the main paths, errors, times and bounds; the last line is
{"ok": true, "device": {...}}.

`--attention-device-times` only times the attention kernels without dropout
from CUDA graphs (no result line); `--kernels-only` stops after the kernels' phase (no result line);
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
import tempfile
import time

import numpy as np
import torch

from dct_autoencoder_torch.patches.synthetic import packed_batch, token_items

HERE = os.path.dirname(os.path.abspath(__file__))
R3B = os.path.join(HERE, "docs", "calibrated_run_r3b", "model")
PATCH14_L = os.path.join(HERE, "conf", "patch14-l.json")
SMALL_448 = os.path.join(HERE, "conf", "small-448.json")

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
# the same test for the fp32 attention backward in 3xTF32 (impl tf32x3): each of
# dq, dk, dv against float64 on the same inputs within this many times the fp32
# plain version's error (cuBLAS SGEMM), and at least ATTN_F64_FLOOR x the largest
# gradient of the case: where the exact value is 0 and both sides give rounding
# noise (at s = 1, dp - delta cancels), 22 bits of noise against 24 can stand
# 8x apart; one TF32 product is off by ~1e-4 of the largest gradient
ATTN_F64_RATIO = 8.0
ATTN_F64_FLOOR = 1e-6
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
# VQ at r3b's widths, fp32: the card's eval codes against the CPU's, share of (token, head) ids equal
MIN_VQ_CODE_AGREEMENT = 0.95


_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets `t_s`, the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
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


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_environment():
    smi = _card()
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
    if dtype == torch.float32:
        simt_row.update(_hold_fwd_to_f64(what, o, o_ref, attention_fwd_f64(q, k, v, q_ids, kv_ids, scale, mode)[0]))

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
    """The tensor-core forward's o (bfloat16: impl mma; float32: impl tf32x3)
    against the CUDA-core kernel's on the same inputs, the CUDA-core kernel's
    time, and what the compiler made of both instantiations.  The limit is
    `simt_tol` in bfloat16 and 1e-5 of the largest value in float32."""
    impl = A._kernel_impl(None, q.dtype)
    info = lambda impl: A.attention_kernel_info("fwd", impl, q.dtype, d)
    o_simt, _ = simt()
    torch.cuda.synchronize()
    diff = (o.float() - o_simt.float()).abs().max().item()
    top = o_simt.float().abs().max().item()
    tol = simt_tol(ATTN_ATOL_BF16, top) if q.dtype == torch.bfloat16 else 1e-5 * max(1.0, top)
    check(diff <= tol, f"{what}: o of impl {impl} and impl simt differ by {diff} > {tol}")
    return {
        "impl": impl, "simt_tol": tol, "max_abs_o": top, "simt_max_abs_diff": diff,
        "simt_ms": time_ms(simt, reps=10), "kernel_info": info(impl), "simt_kernel_info": info("simt"),
    }


def _bwd_against_simt(A, q, d, got, dq_simt, dkv_simt, what):
    """The tensor-core kernels' results `got` = (dq, dk, dv) (bfloat16: impl
    mma; float32: impl tf32x3) against the CUDA-core kernels on the same
    inputs, the CUDA-core kernels' times, and what the compiler made of both
    instantiations.  The limit is `simt_tol` in bfloat16 and 1e-5 of the
    largest value in float32."""
    impl = A._kernel_impl(None, q.dtype, "dq")
    info = lambda kernel, impl: A.attention_kernel_info(kernel, impl, q.dtype, d)
    dq_s, delta_s = dq_simt()
    dk_s, dv_s = dkv_simt(delta_s)
    torch.cuda.synchronize()
    diffs, top = {}, 0.0
    for name, new, old in (("dq", got[0], dq_s), ("dk", got[1], dk_s), ("dv", got[2], dv_s)):
        diffs[name] = (new.float() - old.float()).abs().max().item()
        top = max(top, old.float().abs().max().item())
    tol = simt_tol(ATTN_BWD_ATOL_BF16, top) if q.dtype == torch.bfloat16 else 1e-5 * max(1.0, top)
    for name, diff in diffs.items():
        check(diff <= tol, f"{what}: {name} of impl {impl} and impl simt differ by {diff} > {tol}")
    common = {"impl": impl, "simt_tol": tol, "max_abs_grad": top}
    return (
        {**common, "simt_max_abs_diff": diffs["dq"], "simt_ms": time_ms(dq_simt, reps=10),
         "kernel_info": info("dq", impl), "simt_kernel_info": info("dq", "simt")},
        {**common, "simt_max_abs_diff": max(diffs["dk"], diffs["dv"]), "simt_ms": time_ms(lambda: dkv_simt(delta_s), reps=10),
         "kernel_info": info("dkv", impl), "simt_kernel_info": info("dkv", "simt")},
    )


def attention_bwd_f64(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal=False, dropout=None):
    """attention_bwd_plain's function computed in float64 on the same inputs
    (o and lse as the forward kernel gave them): the yardstick that the fp32
    backward kernels and the fp32 plain version are both read against."""
    from dct_autoencoder_torch.kernels import attention as A

    qq, kk, vv, oo, dd = (t.double() for t in (q, k, v, o, do))
    logits = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * scale
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        allowed = allowed & (pos[None, :] <= pos[:, None])
    logits = logits + allowed.double() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, A.NEG_INF))
    p = torch.exp(logits - lse.double()[..., None])
    dp, pv = torch.einsum("bhqd,bhkd->bhqk", dd, vv), p
    if dropout is not None:
        b, h, s, _ = q.shape
        keep = A.attention_dropout_keep_mask(dropout.seed, dropout.rate, b, h, s, dropout.row0, dropout.head0)
        z = keep.double() * dropout.keep_scale
        pv, dp = p * z, dp * z
    dv = torch.einsum("bhqk,bhqd->bhkd", pv, dd)
    ds = p * (dp - (dd * oo).sum(dim=-1, keepdim=True)) * scale
    return torch.einsum("bhqk,bhkd->bhqd", ds, kk), torch.einsum("bhqk,bhqd->bhkd", ds, qq), dv


def attention_fwd_f64(q, k, v, q_ids, kv_ids, scale, mode, causal=False, dropout=None):
    """attention_fwd_plain's function computed in float64 on the same inputs:
    (o, lse), the yardstick that the fp32 forward kernels and the fp32 plain
    version are both read against."""
    from dct_autoencoder_torch.kernels import attention as A

    qq, kk, vv = (t.double() for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qq, kk) * scale
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        allowed = allowed & (pos[None, :] <= pos[:, None])
    logits = logits + allowed.double() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, A.NEG_INF))
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=A.NEG_INF * 0.5)
    p = torch.exp(logits - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-9)
    pv = p
    if dropout is not None:
        b, h, s, _ = q.shape
        keep = A.attention_dropout_keep_mask(dropout.seed, dropout.rate, b, h, s, dropout.row0, dropout.head0)
        pv = p * keep.double() / (1.0 - dropout.rate)
    return torch.einsum("bhqk,bhkd->bhqd", pv, vv) / den, (m + torch.log(den))[..., 0]


def _hold_fwd_to_f64(what, o, plain, ref64) -> dict:
    """The forward's o of a 3xTF32 kernel against float64, by _hold_bwd_to_f64's
    rule: at most ATTN_F64_RATIO x the fp32 plain version's error, or
    ATTN_F64_FLOOR of the largest value.  Returns the errors and their ratio."""
    e64, p64 = (o.double() - ref64).abs().max().item(), (plain.double() - ref64).abs().max().item()
    limit = max(ATTN_F64_RATIO * p64, ATTN_F64_FLOOR * ref64.abs().max().item())
    check(e64 <= limit, f"{what}: o float64 error {e64} > {limit} ({ATTN_F64_RATIO} x the plain version's {p64})")
    return {"f64": {"o": {"f64_err": e64, "plain_f64_err": p64}}, "f64_ratio": e64 / p64 if p64 > 0 else None}


def _hold_bwd_to_f64(what, got, plain, ref64) -> dict:
    """Each of dq, dk, dv of a 3xTF32 backward against float64: its largest
    error at most ATTN_F64_RATIO x the fp32 plain version's, or
    ATTN_F64_FLOOR of the case's largest gradient where that is more (an
    output that both sides get as rounding noise around 0).  Returns the
    errors and their ratios."""
    row, top = {}, max(r.abs().max().item() for r in ref64)
    for name, x, pl, r in zip(("dq", "dk", "dv"), got, plain, ref64):
        e64, p64 = (x.double() - r).abs().max().item(), (pl.double() - r).abs().max().item()
        limit = max(ATTN_F64_RATIO * p64, ATTN_F64_FLOOR * top)
        check(e64 <= limit, f"{what}: {name} float64 error {e64} > {limit} ({ATTN_F64_RATIO} x the plain version's {p64})")
        row[name] = {"f64_err": e64, "plain_f64_err": p64, "f64_ratio": e64 / p64 if p64 > 0 else None}
    return {"f64": row, "f64_ratio": max((r["f64_ratio"] or 0.0) for r in row.values())}


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
    f64_row = {}
    if dtype == torch.float32:
        f64_row = _hold_bwd_to_f64(f"attention backward {mode} {(b, h, s, d)}", (dq, dk, dv), (dq_ref, dk_ref, dv_ref),
                                   attention_bwd_f64(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode))
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
        "library_computes": "dq, dk and dv (backward of scaled_dot_product_attention)", **f64_row,
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
    """The fp32 backward kernels at (2, 4, 173, 32) (a ragged last tile; the
    inputs of tests/test_torch_cuda.py::test_attention_gradients_match_cpu),
    `runs` times for each implementation, each run after poisoning the
    allocator: the default, tf32x3, through packed_flash_attention's autograd
    (the head merge's transposed grad_output), and simt through the wrappers
    with the grad_output autograd hands over (2 o).  Checks, for each: every
    run gives the same bits, within 1e-5 (+ 1e-5 relative) of the plain
    versions (attention_fwd_plain, attention_bwd_plain) on the card and of a
    float64 computation.  The plain versions on the CPU are read and reported
    beside them; a disagreement with them emits the places where it lies, so
    that an occurrence names the side that moved."""
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

    def grads_simt():
        qq, kk, vv = (t.to("cuda") for t in (q, k, v))
        q_ids, kv_ids = A.segment_ids(ids.cuda(), pad.cuda())
        o, lse = A.attention_fwd_cuda(qq, kk, vv, q_ids, kv_ids, scale, mode)
        dq, delta = A.attention_dq_cuda(qq, kk, vv, q_ids, kv_ids, o, lse, 2 * o, scale, mode, impl="simt")
        return [t.cpu() for t in (dq, *A.attention_dkv_cuda(qq, kk, vv, q_ids, kv_ids, lse, delta, 2 * o, scale, mode, impl="simt"))]

    def plain(dev):
        qq, kk, vv = (t.to(dev) for t in (q, k, v))
        q_ids, kv_ids = A.segment_ids(ids.to(dev), pad.to(dev))
        o, lse = A.attention_fwd_plain(qq, kk, vv, q_ids, kv_ids, scale, mode)
        return [t.cpu() for t in A.attention_bwd_plain(qq, kk, vv, q_ids, kv_ids, o, lse, 2 * o, scale, mode)]

    outside = lambda got, ref: sum(int(((x - r).abs() > 1e-5 + 1e-5 * r.abs()).sum()) for x, r in zip(got, ref))
    max_err = lambda got, ref: max((x.double() - r.double()).abs().max().item() for x, r in zip(got, ref))
    ref = plain("cuda")
    ref64 = attention_grads_f64(q, k, v, ids, pad, scale, mode)
    cpu_kernel_path = grads("cpu")  # the same autograd path, which runs the plain versions on the CPU
    row = {"mode": mode, "shape": [b, h, s, d], "runs": runs, "tol": "1e-5 + 1e-5 |ref|",
           "plain_on_card_vs_f64": max_err(ref, ref64), "cpu_plain_vs_f64": max_err(cpu_kernel_path, ref64),
           "max_abs_grad": max(r.abs().max().item() for r in ref64)}
    for impl, run in (("tf32x3", lambda: grads("cuda")), ("simt", grads_simt)):
        first, differing = None, 0
        for _ in range(runs):
            _poison_allocator()
            got = run()
            if first is None:
                first = got
            differing += not all(torch.equal(x, y) for x, y in zip(first, got))
        row[impl] = {"runs_differing": differing, "max_abs_err": max_err(first, ref), "max_abs_err_vs_f64": max_err(first, ref64),
                     "max_abs_err_vs_cpu_plain": max_err(first, cpu_kernel_path)}
        if differing or outside(first, ref) or outside(first, ref64) or outside(first, cpu_kernel_path):
            where = {}
            for name, x, r in zip(("dq", "dk", "dv"), first, cpu_kernel_path):
                bad = ((x - r).abs() > 1e-5 + 1e-5 * r.abs()).nonzero()
                where[name] = {"elements": int(bad.shape[0]), "batch_head_pairs": sorted({(int(i), int(j)) for i, j, _, _ in bad.tolist()}),
                               "rows": sorted({int(t) for t in bad[:, 2].tolist()})[:40]}
            emit({"phase": "attention_bwd_fp32_disagreement", "impl": impl, **row, "card_vs_cpu_plain_where": where,
                  "cpu_plain_again_vs_f64": max_err(grads("cpu"), ref64), "threads": torch.get_num_threads()})
        what = f"fp32 attention backward {impl} {mode} {(b, h, s, d)}"
        check(differing == 0, f"{what}: {differing} of {runs} runs after poisoning differ from the first")
        check(outside(first, ref) == 0, f"{what}: off the plain versions on the card by more than 1e-5 (max {row[impl]['max_abs_err']})")
        check(outside(first, ref64) == 0, f"{what}: off float64 by more than 1e-5 (max {row[impl]['max_abs_err_vs_f64']})")
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
    f64_row = {}
    if not bf16:
        f64_row = _hold_bwd_to_f64(what, (dq, dk, dv), tuple(refs.values()),
                                   attention_bwd_f64(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, True))
        fwd_row.update(_hold_fwd_to_f64(what, o, o_ref, attention_fwd_f64(q, k, v, q_ids, kv_ids, scale, mode, True)[0]))
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
        "library_computes": "dq, dk and dv (backward of scaled_dot_product_attention)", **f64_row,
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


# ---------------------------------------------------------------- the dropout mode and the head dims

# the rates the dropout mode is held at, and the head dims beside the instantiations
# (16, 32, 64, 128): 24, 48 and 80 run in place in the tensor-core kernels (mma,
# tf32x3) and padded to the next instantiation in the CUDA-core ones (simt)
DROPOUT_RATES = (0.1, 0.3)
HEAD_DIM_CASES = (16, 24, 48, 80, 128)
# (dtype, impl) of every implementation of the three kernels
ATTENTION_IMPLS = ((torch.bfloat16, "mma"), (torch.bfloat16, "simt"), (torch.float32, "simt"), (torch.float32, "tf32x3"))


def _dropout(A, rate, seed, row0=0, head0=0):
    """An AttentionDropout at `rate` with a seed on the card, or None at rate 0."""
    if not rate:
        return None
    return A.AttentionDropout(rate, torch.tensor([seed], dtype=torch.int64, device="cuda"), row0, head0)


def _mode_tol(dtype, limit, ref) -> float:
    """The limit of one output against its plain version: in bfloat16 the larger
    of `limit` and one ulp of the largest value (dropout scales values by
    1 / (1 - rate), past the magnitudes the fixed limits were set for); in
    float32 1e-5 of the largest value, and at least 1e-5."""
    top = ref.float().abs().max().item()
    return simt_tol(limit, top) if dtype == torch.bfloat16 else 1e-5 * max(1.0, top)


def _attention_mode_case(b, h, s, d, dtype, mode, causal, impl, rate, gen, seed=7, row0=0, head0=0):
    """The forward, dq and dk/dv kernels of one implementation at head dim d
    (in place, or padded by the wrappers, as `row_width` says) and, at rate >
    0, in the dropout mode, against the plain versions on the same inputs
    and seed: within `_mode_tol`, finite, the same bits on a second launch,
    padded queries 0 in 'block' mode, no pad copy where the kernels take the
    rows in place; impl tf32x3 also against float64 (_hold_fwd_to_f64,
    _hold_bwd_to_f64).  Returns one row a kernel."""
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.kernels import attention as A

    (q, k, v, do), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, dtype, gen, 4)
    scale = d**-0.5
    drop = _dropout(A, rate, seed, row0, head0)
    fwd = lambda: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, causal, impl=impl, dropout=drop)
    K.reset_launch_counts()
    o, lse = fwd()
    dq_k = lambda: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, impl=impl, dropout=drop)
    dq, delta = dq_k()
    dkv_k = lambda: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, causal, impl=impl, dropout=drop)
    dk, dv = dkv_k()
    torch.cuda.synchronize()
    pad_copies = K.pad_copy_count()
    in_place = A.row_width(d, dtype, impl) == d
    # q, k, v; q, k, v, o, do; q, k, v, do: 12 copies where the wrappers pad
    check(pad_copies == (0 if in_place else 12), f"attention {impl} d = {d}: {pad_copies} pad copies")
    o_ref, lse_ref = A.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, causal, drop)
    refs = A.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, drop)
    what = f"attention {impl} {str(dtype).split('.')[-1]} {mode} causal={causal} rate={rate} {(b, h, s, d)}"
    errs, tols = {}, {}
    for name, got, ref, limit in (("o", o, o_ref, ATTN_ATOL_BF16), ("dq", dq, refs[0], ATTN_BWD_ATOL_BF16),
                                  ("dk", dk, refs[1], ATTN_BWD_ATOL_BF16), ("dv", dv, refs[2], ATTN_BWD_ATOL_BF16)):
        check(got.shape == ref.shape and torch.isfinite(got).all().item(), f"{what}: {name} not finite or misshaped")
        errs[name] = (got.float() - ref.float()).abs().max().item()
        tols[name] = _mode_tol(dtype, limit, ref)
        check(errs[name] <= tols[name], f"{what}: {name} max|diff| {errs[name]} > {tols[name]}")
    lse_err = (lse - lse_ref).abs().max().item()
    check(lse_err <= 1e-4, f"{what}: lse max|diff| {lse_err}")
    if mode == "block" and pad.any():
        check(o.transpose(1, 2)[pad].abs().max().item() == 0.0, f"{what}: padded queries not 0")
        check(dq.transpose(1, 2)[pad].abs().max().item() == 0.0, f"{what}: dq of padded queries not 0")
    again = (*fwd(), *dq_k(), *dkv_k())
    check(all(torch.equal(x, y) for x, y in zip((o, lse, dq, delta, dk, dv), again)), f"{what}: two launches differ")
    f64_row, fwd_f64 = {}, {}
    if impl == "tf32x3":
        f64_row = _hold_bwd_to_f64(what, (dq, dk, dv), refs,
                                   attention_bwd_f64(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal, drop))
        fwd_f64 = _hold_fwd_to_f64(what, o, o_ref, attention_fwd_f64(q, k, v, q_ids, kv_ids, scale, mode, causal, drop)[0])
    common = {"shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode, "causal": causal,
              "impl": impl, "rate": rate, "kernel_head_dim": A.kernel_head_dim(d), "in_place": in_place,
              "pad_copies": pad_copies}
    return {
        "fwd": {**common, "max_abs_err": errs["o"], "tol": tols["o"], "lse_max_abs_err": lse_err, **fwd_f64},
        "dq": {**common, "max_abs_err": errs["dq"], "tol": tols["dq"], **f64_row},
        "dkv": {**common, "max_abs_err": max(errs["dk"], errs["dv"]), "tol": max(tols["dk"], tols["dv"]), **f64_row},
    }


def _dropout_mask_readout(dtype, impl, rate, gen, row0=3, head0=5):
    """The keep bits each kernel drew, read off its outputs at b = h = 2,
    s = d = 128 with every p = 1/s (q = 0), against attention_dropout_keep_mask
    bit for bit: the forward's o with v = I is z / ((1 - rate) s); dk/dv's dv
    with do = I is its transpose; dq with k = I and v = do = e_0 is
    (z / (1 - rate) - mean(z) / (1 - rate)) scale / s, whose sign is z
    (compared where that value is clear of 0)."""
    from dct_autoencoder_torch.kernels import attention as A

    b, h, s = 2, 2, 128
    dev = torch.device("cuda")
    drop = A.AttentionDropout(rate, torch.randint(0, 2**62, (1,), generator=gen).to(dev), row0, head0)
    want = A.attention_dropout_keep_mask(drop.seed, rate, b, h, s, row0, head0)
    zeros = torch.zeros(b, h, s, s, dtype=dtype, device=dev)
    eye = torch.eye(s, dtype=dtype, device=dev).expand(b, h, s, s).contiguous()
    e0 = zeros.clone()
    e0[..., 0] = 1
    ids = torch.zeros(b, s, dtype=torch.int32, device=dev)
    k = torch.randn(b, h, s, s, generator=gen).to(dtype).to(dev)
    scale = s**-0.5
    kw = dict(impl=impl, dropout=drop)
    o, lse = A.attention_fwd_cuda(zeros, k, eye, ids, ids, scale, **kw)
    _, delta = A.attention_dq_cuda(zeros, k, eye, ids, ids, o, lse, eye, scale, **kw)
    _, dv = A.attention_dkv_cuda(zeros, k, eye, ids, ids, lse, delta, eye, scale, **kw)
    o2, lse2 = A.attention_fwd_cuda(zeros, eye, e0, ids, ids, scale, **kw)
    dq, _ = A.attention_dq_cuda(zeros, eye, e0, ids, ids, o2, lse2, e0, scale, **kw)
    torch.cuda.synchronize()
    z = want.float() * drop.keep_scale
    expect = z - z.mean(dim=-1, keepdim=True)
    clear = expect.abs() > 0.05
    what = f"dropout mask {impl} {str(dtype).split('.')[-1]} rate {rate}"
    row = {
        "impl": impl, "dtype": str(dtype).split(".")[-1], "rate": rate, "shape": [b, h, s, s], "row0": row0,
        "head0": head0, "fwd_bits_differing": int(((o != 0) != want).sum()),
        "dkv_bits_differing": int(((dv.transpose(-1, -2) != 0) != want).sum()),
        "dq_bits_differing": int((((dq.float() > 0) != want) & clear).sum()), "dq_share_read": clear.float().mean().item(),
        "kept_share": want.float().mean().item(), "sigma": math.sqrt(rate * (1 - rate) / want.numel()),
    }
    for name in ("fwd", "dkv", "dq"):
        check(row[f"{name}_bits_differing"] == 0, f"{what}: {row[f'{name}_bits_differing']} keep bits of {name} differ from the twin")
    check(row["dq_share_read"] > 0.9, f"{what}: dq's sign read only {row['dq_share_read']} of the bits")
    check(abs(row["kept_share"] - (1 - rate)) <= 4 * row["sigma"], f"{what}: kept share {row['kept_share']}")
    return row


def _dropout_and_dim_cases(gen):
    """Every new mode and dim against its plain version: the dropout mode at
    both rates in both mask modes, causal or not, in the tensor-core kernels
    (bf16, impl "mma"; fp32, impl "tf32x3") and the CUDA-core kernels on
    either type (impl "simt"); the head dims of HEAD_DIM_CASES with and
    without dropout, in every implementation.  Returns rows by kernel key."""
    out = {key: [] for key in ("attention", "attention_dq", "attention_dkv", "attention_causal", "attention_dq_causal",
                               "attention_dkv_causal", "attention_dropout", "attention_dq_dropout", "attention_dkv_dropout")}

    def add(rows, rate, causal):
        suffix = "_dropout" if rate else ("_causal" if causal else "")
        for kernel, key in (("fwd", "attention"), ("dq", "attention_dq"), ("dkv", "attention_dkv")):
            out[key + suffix].append(rows[kernel])

    impls = ATTENTION_IMPLS
    for rate in DROPOUT_RATES:
        for mode in ("block", "bias"):
            for causal in (False, True):
                for dtype, impl in impls:
                    add(_attention_mode_case(2, 4, 200, 64, dtype, mode, causal, impl, rate, gen, row0=1, head0=2), rate, causal)
    for d in HEAD_DIM_CASES:
        for mode in ("block", "bias"):
            for causal in (False, True):
                for rate in (0.0, 0.1):
                    for dtype, impl in impls:
                        add(_attention_mode_case(2, 3, 173, d, dtype, mode, causal, impl, rate, gen), rate, causal)
    return out


def _sdpa_calls(q, k, v, do, mask, scale, rate):
    """scaled_dot_product_attention's forward and its whole backward (dq, dk and
    dv in one call) at dropout_p = rate: the library yardsticks."""
    import torch.nn.functional as F

    fwd = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, dropout_p=rate, scale=scale)
    return fwd, lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)


def _timed_rows(A, b, h, s, d, dtype, mode, rate, gen, seed=11):
    """Rows of the three kernels at one timed shape: ms (tensor cores),
    simt_ms, plain_ms, library_ms (SDPA at dropout_p = rate), bound; in the
    dropout mode also the kernels' times without dropout on the same inputs
    and the kept share of the whole mask."""
    from dct_autoencoder_torch import kernels as K

    (q, k, v, do), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, dtype, gen, 4)
    scale = d**-0.5
    drop = _dropout(A, rate, seed)
    fwd = lambda impl=None, dr=drop: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, mode, impl=impl, dropout=dr)
    K.reset_launch_counts()
    o, lse = fwd()
    o0, _ = fwd(dr=None)
    dq_k = lambda impl=None, dr=drop: A.attention_dq_cuda(
        q, k, v, q_ids, kv_ids, o if dr is not None else o0, lse, do, scale, mode, impl=impl, dropout=dr)
    dq, delta = dq_k()
    dkv_k = lambda impl=None, dr=drop: A.attention_dkv_cuda(
        q, k, v, q_ids, kv_ids, lse, delta, do, scale, mode, impl=impl, dropout=dr)
    dk, dv = dkv_k()
    torch.cuda.synchronize()
    pad_copies = K.pad_copy_count()  # of the four launches above
    fwd_plain = lambda: A.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, mode, False, drop)
    bwd_plain = lambda: A.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, False, drop)
    o_ref, _ = fwd_plain()
    refs = bwd_plain()
    errs = {"fwd": ((o.float() - o_ref.float()).abs().max().item(), _mode_tol(dtype, ATTN_ATOL_BF16, o_ref))}
    errs["dq"] = ((dq.float() - refs[0].float()).abs().max().item(), _mode_tol(dtype, ATTN_BWD_ATOL_BF16, refs[0]))
    errs["dkv"] = (max((x.float() - r.float()).abs().max().item() for x, r in zip((dk, dv), refs[1:])),
                   max(_mode_tol(dtype, ATTN_BWD_ATOL_BF16, r) for r in refs[1:]))
    what = f"timed attention rate {rate} {(b, h, s, d)}"
    for name, (err, tol) in errs.items():
        check(err <= tol, f"{what}: {name} max|diff| {err} > {tol}")
    del o_ref, refs
    mask, pairs = _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype)
    lib_fwd, lib_bwd = _sdpa_calls(q, k, v, do, mask, scale, rate)
    elt, n = q.element_size(), b * h * s * d
    vec, ids_bytes = b * h * s * 4, 2 * b * s * 4
    bounds = {
        "fwd": bound(4 * n * elt + ids_bytes + vec, 4 * h * d * pairs, dtype),
        "dq": bound(6 * n * elt + 2 * vec + ids_bytes, 6 * h * d * pairs, dtype),
        "dkv": bound(6 * n * elt + 2 * vec + ids_bytes, 8 * h * d * pairs, dtype),
    }
    plain_ms = {"fwd": time_ms(fwd_plain, reps=5), "dq": time_ms(bwd_plain, reps=5)}
    plain_ms["dkv"] = plain_ms["dq"]
    lib_ms = {"fwd": time_ms(lib_fwd, inner=TIMED_LAUNCHES), "dq": time_ms(lib_bwd, inner=TIMED_LAUNCHES)}
    lib_ms["dkv"] = lib_ms["dq"]
    rows = {}
    for name, kernel in (("fwd", fwd), ("dq", dq_k), ("dkv", dkv_k)):
        info = lambda impl: A.attention_kernel_info(name, impl, dtype, d, dropout=drop is not None)
        rows[name] = {
            "shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode, "rate": rate, "impl": "mma",
            "kernel_head_dim": A.kernel_head_dim(d), "pad_copies": pad_copies,
            "max_abs_err": errs[name][0], "tol": errs[name][1],
            "ms": time_ms(kernel, inner=TIMED_LAUNCHES), "simt_ms": time_ms(lambda: kernel("simt"), reps=5),
            "plain_ms": plain_ms[name], "library_ms": lib_ms[name],
            "library_computes": ("the forward" if name == "fwd" else "dq, dk and dv")
            + f" of scaled_dot_product_attention at dropout_p {rate}",
            "plain_computes": "the forward" if name == "fwd" else "dq, dk and dv",
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "kernel_info": info("mma"),
            "simt_kernel_info": info("simt"),
        }
        if drop is not None:
            rows[name]["ms_no_dropout"] = time_ms(lambda: kernel(dr=None), inner=TIMED_LAUNCHES)
            rows[name]["kernel_info_no_dropout"] = A.attention_kernel_info(name, "mma", dtype, d)
            rows[name]["philox_calls"] = b * h * s * s // 4  # every tile is computed: no causal skipping here
    if drop is not None:
        keep = A.attention_dropout_keep_mask(drop.seed, rate, b, h, s)
        share, sigma = keep.float().mean().item(), math.sqrt(rate * (1 - rate) / keep.numel())
        del keep
        check(abs(share - (1 - rate)) <= 4 * sigma, f"{what}: kept share {share} of {1 - rate}")
        rows["fwd"].update(kept_share=share, kept_share_sigma=sigma)
    return rows


def phase_attention_modes(gen):
    """The dropout mode and the head dims of the three attention kernels (see
    _dropout_and_dim_cases, _dropout_mask_readout, _timed_rows).  Returns rows
    by kernel key; the dropout keys' first rows are the timed main-path shape."""
    from dct_autoencoder_torch.kernels import attention as A

    t0 = time.perf_counter()
    readouts = [_dropout_mask_readout(dtype, impl, rate, gen) for rate in DROPOUT_RATES for dtype, impl in ATTENTION_IMPLS]
    timed = _timed_rows(A, 64, 16, 256, 64, torch.bfloat16, "block", 0.1, gen)  # the patch14-L train step's shape
    torch.cuda.empty_cache()
    dims = {d: _timed_rows(A, 64, 8, 256, d, torch.bfloat16, "block", 0.0, gen) for d in (16, 48, 128)}
    torch.cuda.empty_cache()
    cases = _dropout_and_dim_cases(gen)
    for kernel, key in (("fwd", "attention"), ("dq", "attention_dq"), ("dkv", "attention_dkv")):
        cases[key + "_dropout"].insert(0, timed[kernel])
        for d, rows in dims.items():
            emit({"phase": "attention_head_dim_timed", "kernel": key, **rows[kernel]})
    for row in readouts:
        emit({"phase": "attention_dropout_mask_readout", **row})
    for key, rows in cases.items():
        worst = max(rows, key=lambda r: r["max_abs_err"] / r["tol"])
        emit({"phase": "attention_modes_vs_plain", "kernel": key, "cases": len(rows),
              "max_abs_err": max(r["max_abs_err"] for r in rows), "largest_err_over_tol": worst["max_abs_err"] / worst["tol"],
              "worst_case": worst})
    pads = {}  # the wrappers' pad copies by implementation and head dim (_attention_mode_case checks each case)
    for row in cases["attention"]:  # one a case: the three kernels' copies
        key = f"{row['impl']} {row['dtype']} d={row['shape'][3]}"
        pads[key] = pads.get(key, 0) + row["pad_copies"]
    emit({"phase": "attention_modes", "cases": sum(len(r) for r in cases.values()), "rates": DROPOUT_RATES,
          "head_dims": HEAD_DIM_CASES, "instantiations": A.HEAD_DIMS, "pad_copies": pads,
          "wall_s": time.perf_counter() - t0})
    return cases, dims


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


def attention_device_times(reps: int = 3) -> None:
    """`--attention-device-times`: the device time of the three attention
    kernels without dropout (CUDA graphs, no host cost) at rows 1-3 (d = 64),
    at (64, 8, 256, 32), at rows 1c-3c and at (64, 8, 256, 48) (a width
    between the instantiations: with the wrappers' pad copies where a tree
    pads it), `reps` times each, one JSON line a kernel and shape.  It uses
    only the wrappers' arguments that every tree of the port has had since
    the causal mode, so a copy of this script in an older tree times that
    tree's kernels beside this one's."""
    from dct_autoencoder_torch.kernels import attention as A

    gen = torch.Generator().manual_seed(0)
    for b, h, s, d, causal in ((64, 16, 256, 64, False), (64, 8, 256, 32, False), (8, 8, 1024, 64, True),
                               (64, 8, 256, 48, False)):
        (q, k, v, do), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, torch.bfloat16, gen, 4)
        scale = d**-0.5
        o, lse = A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, "block", causal)
        dq, delta = A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, "block", causal)
        kernels = {
            "fwd": lambda: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, "block", causal),
            "dq": lambda: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, "block", causal),
            "dkv": lambda: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, delta, do, scale, "block", causal),
        }
        for name, fn in kernels.items():
            emit({"phase": "attention_device_times", "kernel": name, "shape": [b, h, s, d], "causal": causal,
                  "graph_ms": [graph_ms(fn) for _ in range(reps)], "event_ms": time_ms(fn, inner=TIMED_LAUNCHES)})


# the fp32 attention's timed shapes ((b, h, s, d), causal, one image a row): rows 1-3's;
# the sweep's (conf/small-448.json at 4 x 3072 rows, beta 0: one 448^2 image a row,
# every pair allowed); the AR example's (batch 8 x 128, hidden 256, 4 heads)
FP32_TIMED_SHAPES = (((64, 16, 256, 64), False, False), ((4, 8, 3072, 32), False, True), ((8, 4, 128, 64), True, False))
# the fp32 attention kernels' implementations, timed side by side
FP32_IMPLS = ("simt", "tf32x3")


def _sdpa_fp32_times(q, k, v, do, mask, scale) -> dict:
    """SDPA's fp32 forward and whole backward, pinned to the memory-efficient
    backend (CUTLASS; 3xTF32 on sm_80 and later), or to the math backend where
    that one refuses the inputs, and unpinned (the backend the dispatcher
    picks).  library_fwd_ms and library_bwd_ms are the faster of the two,
    library_fwd_backend and library_bwd_backend the call that gave each."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    timed, refused = {"fwd": {}, "bwd": {}}, []
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                fwd, bwd = _sdpa_calls(q, k, v, do, mask, scale, 0.0)
                timed["fwd"][backend.name] = time_ms(fwd, inner=TIMED_LAUNCHES)
                timed["bwd"][backend.name] = time_ms(bwd, inner=TIMED_LAUNCHES)
            break
        except RuntimeError as e:
            refused.append(f"{backend.name}: {str(e)[:200]}")
    picked = SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask=mask, dropout_p=0.0, is_causal=False, scale=scale)).name
    fwd, bwd = _sdpa_calls(q, k, v, do, mask, scale, 0.0)
    timed["fwd"][f"unpinned ({picked})"] = time_ms(fwd, inner=TIMED_LAUNCHES)
    timed["bwd"][f"unpinned ({picked})"] = time_ms(bwd, inner=TIMED_LAUNCHES)
    out = {"library_refused": refused, "library_ms_by_backend": timed}
    for kind, by_backend in timed.items():
        out[f"library_{kind}_backend"], out[f"library_{kind}_ms"] = min(by_backend.items(), key=lambda kv: kv[1])
    return out


def fp32_attention_times(reps: int = 25) -> dict:
    """The fp32 attention kernels at FP32_TIMED_SHAPES: the forward and the
    backward pair in each of FP32_IMPLS, each held to the plain versions
    (1e-5 of the largest value) and the tf32x3 forward's o to float64
    (_hold_fwd_to_f64), beside SDPA's fp32 forward and backward
    (_sdpa_fp32_times), the plain versions and the bounds (each input and
    output once, allowed pairs only; operations at 3xTF32, 495 / 3 TFLOP/s,
    and on the CUDA cores at 67).  The backward reads the tf32x3 forward's o
    and lse.  One JSON line a shape; returns them by shape."""
    from dct_autoencoder_torch.kernels import attention as A

    gen = torch.Generator().manual_seed(3)
    rows = {}
    for (b, h, s, d), causal, one_image in FP32_TIMED_SHAPES:
        (q, k, v, do), pad, q_ids, kv_ids = _attention_inputs(b, h, s, d, torch.float32, gen, 4)
        if one_image:
            pad = torch.zeros_like(pad)
            q_ids, kv_ids = A.segment_ids(torch.zeros_like(q_ids), pad)
        scale = d**-0.5
        fwd = lambda impl: A.attention_fwd_cuda(q, k, v, q_ids, kv_ids, scale, "block", causal, impl=impl)
        o, lse = fwd("tf32x3")
        dq_k = lambda impl: A.attention_dq_cuda(q, k, v, q_ids, kv_ids, o, lse, do, scale, "block", causal, impl=impl)
        dkv_k = lambda impl, dl: A.attention_dkv_cuda(q, k, v, q_ids, kv_ids, lse, dl, do, scale, "block", causal, impl=impl)
        fwd_plain = lambda: A.attention_fwd_plain(q, k, v, q_ids, kv_ids, scale, "block", causal)
        bwd_plain = lambda: A.attention_bwd_plain(q, k, v, q_ids, kv_ids, o, lse, do, scale, "block", causal)
        o_ref, _ = fwd_plain()
        refs = bwd_plain()
        what = f"fp32 attention {(b, h, s, d)} causal={causal}"
        errs, ms = {}, {"fwd": {}, "dq": {}, "dkv": {}}
        for impl in FP32_IMPLS:
            o_impl, _ = fwd(impl)
            torch.cuda.synchronize()
            errs[f"{impl}_fwd"] = (o_impl - o_ref).abs().max().item()
            check(errs[f"{impl}_fwd"] <= _mode_tol(torch.float32, 0.0, o_ref), f"{what}: {impl} o max|diff| {errs[f'{impl}_fwd']}")
            ms["fwd"][impl] = time_ms(lambda: fwd(impl), reps=reps, inner=TIMED_LAUNCHES)
            del o_impl
        f64 = _hold_fwd_to_f64(what, o, o_ref, attention_fwd_f64(q, k, v, q_ids, kv_ids, scale, "block", causal)[0])
        for impl in FP32_IMPLS:
            dq, delta = dq_k(impl)
            dk, dv = dkv_k(impl, delta)
            torch.cuda.synchronize()
            for name, got, ref in (("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])):
                err, tol = (got - ref).abs().max().item(), _mode_tol(torch.float32, 0.0, ref)
                check(err <= tol, f"{what}: {impl} {name} max|diff| {err} > {tol}")
                errs[f"{impl}_{name}"] = err
            ms["dq"][impl] = time_ms(lambda: dq_k(impl), reps=reps, inner=TIMED_LAUNCHES)
            ms["dkv"][impl] = time_ms(lambda: dkv_k(impl, delta), reps=reps, inner=TIMED_LAUNCHES)
            del dq, dk, dv
        del o_ref, refs
        mask, pairs = _sdpa_mask_and_pairs(q_ids, kv_ids, "block", torch.float32, causal)
        n, vec, ids_bytes = b * h * s * d, b * h * s * 4, 2 * b * s * 4
        nbytes = {"fwd": 4 * n * 4 + ids_bytes + vec, "dq": 6 * n * 4 + 2 * vec + ids_bytes, "dkv": 6 * n * 4 + 2 * vec + ids_bytes}
        flops = {"fwd": 4 * h * d * pairs, "dq": 6 * h * d * pairs, "dkv": 8 * h * d * pairs}
        row = {
            "phase": "fp32_attention_times", "shape": [b, h, s, d], "mode": "block", "causal": causal,
            "allowed_pairs_share": pairs / (b * s * s), "ms": ms, "max_abs_err": errs, "fwd_f64": f64,
            "bound_tf32x3": {k_: bound(nbytes[k_], 3 * flops[k_], "tf32") for k_ in flops},
            "bound_fp32_cuda_cores": {k_: bound(nbytes[k_], flops[k_], torch.float32) for k_ in flops},
            "plain_fwd_ms": time_ms(fwd_plain, reps=3), "plain_bwd_ms": time_ms(bwd_plain, reps=3),
            "kernel_info": {f"{kernel}_{impl}": A.attention_kernel_info(kernel, impl, torch.float32, d)
                            for kernel in ("fwd", "dq", "dkv") for impl in FP32_IMPLS},
            **_sdpa_fp32_times(q, k, v, do, mask, scale),
        }
        emit(row)
        rows[(b, h, s, d)] = row
        del q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return rows


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
    fp32_times = fp32_attention_times()
    torch.cuda.empty_cache()
    cases = {
        "attention": attn,
        "attention_dq": [c["attention_dq"] for c in bwd],
        "attention_dkv": [c["attention_dkv"] for c in bwd],
        **{name: [c[name] for c in causal] for name in causal[0]},
    }
    modes, _ = phase_attention_modes(gen)
    for key, rows in modes.items():  # the main paths' shapes stay first
        cases.setdefault(key, []).extend(rows)
    torch.cuda.empty_cache()
    cases.update(_dct_cases(gen))
    for name, rows in cases.items():
        for row in rows:
            if "rate" in row and "ms" not in row:
                continue  # phase_attention_modes emitted a summary of these
            emit({"phase": "kernel_vs_plain", "kernel": name, **row})
    cases["fp32_times"] = list(fp32_times.values())  # fp32_attention_times emitted these
    return cases


def fp32_figures(rows, kernel: str) -> list:
    """One attention kernel's ("fwd", "dq" or "dkv") fp32 figures at each shape
    of fp32_attention_times' rows: ms by implementation, SDPA's fp32 time
    (the forward, or the whole backward), the bounds and the errors."""
    out = []
    for r in rows:
        tf32x3_ms, by = r["bound_tf32x3"][kernel]
        suffixes = {"fwd": ("_fwd",), "dq": ("_dq",), "dkv": ("_dk", "_dv")}[kernel]
        errs = {k: v for k, v in r["max_abs_err"].items() if k.endswith(suffixes)}
        out.append({
            "shape": r["shape"], "causal": r["causal"], "allowed_pairs_share": r["allowed_pairs_share"], "ms": r["ms"][kernel],
            "library_ms": r["library_fwd_ms" if kernel == "fwd" else "library_bwd_ms"],
            "library_backend": r["library_fwd_backend" if kernel == "fwd" else "library_bwd_backend"],
            "bound_ms": tf32x3_ms, "bound_by": by,
            "bound_fp32_cuda_cores_ms": r["bound_fp32_cuda_cores"][kernel][0],
            "plain_ms": r["plain_fwd_ms" if kernel == "fwd" else "plain_bwd_ms"], "max_abs_err": errs,
        })
    return out


# ---------------------------------------------------------------- phase 3


def smooth_images(n, size, seed):
    """Seeded smooth random RGB fields in [0, 1]: a few low-frequency waves per channel."""
    return smooth_fields([(size, size)] * n, seed)


def smooth_fields(sizes, seed):
    """smooth_images at the (h, w) of each of `sizes`."""
    rng = np.random.default_rng(seed)
    ims = []
    for h, w in sizes:
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
        im = np.full((3, h, w), 0.5)
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
    check(all(v == (n_layers if k in ("attention", "attention_dq", "attention_dkv") else 0) for k, v in per_step.items()),
          f"attention launches per step {per_step} for {n_layers} non-causal layers without dropout")
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


# ---------------------------------------------------------------- attention dropout and head dims on the paths


def phase_train_dropout_patch14l(steps=8, rows=64, rate=0.1):
    """patch14-L train steps (64 x 256, bf16, beta 0.02, random tokens) with
    the encoder's attention dropout at `rate`, beside the same steps with the
    rate at 0 from one init and the same batches: ms a step, peak GB, finite
    losses that the rate moved; the encoder's attention launches go through
    the dropout mode, the decoder's (which never drops) through the plain one."""
    import dataclasses

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T

    base = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    cfg = dataclasses.replace(base, encoder_config=dataclasses.replace(base.encoder_config, attention_dropout=rate))
    n_enc, n_dec = base.encoder_config.num_hidden_layers, base.decoder_config.num_hidden_layers
    packed = [packed_batch(base, 256, rows, 0.02, seed=300 + i) for i in range(steps)]
    batches = [T.prepare_train_batch(b)[0] for b, _ in packed]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    dropped = _train_steps(cfg, batches, sharded=False)
    torch.cuda.synchronize()
    launches = path_launches()
    plain = _train_steps(base, batches, sharded=False)
    for name in ("attention_dropout", "attention_dq_dropout", "attention_dkv_dropout"):
        check(launches[name] == steps * n_enc, f"{launches[name]} {name} launches for {steps} steps x {n_enc} encoder layers")
    for name in ("attention", "attention_dq", "attention_dkv"):
        check(launches[name] == steps * n_dec, f"{launches[name]} {name} launches for {steps} steps x {n_dec} decoder layers")
    losses = dropped[0] + plain[0]
    check(all(math.isfinite(x) for x in losses + dropped[4]), f"losses {dropped[0]} and {plain[0]}, norms {dropped[4]}")
    check(dropped[0][0] != plain[0][0], "attention dropout left the step-0 loss where it was")
    ms_drop, ms_plain = statistics.median(dropped[1][1:]), statistics.median(plain[1][1:])
    emit({
        "phase": "train_dropout_patch14l", "attention_dropout": rate, "dtype": "bfloat16 compute, float32 masters",
        "rows": rows, "seq_len": 256, "images_per_batch": [n for _, n in packed], "steps": steps,
        "losses_dropout": dropped[0], "losses_no_dropout": plain[0], "grad_norms_dropout": dropped[4],
        "ms_per_step_dropout": ms_drop, "ms_per_step_no_dropout": ms_plain, "ms_steps_dropout": dropped[1],
        "ms_steps_no_dropout": plain[1], "peak_gb_dropout": dropped[2], "peak_gb_no_dropout": plain[2],
        "launches": launches,
    })
    return launches


def phase_ar_example_head_dims(steps=20):
    """tools/train_ar_example's loop (train_ar: train, save, sample, decode) on
    the card at --hidden 192 and --hidden 64, whose 4 heads are 48 and 16 wide:
    in fp32 as the tool trains (3xTF32 on the tensor cores) and in bf16 (the
    tensor cores), a few steps each; both widths run with no pad copy."""
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.tools import train_ar_example as EX

    pipe = dt.DCTPipeline.from_pretrained(R3B, sample_patches_beta=0.02)  # bf16 tokenizer on the card
    images = smooth_images(8, 448, seed=2)
    rows = []
    for hidden, dtype in ((192, torch.float32), (64, torch.float32), (192, torch.bfloat16), (64, torch.bfloat16)):
        with tempfile.TemporaryDirectory() as out:
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            result = EX.train_ar(pipe, images, steps=steps, batch_size=8, max_len=128, hidden=hidden, out=out, seed=0,
                                 dtype=dtype, log=lambda _: None)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = path_launches()
            pad_copies = K.pad_copy_count()
        tcfg = result["model"].config.transformer
        head_dim = tcfg.hidden_size // tcfg.num_attention_heads
        what = f"AR example hidden {hidden} {str(dtype).split('.')[-1]}"
        check(head_dim == hidden // 4, f"{what}: head dim {head_dim}")
        check(pad_copies == 0, f"{what}: {pad_copies} pad copies at head dim {head_dim}")
        for name in CAUSAL_KERNELS:
            check(launches[name] == tcfg.num_hidden_layers * steps, f"{what}: {launches[name]} {name} launches")
        check_impl_launches(launches, *PATH_IMPLS["ar_example"] if dtype == torch.float32 else BF16_PATH)
        losses, img = result["losses"], result["image"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses), f"{what}: losses {losses}")
        check(img.shape == (3, 448, 448) and np.isfinite(img).all(), f"{what}: the decoded sample")
        rows.append({"hidden": hidden, "head_dim": head_dim, "dtype": str(dtype).split(".")[-1],
                     "loss_first": losses[0], "loss_last": losses[-1], "sampled_tokens": len(result["sampled_record"]["codes"]),
                     "wall_s": wall_s, "launches": {k: launches[k] for k in CAUSAL_KERNELS}, "pad_copies": pad_copies,
                     "fwd_impl": launches["fwd_impl"], "bwd_impl": launches["bwd_impl"]})
    emit({"phase": "ar_example_head_dims", "steps": steps, "runs": rows})


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


def write_image_shards(folder, n, seed=0, sizes=CLI_IMAGE_SIZES, captions=False, maxsize=16e6):
    """Tar shards of n PNG images (smooth fields, bicubic from a random 6 x 6
    grid) with json sizes, through the port's ShardWriter; image i has the
    size sizes[i % len(sizes)], key f"{i:08d}" and, with captions, the
    caption caption_of(i)."""
    from PIL import Image

    from dct_autoencoder_torch.data.shards import ShardWriter

    rng = np.random.default_rng(seed)
    with ShardWriter(os.path.join(folder, "%06d.tar"), maxsize=maxsize) as w:
        for i in range(n):
            h, wd = sizes[i % len(sizes)]
            seed_im = Image.fromarray(rng.integers(40, 216, size=(6, 6, 3), dtype=np.uint8))
            buf = io.BytesIO()
            seed_im.resize((wd, h), Image.BICUBIC).save(buf, format="PNG", compress_level=1)
            sample = {"__key__": f"{i:08d}", "png": buf.getvalue(), "json": {"height": h, "width": wd}}
            if captions:
                sample["txt"] = caption_of(i)
            w.write(sample)


def caption_of(i: int) -> str:
    return f"a smooth field, image {i}"


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


# ---------------------------------------------------------------- VQ mode and the sweep


def vq_config(path):
    """The config at `path` with only vq_type set to 'vq'."""
    import dct_autoencoder_torch as dt

    cfg = dt.DCTAutoencoderConfig.from_json_file(path)
    cfg.vq_type = "vq"
    return cfg


def _replaced_rows(state, codebook) -> dict:
    """The surgery's replaced rows of the last step, and their Adam moments."""
    replaced = state.vq_replaced
    check(replaced is not None, "the surgery step replaced no code")
    moments = state.adamw.state[codebook]
    rows = {k: moments[k][replaced] for k in ("exp_avg", "exp_avg_sq")}
    check(all(bool((v == 0).all()) for v in rows.values()), "a replaced code kept Adam moments")
    return {"replaced": int(replaced.sum()), "codebook_rows": int(replaced.numel())}


def phase_train_vq_patch14l(profile: bool = False, steps=8, expire_every=4, n_images=16, size=448):
    """patch14-L with vq_type 'vq' at random init: train steps on one 64 x 256
    packed batch (bf16 compute, fp32 masters and AdamW), k-means at step 0,
    expiry at steps 3 and 7; then encode and reconstruct_direct with it."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T

    t_phase = time.perf_counter()
    cfg = vq_config(PATCH14_L)
    n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
    model, proc = dt.get_model_and_processor(cfg, dtype=torch.bfloat16, sample_patches_beta=0.02, seed=0)
    vq = model.module.vq_model
    check((vq.heads, vq.codebook_size, vq.codebook_dim) == (16, 8192, 16), f"VQ shape {(vq.heads, vq.codebook_size)}")
    batch, n_batch_images = packed_batch(cfg)
    batch = T.prepare_train_batch(batch)[0]
    tx = T.make_optimizer(1e-4, 10000)
    state = T.TrainState.create(model.module, tx)
    step = T.make_train_step(model.module, tx, vq_expire_threshold=15.0, vq_expire_every=expire_every)
    cb0 = vq.codebook.detach().clone()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    step_ms, losses, surgery = [], [], {}
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, model.patchnorm, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(metrics[k]) for k in ("loss", "rec_loss", "commit_loss", "grad_norm")})
        check(all(math.isfinite(v) for v in losses[-1].values()), f"step {i}: a loss is not finite: {losses[-1]}")
        if i == 0:
            check(not torch.equal(vq.codebook, cb0) and bool(torch.isfinite(vq.codebook).all()),
                  "k-means at step 0 did not give a new, finite codebook")
            surgery[i] = _replaced_rows(state, vq.codebook)
        if i % expire_every == expire_every - 1:
            surgery[i] = _replaced_rows(state, vq.codebook)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches_train = path_launches()
    for name in ("attention", "attention_dq", "attention_dkv"):
        check(launches_train[name] == n_layers * steps, f"{launches_train[name]} {name} launches for {n_layers} x {steps} steps")
    stats = model.module.vq_stats()
    check(all(bool(torch.isfinite(v).all()) for v in stats.values()), "a VQ statistic is not finite")
    plain = [ms for i, ms in enumerate(step_ms) if i not in surgery]
    if profile:  # a step without surgery (step 8 with expiry every 4)
        emit({"phase": "profile_train_vq_step_patch14l", **profile_device(lambda: step(state, model.patchnorm, batch), reps=1, top=24)})

    pipe = dt.DCTPipeline(model, proc)
    ims = smooth_images(n_images, size, seed=5)
    proc.rng = random.Random(0)
    records = pipe.encode(ims)
    codes = [x for r in records for d in r["codes"] for x in d["data"]]
    check(len(codes) > 0 and 0 <= min(codes) and max(codes) < cfg.vq_codebook_size, "encoded codes out of [0, 8192)")
    before = path_launches()
    proc.rng = random.Random(0)
    direct = pipe.reconstruct_direct(ims, as_uint8=True)
    launches = path_launches()
    check(launches["idct_unpatchify"] - before["idct_unpatchify"] == 1, "reconstruct_direct did not launch the IDCT once")
    check(len(direct) == n_images and all(d.shape == (3, size, size) and d.dtype == np.uint8 for d in direct),
          "reconstruct_direct gave no uint8 images of the input size")
    emit({
        "phase": "train_vq_patch14l", "dtype": "bfloat16 compute, float32 masters", "rows": 64, "seq_len": 256,
        "images": n_batch_images, "steps": steps, "vq_expire_every": expire_every, "vq_expire_threshold": 15.0,
        "step_ms": step_ms, "ms_per_step_without_surgery_median": statistics.median(plain[1:]),
        "surgery_step_ms": {i: step_ms[i] for i in surgery}, "surgery": surgery,
        "images_per_s": n_batch_images / statistics.median(plain[1:]) * 1e3, "peak_memory_gb": peak_gb,
        "losses": losses, "launches_train": launches_train, "launches": launches,
        "encode_images": n_images, "encoded_codes": len(codes), "phase_s": time.perf_counter() - t_phase,
    })
    return launches


def phase_train_vq_r3b(n_images=16, size=448, learning_rate=3e-4):
    """VQ at r3b's widths, random init: the fp32 eval forward on the card
    against the CPU; step 0 in bf16 (gumbel on) against the fp32 CPU step;
    save_pretrained and from_pretrained on the card."""
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T
    from dct_autoencoder_torch.models.patchnorm import calibrate_patchnorm_batch

    t_phase = time.perf_counter()
    cfg = vq_config(os.path.join(R3B, "config.json"))
    ims = smooth_images(n_images, size, seed=6)
    models = {}
    for name, dtype, device in (("card", torch.float32, "cuda"), ("cpu", torch.float32, "cpu"), ("card_bf16", torch.bfloat16, "cuda")):
        model, proc = dt.get_model_and_processor(cfg, dtype=dtype, sample_patches_beta=0.02, seed=0, device=device)
        proc.rng = random.Random(0)
        batch = next(proc.iter_batches(iter([_columns(proc.preprocess_many(ims))]), batch_size=None))
        batch = T.prepare_train_batch(batch.to(model.device))[0]
        model.patchnorm, _ = calibrate_patchnorm_batch(model.patchnorm, batch)
        models[name] = (model, batch)
    outs = {k: models[k][0].forward(models[k][0].normalize_(models[k][1])) for k in ("card", "cpu")}
    valid = ~models["cpu"][1].key_pad_mask
    check(torch.equal(models["card"][1].key_pad_mask.cpu(), models["cpu"][1].key_pad_mask), "the card and the CPU packed differently")
    codes_card, codes_cpu = outs["card"]["codes"].cpu()[valid], outs["cpu"]["codes"][valid]
    agreement = float((codes_card == codes_cpu).float().mean())
    check(agreement >= MIN_VQ_CODE_AGREEMENT, f"VQ eval codes agree on {agreement:.4f} of ids, card vs CPU")

    results = {}
    for name in ("card_bf16", "cpu"):
        model, batch = models[name]
        tx = T.make_optimizer(learning_rate, 100)
        state = T.TrainState.create(model.module, tx)
        if name == "card_bf16":
            torch.cuda.synchronize()
            K.reset_launch_counts()
        state, metrics = T.make_train_step(model.module, tx)(state, model.patchnorm, batch)
        results[name] = {k: float(v) for k, v in metrics.items()}
        if name == "card_bf16":
            launches = path_launches()
    card, cpu = results["card_bf16"], results["cpu"]
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    check(all(math.isfinite(v) for v in card.values()), f"step 0 on the card: {card}")
    check(loss_rel <= MAX_TRAIN_LOSS_REL, f"VQ step-0 loss {card['loss']} vs CPU fp32 {cpu['loss']}")
    check(norm_rel <= MAX_TRAIN_GRAD_NORM_REL, f"VQ step-0 grad norm {card['grad_norm']} vs CPU fp32 {cpu['grad_norm']}")

    model, batch = models["card_bf16"]
    tmp = tempfile.mkdtemp(prefix="vq_r3b_")
    try:
        model.save_pretrained(tmp)
        check(os.path.isfile(os.path.join(tmp, "vq_stats.npz")), "save_pretrained wrote no vq_stats.npz")
        loaded = dt.DCTAutoencoder.from_pretrained(tmp, dtype=torch.bfloat16)
        check(loaded.device.type == "cuda", "from_pretrained did not load on the card")
        want, got = model.module.vq_stats(), loaded.module.vq_stats()
        check(want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want), "vq_stats changed on the way")
        same_codes = torch.equal(model.forward(model.normalize_(batch))["codes"], loaded.forward(loaded.normalize_(batch))["codes"])
        check(same_codes, "the reloaded model gives other codes")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    emit({
        "phase": "train_vq_r3b", "images": n_images, "rows": int(batch.patches.shape[0]),
        "tokens": int((~batch.key_pad_mask).sum()), "eval_code_agreement_fp32_card_vs_cpu": agreement,
        "tol_code_agreement": MIN_VQ_CODE_AGREEMENT, "step0_card_bf16": card, "step0_cpu_fp32": cpu,
        "step0_loss_rel_diff": loss_rel, "step0_grad_norm_rel_diff": norm_rel, "launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    })
    return launches


def phase_train_cli_vq_r3b(shards, steps=4, batch_size=16):
    """The CLI with a VQ config at r3b's widths on PNG shards: 8-bit moments,
    expiry every 2 steps, one checkpoint, which DCTPipeline then serves."""
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cli_vq_")
    try:
        cfg_path = os.path.join(tmp, "r3b_vq.json")
        cfg = vq_config(os.path.join(R3B, "config.json"))
        cfg.to_json_file(cfg_path)
        n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
        flags = dict(image_dataset_path_or_url=shards, model_config_path=cfg_path, dtype="bfloat16", epochs=100,
                     batch_size=batch_size, max_iters=steps, train_norm_iters=2, log_every=1, opt_8bit=True,
                     vq_expire_every=2, save_every=1000, out_base=os.path.join(tmp, "out"))
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        _, _, text = _run_cli(flags, (1, 2))
        train_s = time.perf_counter() - t0
        launches = path_launches()
        (out_dir,) = [os.path.join(tmp, "out", d) for d in os.listdir(os.path.join(tmp, "out"))]
        lines = [json.loads(x) for x in open(os.path.join(out_dir, "metrics.jsonl"))]
        step_lines = [d for d in lines if "loss" in d]
        check([d["step"] for d in step_lines] == list(range(steps)), f"logged steps {[d['step'] for d in step_lines]}")
        check(all(math.isfinite(d[k]) for d in step_lines for k in ("loss", "commit_loss", "grad_norm")),
              "a logged loss of the VQ CLI run is not finite")
        check(os.path.isfile(os.path.join(out_dir, "model", "vq_stats.npz")), "the checkpoint holds no vq_stats.npz")
        check(launches["dct_patchify"] > 0, "the VQ CLI's data path launched no DCT kernel")
        for name in ("attention_dq", "attention_dkv"):
            check(launches[name] == n_layers * steps, f"{launches[name]} {name} launches for {n_layers} x {steps} steps")
        served = dt.DCTPipeline.from_pretrained(os.path.join(out_dir, "model"))
        check(served.model.device.type == "cuda" and served.model.config.vq_type == "vq", "the VQ checkpoint did not load")
        recs = served.encode(smooth_images(2, 448, seed=7))
        codes = [x for r in recs for d in r["codes"] for x in d["data"]]
        check(len(codes) > 0 and max(codes) < cfg.vq_codebook_size and min(codes) >= 0, "the VQ checkpoint encoded badly")
        emit({
            "phase": "train_cli_vq_r3b", "steps": steps, "batch_size": batch_size,
            "flags": {k: v for k, v in flags.items() if k not in ("image_dataset_path_or_url", "model_config_path", "out_base")},
            "loss": [d["loss"] for d in step_lines], "commit_loss": [d["commit_loss"] for d in step_lines],
            "images_per_step": [d["images_per_batch"] for d in step_lines], "train_s": train_s,
            "launches": launches, "phase_s": time.perf_counter() - t_phase,
        })
        return launches
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def vq_and_sweep_shards(n=48) -> str:
    """A temporary directory of PNG tar shards (write_image_shards: the CLI
    phase's sizes) for the VQ CLI and sweep phases."""
    import tempfile

    folder = tempfile.mkdtemp(prefix="vq_sweep_shards_")
    write_image_shards(folder, n, seed=1)
    return folder


def phase_sweep_small_448(shards, trials=5, max_iters=6, batch_size=4):
    """train/sweep.py run_onchip with conf/small-448.json (the JAX function's
    default) over the shards, as `--onchip` runs it: fp32, both methods,
    `trials` trials each, more than TPE's random start-up trials so that
    its own suggestion runs.  The whole campaign runs under torch.profiler
    (s_per_trial included) and the line adds its device time by kernel, per
    step of a trial (the set-up's one calibration step included)."""
    import tempfile

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.train import sweep

    n_startup = sweep.TPESuggester(sweep.DEFAULT_SPACE, random.Random(0)).n_startup
    check(trials > n_startup, f"{trials} trials never reach TPE's suggestion (after {n_startup} start-up trials)")
    t_phase = time.perf_counter()
    out_file = os.path.join(tempfile.mkdtemp(prefix="sweep_"), "trials.jsonl")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    logs = []
    # the device's activity alone: the breakdown reads kernels only, and the host's
    # events of 60 steps took over a minute to aggregate (PR 17's timed run)
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        results = sweep.run_onchip(shards, model_config_path=SMALL_448, trials=trials, max_iters=max_iters,
                                   batch_size=batch_size, score_last=2, calib_steps=1, out_file=out_file, log=logs.append)
        torch.cuda.synchronize()
    launches = path_launches()
    recs = [json.loads(x) for x in open(out_file)]
    os.remove(out_file)
    check(len(recs) == 2 * trials and {r["method"] for r in recs} == {"tpe", "random"}, f"{len(recs)} sweep records")
    check(all(math.isfinite(r["rec_loss"]) and math.isfinite(r["loss"]) for r in recs), "a sweep score is not finite")
    tpe, rnd = ([r["hp"] for r in recs if r["method"] == m] for m in ("tpe", "random"))
    # the start-up trials are the random draws of the same seed; then TPE suggests its own
    check(tpe[:n_startup] == rnd[:n_startup] and tpe[n_startup] != rnd[n_startup], "TPE's suggestion did not run")
    check(launches["dct_patchify"] > 0, "the sweep's data path launched no DCT kernel")
    check(launches["attention_dq"] > 0 and launches["attention_dkv"] > 0, "the sweep's trials launched no backward kernel")
    emit({
        "phase": "sweep_small_448", "trials_per_method": trials, "max_iters": max_iters, "batch_size": batch_size,
        "dtype": "float32", "records": [{k: r[k] for k in ("method", "trial", "rec_loss", "loss", "wall_s", "hp")} for r in recs],
        "s_per_trial": statistics.mean(r["wall_s"] for r in recs),
        "best": {m: results[m]["rec_loss"] for m in ("tpe", "random")}, "data_log": [x for x in logs if "sweep data" in x],
        "device_per_step": _device_by_kernel(prof, 2 * trials * max_iters),
        "launches": launches, "phase_s": time.perf_counter() - t_phase,
    })
    return launches


def _device_by_kernel(prof, steps: int, top: int = 12) -> dict:
    """Device ms a step by kernel from a profiler run over `steps` steps, the
    attention kernels' share of it, and the top kernels."""
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count / steps) for e in device_rows(prof)),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    check(busy > 0, "the profiler saw no device time")
    as_dict = lambda r: {"kernel": r[0][:120], "ms_per_step": r[1], "launches_per_step": r[2]}
    attn = [r for r in rows if "attn_" in r[0]]
    return {"steps": steps, "device_ms_per_step": busy, "attention_ms_per_step": sum(r[1] for r in attn),
            "attention_share": sum(r[1] for r in attn) / busy, "attention_kernels": [as_dict(r) for r in attn],
            "top_kernels": [as_dict(r) for r in rows[:top]]}


# ---------------------------------------------------------------- the offline tools


# the AR dump's images: 336-768 px, all above the data path's resolution floor and within its cap
AR_IMAGE_SIZES = [(336, 336), (448, 448), (336, 448), (448, 336), (384, 384), (384, 512), (512, 384), (768, 576),
                  (576, 768), (336, 384), (768, 768), (448, 608)]
# tools/eval.py on r3b, fp32 on the card against fp32 on the CPU
MAX_EVAL_PSNR_DELTA_DB = 0.2
MAX_EVAL_PERPLEXITY_REL = 0.02
# diagnose's printed PSNR on the card against the CPU's; testpipe's printed statistics (3 decimals)
MAX_DIAGNOSE_PSNR_DELTA_DB = 0.1
MAX_TESTPIPE_STAT_DELTA = 1e-3
# a decode_gif frame from the card against the same frame from the CPU's plain path
MIN_GIF_FRAME_PSNR_DB = 40.0


class Recorder:
    """Wraps the attribute `name` of obj (a module function, a method or a
    classmethod) while in use: each call's arguments, result and wall
    seconds (after a synchronize), in call order."""

    def __init__(self, obj, name):
        import inspect

        self.obj, self.name = obj, name
        self.raw = inspect.getattr_static(obj, name)
        self.calls, self.results, self.seconds = [], [], []

    def __enter__(self):
        orig = getattr(self.obj, self.name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.calls.append((args, kwargs))
            self.results.append(out)
            return out

        setattr(self.obj, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.raw)


def _quiet(fn):
    """(fn(), what it printed); the printout goes to stderr if fn raises."""
    import contextlib

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = fn()
    except BaseException:
        print(out.getvalue()[-6000:], file=sys.stderr)
        raise
    return result, out.getvalue()


def write_pngs(folder, images) -> list:
    """(c, h, w) float images in [0, 1] -> PNG files; their paths."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    paths = []
    for i, im in enumerate(images):
        path = os.path.join(folder, f"im{i:03d}.png")
        Image.fromarray((np.clip(im, 0, 1).transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)).save(path)
        paths.append(path)
    return paths


def _pngs_from_shards(url, folder, n) -> list:
    """The first n PNG members of the tar shards matching url, written to folder as files."""
    import glob
    import tarfile

    os.makedirs(folder, exist_ok=True)
    paths = []
    for shard in sorted(glob.glob(url)):
        with tarfile.open(shard) as tar:
            for member in tar:
                if member.name.endswith(".png") and len(paths) < n:
                    path = os.path.join(folder, member.name)
                    with open(path, "wb") as f:
                        f.write(tar.extractfile(member).read())
                    paths.append(path)
    return paths


def phase_tools_prepare_ar_patch14l(n_images=64, batch_size=32, beta=0.01, n_eval=16):
    """tools/prepare_autoregressive_dataset.py at the full width of patch14-L
    (random init, saved with save_pretrained, bf16 on the card, JAX's
    defaults) over PNG shards with captions: one process under the
    profiler, then two processes; then tools/eval.py on the same checkpoint
    over 16 of the images at 448, and every record decoded on the card by
    eval's pipeline."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.data.shards import WebDatasetReader
    from dct_autoencoder_torch.tools import eval as tool_eval
    from dct_autoencoder_torch.tools import prepare_autoregressive_dataset as tool_ar

    t_phase = time.perf_counter()
    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="tools_ar_")
    try:
        model_dir = os.path.join(tmp, "model")
        (_, save_s) = _timed(lambda: dt.DCTAutoencoder(cfg, device="cpu", seed=0).save_pretrained(model_dir))
        write_image_shards(os.path.join(tmp, "raw"), n_images, seed=5, sizes=AR_IMAGE_SIZES, captions=True, maxsize=4e6)
        url = os.path.join(tmp, "raw", "*.tar")
        n_shards = len(os.listdir(os.path.join(tmp, "raw")))
        check(n_shards >= 2, f"{n_shards} input shard: two processes need two")
        flags = dict(image_dataset_path_or_url=url, model_load_path=model_dir, batch_size=batch_size,
                     sample_patches_beta=beta)

        # one process, under the profiler from the end of the model's load
        # to the end of the dump: the device-busy share of the dump itself
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        load = {}
        real_load = tool_ar.get_model_and_processor

        def load_then_profile(*args, **kwargs):
            t0 = time.perf_counter()
            out = real_load(*args, **kwargs)
            torch.cuda.synchronize()
            load.update(s=time.perf_counter() - t0, model=out[0])
            prof.start()
            return out

        tool_ar.get_model_and_processor = load_then_profile
        try:
            K.reset_launch_counts()
            (written, text), wall = _timed(lambda: _quiet(lambda: tool_ar.main(output_dir=os.path.join(tmp, "tok1"), **flags)))
        finally:
            tool_ar.get_model_and_processor = real_load
            if "s" in load:
                prof.stop()
        launches = path_launches()
        load_s, model = load.pop("s"), load.pop("model")
        check(model.dtype == torch.bfloat16 and model.device.type == "cuda", f"the dump ran {model.dtype} on {model.device}")
        del model
        rows = device_rows(prof)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        check(busy_ms > 0, "the profiler saw no device time in the dump")
        top = [{"kernel": e.key[:100], "ms": e.self_device_time_total / 1e3, "launches": e.count}
               for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]]
        dump_s = wall - load_s

        recs = [(smp["__key__"], smp["json"]) for smp in WebDatasetReader(os.path.join(tmp, "tok1"))]
        check(written == len(recs) == n_images, f"{written} records written, {len(recs)} read, {n_images} images")
        check(sorted(os.listdir(os.path.join(tmp, "tok1"))) == ["h000-000000.tar"], "the dump's output shards")
        check([k for k, _ in recs] == [f"{i:08d}" for i in range(n_images)], "records are not in key order")
        check(all(r["caption"] == caption_of(int(k)) for k, r in recs), "a record carries another image's caption")
        for key, r in recs:
            emb = r["image_embedding"]
            check(set(emb) == {"size", "original_size", "codes"} and emb["codes"], f"record {key}: {sorted(emb)}")
            check(all(set(c) == {"c", "h", "w", "data"} and len(c["data"]) == cfg.vq_num_codebooks for c in emb["codes"]),
                  f"record {key}: a code entry of another schema")
            check(all(0 <= x < cfg.vq_codebook_size for c in emb["codes"] for x in c["data"]), f"record {key}: code out of range")
            check(tuple(emb["original_size"]) == AR_IMAGE_SIZES[int(key) % len(AR_IMAGE_SIZES)], f"record {key}: size")
        n_tokens = sum(len(r["image_embedding"]["codes"]) for _, r in recs)
        check(launches["dct_patchify"] == n_images, f"{launches['dct_patchify']} DCT launches for {n_images} images")
        check(launches["attention"] > 0 and launches["attention"] % n_layers == 0, f"attention launches {launches}")
        check(launches["attention_dq"] == launches["attention_dkv"] == launches["idct_unpatchify"] == 0,
              f"the dump ran a backward or IDCT kernel: {launches}")

        # two processes, each owning every other input shard: the same keys, split
        parts, walls2 = [], []
        for index in range(2):
            out_dir = os.path.join(tmp, "tok2")
            (n_part, _), w = _timed(lambda: _quiet(lambda: tool_ar.main(
                output_dir=out_dir, process_index=index, process_count=2, **flags)))
            part = [smp["__key__"] for smp in WebDatasetReader(os.path.join(out_dir, f"h{index:03d}-000000.tar"))]
            check(n_part == len(part) > 0, f"process {index} wrote {n_part} records, {len(part)} read")
            parts.append(set(part))
            walls2.append(w)
        check(not parts[0] & parts[1] and sorted(parts[0] | parts[1]) == [k for k, _ in recs],
              "two processes did not split the one process's keys")

        # tools/eval.py on the same checkpoint over 16 of the images at 448
        paths = _pngs_from_shards(url, os.path.join(tmp, "eval_images"), n_eval)
        check(len(paths) == n_eval, f"{len(paths)} eval images")
        with Recorder(dt.DCTPipeline, "from_pretrained") as built, Recorder(tool_eval, "evaluate_checkpoint") as ev:
            K.reset_launch_counts()
            (rows, _), eval_wall = _timed(lambda: _quiet(lambda: tool_eval.main(
                checkpoint=model_dir, images=",".join(paths), resize=448)))
        eval_launches = path_launches()
        check(len(rows) == 1 and len(built.calls) == 1 and built.calls[0][1]["dtype"] == torch.bfloat16,
              "eval built other than one bf16 pipeline")
        row = rows[0]
        check(math.isfinite(row["psnr"]) and row["n_tokens"] > 0 and row["perplexity"] >= 1.0, f"eval row {row}")
        check(eval_launches["idct_unpatchify"] == n_eval and eval_launches["dct_patchify"] >= 1, f"eval launches {eval_launches}")

        # every record decodes on the card to an image of its original size, through eval's pipeline
        pipe, eval_load_s = built.results[0], built.seconds[0]
        decoded, decode_s = _timed(lambda: pipe.decode([r["image_embedding"] for _, r in recs]))
        check(all(im.shape == (3, *r["image_embedding"]["original_size"]) and np.isfinite(im).all()
                  for im, (_, r) in zip(decoded, recs)), "a record did not decode to its original size")
        del pipe, decoded, built
        emit({
            "phase": "tools_prepare_ar_patch14l", "config": "conf/patch14-l.json (random init, saved and loaded)",
            "dtype": "bfloat16", "images": n_images, "input_shards": n_shards, "image_sizes": AR_IMAGE_SIZES,
            "batch_size": batch_size, "sample_patches_beta": beta, "tokens": n_tokens,
            "records_per_s": n_images / dump_s, "dump_s_without_load": dump_s, "wall_s": wall, "model_load_s": load_s,
            "save_pretrained_s": save_s, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / (dump_s * 1e3),
            "top_device_kernels": top,
            "profiled": "the one-process dump, from the end of the model's load, under torch.profiler (CPU and CUDA)",
            "two_process_wall_s": walls2, "two_process_keys": [len(p) for p in parts],
            "decode_s": decode_s, "launches": launches,
            "eval": {"images": n_eval, "resize": 448, "row": row, "s_per_checkpoint": ev.seconds[0],
                     "images_per_s": n_eval / ev.seconds[0], "wall_s": eval_wall, "load_s": eval_load_s,
                     "launches": eval_launches},
            "card": _card(), "phase_s": time.perf_counter() - t_phase,
        })
        return launches, eval_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_tools_eval_r3b(n_images=8, size=448):
    """tools/eval.py on r3b (the float checkpoint, fp32) on the card and on
    the CPU; then --scan over r3b as ckpt_000001 and as model: two equal
    rows, one DCTPipeline, no kernel built again."""
    import shutil
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.kernels import _build
    from dct_autoencoder_torch.tools import eval as tool_eval

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tools_eval_")
    try:
        images = ",".join(write_pngs(os.path.join(tmp, "images"), smooth_images(n_images, size, seed=11)))
        flags = dict(images=images, resize=size, dtype="float32")
        with Recorder(dt.DCTPipeline, "encode") as enc:
            K.reset_launch_counts()
            (card_rows, _), card_s = _timed(lambda: _quiet(lambda: tool_eval.main(checkpoint=R3B, **flags)))
            launches = path_launches()
            (cpu_rows, _), cpu_s = _timed(lambda: _quiet(lambda: tool_eval.main(checkpoint=R3B, device="cpu", **flags)))
        card, cpu = card_rows[0], cpu_rows[0]
        agree = code_agreement(enc.results[0], enc.results[1])
        check(agree >= MIN_CODE_AGREEMENT, f"eval codes card vs CPU {agree} < {MIN_CODE_AGREEMENT}")
        check(card["n_tokens"] == cpu["n_tokens"], f"n_tokens {card['n_tokens']} vs CPU {cpu['n_tokens']}")
        check(abs(card["psnr"] - cpu["psnr"]) <= MAX_EVAL_PSNR_DELTA_DB, f"eval PSNR {card['psnr']} vs CPU {cpu['psnr']}")
        ppl_rel = abs(card["perplexity"] - cpu["perplexity"]) / cpu["perplexity"]
        check(ppl_rel <= MAX_EVAL_PERPLEXITY_REL, f"perplexity {card['perplexity']} vs CPU {cpu['perplexity']}")
        check(launches["idct_unpatchify"] == n_images and launches["dct_patchify"] >= 1, f"eval launches {launches}")

        scan = os.path.join(tmp, "run")
        for name in ("ckpt_000001", "model"):
            shutil.copytree(R3B, os.path.join(scan, name))
        with Recorder(dt.DCTPipeline, "from_pretrained") as built, Recorder(_build, "_start") as nvcc, \
                Recorder(tool_eval, "evaluate_checkpoint") as ev:
            K.reset_launch_counts()
            (rows, _), scan_s = _timed(lambda: _quiet(lambda: tool_eval.main(scan=scan, **flags)))
            scan_launches = path_launches()
        check([r["step"] for r in rows] == ["ckpt_000001", "model"], f"scan rows {[r['step'] for r in rows]}")
        check(len(built.calls) == 1, f"the scan built {len(built.calls)} pipelines")
        check(all(p is None for p in nvcc.results), "the scan built a kernel again")
        a, b = rows
        check(a["n_tokens"] == b["n_tokens"] and a["perplexity"] == b["perplexity"] and abs(a["psnr"] - b["psnr"]) <= 1e-4,
              f"the same weights gave two rows {a} and {b}")
        with open(os.path.join(scan, "eval.jsonl")) as f:
            check([json.loads(x) for x in f] == rows, "eval.jsonl holds other rows than the scan printed")
        emit({
            "phase": "tools_eval_r3b", "images": n_images, "size": size, "dtype": "float32 (the 3xTF32 attention forward)",
            "card": card, "cpu": cpu, "code_agreement_vs_cpu": agree, "psnr_delta_db": card["psnr"] - cpu["psnr"],
            "perplexity_rel_delta": ppl_rel, "card_wall_s": card_s, "cpu_wall_s": cpu_s,
            "scan": {"rows": rows, "s_per_checkpoint": ev.seconds, "wall_s": scan_s, "pipelines_built": len(built.calls),
                     "nvcc_started": sum(p is not None for p in nvcc.results), "launches": scan_launches},
            "limits": {"code_agreement": MIN_CODE_AGREEMENT, "psnr_db": MAX_EVAL_PSNR_DELTA_DB,
                       "perplexity_rel": MAX_EVAL_PERPLEXITY_REL},
            "launches": launches, "card_name": _card(), "phase_s": time.perf_counter() - t_phase,
        })
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _psnr_lines(text) -> list:
    import re

    return [float(x) for x in re.findall(r"PSNR ([-+\d.]+) dB", text)]


def _numbers(text) -> list:
    import re

    return [float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", text)]


def phase_tools_demos_r3b(n_frames=8, size=448, n_images=4, n_diagnose=2):
    """decode_gif and diagnose on r3b (fp32: the 3xTF32 attention forward)
    and testpipe (no model), each on the card against the CPU."""
    import shutil
    import tempfile

    from PIL import Image

    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.tools import decode_gif as tool_gif
    from dct_autoencoder_torch.tools import diagnose as tool_diagnose
    from dct_autoencoder_torch.tools import testpipe as tool_testpipe

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tools_demos_")
    launches = {}
    try:
        paths = write_pngs(os.path.join(tmp, "images"), smooth_images(n_images, size, seed=13))
        original = np.asarray(Image.open(paths[0]), np.float32) / 255.0  # (h, w, 3)

        # decode_gif: the coarse-to-fine frames; frame 8 on the card against the CPU's
        frames = {}
        for device in ("cuda", "cpu"):
            K.reset_launch_counts()
            # on the CPU one frame, from every token: the card's last frame
            count = n_frames if device == "cuda" else 1
            (out, _), frames[device + "_s"] = _timed(lambda: _quiet(lambda: tool_gif.main(
                image=paths[0], model_load_path=R3B, out_file=os.path.join(tmp, f"{device}.gif"), n_frames=count,
                max_side=size, device=device)))
            frames[device] = [np.asarray(f, np.float32)[:, size:] / 255.0 for f in out]
            if device == "cuda":
                launches["tools_decode_gif"] = path_launches()
        gif = Image.open(os.path.join(tmp, "cuda.gif"))
        check(getattr(gif, "n_frames", 1) == n_frames, f"the GIF has {getattr(gif, 'n_frames', 1)} frames")
        frame_psnr = [psnr(f, original) for f in frames["cuda"]]
        check(frame_psnr[-1] > frame_psnr[0], f"frame PSNR does not rise: {frame_psnr}")
        card_vs_cpu = psnr(frames["cuda"][-1], frames["cpu"][-1])
        check(card_vs_cpu > MIN_GIF_FRAME_PSNR_DB, f"frame {n_frames}, card vs CPU: {card_vs_cpu} dB")
        gl = launches["tools_decode_gif"]
        check(gl["dct_patchify"] == 1 and gl["idct_unpatchify"] == n_frames, f"decode_gif launches {gl}")

        # diagnose: its printed PSNR on the card within 0.1 dB of the CPU's
        text = {}
        for device in ("cuda", "cpu"):
            K.reset_launch_counts()
            _, text[device] = _quiet(lambda: tool_diagnose.main(
                model_load_path=R3B, image_dir=os.path.dirname(paths[0]), n_images=n_diagnose,
                out_file=os.path.join(tmp, f"diagnose_{device}.png"), device=device))
            if device == "cuda":
                launches["tools_diagnose"] = path_launches()
        diag = {d: _psnr_lines(t) for d, t in text.items()}
        check(len(diag["cuda"]) == len(diag["cpu"]) == n_diagnose, f"diagnose printed {diag}")
        diag_delta = max(abs(a - b) for a, b in zip(diag["cuda"], diag["cpu"]))
        check(diag_delta <= MAX_DIAGNOSE_PSNR_DELTA_DB, f"diagnose PSNR card {diag['cuda']} vs CPU {diag['cpu']}")

        # testpipe: no model; junk.png written, the statistics equal the CPU's to the printed digits
        tp = {}
        for device in ("cuda", "cpu"):
            K.reset_launch_counts()
            out_file = os.path.join(tmp, f"junk_{device}.png")
            _, tp[device] = _quiet(lambda: tool_testpipe.main(image_dir=os.path.dirname(paths[0]), out_file=out_file,
                                                               device=device))
            check(os.path.isfile(out_file), f"testpipe wrote no {out_file}")
            if device == "cuda":
                launches["tools_testpipe"] = path_launches()
        stat_lines = {d: [x for x in t.splitlines() if x.startswith("std ")] for d, t in tp.items()}
        stats = {d: _numbers(lines[0]) for d, lines in stat_lines.items()}
        stat_delta = max(abs(a - b) for a, b in zip(stats["cuda"], stats["cpu"]))
        check(len(stats["cuda"]) == 4 and stat_delta <= MAX_TESTPIPE_STAT_DELTA + 1e-9,
              f"testpipe statistics card {stat_lines['cuda']} vs CPU {stat_lines['cpu']}")
        check(_numbers(tp["cuda"].split("std ")[0]) == _numbers(tp["cpu"].split("std ")[0]),
              "testpipe's token counts differ between the card and the CPU")
        tl = launches["tools_testpipe"]
        check(tl["dct_patchify"] == n_images and tl["idct_unpatchify"] == 1 and tl["attention"] == 0,
              f"testpipe launches {tl}")
        emit({
            "phase": "tools_demos_r3b", "dtype": "float32 (the 3xTF32 attention forward)",
            "decode_gif": {"frames": n_frames, "size": size, "frame_psnr_db": frame_psnr,
                           "frame_card_vs_cpu_psnr_db": card_vs_cpu, "card_s": frames["cuda_s"], "cpu_s": frames["cpu_s"],
                           "launches": launches["tools_decode_gif"]},
            "diagnose": {"images": n_diagnose, "psnr_db": diag, "max_delta_db": diag_delta,
                         "launches": launches["tools_diagnose"]},
            "testpipe": {"images": n_images, "stats": stats, "max_delta": stat_delta,
                         "launches": launches["tools_testpipe"]},
            "limits": {"gif_frame_psnr_db": MIN_GIF_FRAME_PSNR_DB, "diagnose_psnr_db": MAX_DIAGNOSE_PSNR_DELTA_DB,
                       "testpipe_stat": MAX_TESTPIPE_STAT_DELTA},
            "card": _card(), "phase_s": time.perf_counter() - t_phase,
        })
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


INT8_STUDY_DYNAMIC = ("dynamic", "dynamic_last1_bf16", "dynamic_last2_bf16", "dynamic_first2_bf16", "dynamic_g128",
                      "dynamic_g128_first2_bf16")


def phase_int8_study_patch14l():
    """tools/int8_study.py at its defaults: patch14-L at random init, bf16,
    synthetic 16 x 256 packed patches, seed 0, no --per_layer."""
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.tools import int8_study

    t_phase = time.perf_counter()
    K.reset_launch_counts()
    (lines, text), wall = _timed(lambda: _quiet(lambda: int8_study.main([])))
    launches = path_launches()
    names = [x["variant"] for x in lines]
    check(len(lines) == 10 and set(INT8_STUDY_DYNAMIC) <= set(names), f"the study's variants: {names}")
    for x in lines:
        check(0.0 <= x["token_agreement"] <= 1.0, f"agreement {x}")
        check((x["int_mm_calls"] > 0) == (x["variant"] in INT8_STUDY_DYNAMIC), f"torch._int_mm calls of {x}")
    emit({
        "phase": "int8_study_patch14l", "config": "conf/patch14-l.json, random init, bfloat16, 16 x 256, seed 0",
        "header": text.splitlines()[0], "variants": lines, "wall_s": wall, "launches": launches,
        "card": _card(), "phase_s": time.perf_counter() - t_phase,
    })
    return launches


def phase_native_packing(n_images=1000, beta=0.02, max_seq_len=256, reps=5):
    """patches/native.py (ext/packing.cpp, built with g++) against the port's
    numpy packing, bit for bit, on the token counts of 1,000 images at
    patch14-L's patch size; host ms of each path."""
    from dct_autoencoder_torch.models.config import DCTAutoencoderConfig
    from dct_autoencoder_torch.patches import native
    from dct_autoencoder_torch.patches.packing import build_attn_mask, fill_batch, group_patches_by_max_seq_len

    t_phase = time.perf_counter()
    available, build_s = _timed(native.available)
    check(available, "the native packing library did not build or load")
    pz = DCTAutoencoderConfig.from_json_file(PATCH14_L).patch_dim
    rng, nprng = random.Random(0), np.random.default_rng(0)
    lengths = np.asarray([min(max(1, round(-1.0 / beta * math.log(rng.random()))), max_seq_len) for _ in range(n_images)])
    items = [(nprng.standard_normal((k, pz)).astype(np.float32), nprng.integers(0, 32, (k, 2)).astype(np.int32),
              nprng.integers(0, 3, (k,)).astype(np.int32)) for k in lengths]
    cat = [np.concatenate([it[j] for it in items]) for j in range(3)]

    def numpy_groups():
        state = group_patches_by_max_seq_len(items, max_seq_len)
        return state.groups + ([state.group] if state.group else [])

    def run_native():
        n_rows, row_ids, slots, offsets = native.greedy_pack(lengths, max_seq_len)
        return native.fill_batch(*cat, lengths, row_ids, slots, offsets, n_rows, max_seq_len)

    def host_ms(fn):
        out = fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    (n_rows, row_ids, _, _), greedy_ms = host_ms(lambda: native.greedy_pack(lengths, max_seq_len))
    groups, grouping_ms = host_ms(numpy_groups)
    check(n_rows == len(groups) and [int(lengths[row_ids == r].sum()) for r in range(n_rows)]
          == [sum(p.shape[0] for p, _, _ in g) for g in groups], "greedy_pack placed the images otherwise than numpy")
    got, native_ms = host_ms(run_native)
    want, numpy_ms = host_ms(lambda: fill_batch(numpy_groups(), max_seq_len, pz))
    for name, a, b in zip(("patches", "positions", "channels", "image_ids", "key_pad_mask"), got, want):
        check(a.dtype == b.dtype and np.array_equal(a, b), f"native fill_batch's {name} differs from numpy's")
    ids, pad = want[3], want[4]
    mask, mask_native_ms = host_ms(lambda: native.build_attn_mask(ids, pad))
    ref, mask_numpy_ms = host_ms(lambda: build_attn_mask(ids, pad))
    check(np.array_equal(mask, ref), "native build_attn_mask differs from numpy's")
    emit({
        "phase": "native_packing", "images": n_images, "tokens": int(lengths.sum()), "rows": n_rows,
        "max_seq_len": max_seq_len, "patch_dim": pz, "sample_patches_beta": beta, "library": native.lib_path(),
        "build_or_load_s": build_s, "card": _card(),
        "host_ms": {"greedy_pack_native": greedy_ms, "greedy_pack_numpy_grouping": grouping_ms,
                    "pack_and_fill_native": native_ms, "group_and_fill_numpy": numpy_ms,
                    "attn_mask_native": mask_native_ms, "attn_mask_numpy": mask_numpy_ms},
        "phase_s": time.perf_counter() - t_phase,
    })


# ---------------------------------------------------------------- the CLIP warm start and the reference tools


# openai/clip-vit-large-patch14's vision tower at its published widths
CLIP_L_VISION = dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
                     layer_norm_eps=1e-5, hidden_act="quick_gelu")
# parity_vs_reference's round trip, card against CPU: the same PSNR to this
MAX_PARITY_PSNR_DELTA_DB = 0.01


def _pipeline_of(model, sample_patches_beta=0.02):
    """A DCTPipeline around `model` with the processor that from_pretrained would give it."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.models.factory import get_max_seq_length

    cfg = model.config
    proc = dt.DCTAutoencoderFeatureExtractor(
        channels=cfg.image_channels, patch_size=cfg.patch_size, sample_patches_beta=sample_patches_beta,
        max_patch_h=cfg.max_patch_h, max_patch_w=cfg.max_patch_w,
        max_seq_len=get_max_seq_length(cfg, sample_patches_beta), device=model.device,
    )
    return dt.DCTPipeline(model, proc)


def _roundtrip_launches(pipe, ims):
    """(records, reconstructions, launches, wall ms) of one encode + decode of
    `ims` on the card, with the token budget reseeded."""
    from dct_autoencoder_torch import kernels as K

    def run():
        pipe.processor.rng = random.Random(0)
        records = pipe.encode(ims)
        return records, pipe.decode(records)

    K.reset_launch_counts()
    (records, recon), wall_s = _timed(run)
    return records, recon, path_launches(), wall_s * 1e3


def _check_roundtrip(what, launches, recon, ims, cfg, mode):
    """encode's one forward (both stacks) and decode's decoder stack and IDCT
    once a record, every attention launch in `mode`."""
    n_dec = cfg.decoder_config.num_hidden_layers
    want = cfg.encoder_config.num_hidden_layers + n_dec + n_dec * len(ims)
    other = "block" if mode == "bias" else "bias"
    check(launches["fwd_mode"][mode] == want and launches["fwd_mode"][other] == 0,
          f"{what}: attention forward launches by mask mode {launches['fwd_mode']}, want {want} in {mode!r}")
    check(launches["attention"] == want and launches["dct_patchify"] >= 1 and launches["idct_unpatchify"] == len(ims),
          f"{what} launches {launches}")
    check(all(launches[k] == 0 for k in BWD_KERNELS), f"{what} ran a backward kernel: {launches}")
    check(len(recon) == len(ims) and all(r.shape == im.shape and np.isfinite(r).all() for r, im in zip(recon, ims)),
          f"{what}: reconstructions have the wrong shape or are not finite")


def _system_exit_message(fn) -> "str | None":
    """The message of the SystemExit that fn() raises, None if it returns."""
    try:
        fn()
    except SystemExit as e:
        return str(e)
    return None


def phase_tools_warm_start_patch14l(n_images=16, size=448):
    """tools/copy_clip_into.py at the full width of patch14-L: a random-init
    stand-in of CLIP-L/14's vision tower at its published widths (24 layers;
    plain torch.nn modules with HF's attribute names, since this machine may
    have no transformers) transplanted into patch14-L's 8 + 8 layers on the
    card, every transplanted tensor equal to its source bit for bit;
    save_pretrained and from_pretrained give the same bits; then one encode
    + decode of 16 448 x 448 images in bf16 (attention in 'block' mode).
    Without transformers, the tool's main must raise SystemExit naming it;
    with it, main warm-starts from a CLIPVisionModel directory.  Returns the
    path's launches and its pipeline (for the next phase's timing)."""
    import importlib.util

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.tools import copy_clip_into as CC

    t_phase = time.perf_counter()
    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    n_enc, n_dec = cfg.encoder_config.num_hidden_layers, cfg.decoder_config.num_hidden_layers
    widths = {k: CLIP_L_VISION[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "layer_norm_eps")}
    clip, standin_s = _timed(lambda: CC.clip_vision_standin(**widths, seed=0))
    model = dt.DCTAutoencoder(cfg, dtype=torch.bfloat16, seed=0)
    _, transplant_s = _timed(lambda: CC.transplant(model, clip))
    src = clip.vision_model.encoder.layers
    pairs = [(f"{side}.layers.{i}.{name}", t) for side, first, n in (("encoder", 0, n_enc), ("decoder", n_enc, n_dec))
             for i in range(n) for name, t in CC.layer_tensors(src[first + i]).items()]
    params = dict(model.module.named_parameters())
    differ = [k for k, t in pairs if not torch.equal(params[k].detach().cpu(), t)]
    check(len(pairs) == 16 * (n_enc + n_dec) and not differ, f"{len(differ)} of {len(pairs)} transplanted tensors differ: {differ[:4]}")
    del clip, src

    with tempfile.TemporaryDirectory(prefix="warm_start_") as d:
        _, save_s = _timed(lambda: model.save_pretrained(d))
        back, load_s = _timed(lambda: dt.DCTAutoencoder.from_pretrained(d, dtype=torch.bfloat16))
        sd, sd_back = model.module.state_dict(), back.module.state_dict()
        check(sd.keys() == sd_back.keys() and all(torch.equal(sd[k], sd_back[k]) for k in sd),
              "save_pretrained / from_pretrained changed the warm-started weights")
        del model, sd, sd_back
        if importlib.util.find_spec("transformers") is None:
            message = _system_exit_message(lambda: CC.main(PATCH14_L, output_path=os.path.join(d, "main")))
            check(message is not None and "transformers" in message, f"copy_clip_into.main without transformers: {message!r}")
            main_run = f"SystemExit: {message}"
        else:
            from transformers import CLIPVisionConfig, CLIPVisionModel

            # the layers that the transplant reads: CLIP-L's widths, its depth cut to n_enc + n_dec
            hf_clip = CLIPVisionModel(CLIPVisionConfig(**{**CLIP_L_VISION, "num_hidden_layers": n_enc + n_dec}))
            hf_clip.save_pretrained(os.path.join(d, "clip"))
            CC.main(PATCH14_L, os.path.join(d, "clip"), os.path.join(d, "main"))
            # CLIP layer n_enc + 1 is the decoder's layer 1; the checkpoint holds JAX's (in, out) kernels
            with np.load(os.path.join(d, "main", "params.npz")) as saved:
                got = saved["decoder/layers_1/fc2/kernel"]
            want = hf_clip.vision_model.encoder.layers[n_enc + 1].mlp.fc2.weight.detach().numpy().T
            check(np.array_equal(got, want), "copy_clip_into.main did not write CLIP's decoder layer 1")
            main_run = "warm-started from a random-init CLIPVisionModel directory"
            del hf_clip

    pipe = _pipeline_of(back)
    ims = smooth_images(n_images, size, seed=5)
    _roundtrip_launches(pipe, ims)  # warm-up
    records, recon, launches, wall_ms = _roundtrip_launches(pipe, ims)
    _check_roundtrip("warm-started patch14-L", launches, recon, ims, cfg, "block")
    emit({
        "phase": "tools_warm_start_patch14l", "clip_standin": CLIP_L_VISION, "transplanted_tensors": len(pairs),
        "clip_layers_used": n_enc + n_dec, "standin_s": standin_s, "transplant_s": transplant_s,
        "save_s": save_s, "load_s": load_s, "main": main_run,
        "images": n_images, "size": size, "dtype": "bfloat16", "attn_mask_mode": back.config.attn_mask_mode,
        "tokens": sum(len(r["codes"]) for r in records), "wall_ms": wall_ms,
        "psnr_db": statistics.mean(psnr(r, im) for r, im in zip(recon, ims)),
        "launches": launches, "card_name": _card(), "phase_s": time.perf_counter() - t_phase,
    })
    return launches, pipe


def phase_tools_reference_convert(block_pipe, n_images=16, size=448, n_r3b_images=8):
    """tools/convert_reference_weights.py and tools/parity_vs_reference.py.
    A random-init stand-in of the reference model (its attribute layout in
    plain torch.nn modules) at patch14-L's widths, converted on the host and
    run on the card in bf16: the converted config keeps the reference's
    'bias' attention mode, which no other patch14-L path takes; its encode
    is timed beside the warm-started 'block' model's on the same images.
    At r3b's widths, a stand-in holding the trained checkpoint's tensors,
    converted: token ids on the card against the CPU fp32 run of the same
    converted model.  Then the harness's own round trip at its defaults
    (p = 16, max_patch 32, 6 images of at most 256 px) on the card (the DCT
    and IDCT kernels) and on the CPU: the same PSNR to 0.01 dB."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch.ops import stats
    from dct_autoencoder_torch.tools import convert_reference_weights as CR
    from dct_autoencoder_torch.tools import parity_vs_reference as PR

    t_phase = time.perf_counter()
    cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    ref, standin_s = _timed(lambda: CR.reference_standin(cfg, seed=1))
    model, convert_s = _timed(lambda: CR.convert(ref, dtype=torch.bfloat16))
    check(model.config.attn_mask_mode == "bias", f"the converted config's mask mode is {model.config.attn_mask_mode!r}")
    check(model.device.type == "cuda", "the converted model is not on the card")
    del ref
    pipe = _pipeline_of(model)
    ims = smooth_images(n_images, size, seed=5)
    _roundtrip_launches(pipe, ims)  # warm-up
    records, recon, launches, wall_ms = _roundtrip_launches(pipe, ims)
    _check_roundtrip("converted patch14-L", launches, recon, ims, cfg, "bias")

    def encode(p):
        def run():
            p.processor.rng = random.Random(0)
            return p.encode(ims)
        return run

    encode_ms = _warm_wall_ms({"bias": encode(pipe), "block": encode(block_pipe)})
    encode_device = {mode: profile_device(encode(p), reps=3, top=6) for mode, p in (("bias", pipe), ("block", block_pipe))}
    del pipe, model
    torch.cuda.empty_cache()

    # r3b's widths: the trained weights in the reference layout, converted
    r3b = dt.DCTAutoencoder.from_pretrained(R3B, device="cpu")
    ref = CR.reference_standin(r3b.config, state_dict=r3b.module.state_dict(), patchnorm=r3b.patchnorm)
    card = _pipeline_of(CR.convert(ref, dtype=torch.bfloat16))
    cpu = _pipeline_of(CR.convert(ref, device="cpu"))
    ims_r3b = smooth_images(n_r3b_images, size, seed=0)
    card_records, card_recon, r3b_launches, _ = _roundtrip_launches(card, ims_r3b)
    _check_roundtrip("converted r3b", r3b_launches, card_recon, ims_r3b, r3b.config, "bias")
    cpu.processor.rng = random.Random(0)
    cpu_records = cpu.encode(ims_r3b)
    cpu_recon = cpu.decode(cpu_records)
    agree = code_agreement(card_records, cpu_records)
    card_psnr = statistics.mean(psnr(r, im) for r, im in zip(card_recon, ims_r3b))
    cpu_psnr = statistics.mean(psnr(r, im) for r, im in zip(cpu_recon, ims_r3b))
    check(agree >= MIN_CODE_AGREEMENT, f"converted r3b: code agreement with the CPU fp32 run {agree} < {MIN_CODE_AGREEMENT}")
    check(abs(card_psnr - cpu_psnr) <= MAX_PSNR_DELTA_DB, f"converted r3b: PSNR {card_psnr} vs CPU fp32 {cpu_psnr}")
    del card, cpu, ref, r3b

    # the parity harness's own round trip, at the tool's defaults, on grainy
    # fields shaped as photos that the tool shrinks to 256 px (3:2, 4:3, 16:9,
    # 1:1, 2:3, 5:4): whole patch grids keep every DCT coefficient, the rest
    # lose their last columns or rows of frequencies
    rng = np.random.default_rng(9)
    parity_ims = [np.clip(im + 0.03 * rng.standard_normal(im.shape), 0, 1).astype(np.float32) for im in smooth_fields(
        [(170, 256), (192, 256), (144, 256), (256, 256), (256, 170), (204, 256)], seed=9)]
    K.reset_launch_counts()
    card_out, parity_s = _timed(lambda: PR.run_ours_roundtrip(parity_ims, 16, 32))
    parity_launches = path_launches()
    check(parity_launches["dct_patchify"] == parity_launches["idct_unpatchify"] == len(parity_ims)
          and parity_launches["attention"] == 0, f"parity round trip launches {parity_launches}")
    cpu_out = PR.run_ours_roundtrip(parity_ims, 16, 32, device="cpu")
    rows = [(stats.psnr(c, im), stats.psnr(o, im)) for im, c, o in zip(parity_ims, card_out, cpu_out)]
    # a lossless round trip's PSNR measures rounding alone (and ops.stats.psnr
    # caps it at 120 dB): those must both clear the no-model limit instead
    lossless = [im.shape[1] % 16 == 0 and im.shape[2] % 16 == 0 for im in parity_ims]
    worst = max(abs(c - o) for (c, o), whole in zip(rows, lossless) if not whole)
    check(worst <= MAX_PARITY_PSNR_DELTA_DB, f"parity round trip PSNR card vs CPU {rows}")
    check(all(min(r) > MIN_LOSSLESS_PSNR_DB for r, whole in zip(rows, lossless) if whole),
          f"lossless parity round trips under {MIN_LOSSLESS_PSNR_DB} dB: {rows}")
    emit({
        "phase": "tools_reference_convert", "standin_s": standin_s, "convert_s": convert_s,
        "patch14l": {"images": n_images, "size": size, "dtype": "bfloat16", "attn_mask_mode": "bias",
                     "tokens": sum(len(r["codes"]) for r in records), "wall_ms": wall_ms,
                     "psnr_db": statistics.mean(psnr(r, im) for r, im in zip(recon, ims)),
                     "encode_wall_ms": encode_ms, "encode_device": encode_device, "launches": launches},
        "r3b": {"images": n_r3b_images, "size": size, "weights": "r3b's float weights in the reference layout",
                "code_agreement_vs_cpu_fp32": agree, "psnr_db": card_psnr, "cpu_fp32_psnr_db": cpu_psnr,
                "limits": {"code_agreement": MIN_CODE_AGREEMENT, "psnr_db": MAX_PSNR_DELTA_DB},
                "launches": r3b_launches},
        "parity_roundtrip": {"sizes": [list(im.shape[1:]) for im in parity_ims], "psnr_card_cpu_db": rows,
                             "lossless": lossless, "max_delta_db_lossy": worst, "limit_db": MAX_PARITY_PSNR_DELTA_DB,
                             "lossless_limit_db": MIN_LOSSLESS_PSNR_DB, "wall_s": parity_s,
                             "launches": parity_launches},
        "card_name": _card(), "phase_s": time.perf_counter() - t_phase,
    })
    return launches, r3b_launches, parity_launches


# ---------------------------------------------------------------- data, tensor and sequence parallelism


# the sharded step on a (1, 1) mesh against the unsharded step: every sum it
# adds runs over one rank and the row-parallel bias enters as one device adds
# it, so no reduction is reordered and the bits must be the same
MAX_SHARDED_VS_UNSHARDED_DIFF = 0.0


def _train_steps(cfg, batches, sharded: bool, learning_rate=1e-4, pipeline=0, opt_8bit=False, profile=False):
    """Steps of make_train_step from the seeded patch14-L init: unsharded, or
    sharded on a (1, 1) mesh with ZeRO-1 and the config's sequence
    parallelism, or (pipeline = M) as a pipeline of one stage with M
    microbatches and ZeRO-1.  Returns (losses, ms a step, peak GB,
    parameters on the host, grad norms, and with profile=True the device
    time of two more steps on the first batch, after the parameters were read)."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import train as T
    from dct_autoencoder_torch.parallel import mesh as pm
    from dct_autoencoder_torch.parallel.pipeline import make_pipelined_module

    model, _ = dt.get_model_and_processor(cfg, dtype=torch.bfloat16, sample_patches_beta=0.02, seed=0)
    mesh = None
    if sharded:
        mesh = pm.make_mesh(1, model.device)
        if pipeline:
            make_pipelined_module(model.module, mesh, pipeline)
        else:
            pm.shard_params(model.module, mesh)
    tx = T.make_optimizer(learning_rate, 10000, opt_8bit=opt_8bit)
    state = T.TrainState.create(model.module, tx, mesh=mesh, zero1=sharded)
    step = T.make_train_step(model.module, tx, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, norms = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, model.patchnorm, batch)
        losses.append(float(metrics["loss"]))  # reading it synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = {k: v.detach().to("cpu", copy=True) for k, v in model.module.state_dict().items()}
    prof = None
    if profile:
        prof = profile_device(lambda: step(state, model.patchnorm, batches[0]), reps=2, top=8)
    del model, state, step
    torch.cuda.empty_cache()
    return losses, ms, peak, params, norms, prof


def _largest_diff(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def phase_parallel_patch14l(steps=8, rows=64, n_images=16, size=448):
    """The multi-device slice's paths at world 1 on the card: a process group
    of one over NCCL, the sharded train step with ZeRO-1 and sequence
    parallelism on a (1, 1) mesh beside the unsharded step (patch14-L,
    64 x 256, bf16, beta 0.02, the same init and batches), then
    DCTPipeline(data_parallel=True) on r3b against data_parallel=False, and
    the two-process check over NCCL where there are two cards."""
    import torch.distributed as dist

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T
    from dct_autoencoder_torch.models.config import with_sequence_parallel
    from dct_autoencoder_torch.parallel import mesh as pm

    check(not dist.is_initialized(), "a process group exists before the parallel phase")
    pm.initialize_distributed("cuda", f"tcp://127.0.0.1:{pm.free_port()}", world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, f"backend {dist.get_backend()}")
        cfg = with_sequence_parallel(dt.DCTAutoencoderConfig.from_json_file(PATCH14_L))
        n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
        packed = [packed_batch(cfg, 256, rows, 0.02, seed=100 + i) for i in range(steps)]
        batches = [T.prepare_train_batch(b)[0] for b, _ in packed]
        images_per_batch = [n for _, n in packed]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        plain = _train_steps(cfg, batches, sharded=False)
        sharded = _train_steps(cfg, batches, sharded=True)
        torch.cuda.synchronize()
        train_launches = path_launches()
        for name in ("attention", "attention_dq", "attention_dkv"):
            check(train_launches[name] == 2 * steps * n_layers,
                  f"{train_launches[name]} {name} launches for 2 runs x {steps} steps x {n_layers} layers")
        loss_diff = max(abs(a - b) for a, b in zip(plain[0], sharded[0]))
        param_diff = _largest_diff(plain[3], sharded[3])
        rerun = None
        if loss_diff or param_diff:  # tell a reordered sum from a step that differs from itself
            again = _train_steps(cfg, batches, sharded=False)
            rerun = {"loss_diff": max(abs(a - b) for a, b in zip(plain[0], again[0])),
                     "param_diff": _largest_diff(plain[3], again[3])}
        check(all(math.isfinite(x) for x in plain[0] + sharded[0]), f"losses {plain[0]} {sharded[0]}")
        ms_plain, ms_sharded = statistics.median(plain[1][1:]), statistics.median(sharded[1][1:])
        emit({
            "phase": "parallel_patch14l", "mesh": [1, 1], "backend": "nccl", "zero1": True,
            "sequence_parallel": True, "dtype": "bfloat16 compute, float32 masters", "rows": rows, "seq_len": 256,
            "images_per_batch": images_per_batch, "steps": steps, "losses_unsharded": plain[0],
            "losses_sharded": sharded[0], "max_loss_diff": loss_diff, "max_param_diff": param_diff,
            "limit": MAX_SHARDED_VS_UNSHARDED_DIFF, "unsharded_rerun": rerun,
            "ms_per_step_unsharded": ms_plain, "ms_per_step_sharded": ms_sharded,
            "ms_steps_unsharded": plain[1], "ms_steps_sharded": sharded[1],
            "peak_gb_unsharded": plain[2], "peak_gb_sharded_zero1": sharded[2],
        })
        check(loss_diff <= MAX_SHARDED_VS_UNSHARDED_DIFF and param_diff <= MAX_SHARDED_VS_UNSHARDED_DIFF,
              f"sharded vs unsharded: loss {loss_diff}, parameters {param_diff}, rerun {rerun}")
        del plain, sharded

        # DCTPipeline(data_parallel=True): one block a visible card (one here)
        ims = smooth_images(n_images, size, seed=12)
        pipe = dt.DCTPipeline.from_pretrained(R3B)
        dp = dt.DCTPipeline(pipe.model, pipe.processor, data_parallel=True)

        def encode(p):  # the token budget's draws (beta 0.02) from one seed for both pipelines
            p.processor.rng = random.Random(12)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            records = p.encode(ims)
            torch.cuda.synchronize()
            return records, (time.perf_counter() - t0) * 1e3

        encode(pipe)  # warm-up
        want, plain_ms = encode(pipe)
        got, dp_ms = encode(dp)
        same = [[c["data"] for c in a["codes"]] == [c["data"] for c in b["codes"]] for a, b in zip(got, want)]
        emit({
            "phase": "pipeline_data_parallel_r3b", "images": n_images, "size": size, "copies": len(dp._replicas),
            "records_equal": all(same) and len(got) == len(want) == n_images, "encode_ms_data_parallel": dp_ms,
            "encode_ms_plain": plain_ms,
        })
        check(all(same) and len(got) == n_images, "data_parallel=True encoded other codes than data_parallel=False")
    finally:
        dist.destroy_process_group()
    launches = path_launches()
    for name in ("attention", "attention_dq", "attention_dkv", "dct_patchify"):
        check(launches[name] > 0, f"{name} was not launched on the parallel path")

    if torch.cuda.device_count() >= 2:
        import tempfile

        from dct_autoencoder_torch.parallel.multiproc_check import run_two_process_check

        r3b = dt.DCTAutoencoderConfig.from_json_file(os.path.join(R3B, "config.json"))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = run_two_process_check(tmp, timeout=600, config=r3b, n_images=8, image_size=448)
            emit({"phase": "parallel_two_process_r3b", "ran": True, "backend": "nccl", "loss": res["loss"],
                  "grad_norm": res["grad_norm"], "s": time.perf_counter() - t0,
                  "outputs": [o.strip().splitlines()[-1] for o in res["outputs"]]})
    else:
        emit({"phase": "parallel_two_process_r3b", "ran": False,
              "why": f"{torch.cuda.device_count()} card: NCCL takes one rank a device, so the two-rank check "
                     "needs two cards; the CPU tests hold the multi-rank numbers (gloo)"})
    return launches


# ---------------------------------------------------------------- pipelines

# The pipelined step at one stage (M = 4 microbatches of 16 rows) against the
# unsharded step, both with 8-bit moments, from one init and the same batches.
# The layers run on row subsets: with deterministic kernels (no atomics in the
# attention kernels; cuBLAS's algorithm per shape) a token's forward is the
# same, but each weight gradient is now 4 bf16-rounded partial products summed
# in fp32 instead of one.
# Steps 0 and 1 run from the same parameters in both runs (the schedule's
# rate is 0 at step 0), so each is one function of one input: the loss read
# the same bits and the grad norm 3.3e-6 apart (an H100 80GB at 700 W).  The
# limits: 1e-5 of the loss, 1e-4 of the grad norm.  Clipping at 5.0 hides a
# gradient's scale from the parameters (every step's norm is ~5.4), so these
# are the readings that fail a gradient fault.  With faults planted on the
# card (_planted_faults), a microbatch counted M times read 1.43 (grad
# norm), microbatch 0 left out 0.043, each microbatch run with the next
# one's ids and padding 6.4e-4 (loss) and 0.017.
SHARED_STEPS = 2
MAX_PIPELINE_SHARED_LOSS_REL = 1e-5
MAX_PIPELINE_GRAD_NORM_REL = 1e-4
# After 8 steps the 8-bit Adam updates have spread that rounding: the loss
# within 1e-3 of the loss (read 6.8e-4), and the parameters' updates,
# |params_pipelined - params_unsharded| / |params_unsharded - init| (L2 over
# every entry), within 0.6.  The clean run reads 0.366 and a gradient fault
# 0.37-0.56: no parameter reading tells those apart, the shared steps do.
# This limit fails the optimizer's faults: ZeRO-1's updated slices not
# written back read 1.00, each update applied twice 1.13 (the largest
# entry's difference, 2.1e-5 and 3.8e-5 against the clean 2.3e-5, cannot
# tell them); 0.6 is the geometric mean of 1.00 and the clean reading.
MAX_PIPELINE_LOSS_REL = 1e-3
MAX_PIPELINE_UPDATE_REL = 0.6
# 1F1B against GPipe + autograd on the same stack and microbatches: the same
# bf16 products (deterministic kernels, recomputed at the same shapes), so only
# the fp32 order of the 4 microbatches' sums differs: within 1e-5 of the
# largest magnitude (loss: rtol 1e-5)
MAX_1F1B_VS_GPIPE_REL = 1e-5
# the memory study: 1F1B's temporary memory flat in M within 10 %, GPipe's growing
MAX_1F1B_TEMP_SPREAD = 0.10


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _init_params(cfg) -> dict:
    """The seeded patch14-L init of _train_steps, on the host."""
    import dct_autoencoder_torch as dt

    model, _ = dt.get_model_and_processor(cfg, dtype=torch.bfloat16, sample_patches_beta=0.02, seed=0)
    out = {k: v.detach().to("cpu", copy=True) for k, v in model.module.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    return out


def _update_rel(params: dict, ref: dict, init: dict) -> float:
    """|params - ref| / |ref - init| over every floating entry (L2 norms):
    how far two runs' updates from one init point apart."""
    num = den = 0.0
    for k, v in ref.items():
        if v.is_floating_point():
            num += float(((params[k].double() - v.double()) ** 2).sum())
            den += float(((v.double() - init[k].double()) ** 2).sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def _planted_faults(cfg, batches, plain, init, microbatches):
    """The pipelined step with one fault planted at a time (a method of
    _GPipe or ShardedOptimizer replaced for the run, then restored), read
    as the phase reads the clean run.  name -> readings."""
    from dct_autoencoder_torch.parallel.optim import ShardedOptimizer
    from dct_autoencoder_torch.parallel.pipeline import _GPipe

    backward, init_run, opt_step = _GPipe.backward, _GPipe.__init__, ShardedOptimizer.step

    def counted_m_times(self, g, params, need_dx):
        return backward(self, g * self.spec.n_microbatches, params, need_dx)

    def microbatch_left_out(self, g, params, need_dx):
        g = g.clone()
        g[: self.micro] = 0
        return backward(self, g, params, need_dx)

    def skewed_metadata(self, *args, **kwargs):  # each microbatch runs with the next one's ids and padding
        init_run(self, *args, **kwargs)
        self.ids, self.pad = self.ids[1:] + self.ids[:1], self.pad[1:] + self.pad[:1]

    def update_twice(self, tx, count, lr_scale=1.0):
        inner = self.inner.step
        self.inner.step = lambda: (inner(), inner())
        try:
            return opt_step(self, tx, count, lr_scale)
        finally:
            del self.inner.step

    def stale_zero1_slices(self, tx, count, lr_scale=1.0):  # the updated slices never written back
        sliced = [i for i, c in enumerate(self.chunks) if c is not None]
        before = [self.params[i].detach().clone() for i in sliced]
        out = opt_step(self, tx, count, lr_scale)
        with torch.no_grad():
            for i, b in zip(sliced, before):
                self.params[i].copy_(b)
        return out

    faults = [
        ("counted_m_times", _GPipe, "backward", backward, counted_m_times),
        ("microbatch_left_out", _GPipe, "backward", backward, microbatch_left_out),
        ("skewed_metadata", _GPipe, "__init__", init_run, skewed_metadata),
        ("update_twice", ShardedOptimizer, "step", opt_step, update_twice),
        ("stale_zero1_slices", ShardedOptimizer, "step", opt_step, stale_zero1_slices),
    ]
    out = {}
    for name, cls, attr, orig, fault in faults:
        setattr(cls, attr, fault)
        try:
            run = _train_steps(cfg, batches, sharded=True, pipeline=microbatches, opt_8bit=True)
        finally:
            setattr(cls, attr, orig)
        out[name] = {
            "shared_loss_rel": max(_rel(run[0][i], plain[0][i]) for i in range(SHARED_STEPS)),
            "shared_grad_norm_rel": max(_rel(run[4][i], plain[4][i]) for i in range(SHARED_STEPS)),
            "max_loss_rel": max(_rel(a, b) for a, b in zip(run[0], plain[0])),
            "update_rel": _update_rel(run[3], plain[3], init), "max_param_diff": _largest_diff(run[3], plain[3]),
        }
    return out


def _f1b_vs_gpipe(cfg, rows=64, microbatches=4):
    """pipeline_1f1b_loss_and_grad against pipeline_stack_apply + autograd on
    patch14-L's encoder stack (bf16, one stage, the packed batch's ids and
    padding): (loss, parameter gradients, dx) relative differences."""
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.parallel import mesh as pm
    from dct_autoencoder_torch.parallel.pipeline import PipelineSpec, pipeline_stack_apply
    from dct_autoencoder_torch.parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grad

    model, _ = dt.get_model_and_processor(cfg, dtype=torch.bfloat16, sample_patches_beta=0.02, seed=0)
    layers = list(model.module.encoder.layers)
    batch, _ = packed_batch(cfg, 256, rows, 0.02, seed=300)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((rows, 256, cfg.encoder_config.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    ids, pad = batch.batched_image_ids, batch.key_pad_mask
    spec = PipelineSpec(pm.make_mesh(1, "cuda"), microbatches)
    mode = cfg.attn_mask_mode

    def layer_apply(layer, xm, i, p):
        return layer(xm, i, p, mode, True)

    def loss_fn(y, i, p):
        keep = (~p)[..., None].float()
        return (y.float() ** 2 * keep).sum() / (keep.sum() * y.shape[-1])

    params = [p for layer in layers for p in layer.parameters()]
    xg = x.clone().requires_grad_()
    y = pipeline_stack_apply(layer_apply, layers, xg, ids, pad, spec)
    k = rows // microbatches
    loss = torch.stack([loss_fn(y[m * k:(m + 1) * k], ids[m * k:(m + 1) * k], pad[m * k:(m + 1) * k])
                        for m in range(microbatches)]).mean()
    *g_gpipe, dx_gpipe = torch.autograd.grad(loss, params + [xg])
    loss_f, grads_f, dx_f = pipeline_1f1b_loss_and_grad(layer_apply, loss_fn, layers, x, ids, pad, spec)
    g_f = [g for layer in grads_f for g in layer]
    grad_scale = max(float(g.abs().max()) for g in g_gpipe)
    out = {
        "loss_rel": _rel(float(loss_f), float(loss.detach())),
        "grad_rel": max(float((a.float() - b.float()).abs().max()) for a, b in zip(g_f, g_gpipe)) / grad_scale,
        "dx_rel": float((dx_f.float() - dx_gpipe.float()).abs().max()) / float(dx_gpipe.float().abs().max()),
        "loss": float(loss.detach()), "layers": len(layers), "rows": rows, "microbatches": microbatches,
    }
    del model, layers, params, y, g_gpipe, dx_gpipe, grads_f, dx_f
    torch.cuda.empty_cache()
    return out


def phase_pipeline_patch14l(steps=8, rows=64, microbatches=4):
    """Pipeline parallelism on the card, at world 1 over NCCL: the pipelined
    train step (one stage, `microbatches` microbatches, ZeRO-1, 8-bit
    moments) beside the unsharded step at patch14-L, 64 x 256, bf16, beta
    0.02 (the same init and batches; a second unsharded run tells the
    step's own noise; five planted faults, each of which the comparison must
    fail), then 1F1B against GPipe + autograd on one patch14-L
    stack, tools/pp_memory_study.py at M in {2, 4, 8, 16} and
    tools/compile_probe.py at patch14-L (16 rows, bf16).  Where there are two
    cards, the two-process check as a two-stage pipeline (r3b, fp32).
    Returns the launch counts of the pipelined run alone (its timed and
    profiled steps) and of the compile probe alone."""
    import torch.distributed as dist

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T
    from dct_autoencoder_torch.parallel import mesh as pm
    from dct_autoencoder_torch.tools import compile_probe, pp_memory_study

    check(not dist.is_initialized(), "a process group exists before the pipeline phase")
    pm.initialize_distributed("cuda", f"tcp://127.0.0.1:{pm.free_port()}", world_size=1, rank=0)
    try:
        cfg = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
        n_layers = cfg.encoder_config.num_hidden_layers + cfg.decoder_config.num_hidden_layers
        packed = [packed_batch(cfg, 256, rows, 0.02, seed=200 + i) for i in range(steps)]
        batches = [T.prepare_train_batch(b)[0] for b, _ in packed]
        tx = T.make_optimizer(1e-4, 10000)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        plain = _train_steps(cfg, batches, sharded=False, opt_8bit=True, profile=True)
        torch.cuda.synchronize()
        plain_launches = path_launches()
        K.reset_launch_counts()
        piped = _train_steps(cfg, batches, sharded=True, pipeline=microbatches, opt_8bit=True, profile=True)
        torch.cuda.synchronize()
        step_launches = path_launches()
        for name in ("attention", "attention_dq", "attention_dkv"):  # 2 profiled steps beside the timed ones
            check(plain_launches[name] == (steps + 2) * n_layers,
                  f"{plain_launches[name]} {name} launches unsharded for {steps} + 2 steps x {n_layers} layers")
            check(step_launches[name] == (steps + 2) * n_layers * microbatches,
                  f"{step_launches[name]} {name} launches pipelined for {steps} + 2 steps x {n_layers} layers x "
                  f"{microbatches} microbatches")
        again = _train_steps(cfg, batches, sharded=False, opt_8bit=True)
        init = _init_params(cfg)
        rerun = {"loss_rel": max(_rel(a, b) for a, b in zip(again[0], plain[0])),
                 "param_diff": _largest_diff(again[3], plain[3]), "update_rel": _update_rel(again[3], plain[3], init)}
        loss_rel = max(_rel(a, b) for a, b in zip(piped[0], plain[0]))
        param_diff = _largest_diff(piped[3], plain[3])
        update_rel = _update_rel(piped[3], plain[3], init)
        faults = _planted_faults(cfg, batches, plain, init, microbatches)
        del init
        check(tx.schedule(0) == 0.0, "the shared steps need the rate 0 at step 0")
        shared_loss_rel = max(_rel(piped[0][i], plain[0][i]) for i in range(SHARED_STEPS))
        shared_norm_rel = max(_rel(piped[4][i], plain[4][i]) for i in range(SHARED_STEPS))
        check(all(math.isfinite(x) for x in plain[0] + piped[0]), f"losses {plain[0]} {piped[0]}")
        ms_plain, ms_piped = statistics.median(plain[1][1:]), statistics.median(piped[1][1:])
        f1b = _f1b_vs_gpipe(cfg, rows, microbatches)
        emit({
            "phase": "pipeline_patch14l", "stages": 1, "microbatches": microbatches, "backend": "nccl",
            "zero1": True, "opt_8bit": True, "dtype": "bfloat16 compute, float32 masters", "rows": rows,
            "seq_len": 256, "steps": steps, "losses_unsharded": plain[0], "losses_pipelined": piped[0],
            "grad_norms_unsharded": plain[4], "grad_norms_pipelined": piped[4],
            "max_loss_rel": loss_rel, "loss_rel_limit": MAX_PIPELINE_LOSS_REL,
            "shared_steps": SHARED_STEPS, "shared_loss_rel": shared_loss_rel,
            "shared_loss_rel_limit": MAX_PIPELINE_SHARED_LOSS_REL, "shared_grad_norm_rel": shared_norm_rel,
            "shared_grad_norm_rel_limit": MAX_PIPELINE_GRAD_NORM_REL,
            "max_param_diff": param_diff, "update_rel": update_rel, "update_rel_limit": MAX_PIPELINE_UPDATE_REL,
            "unsharded_rerun": rerun,
            "ms_per_step_unsharded": ms_plain, "ms_per_step_pipelined": ms_piped,
            "ms_steps_unsharded": plain[1], "ms_steps_pipelined": piped[1],
            "peak_gb_unsharded": plain[2], "peak_gb_pipelined": piped[2],
            "ms_steps_unsharded_rerun": again[1], "profile_unsharded": plain[5], "profile_pipelined": piped[5],
            "attention_launches_per_step_pipelined": step_launches["attention"] // (steps + 2),
            "f1b_vs_gpipe": f1b, "f1b_limit": MAX_1F1B_VS_GPIPE_REL, "planted_faults": faults,
        })
        check(shared_loss_rel <= MAX_PIPELINE_SHARED_LOSS_REL and shared_norm_rel <= MAX_PIPELINE_GRAD_NORM_REL,
              f"pipelined vs unsharded from the same parameters (steps 0-{SHARED_STEPS - 1}): loss {shared_loss_rel}, "
              f"grad norm {shared_norm_rel}")
        check(loss_rel <= MAX_PIPELINE_LOSS_REL and update_rel <= MAX_PIPELINE_UPDATE_REL,
              f"pipelined vs unsharded after {steps} steps: loss {loss_rel}, updates {update_rel}, rerun {rerun}")
        for name, r in faults.items():  # each planted fault fails a comparison
            failed = (r["shared_loss_rel"] > MAX_PIPELINE_SHARED_LOSS_REL or r["update_rel"] > MAX_PIPELINE_UPDATE_REL
                      or r["shared_grad_norm_rel"] > MAX_PIPELINE_GRAD_NORM_REL)
            check(failed, f"the comparison passes the planted fault {name}: {r}")
        check(f1b["loss_rel"] <= MAX_1F1B_VS_GPIPE_REL and f1b["grad_rel"] <= MAX_1F1B_VS_GPIPE_REL
              and f1b["dx_rel"] <= MAX_1F1B_VS_GPIPE_REL, f"1F1B against GPipe: {f1b}")
        del plain, piped, again

        # 32 rows a microbatch: 1F1B's ~28 MB working set dwarfs the allocator's
        # sub-MB jitter between runs (at the default 8 rows it read 7.0-7.6 MB)
        study, _ = _quiet(lambda: pp_memory_study.main(["--micro_rows", "32", "--microbatches", "2", "4", "8", "16"]))
        g = [r["gpipe_temp_mb"] for r in study["rows"]]
        f = [r["f1b_temp_mb"] for r in study["rows"]]
        spread = (max(f) - min(f)) / max(min(f), 1e-9)
        emit({"phase": "pp_memory_study", **study, "f1b_temp_spread": spread, "f1b_spread_limit": MAX_1F1B_TEMP_SPREAD})
        check(all(a < b for a, b in zip(g, g[1:])), f"GPipe's temporary memory does not grow with M: {g}")
        check(spread <= MAX_1F1B_TEMP_SPREAD, f"1F1B's temporary memory is not flat in M: {f}")

        torch.cuda.synchronize()
        K.reset_launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            probe, _ = _quiet(lambda: compile_probe.main(PATCH14_L, rows=16, seq_len=256, iters=10, dtype="bfloat16",
                                                         profile_dir=os.path.join(tmp, "trace")))
            probe["trace_bytes"] = os.path.getsize(probe.pop("trace"))
        torch.cuda.synchronize()
        probe_launches = path_launches()
        emit({"phase": "compile_probe_patch14l", **probe, "attention_launches": probe_launches["attention"]})
        check(math.isfinite(probe["ms_per_batch"]) and probe["trace_bytes"] > 0, f"compile probe {probe}")
    finally:
        dist.destroy_process_group()
    phase_pipeline_two_cards()
    return step_launches, probe_launches


def phase_pipeline_two_cards():
    """The two-process check as a two-stage pipeline over NCCL (r3b, fp32,
    2 microbatches) against one card, where there are two cards."""
    import dct_autoencoder_torch as dt

    if torch.cuda.device_count() >= 2:
        from dct_autoencoder_torch.parallel.multiproc_check import run_two_process_check

        r3b = dt.DCTAutoencoderConfig.from_json_file(os.path.join(R3B, "config.json"))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = run_two_process_check(tmp, timeout=600, config=r3b, n_images=8, image_size=448,
                                        pipeline_microbatches=2)
            emit({"phase": "pipeline_two_process_r3b", "ran": True, "backend": "nccl", "loss": res["loss"],
                  "grad_norm": res["grad_norm"], "s": time.perf_counter() - t0,
                  "outputs": [o.strip().splitlines()[-1] for o in res["outputs"]]})
    else:
        emit({"phase": "pipeline_two_process_r3b", "ran": False,
              "why": f"{torch.cuda.device_count()} card: a two-stage pipeline over NCCL takes one rank a card; "
                     "the CPU tests hold the multi-rank numbers (gloo)"})


# ---------------------------------------------------------------- four cards

# (n_model, sequence parallelism, ZeRO-1, 8-bit moments) of the four-card
# check: dp4, dp2 x tp2, with sequence parallelism, ZeRO-1, both, and 8-bit
FOUR_CARD_CASES = ((1, False, False, False), (2, False, False, False), (2, True, False, False),
                   (1, False, True, False), (2, True, True, False), (2, True, True, True))
# fp32 against one card over the steps: tests/test_parallel.py's limits on
# JAX's sharded step (bf16 is printed, not held: its roundings follow the order)
MAX_FOUR_CARD_LOSS_REL, MAX_FOUR_CARD_GRAD_NORM_REL = 1e-4, 1e-3
# (pipeline stages, ZeRO-1, 8-bit moments) of the four-card pipeline check, 2
# microbatches, fp32 against one card within the limits above: pp4, dp2 x pp2,
# with ZeRO-1, with ZeRO-1 and 8-bit moments
PIPELINE_FOUR_CARD_CASES = ((4, False, False), (2, False, False), (2, True, False), (2, True, True))


def sharded_steps_rank(steps=3, rows=32, seq=256):
    """One rank of the four-card check, started by phase_parallel_four_cards
    as `torch.distributed.run --nproc_per_node 4 chip_smoke.py
    --sharded-steps-rank`: r3b's widths at random init, `steps` steps of each
    FOUR_CARD_CASES case in fp32 and bf16, and of each
    PIPELINE_FOUR_CARD_CASES case in fp32, beside the unsharded step on one
    card, from one init and the same batches; rank 0 prints a JSON line a
    case (the largest relative loss and grad-norm differences, the largest
    parameter difference after the steps, the attention launches, rank 0's
    optimizer state and peak memory).  Then patch14-L in bf16 as pp4 and
    dp2 x pp2 (4 microbatches, 64 x 256, 5 steps): ms a step and each
    rank's peak GB."""
    import torch.distributed as dist

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K
    from dct_autoencoder_torch import train as T
    from dct_autoencoder_torch.models.config import with_sequence_parallel
    from dct_autoencoder_torch.parallel import mesh as pm
    from dct_autoencoder_torch.parallel.pipeline import make_pipelined_module
    from dct_autoencoder_torch.train.opt8bit import opt_state_bytes

    pm.initialize_distributed("cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    base = dt.DCTAutoencoderConfig.from_json_file(os.path.join(R3B, "config.json"))
    batches = [
        pm.pad_batch_rows(T.prepare_train_batch(packed_batch(base, seq, rows, 0.02, seed=50 + i, device=dev)[0])[0], 4)
        for i in range(steps)
    ]

    def run(n_model, sp, zero1, opt_8bit, dtype, sharded=True, pipeline=0, cfg=None, steps_of=None):
        cfg = cfg or (with_sequence_parallel(base) if sp else base)
        model, _ = dt.get_model_and_processor(cfg, dtype=dtype, sample_patches_beta=0.0, seed=0, device=dev)
        mesh = None
        if sharded:
            mesh = pm.make_mesh(n_model, dev)
            if pipeline:
                make_pipelined_module(model.module, mesh, pipeline)
            elif n_model > 1 or sp:
                pm.shard_params(model.module, mesh)
        tx = T.make_optimizer(1e-4, 1000, warmup_steps=0, opt_8bit=opt_8bit)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = T.TrainState.create(model.module, tx, mesh=mesh, zero1=zero1)
        step = T.make_train_step(model.module, tx, mesh=mesh)
        out = []
        for b in steps_of or batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, model.patchnorm, b)
            out.append((float(m["loss"]), float(m["grad_norm"]), (time.perf_counter() - t0) * 1e3))
        memory = {"opt_state_mb": opt_state_bytes(state.adamw.inner if sharded else state.adamw) / 1e6,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        full = pm.gather_params(model.module, mesh) if sharded else model.module.state_dict()
        return out, {k: v.float().cpu() for k, v in full.items()}, memory

    for dtype in (torch.float32, torch.bfloat16):
        refs = {b8: run(1, False, False, b8, dtype, sharded=False) for b8 in (False, True)}
        cases = [(n, sp, z, b8, 0) for n, sp, z, b8 in FOUR_CARD_CASES]
        if dtype == torch.float32:
            cases += [(n, False, z, b8, 2) for n, z, b8 in PIPELINE_FOUR_CARD_CASES]
        for n_model, sp, zero1, opt_8bit, pipeline in cases:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            got, got_p, memory = run(n_model, sp, zero1, opt_8bit, dtype, pipeline=pipeline)
            ref, ref_p, ref_memory = refs[opt_8bit]
            line = {
                "phase": "parallel_four_cards_case", "dtype": str(dtype), "n_model": n_model, "sp": sp,
                "zero1": zero1, "opt_8bit": opt_8bit, "pipeline_microbatches": pipeline, "steps": steps, "rows": rows,
                "seq_len": seq,
                "loss_rel": max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got, ref)),
                "grad_norm_rel": max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, ref)),
                "param_max_diff": _largest_diff(got_p, ref_p), "attention_launches": K.launch_counts()["attention"],
                **memory, "one_card_opt_state_mb": ref_memory["opt_state_mb"], "s": time.perf_counter() - t0,
            }
            if dist.get_rank() == 0:
                emit(line)

    # patch14-L in bf16 as pp4 and dp2 x pp2 (4 microbatches, 64 x 256): ms a step, peak GB a rank
    big = dt.DCTAutoencoderConfig.from_json_file(PATCH14_L)
    big_batches = [T.prepare_train_batch(packed_batch(big, 256, 64, 0.02, seed=400 + i, device=dev)[0])[0]
                   for i in range(5)]
    for n_stages in (4, 2):
        got, _, memory = run(n_stages, False, False, False, torch.bfloat16, pipeline=4, cfg=big, steps_of=big_batches)
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, memory["peak_gb"])
        if dist.get_rank() == 0:
            emit({"phase": "parallel_four_cards_pipeline_patch14l", "mesh": [4 // n_stages, n_stages],
                  "microbatches": 4, "rows": 64, "seq_len": 256, "dtype": "bfloat16 compute, float32 masters",
                  "losses": [g[0] for g in got], "ms_steps": [g[2] for g in got],
                  "ms_per_step": statistics.median([g[2] for g in got[1:]]), "peak_gb_by_rank": peaks,
                  "opt_state_mb_rank0": memory["opt_state_mb"]})
    dist.destroy_process_group()
    return 0


def _torchrun(args, timeout):
    """`python -m torch.distributed.run --nproc_per_node 4 <args>` from this
    checkout; returns its output, raises with its tail if it failed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
           "--master_port", str(_free_port()), *args]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"{' '.join(args[:3])} failed ({proc.returncode}):\n{(proc.stdout + proc.stderr)[-6000:]}")
    return proc.stdout


def _free_port() -> int:
    from dct_autoencoder_torch.parallel.mesh import free_port

    return free_port()


def phase_parallel_four_cards(n_images=96, size=448, cli_steps=4):
    """The multi-rank paths over NCCL where there are four cards: the sharded
    steps of FOUR_CARD_CASES and the pipelines of PIPELINE_FOUR_CARD_CASES
    on four ranks against one card (held in fp32 to JAX's limits for its
    sharded step) and patch14-L's pipelined steps, then the training CLI
    under torch.distributed.run with dp2 x tp2, sequence parallelism, ZeRO-1
    and 8-bit moments at r3b's widths, and again as dp2 x pp2 with 2
    pipeline microbatches, each checkpoint loading on one card with the
    whole parameters.  On fewer cards it says that it did not run."""
    n = torch.cuda.device_count()
    if n < 4:
        emit({"phase": "parallel_four_cards", "ran": False,
              "why": f"{n} card(s): the four-rank check takes one rank a card; the CPU tests hold the "
                     "multi-rank numbers (gloo)"})
        return
    import glob
    import tempfile

    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch.kernels import _build

    _build.build_all()  # once, before the ranks start
    t0 = time.perf_counter()
    out = _torchrun([os.path.join(HERE, "chip_smoke.py"), "--sharded-steps-rank"], timeout=900)
    cases = [json.loads(l) for l in out.splitlines() if l.startswith("{") and "parallel_four_cards_case" in l]
    for c in cases:
        print(json.dumps(c), flush=True)
    check(len(cases) == 2 * len(FOUR_CARD_CASES) + len(PIPELINE_FOUR_CARD_CASES), f"{len(cases)} case lines from the four ranks")
    big = [json.loads(l) for l in out.splitlines() if l.startswith("{") and "four_cards_pipeline_patch14l" in l]
    for b in big:
        print(json.dumps(b), flush=True)
    check(len(big) == 2 and all(math.isfinite(x) for b in big for x in b["losses"]), f"patch14-L pipelines {big}")
    fp32 = [c for c in cases if c["dtype"] == "torch.float32"]
    check(all(c["attention_launches"] > 0 for c in cases), "a four-card case launched no attention kernel")
    steps_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        shards, out_base = os.path.join(tmp, "shards"), os.path.join(tmp, "out")
        os.makedirs(shards)
        write_image_shards(shards, n_images, seed=3, sizes=[(size, size), (size, size + size // 4), (size + size // 4, size)])
        t1 = time.perf_counter()
        _torchrun(["-m", "dct_autoencoder_torch.train.cli", "--image_dataset_path_or_url", os.path.join(shards, "*.tar"),
                   "--model_config_path", os.path.join(R3B, "config.json"), "--batch_size", "16",
                   "--max_iters", str(cli_steps), "--n_model_parallel", "2", "--sequence_parallel", "--zero1",
                   "--opt_8bit", "--train_norm_iters", "1", "--save_every", "2", "--log_every", "1",
                   "--out_base", out_base, "--epochs", "4", "--log_images_every", "2"], timeout=900)
        cli_s = time.perf_counter() - t1
        run = sorted(glob.glob(os.path.join(out_base, "*")))[-1]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            logged = [d for d in map(json.loads, f) if "loss" in d]
        model = dt.DCTAutoencoder.from_pretrained(os.path.join(run, "model"))
        state = torch.load(os.path.join(run, "train_state.pt"), map_location="cpu", weights_only=True)
        whole = all(torch.equal(state["params"][k], v.cpu()) for k, v in model.module.state_dict().items())
        emit({
            "phase": "parallel_four_cards", "ran": True, "backend": "nccl", "card": _card(),
            "steps_s": steps_s, "fp32_within_limits": all(
                c["loss_rel"] <= MAX_FOUR_CARD_LOSS_REL and c["grad_norm_rel"] <= MAX_FOUR_CARD_GRAD_NORM_REL
                for c in fp32),
            "cli": {"mesh": [2, 2], "steps": [(d["step"], d["loss"], d["grad_norm"]) for d in logged],
                    "s": cli_s, "checkpoint_step": state["step"], "checkpoint_whole_on_one_card": whole},
        })
        check(logged and all(math.isfinite(d["loss"]) for d in logged), f"CLI losses {logged}")
        check(whole, "the four-rank CLI's checkpoint does not hold the whole parameters")

        # the CLI again, as dp2 x pp2 with 2 pipeline microbatches, ZeRO-1 and 8-bit moments
        pp_base = os.path.join(tmp, "out_pp")
        t1 = time.perf_counter()
        _torchrun(["-m", "dct_autoencoder_torch.train.cli", "--image_dataset_path_or_url", os.path.join(shards, "*.tar"),
                   "--model_config_path", os.path.join(R3B, "config.json"), "--batch_size", "16",
                   "--max_iters", str(cli_steps), "--n_model_parallel", "2", "--pipeline_microbatches", "2", "--zero1",
                   "--opt_8bit", "--train_norm_iters", "1", "--save_every", "2", "--log_every", "1",
                   "--out_base", pp_base, "--epochs", "4"], timeout=900)
        pp_s = time.perf_counter() - t1
        run = sorted(glob.glob(os.path.join(pp_base, "*")))[-1]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            pp_logged = [d for d in map(json.loads, f) if "loss" in d]
        model = dt.DCTAutoencoder.from_pretrained(os.path.join(run, "model"))
        state = torch.load(os.path.join(run, "train_state.pt"), map_location="cpu", weights_only=True)
        pp_whole = all(torch.equal(state["params"][k], v.cpu()) for k, v in model.module.state_dict().items())
        emit({"phase": "parallel_four_cards_pipeline_cli", "mesh": [2, 2], "pipeline_microbatches": 2,
              "steps": [(d["step"], d["loss"], d["grad_norm"]) for d in pp_logged], "s": pp_s,
              "checkpoint_step": state["step"], "checkpoint_whole_on_one_card": pp_whole})
        check(pp_logged and all(math.isfinite(d["loss"]) for d in pp_logged), f"pipelined CLI losses {pp_logged}")
        check(pp_whole, "the pipelined CLI's checkpoint does not hold the whole parameters")
    for c in fp32:
        check(c["loss_rel"] <= MAX_FOUR_CARD_LOSS_REL and c["grad_norm_rel"] <= MAX_FOUR_CARD_GRAD_NORM_REL,
              f"four-card case against one card: {c}")


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
    ("attention_dropout", "packed_attention_fwd_dropout", "dct_autoencoder_torch/csrc/attention_fwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:91", "attention_dropout", "train_dropout_patch14l"),
    ("attention_dq_dropout", "packed_attention_bwd_dq_dropout", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:194", "attention_dq_dropout", "train_dropout_patch14l"),
    ("attention_dkv_dropout", "packed_attention_bwd_dkv_dropout", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:236", "attention_dkv_dropout", "train_dropout_patch14l"),
    ("dct", "fused_ipt_dct_patchify", "dct_autoencoder_torch/csrc/dct_patchify.cu",
     "dct_autoencoder_tpu/kernels/dct_patchify.py:43", "dct_patchify", "serving_daemon"),
    ("idct", "fused_idct_unpatchify_rgb", "dct_autoencoder_torch/csrc/idct_unpatchify.cu",
     "dct_autoencoder_tpu/kernels/idct_unpatchify.py:47", "idct_unpatchify", "serving_daemon"),
]
SERVING_KERNELS = ("attention", "dct_patchify", "idct_unpatchify")
FWD_KERNELS = ("attention", "attention_causal", "attention_dropout")
BWD_KERNELS = ("attention_dq", "attention_dkv", "attention_dq_causal", "attention_dkv_causal", "attention_dq_dropout",
               "attention_dkv_dropout")
# path -> ((impl of its non-causal forward launches, of its causal ones),
#          (impl of its non-causal backward launches, of its causal ones)):
# bfloat16 runs on the tensor cores (BF16_PATH); float32 runs the three
# kernels on the tensor cores in 3xTF32 (FP32_PATH).
# The sweep trains in float32 as its command line does; the AR example
# tokenizes in bfloat16 (non-causal forward) and trains its AR model in
# float32 (causal); the offline tools that run float32 (eval on r3b as the
# phase asks, decode_gif and diagnose as their tools do) launch forwards
# only.  testpipe and the parity harness's round trip run no model, so no
# attention: their launches are read by their phases and listed in
# launches_by_path only
BF16_PATH = (("mma", "mma"), ("mma", "mma"))
FP32_PATH = (("tf32x3", "tf32x3"), ("tf32x3", "tf32x3"))
PATH_IMPLS = {
    "serving": BF16_PATH, "reconstruct_direct": BF16_PATH, "serving_daemon": BF16_PATH,
    "full_width": BF16_PATH, "train_r3b": BF16_PATH,
    "train_patch14l": BF16_PATH, "ar_train": BF16_PATH, "ar_example": (("mma", "tf32x3"), ("mma", "tf32x3")),
    "train_pixel_r3b": BF16_PATH, "train_cli": BF16_PATH,
    "train_vq_patch14l": BF16_PATH, "train_vq_r3b": BF16_PATH, "train_cli_vq": BF16_PATH,
    "sweep": FP32_PATH,
    "tools_prepare_ar": BF16_PATH, "tools_eval_patch14l": BF16_PATH, "int8_study": BF16_PATH,
    "tools_eval_r3b": FP32_PATH, "tools_decode_gif": FP32_PATH, "tools_diagnose": FP32_PATH,
    "parallel_patch14l": BF16_PATH, "pipeline_patch14l": BF16_PATH,
    "compile_probe": BF16_PATH, "train_dropout_patch14l": BF16_PATH,
    "tools_warm_start_patch14l": BF16_PATH, "tools_reference_convert": BF16_PATH,
    "tools_reference_convert_r3b": BF16_PATH,
}


def path_launches() -> dict:
    """The launch counts of every kernel, and of the attention kernels by
    implementation and (the forward) by mask mode."""
    from dct_autoencoder_torch import kernels as K

    return {**K.launch_counts(), "fwd_impl": K.fwd_impl_launch_counts(), "bwd_impl": K.bwd_impl_launch_counts(),
            "fwd_mode": K.fwd_mode_launch_counts()}


def check_impl_launches(launches: dict, fwd_impls: tuple, bwd_impls: tuple) -> None:
    """Every attention forward launch of one path was counted under
    fwd_impls[0], or fwd_impls[1] for a causal one, and every backward launch
    under bwd_impls[0] or bwd_impls[1] alike."""
    for kind, kernels, (impl, causal_impl) in (("fwd", FWD_KERNELS, fwd_impls), ("bwd", BWD_KERNELS, bwd_impls)):
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
    if "--sharded-steps-rank" in sys.argv[1:]:  # one rank of phase_parallel_four_cards
        return sharded_steps_rank()
    smi = phase_environment()
    if "--attention-device-times" in sys.argv[1:]:
        attention_device_times()
        return 0
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
    launches["train_dropout_patch14l"] = phase_train_dropout_patch14l()
    torch.cuda.empty_cache()
    phase_opt8bit_card_vs_cpu()
    launches["train_pixel_r3b"] = phase_train_pixel_r3b()
    torch.cuda.empty_cache()
    launches["train_cli"] = phase_train_cli_patch14l()
    torch.cuda.empty_cache()
    launches["train_vq_patch14l"] = phase_train_vq_patch14l(profile)
    torch.cuda.empty_cache()
    launches["train_vq_r3b"] = phase_train_vq_r3b()
    shard_dir = vq_and_sweep_shards()
    try:
        launches["train_cli_vq"] = phase_train_cli_vq_r3b(os.path.join(shard_dir, "*.tar"))
        launches["sweep"] = phase_sweep_small_448(os.path.join(shard_dir, "*.tar"))
    finally:
        import shutil

        shutil.rmtree(shard_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    launches["ar_train"], ar_model = phase_ar_train_full_width(profile)
    launches["ar_example"], example_ar_model = phase_ar_example_r3b()
    phase_ar_sampling(ar_model)
    phase_ar_example_head_dims()
    launches["serving_daemon"] = phase_serving_daemon_r3b(example_ar_model)
    del ar_model, example_ar_model
    torch.cuda.empty_cache()
    launches["tools_prepare_ar"], launches["tools_eval_patch14l"] = phase_tools_prepare_ar_patch14l()
    torch.cuda.empty_cache()
    launches["tools_eval_r3b"] = phase_tools_eval_r3b()
    launches.update(phase_tools_demos_r3b())
    launches["int8_study"] = phase_int8_study_patch14l()
    torch.cuda.empty_cache()
    phase_native_packing()
    launches["tools_warm_start_patch14l"], block_pipe = phase_tools_warm_start_patch14l()
    (launches["tools_reference_convert"], launches["tools_reference_convert_r3b"],
     launches["tools_parity_roundtrip"]) = phase_tools_reference_convert(block_pipe)
    del block_pipe
    torch.cuda.empty_cache()
    launches["parallel_patch14l"] = phase_parallel_patch14l()
    torch.cuda.empty_cache()
    launches["pipeline_patch14l"], launches["compile_probe"] = phase_pipeline_patch14l()
    torch.cuda.empty_cache()
    phase_parallel_four_cards()

    for path, impls in PATH_IMPLS.items():
        check_impl_launches(launches[path], *impls)

    from dct_autoencoder_torch.kernels.attention import HEAD_DIMS

    # what every attention kernel is compiled for; other head dims run padded to the next
    instantiations = {"head_dims": list(HEAD_DIMS), "dropout_mode": [False, True],
                      "impls": ["mma (bfloat16)", "tf32x3 (float32)", "simt"],
                      "in_place": "mma and tf32x3 read and write rows of d in place where a row is whole 16-byte "
                                  "chunks (d % 8 == 0 in bfloat16, d % 4 == 0 in float32); other widths, and simt, "
                                  "are padded to the next head dim"}
    fp32_kernel = {"attention": "fwd", "attention_dq": "dq", "attention_dkv": "dkv"}
    kernels = []
    for key, name, source, replaces, counter, path in KERNEL_TABLE:
        head = cases[key][0]  # the main path's shape
        check(launches[path][counter] > 0, f"{name} was not launched on the {path} path")
        check(head["impl"] == "mma", f"{name}: the main path's shape was held with impl {head['impl']}")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[path][counter], "launches_on": path,
            "launches_by_path": {p: n.get(counter, 0) for p, n in launches.items()},
            "bias_mode_launches_by_path": {p: n["fwd_mode"]["bias"] for p, n in launches.items()
                                           if n.get("fwd_mode", {}).get("bias")} if key == "attention" else None,
            "max_abs_err": max(c["max_abs_err"] for c in cases[key]),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "ms_every_tile": head.get("ms_every_tile"), "shape": head["shape"], "card": smi,
            "impl": head.get("impl"), "simt_ms": head.get("simt_ms"), "kernel_info": head.get("kernel_info"),
            "instantiations": instantiations if key.startswith("attention") else None,
            "ms_no_dropout": head.get("ms_no_dropout"),
            "fp32": {"source": "dct_autoencoder_torch/csrc/" + ("attention_fwd_tf32x3.cu" if key == "attention" else "attention_bwd_tf32x3.cu"),
                     "shapes": fp32_figures(cases["fp32_times"], fp32_kernel[key])} if key in fp32_kernel else None,
            **{k: head[k] for k in ("wrapper_ms", "bound_tf32x3_ms", "bound_fp32_cuda_cores_ms", "bound_bytes_ms") if k in head},
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
