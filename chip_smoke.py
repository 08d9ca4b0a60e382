"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py            # add --profile for device-time breakdowns

Builds the five hand-written CUDA kernels from dct_autoencoder_torch/csrc
(nvcc, sm_90a), holds each against its plain PyTorch version at the shapes
the main paths give it, and then drives the paths themselves:
  * the serving round trip with the trained checkpoint in
    docs/calibrated_run_r3b/model (and the same batch through the port on
    the CPU in fp32), and a lossless no-model round trip;
  * one forward of a random-init patch14-L model at full width on a 64 x 256
    packed batch;
  * train() for 20 steps on that checkpoint (bf16 compute, fp32 masters) on
    one fixed packed batch, its first step held against the port's fp32 CPU
    run;
  * train() at the full width of patch14-L on 64 x 256 batches, then timed
    train steps.
Every phase prints one JSON line; any failed check raises and the script
exits non-zero.  The line before the last lists the kernels with their
launches on the main paths, errors, times and bounds; the last line is
{"ok": true, "device": {...}}.

Needs a CUDA device, and exits non-zero without one.  Imports no JAX.
"""
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ATTN_ATOL_BF16 = 2e-2
# backward: dq, dk, dv reach ~4, where half a bf16 ulp is 1.6e-2; the kernels keep
# p and ds in fp32 and round once at the store, the plain version is fp32 inside
ATTN_BWD_ATOL_BF16 = 3e-2
DCT_REL_TOL = 1e-5
MIN_CODE_AGREEMENT = 0.95
MAX_PSNR_DELTA_DB = 0.5
MIN_LOSSLESS_PSNR_DB = 60.0
# bf16 training step on the card against the port's fp32 step on the CPU, same batch
MAX_TRAIN_LOSS_REL = 0.05
MAX_TRAIN_GRAD_NORM_REL = 0.30


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 25) -> float:
    """Median of `reps` CUDA-event timings of fn(), after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype):
    """The additive mask that makes scaled_dot_product_attention compute the same
    function, and the (query, key) pairs whose products the function needs."""
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
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
    check(err <= tol, f"attention {mode} {(b, h, s, d)}: max|diff| {err} > {tol}")
    check(torch.isfinite(o).all().item(), "attention output not finite")
    if mode == "block":
        pad_max = o.transpose(1, 2)[pad].abs().max().item() if pad.any() else 0.0
        check(pad_max == 0.0, f"attention block mode: padded queries not 0 ({pad_max})")

    sdpa_mask, pairs = _sdpa_mask_and_pairs(q_ids, kv_ids, mode, dtype)
    library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask, scale=scale)

    elt = q.element_size()
    nbytes = 4 * b * h * s * d * elt + 2 * b * s * 4 + b * h * s * 4
    flops = 4 * h * d * pairs
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    return {
        "shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode,
        "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": tol,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _attention_bwd_case(b, h, s, d, dtype, mode, gen):
    """The dq and dk/dv kernels against attention_bwd_plain; o and lse come from the forward kernel."""
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
    plain_ms, library_ms = time_ms(plain, reps=10), time_ms(library)
    common = {
        "shape": [b, h, s, d], "dtype": str(dtype).split(".")[-1], "mode": mode, "tol": tol,
        "plain_ms": plain_ms, "plain_computes": "dq, dk and dv", "library_ms": library_ms,
        "library_computes": "dq, dk and dv (backward of scaled_dot_product_attention)",
    }
    return {
        "attention_dq": {
            **common, "max_abs_err": errs["dq"], "delta_max_abs_err": delta_err, "ms": time_ms(dq_kernel),
            "bound_ms": dq_bound[0], "bound_by": dq_bound[1],
        },
        "attention_dkv": {
            **common, "max_abs_err": max(errs["dk"], errs["dv"]), "ms": time_ms(dkv_kernel),
            "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
        },
    }


def _dct_cases(gen):
    from dct_autoencoder_torch.kernels import dct_patchify as P
    from dct_autoencoder_torch.kernels import idct_unpatchify as I

    out = {"dct": [], "idct": []}
    for b, h, w, p in [(16, 448, 448, 14), (2, 1000, 700, 14)]:
        ch, cw = (h // p) * p, (w // p) * p
        x = torch.rand(b, 3, h, w, generator=gen).cuda()
        kernel = lambda: P.fused_ipt_dct_patchify_cuda(x, p, ch, cw)
        plain = lambda: P.fused_ipt_dct_patchify_plain(x, p, ch, cw)
        y = kernel()
        torch.cuda.synchronize()
        y_ref = plain()
        err, vmax = (y - y_ref).abs().max().item(), y_ref.abs().max().item()
        check(err <= DCT_REL_TOL * vmax, f"dct_patchify {(b, h, w)}: max|diff| {err} > {DCT_REL_TOL} x {vmax}")
        flops = b * 3 * (2 * ch * h * w + 2 * ch * w * cw)
        nbytes = 4 * (b * 3 * h * w + b * 3 * ch * cw + ch * h + cw * w)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        out["dct"].append({
            "shape": [b, 3, h, w], "crop": [ch, cw], "max_abs_err": err, "max_abs_value": vmax,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })

        planes = y_ref.reshape(b, ch // p, cw // p, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(b, 3, ch, cw).contiguous()
        kernel = lambda: I.fused_idct_unpatchify_rgb_cuda(planes, h, w)
        plain = lambda: I.fused_idct_unpatchify_rgb_plain(planes, h, w)
        r = kernel()
        torch.cuda.synchronize()
        r_ref = plain()
        err, vmax = (r - r_ref).abs().max().item(), r_ref.abs().max().item()
        check(err <= DCT_REL_TOL * vmax, f"idct_unpatchify {(b, h, w)}: max|diff| {err} > {DCT_REL_TOL} x {vmax}")
        if (ch, cw) == (h, w):
            check((r - x).abs().max().item() < 1e-3, "DCT kernel -> IDCT kernel does not give the image back")
        flops = b * 3 * (2 * h * ch * cw + 2 * h * cw * w)
        nbytes = 4 * (b * 3 * ch * cw + b * 3 * h * w + ch * h + cw * w)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)
        out["idct"].append({
            "shape": [b, 3, ch, cw], "out": [h, w], "max_abs_err": err, "max_abs_value": vmax,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return out


def phase_kernels():
    gen = torch.Generator().manual_seed(0)
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
    ]
    cases = {
        "attention": attn,
        "attention_dq": [c["attention_dq"] for c in bwd],
        "attention_dkv": [c["attention_dkv"] for c in bwd],
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


def phase_serving():
    import dct_autoencoder_torch as dt
    from dct_autoencoder_torch import kernels as K

    ims = smooth_images(8, 448, seed=0)

    pipe = dt.DCTPipeline.from_pretrained(R3B)  # bf16 on the card
    check(pipe.model.device.type == "cuda", "pipeline did not land on the card")
    pipe.processor.rng = random.Random(0)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    records = pipe.encode(ims)
    recon = pipe.decode(records)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = K.launch_counts()
    check(all(launches[k] > 0 for k in SERVING_KERNELS), f"a kernel was not launched on the serving path: {launches}")
    check(launches["attention_dq"] == launches["attention_dkv"] == 0, f"serving ran a backward kernel: {launches}")
    check(len(recon) == len(ims) and all(r.shape == im.shape and np.isfinite(r).all() for r, im in zip(recon, ims)),
          "reconstructions have the wrong shape or are not finite")
    gpu_psnr = statistics.mean(psnr(r, im) for r, im in zip(recon, ims))

    cpu = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu")
    cpu.processor.rng = random.Random(0)
    cpu_records = cpu.encode(ims)
    cpu_psnr = statistics.mean(psnr(r, im) for r, im in zip(cpu.decode(cpu_records), ims))
    agree = code_agreement(records, cpu_records)
    check(agree >= MIN_CODE_AGREEMENT, f"code agreement with the CPU fp32 run {agree} < {MIN_CODE_AGREEMENT}")
    check(abs(gpu_psnr - cpu_psnr) <= MAX_PSNR_DELTA_DB, f"PSNR {gpu_psnr} vs CPU fp32 {cpu_psnr}")
    emit({
        "phase": "serving_roundtrip_r3b", "images": len(ims), "size": 448, "dtype": "bfloat16",
        "tokens": sum(len(r["codes"]) for r in records), "psnr_db": gpu_psnr, "cpu_fp32_psnr_db": cpu_psnr,
        "psnr_delta_db": gpu_psnr - cpu_psnr, "code_agreement_vs_cpu_fp32": agree,
        "launches": launches, "wall_s": wall_s,
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
    rows = [
        (e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    check(busy > 0, "the profiler saw no device time")
    return {
        "wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy,
        "device_idle_share": max(0.0, 1 - busy / wall_ms),
        "top_kernels": [{"kernel": k[:120], "ms_per_call": ms, "launches_per_call": n} for k, ms, n in rows[:top]],
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
    attn_launches = K.launch_counts()["attention"]
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
    launches = K.launch_counts()
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
    launches = K.launch_counts()
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
    check(all(v == n_layers for v in per_step.values()), f"attention launches per step {per_step} for {n_layers} layers")
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


# ---------------------------------------------------------------- main


# (cases key, name, source, TPU kernel, launch counter, the main path its count is read from)
KERNEL_TABLE = [
    ("attention", "packed_attention_fwd", "dct_autoencoder_torch/csrc/attention_fwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:91", "attention", "serving"),
    ("attention_dq", "packed_attention_bwd_dq", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:194", "attention_dq", "train_patch14l"),
    ("attention_dkv", "packed_attention_bwd_dkv", "dct_autoencoder_torch/csrc/attention_bwd.cu",
     "dct_autoencoder_tpu/kernels/attention.py:236", "attention_dkv", "train_patch14l"),
    ("dct", "fused_ipt_dct_patchify", "dct_autoencoder_torch/csrc/dct_patchify.cu",
     "dct_autoencoder_tpu/kernels/dct_patchify.py:43", "dct_patchify", "serving"),
    ("idct", "fused_idct_unpatchify_rgb", "dct_autoencoder_torch/csrc/idct_unpatchify.cu",
     "dct_autoencoder_tpu/kernels/idct_unpatchify.py:47", "idct_unpatchify", "serving"),
]
SERVING_KERNELS = ("attention", "dct_patchify", "idct_unpatchify")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    smi = phase_environment()
    cases = phase_kernels()
    profile = "--profile" in sys.argv[1:]
    launches = {"serving": phase_serving()}
    phase_full_width(profile)
    torch.cuda.empty_cache()
    launches["train_r3b"] = phase_train_r3b()
    torch.cuda.empty_cache()
    launches["train_patch14l"] = phase_train_full_width(profile)

    kernels = []
    for key, name, source, replaces, counter, path in KERNEL_TABLE:
        head = cases[key][0]  # the main path's shape
        check(launches[path][counter] > 0, f"{name} was not launched on the {path} path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[path][counter], "launches_on": path,
            "launches_by_path": {p: n[counter] for p, n in launches.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases[key]),
            "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "card": smi,
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
