"""The float32 attention backward's 3xTF32 arithmetic, argued on the CPU against the JAX package.

On the card the float32 dq and dk/dv kernels (csrc/attention_bwd_tf32x3.cu,
impl "tf32x3") multiply on the tensor cores in 3xTF32: each operand, and p
and ds before the second products, is split into TF32 parts
(``ops/dct.py::tf32_split``: hi = tf32(x), lo = tf32(x - hi); the kernels
take hi by Veltkamp's split on the FP32 pipe and truncate lo, which is
emulated beside it and holds the same limits), and each m16n8k8 mma sums lo*hi + hi*lo + hi*hi (lo*lo dropped) into fp32.  The
tensor cores round each mma's sum toward zero, so the kernels sum each
8-deep slice's three mma from zero and add that to the accumulator in fp32,
rounding to nearest.  That arithmetic is emulated here (each mma's exact
result rounded toward zero, as tests/test_torch_dct_tf32.py models it) and
held, at small shapes in both mask modes, causal or not, to JAX's fp32
backward (the Pallas kernels _attn_dq_kernel and _attn_dkv_kernel in
interpret mode, on JAX's own saved o and lse) at the fp32 limit the card
holds the kernels to: 1e-5 of the largest value.  Against a float64
computation of the same function its largest error is at most 8 x that of
the fp32 plain version (chip_smoke.py's ATTN_F64_RATIO; measured here
0.3-2.2 x, where chaining the products over the head dim on the tensor
cores gave up to 8.7 x and chaining passes of 32 rows in the second
products up to 3.5 x); one TF32 product (hi*hi alone) misses 1e-5, so the
limit tells 3xTF32 from TF32.  The emulation is test code, not a path of
the package: on the CPU the port runs ``attention_bwd_plain``.

Also here: which implementation a float32 launch takes by default (tf32x3,
the backward's and, since its own kernel, the forward's), and that a float32 backward
whose library does not build raises instead of falling back to simt.
"""
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from dct_autoencoder_torch.kernels import _build  # noqa: E402
from dct_autoencoder_torch.kernels import attention as tatt  # noqa: E402
from dct_autoencoder_torch.ops.dct import tf32_round, tf32_split  # noqa: E402
from dct_autoencoder_tpu.kernels import attention as jatt  # noqa: E402
from test_torch_kernels import make_inputs  # noqa: E402
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x64.to(torch.float32)
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _kernel_split(t: torch.Tensor):
    """The kernels' split: hi = t rounded to 11 significant bits by Veltkamp's
    split (c = 8193 t, hi = c - (c - t), each step rounded in fp32), lo =
    t - hi (exact) with its low 13 bits cleared."""
    c = t * 8193.0
    hi = c - (c - t)
    return hi, ((t - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


SPLITS = {"tf32_split": tf32_split, "kernel": _kernel_split}


def _tc_product(a, b, split=_kernel_split):
    """a (..., m, k) @ b (..., k, n) as the kernels compute it: per 8-deep
    slice three mma (lo*hi, hi*lo, hi*hi of the TF32 parts) from zero, each
    mma's exact sum rounded toward zero onto the slice's running sum, and the
    slices added in fp32 in order."""
    depth = -(-a.shape[-1] // 8) * 8  # zero-filled to whole slices, as the kernels' tiles are
    a = torch.nn.functional.pad(a, (0, depth - a.shape[-1]))
    b = torch.nn.functional.pad(b, (0, 0, 0, depth - b.shape[-2]))
    ah, al = split(a.contiguous())
    bh, bl = split(b.contiguous())
    by_slice = lambda x, y: torch.einsum(  # noqa: E731  (..., slice, m, n): each slice's exact products
        "...mjk,...jkn->...jmn", x.double().unflatten(-1, (-1, 8)), y.double().unflatten(-2, (-1, 8)))
    d = torch.zeros(())
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        d = _round_toward_zero(d.double() + by_slice(x, y))
    out = torch.zeros(d.shape[:-3] + d.shape[-2:], dtype=torch.float32)
    for j in range(d.shape[-3]):
        out = out + d[..., j, :, :]
    return out


def _tf32_product(a, b, split=None):
    """One TF32 product (hi*hi), summed in fp32: what the tensor cores give without the split."""
    return tf32_round(a.contiguous()) @ tf32_round(b.contiguous())


def _emulated_bwd(product, split, q, k, v, q_ids, kv_ids, o, lse, do, scale, mode, causal):
    """(dq, dk, dv) of the tensor-core kernels' arithmetic with `product` (and
    `split`) for every matrix product; the mask, exp and ds in fp32 as the
    kernels take them."""
    s = q.shape[2]
    dots = product(q, k.transpose(-1, -2), split)
    dp = product(do, v.transpose(-1, -2), split)
    allowed = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
    if causal:
        pos = torch.arange(s)
        allowed = allowed & (pos[None, :] <= pos[:, None])
    logits = dots * scale
    logits = logits + allowed.float() if mode == "bias" else torch.where(allowed, logits, torch.full_like(logits, tatt.NEG_INF))
    p = torch.exp(logits - lse[..., None])
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = product(ds, k, split)
    dk = product(ds.transpose(-1, -2), q, split)
    dv = product(p.transpose(-1, -2), do, split)
    return dq, dk, dv


def _ids(ids, pad):
    return np.where(pad, -2, ids).astype(np.int32), np.where(pad, -1, ids).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_case(s, d, mode, causal):
    """The inputs (q, k, v, q_ids, kv_ids, JAX's o and lse, do) and JAX's fp32
    (dq, dk, dv), as numpy arrays; one JAX run for both splits."""
    q, k, v, ids, pad = make_inputs(b=1, h=2, s=s, d=d, seed=s + d)
    q_ids, kv_ids = _ids(ids, pad)
    jq, jk, jv, jqi, jki = map(jnp.asarray, (q, k, v, q_ids, kv_ids))
    o, lse = jatt._flash_attention_fwd_impl(jq, jk, jv, jqi, jki, d**-0.5, mode, causal, True)
    do = np.random.default_rng(s).standard_normal(o.shape).astype(np.float32)
    want = jatt._flash_attention_bwd_impl(jq, jk, jv, jqi, jki, o, lse, jnp.asarray(do), d**-0.5, mode, causal, True)
    return tuple(np.array(a) for a in (q, k, v, q_ids, kv_ids, o, lse, do)), tuple(np.array(w) for w in want)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["block", "bias"])
@pytest.mark.parametrize("s,d", [(128, 32), (173, 64)])
def test_emulated_3xtf32_backward_matches_jax_and_float64(s, d, mode, causal, split):
    scale = d**-0.5
    inputs, want = _jax_case(s, d, mode, causal)
    args = [torch.from_numpy(a.copy()) for a in inputs]
    got = _emulated_bwd(_tc_product, SPLITS[split], *args, scale, mode, causal)
    one_tf32 = _emulated_bwd(_tf32_product, None, *args, scale, mode, causal)
    plain = tatt.attention_bwd_plain(*args, scale, mode, causal)
    ref64 = chip_smoke.attention_bwd_f64(*args, scale, mode, causal)
    worst_tf32 = 0.0
    for name, g, w, t, pl, r in zip(("dq", "dk", "dv"), got, want, one_tf32, plain, ref64):
        w = torch.from_numpy(w)
        tol = 1e-5 * max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        e64, p64 = (g.double() - r).abs().max().item(), (pl.double() - r).abs().max().item()
        print(f"{name}: max|3xTF32 - JAX| {err:.3g} (limit {tol:.3g}); float64 error {e64:.3g}, fp32 plain {p64:.3g}")
        assert err <= tol, (name, err, tol)
        assert e64 <= chip_smoke.ATTN_F64_RATIO * p64, (name, e64, p64)
        worst_tf32 = max(worst_tf32, (t - w).abs().max().item() / tol)
    assert worst_tf32 > 1.0, worst_tf32  # one TF32 product misses the fp32 limit


def test_float32_takes_tf32x3_backward_and_simt_forward():
    for kernel in ("dq", "dkv"):
        assert tatt._kernel_impl(None, torch.float32, kernel) == "tf32x3"
        assert tatt._kernel_impl(None, torch.bfloat16, kernel) == "mma"
        assert tatt._kernel_impl("simt", torch.float32, kernel) == "simt"
        with pytest.raises(TypeError, match="float32"):
            tatt._kernel_impl("tf32x3", torch.bfloat16, kernel)
    # the forward has its own 3xTF32 kernel now (tests/test_torch_attention_fwd_tf32x3.py)
    assert tatt._kernel_impl(None, torch.float32, "fwd") == tatt._kernel_impl(None, torch.float32) == "tf32x3"
    assert tatt._kernel_impl("simt", torch.float32, "fwd") == "simt"
    with pytest.raises(ValueError, match="impl"):
        tatt._kernel_impl("wgmma", torch.float32, "fwd")
    assert tatt.IMPLS.index("tf32x3") == 2  # the C entry points' number
    assert set(tatt.LAUNCHES_BWD_IMPL) == set(tatt.IMPLS) and set(tatt.LAUNCHES_FWD_IMPL) == set(tatt.IMPLS)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_float32_backward_that_cannot_build_raises(monkeypatch, kernel):
    """The wrapper asks for the 3xTF32 library alone, and a failure to build it
    raises: float32 never drops back to the CUDA-core kernels quietly."""
    asked = []

    def failing_build(name):
        asked.append(name)
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", failing_build)
    q = torch.zeros((1, 2, 8, 32))
    ids = torch.zeros((1, 8), dtype=torch.int32)
    rows = torch.zeros((1, 2, 8))
    before = dict(tatt.LAUNCHES_BWD_IMPL)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if kernel == "dq":
            tatt.attention_dq_cuda(q, q, q, ids, ids, q, rows, q, 1.0)
        else:
            tatt.attention_dkv_cuda(q, q, q, ids, ids, rows, rows, q, 1.0)
    assert asked == [f"attention_bwd_tf32x3_{kernel}"]
    assert tatt.LAUNCHES_BWD_IMPL == before
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tatt.attention_kernel_info(kernel, "tf32x3", torch.float32, 64)


def test_each_backward_library_is_a_source_of_its_own_half():
    for kernel, part in (("dq", "0"), ("dkv", "1")):
        name = f"attention_bwd_tf32x3_{kernel}"
        assert _build.SOURCES[name] == "attention_bwd_tf32x3.cu"
        assert _build.DEFINES[name] == [f"-DATTN_BWD_PART={part}"]
        assert _build.DEFINES[f"attention_bwd_{kernel}"] == _build.DEFINES[name]
