"""The 3xTF32 error model of the tensor-core DCT kernels, argued on the CPU.

The kernels (csrc/tf32x3_gemm3.cuh) split each operand into TF32 parts,
hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32``: round to nearest,
ties away from zero), and sum lo*hi + hi*lo + hi*hi in fp32, dropping
lo*lo.  Here that arithmetic is emulated with ``ops/dct.py::tf32_split`` and
fp32 matrix products, at the serving size and at a ragged 1000 x 700, and
held to the limit the card tests and chip_smoke.py hold the kernels to:
against a float64 computation of the same function, the largest error is at
most 8 x that of the fp32 plain version, over the whole output and over the
high-frequency quarter alone (i >= ch/2, j >= cw/2).  One TF32 product
(hi*hi alone) misses that limit more than tenfold (its error is ~400 x the
fp32 plain version's at these sizes), so the limit tells 3xTF32 from TF32.

The tensor cores also round each mma's fp32 sum toward zero.  Modelled
here as one rounding toward zero of each mma's exact result, a sum chained
through one accumulator over 448 (1,000) deep products misses the limit
(15x, 61x; on the card the first design missed the fp32 plain version by
4e-3 at a DC coefficient of 323), and the kernels' sum, each 16-deep stage
(two 8-deep slices) summed apart and added in fp32 with rounding to
nearest, meets it.

The DCT matrices come from per-device caches (no call after the first
builds or uploads one), and ``tf32_split`` rounds as the instruction does:
hi + lo equals the input to within 2^-22 relative; ties go away from zero.
"""
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.kernels import dct_patchify as tdp
from dct_autoencoder_torch.kernels import idct_unpatchify as tid
from dct_autoencoder_torch.ops import dct as tdct
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

F64_RATIO = 8.0  # chip_smoke.py DCT_F64_RATIO, tests/test_torch_cuda.py


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def test_tf32_split_is_exact_to_22_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32))
    hi, lo = tdct.tf32_split(x)
    assert bool(((_bits(hi) & 0x1FFF) == 0).all()) and bool(((_bits(lo) & 0x1FFF) == 0).all())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0**-22, rel
    # hi alone keeps 11 bits: half a TF32 ulp
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max().item() <= 2.0**-11
    assert torch.equal(tdct.tf32_split(torch.zeros(3))[0], torch.zeros(3))


@pytest.mark.parametrize(
    "value,want",
    [
        (1 + 2**-11, 1 + 2**-10),  # a tie: away from zero (to even would give 1)
        (-(1 + 2**-11), -(1 + 2**-10)),
        (1 + 3 * 2**-11, 1 + 2**-9),  # a tie above an odd mantissa
        (1 + 2**-11 - 2**-23, 1.0),  # just below the tie
        (1 + 2**-11 + 2**-23, 1 + 2**-10),  # just above
        (2 - 2**-23, 2.0),  # carries into the exponent
        (3.0, 3.0),
    ],
)
def test_tf32_round_ties_away_from_zero(value, want):
    got = tdct.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


def test_matrix_caches_return_the_same_tensors():
    tdct.dct_matrix_cropped.cache_clear()
    a = tdct.dct_matrix_cropped(40, 32)
    assert tdct.dct_matrix_cropped(40, 32) is a
    assert a.shape == (32, 40) and a.is_contiguous()
    np.testing.assert_array_equal(a.numpy(), tdct.dct_matrix(40).numpy()[:32])
    hi, lo = tdct.dct_matrix_tf32(43, 40, True, torch.device("cpu"))
    assert tdct.dct_matrix_tf32(43, 40, True, torch.device("cpu"))[0] is hi
    assert hi.shape == lo.shape == (43, 40)  # the transpose, 40 already a multiple of 4
    hi, lo = tdct.dct_matrix_tf32(43, 40, False, torch.device("cpu"))
    assert hi.shape == (40, 44) and bool((hi[:, 43:] == 0).all()) and bool((lo[:, 43:] == 0).all())
    m = tdct.dct_matrix_cropped(43, 40)
    assert (hi[:, :43] + lo[:, :43] - m).abs().max().item() <= 2.0**-22


def test_plain_versions_build_each_matrix_once():
    tdct.dct_matrix_cropped.cache_clear()
    x = torch.rand(1, 3, 24, 32, generator=torch.Generator().manual_seed(0))
    tdp.fused_ipt_dct_patchify_plain(x, 8, 24, 32)
    tid.fused_idct_unpatchify_rgb_plain(torch.rand(1, 3, 16, 24), 24, 32)
    misses = tdct.dct_matrix_cropped.cache_info().misses
    tdp.fused_ipt_dct_patchify_plain(x, 8, 24, 32)
    tid.fused_idct_unpatchify_rgb_plain(torch.rand(1, 3, 16, 24), 24, 32)
    assert tdct.dct_matrix_cropped.cache_info().misses == misses == 4


@pytest.mark.parametrize(
    "call",
    [
        lambda: tdp.fused_ipt_dct_patchify_cuda(torch.rand(1, 4, 16, 16), 8, 16, 16),  # not RGB
        lambda: tdp.fused_ipt_dct_patchify_cuda(torch.rand(1, 3, 16, 16), 8, 12, 16),  # crop not in patches
        lambda: tid.fused_idct_unpatchify_rgb_cuda(torch.rand(1, 3, 16, 24), 16, 16),  # plane wider than the output
    ],
    ids=["dct-channels", "dct-crop", "idct-plane"],
)
def test_cuda_wrappers_check_their_arguments_first(call):
    """A bad argument is refused before anything is built or launched."""
    with pytest.raises(ValueError):
        call()


def _mm_3xtf32(a, b):
    """The kernels' product: three TF32 products summed in fp32, lo*lo dropped."""
    ah, al = tdct.tf32_split(a)
    bh, bl = tdct.tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """One TF32 product: what the tensor cores give without the split."""
    return tdct.tf32_round(a) @ tdct.tf32_round(b)


def _ipt(x):
    """The colour transform in fp32, as the plain version and the kernels' pre-pass compute it."""
    from dct_autoencoder_torch.ops.colorspace import IPT_GAMMA, M_IPT, RGB2LMS

    lms = tdp._signed_pow(torch.einsum("ij,bjhw->bihw", torch.as_tensor(RGB2LMS, dtype=torch.float32), x), IPT_GAMMA)
    return torch.einsum("ij,bjhw->bihw", torch.as_tensor(M_IPT, dtype=torch.float32), lms)


def _errors(got, ref64, ch, cw):
    diff = (got.double() - ref64).abs()
    return diff.max().item(), diff[..., ch // 2 :, cw // 2 :].max().item()


@pytest.mark.parametrize("h,w,p", [(448, 448, 14), (1000, 700, 14)])
def test_3xtf32_dct_meets_the_float64_limit_and_tf32_does_not(h, w, p):
    ch, cw = (h // p) * p, (w // p) * p
    x = torch.rand(1, 3, h, w, generator=torch.Generator().manual_seed(h))
    dh, dw = tdct.dct_matrix_cropped(h, ch), tdct.dct_matrix_cropped(w, cw)
    ipt = _ipt(x)
    ref64 = tdp.fused_ipt_dct_patchify_plain(x, p, ch, cw, torch.float64)
    to_planes = lambda t: t.reshape(1, ch // p, cw // p, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(1, 3, ch, cw)
    ref64 = to_planes(ref64)
    fp32 = _errors(to_planes(tdp.fused_ipt_dct_patchify_plain(x, p, ch, cw)), ref64, ch, cw)
    x3 = _errors(_mm_3xtf32(_mm_3xtf32(dh, ipt), dw.T), ref64, ch, cw)
    one = _errors(_mm_tf32(_mm_tf32(dh, ipt), dw.T), ref64, ch, cw)
    for whole_or_hf in (0, 1):
        assert x3[whole_or_hf] <= F64_RATIO * fp32[whole_or_hf], (x3, fp32)
        assert one[whole_or_hf] > 10 * F64_RATIO * fp32[whole_or_hf], (one, fp32)


@pytest.mark.parametrize("h,w,p", [(448, 448, 14), (1000, 700, 14)])
def test_3xtf32_idct_meets_the_float64_limit_and_tf32_does_not(h, w, p):
    """The IDCT's products, on all frequencies and on the high-frequency quarter alone."""
    from dct_autoencoder_torch.ops.colorspace import IPT2LMS, IPT_GAMMA, LMS2RGB

    ch, cw = (h // p) * p, (w // p) * p
    x = torch.rand(1, 3, h, w, generator=torch.Generator().manual_seed(w))
    y = tdp.fused_ipt_dct_patchify_plain(x, p, ch, cw)
    y = y.reshape(1, ch // p, cw // p, 3, p, p).permute(0, 3, 1, 4, 2, 5).reshape(1, 3, ch, cw).contiguous()
    dh, dw = tdct.dct_matrix_cropped(h, ch), tdct.dct_matrix_cropped(w, cw)

    def rgb(ipt):
        lms = tdp._signed_pow(torch.einsum("ij,bjhw->bihw", torch.as_tensor(IPT2LMS, dtype=torch.float32), ipt), 1 / IPT_GAMMA)
        return torch.einsum("ij,bjhw->bihw", torch.as_tensor(LMS2RGB, dtype=torch.float32), lms)

    hf = torch.zeros(ch, cw)
    hf[ch // 2 :, cw // 2 :] = 1.0
    for planes in (y, y * hf):
        ref64 = tid.fused_idct_unpatchify_rgb_plain(planes, h, w, torch.float64)
        fp32 = (tid.fused_idct_unpatchify_rgb_plain(planes, h, w).double() - ref64).abs().max().item()
        x3 = (rgb(_mm_3xtf32(_mm_3xtf32(dh.T, planes), dw)).double() - ref64).abs().max().item()
        one = (rgb(_mm_tf32(_mm_tf32(dh.T, planes), dw)).double() - ref64).abs().max().item()
        assert x3 <= F64_RATIO * fp32, (x3, fp32)
        assert one > 10 * F64_RATIO * fp32, (one, fp32)


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x64.to(torch.float32)
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mm_tensor_cores(a, b, chained: bool):
    """3xTF32 on m16n8k8 with each mma's sum rounded toward zero: chained
    through one accumulator, or (the kernels) each 16-deep stage from zero
    and added to the accumulator in fp32."""
    ah, al = tdct.tf32_split(a.contiguous())
    bh, bl = tdct.tf32_split(b.contiguous())
    acc = al[..., :0] @ bh[..., :0, :]  # zeros of the product's shape
    for k0 in range(0, a.shape[-1], 16):
        d = acc if chained else torch.zeros_like(acc)
        for k in (slice(k0, k0 + 8), slice(k0 + 8, k0 + 16)):
            for x, y in ((al, bh), (ah, bl), (ah, bh)):  # the exact products of TF32 values
                d = _round_toward_zero(d.double() + x[..., k].double() @ y[..., k, :].double())
        acc = d if chained else acc + d
    return acc


@pytest.mark.parametrize("h,w,p", [(448, 448, 14), (1000, 700, 14)])
def test_truncating_tensor_core_sums_need_each_slice_summed_apart(h, w, p):
    """On the first and the last patch row of the DCT (the DC coefficient and
    the high-frequency quarter's last rows), so that it runs in a second."""
    ch, cw = (h // p) * p, (w // p) * p
    x = torch.rand(1, 3, h, w, generator=torch.Generator().manual_seed(h))
    rows = torch.cat([torch.arange(p), torch.arange(ch - p, ch)])
    dh, dw = tdct.dct_matrix_cropped(h, ch)[rows], tdct.dct_matrix_cropped(w, cw)
    ipt = _ipt(x)
    ref64 = dh.double() @ ipt.double() @ dw.double().T
    hf = torch.zeros(2 * p, cw, dtype=torch.bool)
    hf[p:, cw // 2 :] = True

    def errors(y):
        diff = (y.double() - ref64).abs()
        return diff.max().item(), diff[..., hf].max().item()

    fp32 = errors(dh @ ipt @ dw.T)
    sliced = errors(_mm_tensor_cores(_mm_tensor_cores(dh, ipt, False), dw.T, False))
    chained = errors(_mm_tensor_cores(_mm_tensor_cores(dh, ipt, True), dw.T, True))
    for whole_or_hf in (0, 1):
        assert sliced[whole_or_hf] <= F64_RATIO * fp32[whole_or_hf], (sliced, fp32)
    assert chained[0] > F64_RATIO * fp32[0], (chained, fp32)
