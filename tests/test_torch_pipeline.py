"""The port's extractor, packing and DCTPipeline against the JAX package.

Images are made with numpy from a seed and fed to both packages on the CPU.

Tolerances:
  * DCT patch tokens atol 2e-4 (as tests/test_kernels.py).  Tokens are
    compared as sets keyed by (channel, h, w): equal importance scores may
    sort in another order in the two packages;
    Each package is also held on its own to a float64 numpy computation of
    the same tokens (atol 1e-4), so a failure names the side that moved;
  * RGB from postprocess atol 2e-4; images decoded from the same records by
    the two packages atol 1e-3 (fp32 on both sides; the signed power 1/0.43
    of the colour transform amplifies rounding).
"""
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.patches import extractor as text
from dct_autoencoder_tpu.patches import extractor as jext
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from test_torch_model import R3B, to_torch_batch
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(channels=3, patch_size=8, sample_patches_beta=0.0, max_patch_h=8, max_patch_w=8, max_seq_len=192)


def _images(sizes, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    ims = [rng.uniform(0.05, 0.95, size=(3, h, w)).astype(np.float32) for h, w in sizes]
    if dtype == np.uint8:
        ims = [(im * 255).astype(np.uint8) for im in ims]
    return ims


def _extractors(**overrides):
    kw = {**KW, **overrides}
    return jext.DCTAutoencoderFeatureExtractor(**kw), text.DCTAutoencoderFeatureExtractor(**kw, device="cpu")


def _tokens_f64(im, p, grid):
    """RGB -> IPT -> whole-image DCT -> patches in float64 numpy: {(c, h, w): (p*p,)}."""
    from dct_autoencoder_torch.ops.colorspace import IPT_GAMMA, M_IPT, RGB2LMS

    x = np.asarray(im, np.float64) / (255.0 if im.dtype == np.uint8 else 1.0)
    lms = np.einsum("ij,jhw->ihw", np.asarray(RGB2LMS, np.float64), x)
    ipt = np.einsum("ij,jhw->ihw", np.asarray(M_IPT, np.float64), np.sign(lms) * np.abs(lms) ** IPT_GAMMA)

    def dct(n):
        k, i = np.arange(n)[:, None], np.arange(n)[None, :]
        m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
        m[0] = np.sqrt(1.0 / n)
        return m

    y = dct(x.shape[1]) @ ipt @ dct(x.shape[2]).T
    return {
        (c, h, w): y[c, h * p : (h + 1) * p, w * p : (w + 1) * p].reshape(-1)
        for c in range(3) for h in range(grid[0]) for w in range(grid[1])
    }


def _token_map(d):
    return {
        (int(c), int(h), int(w)): p
        for p, (h, w), c in zip(np.asarray(d["patches"]), np.asarray(d["positions"]), np.asarray(d["channels"]))
    }


@pytest.mark.parametrize("size", [(64, 80), (43, 61), (96, 72)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_preprocess_matches_jax(size, dtype):
    """Same token set, same values, same metadata; (96, 72) exceeds the 8x8 grid."""
    jp, tp = _extractors()
    (im,) = _images([size], seed=size[0], dtype=dtype)
    dj, dt_ = jp.preprocess(im), tp.preprocess(im)
    assert dj["patch_sizes"] == dt_["patch_sizes"] and dj["original_sizes"] == dt_["original_sizes"]
    mj, mt = _token_map(dj), _token_map(dt_)
    assert mj.keys() == mt.keys()
    want = _tokens_f64(im, KW["patch_size"], dj["patch_sizes"])
    for key in mj:
        np.testing.assert_allclose(mt[key], want[key], atol=1e-4, err_msg=f"the port's token {key} against float64")
        np.testing.assert_allclose(mj[key], want[key], atol=1e-4, err_msg=f"the JAX token {key} against float64")
        np.testing.assert_allclose(mt[key], mj[key], atol=2e-4)


def test_preprocess_top_cap_matches_jax():
    """With a budget below the token count, both keep the same top tokens."""
    jp, tp = _extractors(max_seq_len=40)
    (im,) = _images([(64, 64)], seed=7)
    dj, dt_ = jp.preprocess(im), tp.preprocess(im)
    assert len(dt_["patches"]) == 40
    assert _token_map(dj).keys() == _token_map(dt_).keys()


def test_token_budget_draws_match_jax():
    """Given the same random.Random, the budgets match draw for draw."""
    jp, tp = _extractors(sample_patches_beta=0.02, max_seq_len=256)
    jp.rng, tp.rng = random.Random(11), random.Random(11)
    assert [jp.sample_k(3072) for _ in range(50)] == [tp.sample_k(3072) for _ in range(50)]


@pytest.mark.parametrize("batch_size,drain", [(None, False), (2, True)])
def test_iter_batches_matches_jax(batch_size, drain):
    jp, tp = _extractors(max_seq_len=128)
    ds = [jp.preprocess(im) for im in _images([(64, 64), (40, 48), (56, 32), (64, 40), (32, 32), (48, 64)], seed=2)]
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    jb = list(jp.iter_batches(iter([cols]), batch_size=batch_size, drain=drain))
    tb = list(tp.iter_batches(iter([cols]), batch_size=batch_size, drain=drain))
    assert len(jb) == len(tb) > 0
    for j, t in zip(jb, tb):
        for name in ("patches", "key_pad_mask", "batched_image_ids", "patch_channels", "patch_positions"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        assert t.patch_sizes == j.patch_sizes and t.original_sizes == j.original_sizes


def test_postprocess_matches_jax():
    jp, tp = _extractors()
    ims = _images([(64, 64), (43, 61), (64, 80)], seed=3)
    ds = [jp.preprocess(im) for im in ims]
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    jb = next(jp.iter_batches(iter([cols]), batch_size=None))
    want = jp.postprocess(jb)
    got = tp.postprocess(to_torch_batch(jb))
    for g, w, im in zip(got, want, ims):
        assert g.shape == im.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4)


def test_no_model_roundtrip_is_lossless():
    """beta=0 with the full grid keeps every token: image back to fp32 rounding."""
    _, tp = _extractors(max_seq_len=8 * 8 * 3)
    ims = _images([(64, 64), (64, 48)], seed=4)
    ds = tp.preprocess_many(ims)
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    out = tp.postprocess(next(tp.iter_batches(iter([cols]), batch_size=None)))
    for o, im in zip(out, ims):
        np.testing.assert_allclose(o, im, atol=1e-4)


@pytest.fixture(scope="module")
def pipelines():
    jpipe = JaxPipeline.from_pretrained(R3B, dtype=jnp.float32, prefer_int8="never")
    tpipe = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu", prefer_int8="never")
    return jpipe, tpipe


@pytest.mark.parametrize("encoder", ["jax", "torch"])
def test_records_cross_between_packages(encoder, pipelines):
    """Records encoded by either package decode in the other."""
    jpipe, tpipe = pipelines
    ims = _images([(112, 140), (98, 98), (84, 126)], seed=5)
    jpipe.processor.rng, tpipe.processor.rng = random.Random(0), random.Random(0)
    enc = jpipe if encoder == "jax" else tpipe
    records = enc.encode(ims)
    assert [tuple(r["original_size"]) for r in records] == [im.shape[1:] for im in ims]
    by_jax, by_torch = jpipe.decode(records), tpipe.decode(records)
    for a, b, im in zip(by_jax, by_torch, ims):
        assert b.shape == im.shape
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-3)


def test_records_match_jax_records(pipelines):
    """Same images and budgets: same tokens and the same codes."""
    jpipe, tpipe = pipelines
    ims = _images([(112, 140), (98, 98)], seed=6)
    jpipe.processor.rng, tpipe.processor.rng = random.Random(1), random.Random(1)
    jr, tr = jpipe.encode(ims), tpipe.encode(ims)
    for a, b in zip(jr, tr):
        assert tuple(a["size"]) == tuple(b["size"])
        ca = {(d["c"], d["h"], d["w"]): d["data"] for d in a["codes"]}
        cb = {(d["c"], d["h"], d["w"]): d["data"] for d in b["codes"]}
        assert ca == cb


def test_port_imports_no_jax():
    code = (
        "import sys, dct_autoencoder_torch, dct_autoencoder_torch.train, dct_autoencoder_torch.ops.stats\n"
        "import dct_autoencoder_torch.train.pixel_loss, dct_autoencoder_torch.models.quant\n"
        "from dct_autoencoder_torch.tools import serve, bench_serving, quantize_checkpoint, int8_study\n"
        "from dct_autoencoder_torch.tools import viz, preproc_dataset\n"
        "import dct_autoencoder_torch.data\n"
        "from dct_autoencoder_torch.data import shards, images, augment, prefetch, dataset\n"
        "from dct_autoencoder_torch.train import cli, opt8bit, loop, losses, checkpoint, pixel_loss\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'dct_autoencoder_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


@pytest.mark.parametrize(
    "entry",
    ["get_model_and_processor", "from_config", "from_pretrained", "extractor", "trainable_model", "resumed_model"],
)
def test_entry_points_need_cuda_by_default(entry, monkeypatch):
    """Without a CUDA device and without device='cpu', every entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dt.DCTAutoencoderConfig.from_json_file(os.path.join(R3B, "config.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "get_model_and_processor":
            dt.get_model_and_processor(cfg)
        elif entry == "from_config":
            dt.DCTPipeline.from_config(cfg)
        elif entry == "from_pretrained":
            dt.DCTPipeline.from_pretrained(R3B)
        elif entry == "trainable_model":
            dt.DCTAutoencoder(cfg)  # what train() and make_train_step are handed
        elif entry == "resumed_model":
            dt.get_model_and_processor(resume_path=R3B)
        else:
            text.DCTAutoencoderFeatureExtractor(**KW)
