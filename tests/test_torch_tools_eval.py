"""The port's checkpoint evaluation tool (tools/eval.py) against the JAX package's, on the CPU.

Fixture: the trained checkpoint docs/calibrated_run_r3b/model, in float32 in
both packages (the float checkpoint, prefer_int8='never', as the tool loads
it), on two seeded smooth 112 x 112 PNG images written to a temporary
directory.

Tolerances: codes exactly equal (keyed by channel and position, as
tests/test_torch_pipeline.py holds records); token counts equal; PSNR
within 1e-3 dB, per image and on average; perplexity within 1e-5 relative.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.tools import eval as teval
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from dct_autoencoder_tpu.tools import eval as jeval
from test_torch_model import R3B
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

SIZE = 112
PSNR_ATOL_DB = 1e-3
PPL_RTOL = 1e-5


def smooth_png(path, size, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    im = np.full((size, size, 3), 0.5)
    for c in range(3):
        for _ in range(5):
            fy, fx = rng.uniform(-3, 3, size=2)
            im[..., c] += rng.uniform(0.05, 0.15) * np.cos(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 6.3))
    Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def image_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_images")
    return [smooth_png(d / f"im{i}.png", SIZE, seed=i) for i in range(2)]


@pytest.fixture(scope="module")
def pipelines():
    jpipe = JaxPipeline.from_pretrained(R3B, dtype=jnp.float32, prefer_int8="never")
    tpipe = dt.DCTPipeline.from_pretrained(R3B, dtype=torch.float32, device="cpu", prefer_int8="never")
    return jpipe, tpipe


def _capture_records(pipe):
    seen = []
    encode = pipe.encode

    def wrapped(images, *a, **k):
        seen.append(encode(images, *a, **k))
        return seen[-1]

    pipe.encode = wrapped
    return seen


def _codes_by_token(records):
    return [{(d["c"], d["h"], d["w"]): d["data"] for d in rec["codes"]} for rec in records]


def assert_rows_match(got, want):
    assert got["n_tokens"] == want["n_tokens"]
    assert got["psnr"] == pytest.approx(want["psnr"], abs=PSNR_ATOL_DB)
    np.testing.assert_allclose(got["psnr_per_image"], want["psnr_per_image"], atol=PSNR_ATOL_DB + 1e-3)  # rounded to 1e-3
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=PPL_RTOL)


def test_evaluate_checkpoint_matches_jax(pipelines, image_paths):
    jpipe, tpipe = pipelines
    ims_j, ims_t = jeval.load_images(image_paths, resize=SIZE), teval.load_images(image_paths, resize=SIZE)
    for a, b in zip(ims_j, ims_t):
        np.testing.assert_array_equal(a, b)
    jrec, trec = _capture_records(jpipe), _capture_records(tpipe)
    try:
        want = jeval.evaluate_checkpoint(jpipe, ims_j, seed=7)
        got = teval.evaluate_checkpoint(tpipe, ims_t, seed=7)
    finally:
        del jpipe.encode, tpipe.encode
    assert _codes_by_token(trec[0]) == _codes_by_token(jrec[0])
    assert set(got) == set(want)
    assert_rows_match(got, want)
    assert 0.0 < got["psnr"] < 60.0 and 1.0 < got["perplexity"] <= 1024
    # the reseed gives the same budget again
    assert teval.evaluate_checkpoint(tpipe, ims_t, seed=7) == got


def _perturbed_copy(src, dst, seed):
    """A copy of checkpoint `src` whose float weights carry 2 % seeded noise."""
    shutil.copytree(src, dst)
    rng = np.random.default_rng(seed)
    with np.load(os.path.join(src, "params.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    arrays = {k: (v * (1 + 0.02 * rng.standard_normal(v.shape))).astype(v.dtype) for k, v in arrays.items()}
    np.savez(os.path.join(dst, "params.npz"), **arrays)


def test_scan_matches_jax_with_one_pipeline(tmp_path, image_paths, monkeypatch, capsys):
    """main(scan=...) over ckpt_000001 (perturbed weights) and model (r3b):
    both packages write the same rows, a stale eval.jsonl is replaced, and
    the port builds one DCTPipeline and swaps the weights into it."""
    scan = tmp_path / "run"
    scan.mkdir()
    _perturbed_copy(R3B, scan / "ckpt_000001", seed=3)
    shutil.copytree(R3B, scan / "model")
    stale = json.dumps({"step": "stale"}) + "\n"
    (scan / "eval.jsonl").write_text(stale)
    (tmp_path / "jax.jsonl").write_text(stale)
    images = ",".join(image_paths)

    real_jax = JaxPipeline.from_pretrained.__func__
    monkeypatch.setattr(JaxPipeline, "from_pretrained", classmethod(
        lambda cls, path, **kw: real_jax(cls, path, **{**kw, "dtype": jnp.float32})))
    want = jeval.main(scan=str(scan), images=images, resize=SIZE, output=str(tmp_path / "jax.jsonl"))

    built = []
    real_port = dt.DCTPipeline.from_pretrained.__func__

    def counting(cls, path, **kw):
        built.append(kw)
        return real_port(cls, path, **kw)

    monkeypatch.setattr(dt.DCTPipeline, "from_pretrained", classmethod(counting))
    got = teval.main(scan=str(scan), images=images, resize=SIZE, device="cpu")

    assert len(built) == 1 and built[0]["prefer_int8"] == "never" and built[0]["dtype"] == torch.float32
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["ckpt_000001", "model"]
    for g, w in zip(got, want):
        assert g["checkpoint"] == w["checkpoint"]
        assert_rows_match(g, w)
    assert got[0]["psnr"] != got[1]["psnr"]  # the weights were swapped
    for path, rows in ((scan / "eval.jsonl", got), (tmp_path / "jax.jsonl", want)):
        assert [json.loads(x) for x in path.read_text().splitlines()] == rows
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed[-2:] == got


def test_main_needs_images_and_a_checkpoint():
    with pytest.raises(ValueError, match="--images"):
        teval.main(checkpoint=R3B, device="cpu")
    with pytest.raises(ValueError, match="--checkpoint"):
        teval.main(images="a.png", device="cpu")


def test_load_weights_into_refuses_another_config(tmp_path):
    model = dt.DCTAutoencoder.from_pretrained(R3B, device="cpu")
    other = tmp_path / "other"
    shutil.copytree(R3B, other)
    cfg = json.loads((other / "config.json").read_text())
    cfg["vq_codebook_size"] = 512
    (other / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="another config"):
        teval.load_weights_into(model, str(other))


def test_load_weights_into_swaps_vq_statistics(tmp_path):
    """A scan over VQ checkpoints: the next checkpoint's statistics replace
    the loaded ones, and a checkpoint without vq_stats.npz gets a new
    model's statistics, as the JAX package's fresh load of it would."""
    from test_model import tiny_config

    cfg = dt.DCTAutoencoderConfig.from_dict(tiny_config("vq").to_dict())
    fresh = dt.DCTAutoencoder(cfg, device="cpu", seed=1)
    initial = {k: v.clone() for k, v in fresh.module.vq_stats().items()}
    trained = dt.DCTAutoencoder(cfg, device="cpu", seed=2)
    for i, t in enumerate(trained.module.vq_stats().values()):
        t.add_(0.5 + i)
    trained.save_pretrained(str(tmp_path / "with_stats"))
    trained.save_pretrained(str(tmp_path / "without_stats"))
    os.remove(tmp_path / "without_stats" / "vq_stats.npz")

    model = dt.DCTAutoencoder(cfg, device="cpu", seed=3)
    teval.load_weights_into(model, str(tmp_path / "with_stats"))
    for k, v in trained.module.state_dict().items():
        assert torch.equal(model.module.state_dict()[k], v), k
    teval.load_weights_into(model, str(tmp_path / "without_stats"))
    stats = model.module.vq_stats()
    assert stats and all(torch.equal(stats[k], initial[k]) for k in initial)
    assert torch.equal(model.module.vq_model.codebook, trained.module.vq_model.codebook)
