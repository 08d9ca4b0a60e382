"""The port's data package and token-shard tool against the JAX package's.

Shards are written here with either package's ShardWriter from seeded numpy
arrays and images (PNG and JPEG through PIL, which both packages decode
with the same code), and read back by both.

Tolerances: samples read from shards, collates, URL expansion, shard
ownership, augmented images and the resolution and bucket decisions are
equal.  Token records of load_and_transform_dataset: positions, channels and
sizes equal; tokens compared as sets keyed by (channel, h, w), atol 2e-4, as
tests/test_torch_pipeline.py::test_preprocess_matches_jax holds the
extractor.
"""
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from dct_autoencoder_torch.data import augment as taug
from dct_autoencoder_torch.data import dataset as tds
from dct_autoencoder_torch.data import prefetch as tpf
from dct_autoencoder_torch.data import shards as tsh
from dct_autoencoder_torch.patches.extractor import DCTAutoencoderFeatureExtractor as TorchExtractor
from dct_autoencoder_tpu.data import augment as jaug
from dct_autoencoder_tpu.data import dataset as jds
from dct_autoencoder_tpu.data import shards as jsh
from dct_autoencoder_tpu.patches.extractor import DCTAutoencoderFeatureExtractor as JaxExtractor
from test_torch_pipeline import _token_map
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

PROC_KW = dict(channels=3, patch_size=8, sample_patches_beta=0.0, max_patch_h=12, max_patch_w=12, max_seq_len=432)


def _extractors(**overrides):
    kw = {**PROC_KW, **overrides}
    return JaxExtractor(**kw), TorchExtractor(**kw, device="cpu")


def _image_bytes(arr_hwc: np.ndarray, fmt: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr_hwc).save(buf, format=fmt)
    return buf.getvalue()


def write_image_shard(writer_cls, path, sizes, fmt="PNG", seed=0, meta=True):
    """One shard of images of the given (h, w) sizes, with json metadata and a caption."""
    rng = np.random.default_rng(seed)
    ext = {"PNG": "png", "JPEG": "jpg"}[fmt]
    with writer_cls(path) as w:
        for i, (h, wd) in enumerate(sizes):
            arr = (rng.uniform(0, 1, size=(h, wd, 3)) * 255).astype(np.uint8)
            sample = {"__key__": f"{i:08d}", ext: _image_bytes(arr, fmt), "txt": f"caption {i}"}
            if meta:
                sample["json"] = {"height": h, "width": wd}
            w.write(sample)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_shards_interchange(tmp_path, writer, reader):
    """npy, json, pyd, PNG and .pth fields, plain and gzip, rolled over several shards."""
    W = {"jax": jsh.ShardWriter, "torch": tsh.ShardWriter}[writer]
    R = {"jax": jsh.WebDatasetReader, "torch": tsh.WebDatasetReader}[reader]
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(6)]
    pixels = [(rng.uniform(0, 1, size=(16, 24, 3)) * 255).astype(np.uint8) for _ in range(6)]
    for compress in (False, True):
        out = tmp_path / f"c{int(compress)}"
        with W(str(out / "%06d.tar"), maxsize=2000, compress=compress) as w:
            for i in range(6):
                pth = io.BytesIO()
                torch.save(torch.from_numpy(arrays[i]), pth)
                w.write({
                    "__key__": f"{i:08d}", "patches.npy": arrays[i], "meta.json": {"i": i}, "size.pyd": (i, i + 1),
                    "png": _image_bytes(pixels[i], "PNG"), "x.pth": pth.getvalue(),
                })
        assert len(os.listdir(out)) > 1  # rolled
        got = list(R(str(out)))
        assert [s["__key__"] for s in got] == [f"{i:08d}" for i in range(6)]
        for i, s in enumerate(got):
            np.testing.assert_array_equal(s["patches.npy"], arrays[i])
            np.testing.assert_array_equal(s["x.pth"], arrays[i])
            assert s["meta.json"] == {"i": i} and s["size.pyd"] == (i, i + 1)
            np.testing.assert_array_equal(s["png"], pixels[i].transpose(2, 0, 1).astype(np.float32) / 255.0)


def test_expand_urls_matches_jax(tmp_path):
    for i in range(3):
        (tmp_path / f"s-{i:06d}.tar").write_bytes(b"")
    (tmp_path / "other.txt").write_bytes(b"")
    for url in ("shard-{000000..000002}.tar", str(tmp_path / "s-*.tar"), str(tmp_path), "one.tar"):
        assert tsh.expand_urls(url) == jsh.expand_urls(url), url
    assert tsh.expand_urls("shard-{000008..000010}.tar") == ["shard-000008.tar", "shard-000009.tar", "shard-000010.tar"]


def test_reader_skips_corrupt_shard(tmp_path):
    with tsh.ShardWriter(str(tmp_path / "good-%06d.tar")) as w:
        w.write({"__key__": "0", "x.json": {"ok": True}})
    (tmp_path / "bad-000000.tar").write_bytes(b"this is not a tar file at all........")
    got = list(tsh.WebDatasetReader(str(tmp_path / "*.tar")))
    assert len(got) == 1 and got[0]["x.json"]["ok"]
    with pytest.raises(FileNotFoundError):
        tsh.WebDatasetReader(str(tmp_path / "none-*.tar"))


def test_collates_match_jax():
    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}, {"a": 3, "b": "z"}]
    assert tds.dict_collate(rows) == jds.dict_collate(rows) == {"a": [1, 2, 3], "b": ["x", "y", "z"]}
    assert tds.tuple_collate([(1, "x"), (2, "y")]) == jds.tuple_collate([(1, "x"), (2, "y")])
    for n in (1, 2, 5):
        assert list(tds.batched(iter(rows), n)) == list(jds.batched(iter(rows), n))


def _assert_records_match(got, want):
    assert len(got) == len(want) > 0
    for t, j in zip(got, want):
        assert t["original_sizes"] == j["original_sizes"] and t["patch_sizes"] == j["patch_sizes"]
        assert set(t) == set(j)
        for k in set(t) - {"patches", "positions", "channels", "original_sizes", "patch_sizes"}:
            assert t[k] == j[k], k
        mt, mj = _token_map(t), _token_map(j)
        assert mt.keys() == mj.keys()
        for key in mj:
            np.testing.assert_allclose(mt[key], mj[key], atol=2e-4)


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_load_and_transform_dataset_matches_jax(tmp_path, fmt):
    """Mixed sizes, one over the resize cap (768), one under the resolution
    floor (12 x 8 px), one without metadata; shuffled."""
    sizes = [(96, 96), (120, 96), (80, 80), (100, 800), (96, 112)]
    write_image_shard(jsh.ShardWriter, str(tmp_path / "raw-%06d.tar"), sizes, fmt=fmt)
    write_image_shard(jsh.ShardWriter, str(tmp_path / "nometa-%06d.tar"), [(104, 96)], fmt=fmt, seed=1, meta=False)
    jp, tp = _extractors()
    url = str(tmp_path / "*.tar")
    want = list(jds.load_and_transform_dataset(url, jp, shuffle_buffer=4, seed=3))
    got = list(tds.load_and_transform_dataset(url, tp, shuffle_buffer=4, seed=3))
    _assert_records_match(got, want)
    assert len(got) == 5  # the 80 x 80 image is filtered
    assert (96, 768) in [d["original_sizes"] for d in got]  # 100 x 800 capped at 768


def test_resolution_filter(tmp_path):
    write_image_shard(tsh.ShardWriter, str(tmp_path / "raw-%06d.tar"), [(48, 48), (48, 48)])
    jp, tp = _extractors()
    url = str(tmp_path / "*.tar")
    assert list(tds.load_and_transform_dataset(url, tp)) == list(jds.load_and_transform_dataset(url, jp)) == []


def test_size_buckets_and_batched_preprocess_match_jax(tmp_path):
    buckets = tds.default_size_buckets(max_size=512, min_size=256, step=128)
    assert buckets == jds.default_size_buckets(max_size=512, min_size=256, step=128)
    im = np.random.default_rng(0).uniform(0, 1, size=(3, 300, 500)).astype(np.float32)
    np.testing.assert_array_equal(tds.resize_to_bucket(im, buckets), jds.resize_to_bucket(im, buckets))

    write_image_shard(tsh.ShardWriter, str(tmp_path / "raw-%06d.tar"), [(200, 200), (200, 300), (300, 200)] * 2)
    jp, tp = _extractors(max_patch_h=64, max_patch_w=64, max_seq_len=64 * 64 * 3)
    kw = dict(size_buckets=buckets, preprocess_batch_size=4)
    url = str(tmp_path / "*.tar")
    got = list(tds.load_and_transform_dataset(url, tp, **kw))
    _assert_records_match(got, list(jds.load_and_transform_dataset(url, jp, **kw)))
    assert len(got) == 6 and all(d["original_sizes"] in buckets for d in got)


def test_preprocess_refusal_is_skipped_but_a_kernel_failure_raises(tmp_path, monkeypatch):
    """An image the extractor refuses (ValueError) is skipped, as JAX skips a
    failed preprocess; a kernel's build or launch failure (RuntimeError) is raised."""
    write_image_shard(tsh.ShardWriter, str(tmp_path / "raw-%06d.tar"), [(96, 96)] * 3)
    _, tp = _extractors()
    real = tp.preprocess
    calls = []

    def refuse_second(im):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("image smaller than one patch")
        return real(im)

    monkeypatch.setattr(tp, "preprocess", refuse_second)
    assert len(list(tds.load_and_transform_dataset(str(tmp_path / "*.tar"), tp))) == 2

    def kernel_fails(im):
        raise RuntimeError("nvcc failed for dct_patchify.cu")

    monkeypatch.setattr(tp, "preprocess", kernel_fails)
    with pytest.raises(RuntimeError, match="nvcc"):
        list(tds.load_and_transform_dataset(str(tmp_path / "*.tar"), tp))


def test_multihost_shard_ownership_matches_jax(tmp_path):
    for i in range(5):
        with tsh.ShardWriter(str(tmp_path / f"s{i}-%06d.tar")) as w:
            w.write({"__key__": "0", "x.json": {"shard": i}})
    url = str(tmp_path / "*.tar")
    owned = []
    for pi in range(2):
        t = [s["x.json"]["shard"] for s in tsh.WebDatasetReader(url, process_index=pi, process_count=2)]
        j = [s["x.json"]["shard"] for s in jsh.WebDatasetReader(url, process_index=pi, process_count=2)]
        assert t == j
        owned.append(set(t))
    assert owned[0] | owned[1] == set(range(5)) and not owned[0] & owned[1]
    # a shuffled reader takes the same order as JAX's for a seed
    t = [s["x.json"]["shard"] for s in tsh.WebDatasetReader(url, shuffle_buffer=3, seed=5)]
    assert t == [s["x.json"]["shard"] for s in jsh.WebDatasetReader(url, shuffle_buffer=3, seed=5)]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_token_shards_interchange(tmp_path, writer):
    """tools/preproc_dataset.py of one package writes token shards that the
    other's load_preprocessed_dataset reads."""
    import json

    from dct_autoencoder_torch.tools import preproc_dataset as tpre
    from dct_autoencoder_tpu.tools import preproc_dataset as jpre

    write_image_shard(tsh.ShardWriter, str(tmp_path / "raw" / "r-%06d.tar"), [(96, 96), (104, 96), (96, 120)])
    cfg = json.load(open(os.path.join(os.path.dirname(__file__), "..", "conf", "patch14-l.json")))
    cfg.update(patch_size=8, max_patch_h=12, max_patch_w=12)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    kw = dict(image_dataset_path_or_url=str(tmp_path / "raw" / "*.tar"), output_dir=str(tmp_path / "pre"),
              model_config_path=str(tmp_path / "cfg.json"), sample_patches_beta=0.0, n=100, compress=True)
    n = tpre.main(**kw, device="cpu") if writer == "torch" else jpre.main(**kw)
    assert n == 3
    url = str(tmp_path / "pre")
    got = list(tds.load_preprocessed_dataset(url))
    want = list(jds.load_preprocessed_dataset(url))
    assert len(got) == len(want) == 3
    for t, j in zip(got, want):
        for k in ("patches", "positions", "channels"):
            np.testing.assert_array_equal(t[k], j[k])
        assert t["original_sizes"] == j["original_sizes"] and t["patch_sizes"] == j["patch_sizes"]
        assert t["patches"].shape[1] == 64
    # and the tokens are the extractor's: the JAX records of the same images
    jp, _ = _extractors()
    ref = {d["original_sizes"]: d for d in jds.load_and_transform_dataset(str(tmp_path / "raw" / "*.tar"), jp)}
    for t in got:
        r = ref[t["original_sizes"]]
        mt, mj = _token_map(t), _token_map(r)
        assert mt.keys() == mj.keys()
        for key in mj:
            np.testing.assert_allclose(mt[key], mj[key], atol=2e-4)


def test_augment_equals_jax_for_a_seed():
    rng = np.random.default_rng(0)
    ims = [rng.uniform(0, 1, size=(3, h, w)).astype(np.float32) for h, w in ((64, 48), (40, 40), (64, 96), (33, 50))]
    for cfg in (dict(), dict(color_jitter=0.2), dict(scale=(1.0, 1.0), ratio=(1.0, 1.0), hflip=1.0)):
        ta, ja = taug.Augmenter(taug.AugmentConfig(**cfg), seed=5), jaug.Augmenter(jaug.AugmentConfig(**cfg), seed=5)
        for im in ims * 2:
            got, want = ta(im), ja(im)
            assert got.shape == im.shape and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError):
        taug.AugmentConfig(scale=(0.0, 1.0))


# ---------------------------------------------------------------- prefetch


def test_prefetch_preserves_order_and_items():
    src = list(range(57))
    assert list(tpf.prefetch(iter(src), buffer_size=4)) == src


def test_prefetch_propagates_exceptions():
    def bad():
        yield 1
        yield 2
        raise ValueError("boom")

    it = tpf.prefetch(bad(), buffer_size=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_overlaps_production():
    """A consumer that sleeps finds the next item made: serial work takes
    >= 0.5 s, overlapped ~0.3 s; a noisy host gets three tries."""
    def slow_source():
        for i in range(5):
            time.sleep(0.05)
            yield i

    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        out = []
        for x in tpf.prefetch(slow_source(), buffer_size=2):
            time.sleep(0.05)
            out.append(x)
        best = min(best, time.time() - t0)
        assert out == list(range(5))
        if best < 0.45:
            break
    assert best < 0.45, best


def test_prefetch_early_stop_joins_the_worker():
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield i
            i += 1

    it = tpf.prefetch(endless(), buffer_size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert started.is_set()
    assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())
