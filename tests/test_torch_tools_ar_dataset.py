"""The port's AR token dump (tools/prepare_autoregressive_dataset.py) against the JAX package's, on the CPU.

Mirrors tests/test_tools.py:69.  Both packages' factories are replaced by
the tiny config of tests/test_model.py in float32 with the same weights
(the JAX model's, carried into the port through models/convert.py) and
processors drawing their token budgets from the same random.Random.  The
input is two raw tar shards of seeded JPEGs, each with a distinct caption.

Tolerances: everything exact.  Records equal JAX's: keys, captions, sizes,
the tokens and their codes (keyed by channel and position); each package's
from_dict reads the other's records into equal tokens and codes.  Two
processes (--process_count 2) write disjoint keys whose union is the one
process's, each key with its own caption.
"""
import io
import random

import numpy as np
import pytest

from dct_autoencoder_torch.data.shards import ShardWriter, WebDatasetReader
from dct_autoencoder_torch.models.factory import get_model_and_processor as port_factory
from dct_autoencoder_torch.patches.container import from_dict as port_from_dict
from dct_autoencoder_torch.tools import prepare_autoregressive_dataset as port_ar
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_factory
from dct_autoencoder_tpu.patches.container import from_dict as jax_from_dict
from dct_autoencoder_tpu.tools import prepare_autoregressive_dataset as jax_ar
from test_model import tiny_config
from test_torch_train import port_of

N_IMAGES = 10
BETA = 0.05  # about 20 tokens an image: several images share a packed row
SIZES = [(64, 64), (56, 72), (64, 48), (80, 64), (48, 48)]


def write_raw_shards(folder):
    """Two raw shards of seeded JPEGs with json sizes and distinct captions; key i is image i."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for shard, keys in (("a", range(0, 6)), ("b", range(6, N_IMAGES))):
        with ShardWriter(str(folder / f"{shard}-%06d.tar")) as w:
            for i in keys:
                h, wd = SIZES[i % len(SIZES)]
                arr = (rng.uniform(0, 1, size=(h, wd, 3)) * 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG")
                w.write({"__key__": f"{i:08d}", "jpg": buf.getvalue(), "json": {"height": h, "width": wd},
                         "txt": f"caption of image {i}"})
    return str(folder / "*.tar")


@pytest.fixture()
def factories(monkeypatch):
    """Both tools' factories -> the tiny config in fp32, same weights, same budget draws."""
    jm, _ = jax_factory(tiny_config("lfq"), sample_patches_beta=BETA)

    def jax_fake(config, dtype=None, sample_patches_beta=0.0, resume_path=None, **kw):
        model, proc = jax_factory(tiny_config("lfq"), sample_patches_beta=sample_patches_beta)
        model.params = jm.params
        proc.rng = random.Random(5)
        return model, proc

    def port_fake(config, dtype=None, sample_patches_beta=0.0, resume_path=None, device="cuda", **kw):
        assert device == "cpu"
        _, proc = port_factory(port_of(jm).config, sample_patches_beta=sample_patches_beta, device="cpu")
        proc.rng = random.Random(5)
        return port_of(jm), proc

    monkeypatch.setattr(jax_ar, "get_model_and_processor", jax_fake)
    monkeypatch.setattr(port_ar, "get_model_and_processor", port_fake)


def read_records(folder):
    return {s["__key__"]: s["json"] for s in WebDatasetReader(str(folder))}


def _by_token(emb):
    return {(d["c"], d["h"], d["w"]): d["data"] for d in emb["codes"]}


def test_records_equal_jax_and_cross_read(tmp_path, factories):
    url = write_raw_shards(tmp_path)
    kw = dict(image_dataset_path_or_url=url, sample_patches_beta=BETA, batch_size=2, n=100)
    n_jax = jax_ar.main(output_dir=str(tmp_path / "jax"), **kw)
    n_port = port_ar.main(output_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert n_jax == n_port == N_IMAGES
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["h000-000000.tar"]
    jrec, trec = read_records(tmp_path / "jax"), read_records(tmp_path / "port")
    assert list(trec) == list(jrec) == [f"{i:08d}" for i in range(N_IMAGES)]
    tokens = []
    for key in jrec:
        j, t = jrec[key], trec[key]
        assert t["caption"] == j["caption"] == f"caption of image {int(key)}"
        je, te = j["image_embedding"], t["image_embedding"]
        assert set(te) == {"size", "original_size", "codes"}
        assert all(set(c) == {"c", "h", "w", "data"} for c in te["codes"])
        assert te["size"] == je["size"] and te["original_size"] == je["original_size"]
        assert te["original_size"] == list(SIZES[int(key) % len(SIZES)])
        assert len(te["codes"]) == len(je["codes"]) and _by_token(te) == _by_token(je)
        tokens.append(len(te["codes"]))
        # each package reads the other's record
        for reader, rec, other in ((jax_from_dict, te, je), (port_from_dict, je, te)):
            dp, codes = reader(rec)
            assert codes.shape == (len(rec["codes"]), 4)
            np.testing.assert_array_equal(codes, np.asarray([c["data"] for c in other["codes"]]))
            pos = np.asarray(dp.patch_positions).reshape(-1, 2)
            np.testing.assert_array_equal(pos, [[c["h"], c["w"]] for c in other["codes"]])
    # beta 0.05 gives rows of 64 tokens: images this short share them, so captions ride through packing
    assert np.mean(tokens) < 32, tokens


def test_two_processes_write_the_keys_of_one(tmp_path, factories):
    url = write_raw_shards(tmp_path)
    kw = dict(image_dataset_path_or_url=url, output_dir=str(tmp_path / "tok"), sample_patches_beta=BETA,
              batch_size=2, device="cpu")
    assert port_ar.main(**kw, process_index=0, process_count=2) == 6
    assert port_ar.main(**kw, process_index=1, process_count=2) == 4
    assert sorted(p.name for p in (tmp_path / "tok").iterdir()) == ["h000-000000.tar", "h001-000000.tar"]
    parts = [{s["__key__"]: s["json"] for s in WebDatasetReader(str(tmp_path / "tok" / f"h00{i}-000000.tar"))}
             for i in range(2)]
    assert not set(parts[0]) & set(parts[1])
    assert sorted({**parts[0], **parts[1]}) == [f"{i:08d}" for i in range(N_IMAGES)]
    for part in parts:
        for key, rec in part.items():
            assert rec["caption"] == f"caption of image {int(key)}"


def test_n_stops_in_the_middle_of_a_batch(tmp_path, factories):
    url = write_raw_shards(tmp_path)
    n = port_ar.main(image_dataset_path_or_url=url, output_dir=str(tmp_path / "tok"), sample_patches_beta=BETA,
                     batch_size=2, n=3, device="cpu")
    assert n == 3
    assert list(read_records(tmp_path / "tok")) == [f"{i:08d}" for i in range(3)]


def test_no_model_path_is_refused_as_in_jax(tmp_path):
    """With neither a config nor --model_load_path both factories refuse (JAX by assertion)."""
    url = write_raw_shards(tmp_path)
    with pytest.raises(ValueError, match="model_config or a resume_path"):
        port_ar.main(image_dataset_path_or_url=url, output_dir=str(tmp_path / "tok"), device="cpu")
    with pytest.raises(AssertionError):
        jax_ar.main(image_dataset_path_or_url=url, output_dir=str(tmp_path / "jax"), platform="cpu")
