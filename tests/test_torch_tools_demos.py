"""The port's demos and probes (tools/testpipe.py, decode_gif.py, diagnose.py,
test_colorspaces.py) against the JAX package's, on the CPU.

Mirrors tests/test_tools.py:22,42 and adds diagnose and test_colorspaces,
which JAX does not test: each tool of both packages runs on the same seeded
images (written to a temporary directory) and the same weights, in float32.

Tolerances: testpipe's printed numbers within 1e-4 of JAX's (they are
printed to 3 decimals) and its junk.png within 1/255; decode_gif's frames
(the uint8 arrays handed to PIL) within 2/255 of JAX's, frame by frame;
diagnose's printed numbers on docs/calibrated_run_r3b/model within 1e-3;
test_colorspaces' printed numbers within 1e-4 of JAX's (printed to 3
significant digits: a digit may differ only at a rounding boundary, which
the seed avoids) and its PNG within 1/255.
"""
import re

import numpy as np
import pytest
from PIL import Image

from dct_autoencoder_torch.tools import decode_gif as port_gif
from dct_autoencoder_torch.tools import diagnose as port_diagnose
from dct_autoencoder_torch.tools import test_colorspaces as port_colorspaces
from dct_autoencoder_torch.tools import testpipe as port_testpipe
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_factory
from dct_autoencoder_torch.models.factory import get_model_and_processor as port_factory
from dct_autoencoder_tpu.tools import decode_gif as jax_gif
from dct_autoencoder_tpu.tools import diagnose as jax_diagnose
from dct_autoencoder_tpu.tools import test_colorspaces as jax_colorspaces
from dct_autoencoder_tpu.tools import testpipe as jax_testpipe
from test_model import tiny_config
from test_tools import make_images_dir
from test_torch_model import R3B
from test_torch_train import port_of

NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")


def numbers(text):
    return [float(x) for x in NUMBER.findall(text)]


def _words(text):
    return NUMBER.sub("#", text)


def test_testpipe_matches_jax(tmp_path, capsys):
    imdir = make_images_dir(tmp_path)
    kw = dict(image_dir=str(imdir), patch_size=8, max_patch_h=8, max_patch_w=8, max_seq_len=128,
              sample_patches_beta=0.005)
    jax_testpipe.main(out_file=str(tmp_path / "jax.png"), **kw)
    want = capsys.readouterr().out
    rec = port_testpipe.main(out_file=str(tmp_path / "port.png"), device="cpu", **kw)
    got = capsys.readouterr().out
    assert "number of patches for image 0" in got and "std" in got
    assert _words(got.replace("port.png", "jax.png")) == _words(want)
    np.testing.assert_allclose(numbers(got), numbers(want), atol=1e-4)
    a = np.asarray(Image.open(tmp_path / "port.png"), np.int16)
    b = np.asarray(Image.open(tmp_path / "jax.png"), np.int16)
    assert a.shape == b.shape == (64, 64, 3) and rec.shape == (3, 64, 64)
    assert np.abs(a - b).max() <= 1


@pytest.fixture()
def recorded_frames(monkeypatch):
    """Every array handed to PIL's Image.fromarray, by whichever package."""
    seen = []
    real = Image.fromarray

    def record(arr, *a, **k):
        seen.append(np.asarray(arr).copy())
        return real(arr, *a, **k)

    monkeypatch.setattr(Image, "fromarray", record)
    return seen


def test_decode_gif_matches_jax(tmp_path, monkeypatch, recorded_frames):
    jm, _ = jax_factory(tiny_config("lfq"), sample_patches_beta=0.0)

    def jax_fake(config, dtype=None, sample_patches_beta=0.0, resume_path=None, **kw):
        return jm, jax_factory(tiny_config("lfq"), sample_patches_beta=sample_patches_beta)[1]

    def port_fake(config, dtype=None, sample_patches_beta=0.0, resume_path=None, device="cuda", **kw):
        tm = port_of(jm)
        return tm, port_factory(tm.config, sample_patches_beta=sample_patches_beta, device=device)[1]

    monkeypatch.setattr(jax_gif, "get_model_and_processor", jax_fake)
    monkeypatch.setattr(port_gif, "get_model_and_processor", port_fake)
    imdir = make_images_dir(tmp_path, n=1, size=48)
    kw = dict(image=str(imdir / "im0.png"), model_load_path=None, n_frames=4, max_side=48)
    recorded_frames.clear()  # the input image
    jax_gif.main(out_file=str(tmp_path / "jax.gif"), **kw)
    want, recorded_frames[:] = list(recorded_frames), []
    port_gif.main(out_file=str(tmp_path / "port.gif"), device="cpu", **kw)
    got = list(recorded_frames)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (48, 96, 3)
        assert np.abs(g.astype(np.int16) - w).max() <= 2
    # the frames differ: each decodes from more of the tokens
    assert all(np.abs(a.astype(np.int16) - b).max() > 0 for a, b in zip(got, got[1:]))
    assert getattr(Image.open(tmp_path / "port.gif"), "n_frames", 1) == 4


def test_diagnose_matches_jax_on_r3b(tmp_path, capsys):
    imdir = make_images_dir(tmp_path, n=3, size=112)
    jax_diagnose.main(model_load_path=R3B, image_dir=str(imdir), out_file=str(tmp_path / "jax.png"))
    want = capsys.readouterr().out
    port_diagnose.main(model_load_path=R3B, image_dir=str(imdir), out_file=str(tmp_path / "port.png"), device="cpu")
    got = capsys.readouterr().out
    assert "codes: perplexity" in got and got.count("PSNR") == 3
    assert _words(got.replace("port.png", "jax.png")) == _words(want)
    np.testing.assert_allclose(numbers(got), numbers(want), atol=1e-3)
    assert (tmp_path / "port.png").exists()


def test_colorspaces_probe_matches_jax(tmp_path, capsys):
    imdir = make_images_dir(tmp_path, n=1, size=96)
    jax_colorspaces.main(image=str(imdir / "im0.png"), out_file=str(tmp_path / "jax.png"))
    want = capsys.readouterr().out
    results = port_colorspaces.main(image=str(imdir / "im0.png"), out_file=str(tmp_path / "port.png"), device="cpu")
    got = capsys.readouterr().out
    assert _words(got.replace("port.png", "jax.png")) == _words(want)
    np.testing.assert_allclose(numbers(got), numbers(want), atol=1e-4)
    assert set(results) == {"ipt", "ycbcr"} and results["ycbcr"]["roundtrip_l1"] < 1e-5
    a = np.asarray(Image.open(tmp_path / "port.png"), np.int16)
    b = np.asarray(Image.open(tmp_path / "jax.png"), np.int16)
    assert a.shape == b.shape == (96, 5 * 96, 3)
    assert np.abs(a - b).max() <= 1
