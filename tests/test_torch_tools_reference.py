"""The port's reference parity harness (tools/parity_vs_reference.py) and the
reference halves of both reference tools, against the JAX package's, on the CPU.

The reference package itself is not in the repository, so the tests write a
stand-in `dct_autoencoder` package to tmp_path: it imports torch_dct,
torchvision and matplotlib at module scope, as the reference does, so the
shims and stubs must be in place; its feature extractor is a thin wrapper
of the port's, and its model's `from_pretrained` builds
convert_reference_weights.reference_standin from a port checkpoint.

The shims, the stubs and the stand-in change `sys.modules` and `sys.path`
for the rest of the process; under `--dist loadfile` a worker runs later
files in the same process, so every test here undoes that (`restore_imports`)
and the last test checks that nothing was left behind.

Tolerances: the DCT shim against scipy in float64 atol 1e-12, and equal to
JAX's shim; round-trip PSNRs of the port and of JAX within 0.01 dB; the two
`main`s' rows within 0.01 dB (the reference column, the same code on both
sides, equal); converted checkpoints equal bit for bit.
"""
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import scipy.fft
import torch
from PIL import Image

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.config import TransformerConfig as TorchTransformerConfig
from dct_autoencoder_torch.ops.stats import psnr
from dct_autoencoder_torch.tools import convert_reference_weights as tcr
from dct_autoencoder_torch.tools import parity_vs_reference as tpr
from dct_autoencoder_tpu.tools import convert_reference_weights as jcr
from dct_autoencoder_tpu.tools import parity_vs_reference as jpr
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

MAX_PSNR_DELTA_DB = 0.01
IMAGE_SIZES = [(256, 171), (192, 256), (233, 97), (256, 256), (120, 250), (64, 80)]

STANDIN_INIT = '''
"""A stand-in for the reference's dct_autoencoder package (tests only)."""
import matplotlib.pyplot  # noqa: F401  (the reference imports these at module scope)
import torch_dct  # noqa: F401
import torchvision.transforms  # noqa: F401
'''

STANDIN_EXTRACTOR = '''
import numpy as np
import torch

from dct_autoencoder_torch.patches.extractor import DCTAutoencoderFeatureExtractor as _Port


class DCTAutoencoderFeatureExtractor:
    """The port's extractor on the CPU behind the reference's torch-tensor interface."""

    def __init__(self, **kwargs):
        self._port = _Port(**kwargs, device="cpu")

    def preprocess(self, image):
        return self._port.preprocess(image.numpy())

    def iter_batches(self, dataloader, batch_size=None):
        return self._port.iter_batches(dataloader, batch_size=batch_size)

    def postprocess(self, batch):
        return [torch.from_numpy(np.asarray(im)) for im in self._port.postprocess(batch)]
'''

STANDIN_MODELING = '''
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as _Port
from dct_autoencoder_torch.tools.convert_reference_weights import reference_standin


class DCTAutoencoder:
    @staticmethod
    def from_pretrained(path):
        """The reference layout holding a port checkpoint's tensors."""
        model = _Port.from_pretrained(path, device="cpu")
        return reference_standin(model.config, state_dict=model.module.state_dict(), patchnorm=model.patchnorm)
'''


def _touched() -> set:
    """The modules the shims, the stubs and the stand-in package put in sys.modules."""
    roots = {"torch_dct", "torchvision", "matplotlib", "dct_autoencoder"}
    return {k for k in sys.modules if k.split(".")[0] in roots}


@pytest.fixture(scope="module")
def baseline():
    """sys.modules' touched names and sys.path before this file's tests."""
    return _touched(), list(sys.path)


@pytest.fixture(autouse=True)
def restore_imports(baseline, monkeypatch):
    """Undo every change to sys.path and to the touched modules."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    before = _touched()
    for name in before:
        monkeypatch.setitem(sys.modules, name, sys.modules[name])
    yield
    for name in _touched() - before:
        del sys.modules[name]


def fresh(install) -> dict:
    """The modules that `install` puts in sys.modules when none of the
    touched names is there (`restore_imports` puts back those it removes)."""
    for name in _touched():
        del sys.modules[name]
    install()
    return {name: sys.modules[name] for name in _touched()}


def standin_reference(tmp_path) -> str:
    root = tmp_path / "reference"
    pkg = root / "dct_autoencoder"
    pkg.mkdir(parents=True)
    for name, text in (("__init__.py", STANDIN_INIT), ("feature_extraction_dct_autoencoder.py", STANDIN_EXTRACTOR),
                       ("modeling_dct_autoencoder.py", STANDIN_MODELING)):
        (pkg / name).write_text(textwrap.dedent(text))
    return str(root)


def grainy_images(sizes, seed=0):
    """Seeded RGB fields in [0, 1]: a few low-frequency waves per channel and
    some grain, so that a crop of the DCT planes loses a measurable part."""
    rng = np.random.default_rng(seed)
    ims = []
    for h, w in sizes:
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
        im = np.full((3, h, w), 0.5)
        for c in range(3):
            for _ in range(6):
                fy, fx = rng.uniform(-6, 6, size=2)
                im[c] += rng.uniform(0.03, 0.12) * np.cos(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        im += 0.03 * rng.standard_normal(im.shape)
        ims.append(np.clip(im, 0.0, 1.0).astype(np.float32))
    return ims


@pytest.mark.parametrize("shape", [(8, 8), (12, 20), (2, 3, 16, 9)])
def test_dct_shim_matches_scipy_and_jax(shape):
    ours = fresh(tpr._install_torch_dct_shim)["torch_dct"]
    theirs = fresh(jpr._install_torch_dct_shim)["torch_dct"]
    assert ours is not theirs
    x = np.random.default_rng(0).standard_normal(shape)
    t = torch.from_numpy(x)
    for fn, ref in (("dct_2d", scipy.fft.dctn), ("idct_2d", scipy.fft.idctn)):
        got = getattr(ours, fn)(t, norm="ortho")
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref(x, axes=(-2, -1), norm="ortho"), atol=1e-12)
        assert torch.equal(got, getattr(theirs, fn)(t, norm="ortho"))
        with pytest.raises(ValueError, match="ortho"):
            getattr(ours, fn)(t)
    back = ours.idct_2d(ours.dct_2d(t.float(), norm="ortho"), norm="ortho")
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_stubs_install_the_same_modules_as_jax():
    ours = fresh(tpr._install_import_stubs)
    theirs = fresh(jpr._install_import_stubs)
    assert sorted(ours) == sorted(theirs) == sorted(tpr.STUBBED_MODULES)
    for name, mod in ours.items():
        assert mod.__spec__.name == theirs[name].__spec__.name == name
        public = lambda m: {k for k in vars(m) if not k.startswith("__")}
        assert public(mod) == public(theirs[name]), name
    assert ours["torchvision"].transforms is ours["torchvision.transforms"]
    assert ours["matplotlib"].pyplot is ours["matplotlib.pyplot"]
    assert ours["torchvision.transforms"].Resize is None


def test_ours_roundtrip_matches_jax():
    ims = grainy_images(IMAGE_SIZES)
    ours = tpr.run_ours_roundtrip(ims, 16, 32, device="cpu")
    theirs = jpr.run_ours_roundtrip(ims, 16, 32)
    for im, o, t in zip(ims, ours, theirs):
        assert o.shape == im.shape and o.dtype == np.float32
        assert abs(psnr(o, im) - psnr(np.asarray(t), im)) <= MAX_PSNR_DELTA_DB
    lossless = [psnr(o, im) for (h, w), o, im in zip(IMAGE_SIZES, ours, ims) if h % 16 == 0 and w % 16 == 0]
    assert lossless and min(lossless) > 100  # whole patch grids keep every DCT coefficient


def test_parity_main_of_both_against_a_standin_reference(tmp_path, capsys):
    reference = standin_reference(tmp_path)
    image_dir = tmp_path / "images"
    image_dir.mkdir()
    for i, im in enumerate(grainy_images([(300, 200), (180, 260), (96, 96)], seed=1)):
        Image.fromarray((im.transpose(1, 2, 0) * 255).round().astype(np.uint8)).save(image_dir / f"im{i}.png")
    (image_dir / "notes.txt").write_text("not an image")
    theirs = jpr.main(str(image_dir), reference, platform="cpu")
    ours = tpr.main(str(image_dir), reference, device="cpu")
    assert [r[0] for r in ours] == [r[0] for r in theirs] == ["im0.png", "im1.png", "im2.png"]
    for (_, ref_o, ours_o), (_, ref_t, ours_t) in zip(ours, theirs):
        assert ref_o == ref_t
        assert abs(ours_o - ours_t) <= MAX_PSNR_DELTA_DB
        assert abs(ours_o - ref_o) <= MAX_PSNR_DELTA_DB  # the stand-in is the port's extractor
    assert "3/3 images at-or-above the reference PSNR" in capsys.readouterr().out


def test_convert_main_of_both_against_a_standin_reference(tmp_path):
    reference = standin_reference(tmp_path)
    tc = TorchTransformerConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4)
    cfg = TorchConfig(patch_size=4, max_patch_h=8, max_patch_w=8, vq_codebook_size=64, vq_num_codebooks=4,
                      encoder_config=tc, decoder_config=tc)
    src = TorchAE(cfg, device="cpu", seed=5)
    src.patchnorm.median.normal_(generator=torch.Generator().manual_seed(5))
    src.save_pretrained(str(tmp_path / "ref_ckpt"))
    jcr.main(str(tmp_path / "ref_ckpt"), str(tmp_path / "jax"), reference)
    tcr.main(str(tmp_path / "ref_ckpt"), str(tmp_path / "torch"), reference, device="cpu")
    for name in ("params.npz", "patchnorm.npz"):
        with np.load(tmp_path / "jax" / name) as fj, np.load(tmp_path / "torch" / name) as ft, \
                np.load(tmp_path / "ref_ckpt" / name) as fs:
            assert sorted(ft.files) == sorted(fj.files) == sorted(fs.files)
            for k in fs.files:
                np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
                np.testing.assert_array_equal(ft[k], fs[k], err_msg=k)
    configs = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("jax", "torch")]
    assert configs[0] == configs[1] and configs[1]["attn_mask_mode"] == "bias"


@pytest.mark.parametrize("tool", ["parity", "convert"])
def test_main_without_the_reference_tree_raises_by_name(tool, tmp_path):
    missing = str(tmp_path / "no_reference_here")
    with pytest.raises(FileNotFoundError, match="no_reference_here"):
        if tool == "parity":
            tpr.main(str(tmp_path), missing, device="cpu")
        else:
            tcr.main(str(tmp_path / "ckpt"), str(tmp_path / "out"), missing, device="cpu")
    assert not os.path.exists(tmp_path / "out")


def test_nothing_is_left_behind(baseline):
    """Runs last in this file: the earlier tests installed the shim, the
    stubs and the stand-in package, and put the stand-in on sys.path."""
    names, path = baseline
    assert _touched() == names
    assert sys.path == path
