"""Side-by-side parity harness against the PyTorch reference implementation.

Counterpart of the JAX package's tools/parity_vs_reference.py, with the same
flags, printed lines and rows, except that --device (the card by default)
replaces --platform, and --image_dir and --reference_dir have no default
(JAX's name a tree outside the repository).  Runs the REFERENCE's own
feature extractor (imported from --reference_dir, on the CPU) and the port's
(on --device: the DCT and IDCT kernels on the card) on the same images, and
compares the no-model pixel round trip's PSNR per image (the BASELINE.md
quality gate: ours must be >= the reference's, within 0.5 dB).

The reference imports `torch_dct`, torchvision and matplotlib, none of which
the port needs: `_install_torch_dct_shim` puts a matmul-form orthonormal
DCT-II/III (the standard definition, written here) under the first name,
and `_install_import_stubs` empty modules under the others, before the
reference is imported.  Both change `sys.modules` for the rest of the
process, as `main` changes `sys.path`.

Usage:
  python -m dct_autoencoder_torch.tools.parity_vs_reference \
      --image_dir <images> --reference_dir <directory holding the dct_autoencoder package>
"""
from __future__ import annotations

import argparse
import os
import sys
import types
from typing import List

import numpy as np

from ..ops.stats import psnr


def _install_torch_dct_shim() -> None:
    """Provide torch_dct.dct_2d/idct_2d (orthonormal, matmul form)."""
    import torch

    if "torch_dct" in sys.modules:
        return

    def _mat(n: int, dtype, device):
        k = torch.arange(n, dtype=torch.float64).unsqueeze(1)
        i = torch.arange(n, dtype=torch.float64).unsqueeze(0)
        m = torch.cos(torch.pi * (2 * i + 1) * k / (2 * n))
        scale = torch.full((n, 1), (2.0 / n) ** 0.5, dtype=torch.float64)
        scale[0, 0] = (1.0 / n) ** 0.5
        return (m * scale).to(dtype).to(device)

    def dct_2d(x, norm=None):
        if norm != "ortho":
            raise ValueError(f"the torch_dct shim has norm='ortho' only, not {norm!r}")
        h, w = x.shape[-2], x.shape[-1]
        dh = _mat(h, x.dtype, x.device)
        dw = _mat(w, x.dtype, x.device)
        return dh @ x @ dw.T

    def idct_2d(x, norm=None):
        if norm != "ortho":
            raise ValueError(f"the torch_dct shim has norm='ortho' only, not {norm!r}")
        h, w = x.shape[-2], x.shape[-1]
        dh = _mat(h, x.dtype, x.device)
        dw = _mat(w, x.dtype, x.device)
        return dh.T @ x @ dw

    mod = types.ModuleType("torch_dct")
    mod.dct_2d = dct_2d
    mod.idct_2d = idct_2d
    sys.modules["torch_dct"] = mod


STUBBED_MODULES = (
    "torchvision", "torchvision.transforms", "torchvision.utils", "torchvision.io", "matplotlib", "matplotlib.pyplot",
)


def _install_import_stubs() -> None:
    """Stub torchvision/matplotlib where they are not imported already — the
    reference's util module imports them at module scope, but none of the
    code paths this harness executes touch them."""
    import importlib.machinery

    for name in STUBBED_MODULES:
        if name not in sys.modules:
            mod = types.ModuleType(name)
            # a real spec so importlib.util.find_spec (transformers probes it)
            # doesn't choke on the stub
            mod.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
            sys.modules[name] = mod
    sys.modules["torchvision"].transforms = sys.modules["torchvision.transforms"]
    sys.modules["torchvision"].utils = sys.modules["torchvision.utils"]
    sys.modules["matplotlib"].pyplot = sys.modules["matplotlib.pyplot"]
    sys.modules["torchvision.transforms"].Resize = None
    sys.modules["torchvision.transforms"].InterpolationMode = None


def import_reference(reference_dir: str) -> None:
    """Make the reference's `dct_autoencoder` package importable: the shim
    and the stubs, then `reference_dir` on sys.path.  Raises
    FileNotFoundError where the directory holds no such package."""
    if not os.path.isfile(os.path.join(reference_dir, "dct_autoencoder", "__init__.py")):
        raise FileNotFoundError(f"no reference package: {reference_dir!r} holds no dct_autoencoder/__init__.py")
    _install_torch_dct_shim()
    _install_import_stubs()
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)


def run_reference_roundtrip(images: List[np.ndarray], reference_dir: str, patch_size: int,
                            max_patch: int) -> List[np.ndarray]:
    """No-model roundtrip through the reference's own extractor (torch cpu)."""
    import torch

    import_reference(reference_dir)
    from dct_autoencoder.feature_extraction_dct_autoencoder import (  # the reference's package
        DCTAutoencoderFeatureExtractor as RefExtractor,
    )

    proc = RefExtractor(
        channels=3,
        patch_size=patch_size,
        sample_patches_beta=0.0,
        max_patch_h=max_patch,
        max_patch_w=max_patch,
        max_seq_len=max_patch * max_patch * 3,
    )
    outs = []
    for im in images:
        t = torch.from_numpy(im)
        d = proc.preprocess(t)
        cols = {k: [v] for k, v in d.items()}
        batch = next(proc.iter_batches(iter([cols]), batch_size=None))
        rec = proc.postprocess(batch)[0]
        outs.append(rec.numpy())
    return outs


def run_ours_roundtrip(images: List[np.ndarray], patch_size: int, max_patch: int,
                       device: str = "cuda") -> List[np.ndarray]:
    """No-model roundtrip through the port's extractor on `device`."""
    from ..patches.extractor import DCTAutoencoderFeatureExtractor

    proc = DCTAutoencoderFeatureExtractor(
        channels=3,
        patch_size=patch_size,
        sample_patches_beta=0.0,
        max_patch_h=max_patch,
        max_patch_w=max_patch,
        max_seq_len=max_patch * max_patch * 3,
        device=device,
    )
    outs = []
    for im in images:
        d = proc.preprocess(im)
        cols = {k: [v] for k, v in d.items()}
        batch = next(proc.iter_batches(iter([cols]), batch_size=None))
        outs.append(proc.postprocess(batch)[0])
    return outs


def load_images(image_dir: str, n_images: int, max_side: int):
    """(file names, (c, h, w) float32 images in [0, 1]): the first n_images
    .jpg/.jpeg/.png files by name, shrunk (bicubic) to max_side."""
    from PIL import Image

    files = sorted(
        f for f in os.listdir(image_dir) if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )[:n_images]
    images = []
    for f in files:
        with Image.open(os.path.join(image_dir, f)) as src:
            im = src.convert("RGB")
        if max(im.size) > max_side:
            s = max_side / max(im.size)
            im = im.resize((int(im.width * s), int(im.height * s)), Image.BICUBIC)
        images.append(np.asarray(im, dtype=np.float32).transpose(2, 0, 1) / 255.0)
    return files, images


def main(
    image_dir: str,
    reference_dir: str,
    patch_size: int = 16,
    max_patch: int = 32,
    max_side: int = 256,
    n_images: int = 6,
    device: str = "cuda",
):
    import_reference(reference_dir)
    files, images = load_images(image_dir, n_images, max_side)
    ref = run_reference_roundtrip(images, reference_dir, patch_size, max_patch)
    ours = run_ours_roundtrip(images, patch_size, max_patch, device)

    wins = 0
    rows = []
    for f, im, r, o in zip(files, images, ref, ours):
        pr, po = psnr(r, im), psnr(o, im)
        wins += po >= pr - 0.5  # equal-within-noise counts
        rows.append((f, pr, po))
        print(f"{f:24s} reference {pr:7.2f} dB   ours {po:7.2f} dB   {'OK' if po >= pr - 0.5 else 'WORSE'}")

    print(f"\n{wins}/{len(rows)} images at-or-above the reference PSNR (0.5 dB tolerance)")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--reference_dir", required=True,
                   help="the directory that holds the reference's dct_autoencoder package")
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--max_patch", type=int, default=32)
    p.add_argument("--max_side", type=int, default=256)
    p.add_argument("--n_images", type=int, default=6)
    p.add_argument("--device", default="cuda", help="where the port's extractor runs ('cuda' or 'cpu')")
    main(**vars(p.parse_args()))
