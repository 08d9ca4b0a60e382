"""The port's native packing runtime (patches/native.py over ext/packing.cpp).

Mirrors the five tests of tests/test_native.py: the library builds (into
the port's own build directory), and greedy_pack, fill_batch and
build_attn_mask equal the port's numpy packing and the JAX package's
native entry points bit for bit; the last test times the two paths (for
information only: wall time on a shared host is too noisy to hold).  Also:
without the library every entry point raises by name, where JAX falls back
quietly.
"""
import os
import time

import numpy as np
import pytest

from dct_autoencoder_torch.kernels._build import BUILD_DIR
from dct_autoencoder_torch.patches import native
from dct_autoencoder_torch.patches.packing import build_attn_mask, fill_batch, group_patches_by_max_seq_len
from dct_autoencoder_tpu.patches import native as jax_native
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_items(rng, n=50, pz=16, max_k=40):
    items = []
    for _ in range(n):
        k = int(rng.integers(1, max_k))
        items.append((
            rng.standard_normal((k, pz)).astype(np.float32),
            rng.integers(0, 32, size=(k, 2)).astype(np.int32),
            rng.integers(0, 3, size=(k,)).astype(np.int32),
        ))
    return items


def _groups(items, max_seq_len):
    state = group_patches_by_max_seq_len(items, max_seq_len)
    if state.group:
        state.groups.append(state.group)
    return state.groups


def _native_batch(items, max_seq_len, lib=native):
    lengths = np.asarray([p.shape[0] for p, _, _ in items])
    n_rows, row_ids, slots, offsets = lib.greedy_pack(lengths, max_seq_len)
    cat = [np.concatenate([it[j] for it in items]) for j in range(3)]
    return lib.fill_batch(*cat, lengths, row_ids, slots, offsets, n_rows, max_seq_len)


def test_native_builds_into_the_ports_build_directory():
    assert native.available(), "the native packing library did not build (is g++ there?)"
    path = native.lib_path()
    assert os.path.isfile(path) and os.path.dirname(path) == BUILD_DIR
    assert os.path.commonpath([path, os.path.join(REPO, "ext")]) != os.path.join(REPO, "ext")


def test_greedy_pack_matches_numpy_grouping_and_jax():
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 50, size=200)
    n_rows, row_ids, slots, offsets = native.greedy_pack(lengths, 128)
    for got, want in zip((n_rows, row_ids, slots, offsets), jax_native.greedy_pack(lengths, 128)):
        np.testing.assert_array_equal(got, want)

    items = [(np.zeros((k, 1), np.float32), np.zeros((k, 2), np.int32), np.zeros(k, np.int32)) for k in lengths]
    groups = _groups(items, 128)
    assert n_rows == len(groups)
    assert [int(lengths[row_ids == r].sum()) for r in range(n_rows)] == [sum(p.shape[0] for p, _, _ in g) for g in groups]
    for r, g in enumerate(groups):
        sel = np.where(row_ids == r)[0]
        np.testing.assert_array_equal(slots[sel], np.arange(len(g)))
        np.testing.assert_array_equal(offsets[sel], np.concatenate([[0], np.cumsum(lengths[sel])[:-1]]))


def test_fill_batch_matches_numpy_packing_and_jax():
    items = make_items(np.random.default_rng(1))
    got = _native_batch(items, 128)
    want = fill_batch(_groups(items, 128), 128, 16)
    theirs = _native_batch(items, 128, jax_native)
    for name, g, w, j in zip(("patches", "positions", "channels", "image_ids", "key_pad_mask"), got, want, theirs):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, j, err_msg=name)


def test_attn_mask_matches_numpy_and_jax():
    items = make_items(np.random.default_rng(2), n=6)
    _, _, _, ids, pad = fill_batch(_groups(items, 128), 128, 16)
    got = native.build_attn_mask(ids, pad)
    assert got.shape == (ids.shape[0], 128, 128) and got.dtype == bool
    np.testing.assert_array_equal(got, build_attn_mask(ids, pad))
    np.testing.assert_array_equal(got, jax_native.build_attn_mask(ids, pad))


def test_native_vs_numpy_timing_report():
    items = make_items(np.random.default_rng(3), n=600, pz=196, max_k=250)
    lengths = np.asarray([p.shape[0] for p, _, _ in items])
    cat = [np.concatenate([it[j] for it in items]) for j in range(3)]

    def run_native():
        packed = native.greedy_pack(lengths, 256)
        return native.fill_batch(*cat, lengths, *packed[1:], packed[0], 256)

    def run_numpy():
        return fill_batch(_groups(items, 256), 256, 196)

    def clock(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn()
        return (time.perf_counter() - t0) / 3, out

    t_native, a = clock(run_native)
    t_numpy, b = clock(run_numpy)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    print(f"batch assembly: native {t_native * 1e3:.1f} ms, numpy {t_numpy * 1e3:.1f} ms")


def test_entry_points_raise_by_name_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "RuntimeError: g++ not found")
    assert not native.available()
    ids, pad = np.zeros((1, 4), np.int32), np.zeros((1, 4), bool)
    calls = [
        lambda: native.greedy_pack(np.ones(3), 8),
        lambda: native.fill_batch(np.zeros((3, 1), np.float32), np.zeros((3, 2), np.int32), np.zeros(3, np.int32),
                                  np.ones(3), np.zeros(3), np.arange(3), np.arange(3), 1, 8),
        lambda: native.build_attn_mask(ids, pad),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="native packing library.*g\\+\\+ not found"):
            call()
