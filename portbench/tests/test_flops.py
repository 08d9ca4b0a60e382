"""The operation and byte counts against hand-worked cases."""
import json
import os

import pytest

from portbench import flops
from portbench.common import HERE

CFG = json.load(open(os.path.join(HERE, "configs", "patch14l-lfq.json")))


def test_pairs_count_each_image_of_a_row_apart_and_no_padding():
    # one row of 256: images of 100, 50 and 6 tokens, then 100 of padding
    assert flops.pair_count([100, 50, 6]) == 100 * 100 + 50 * 50 + 6 * 6 == 12536
    # padding is not an image: a row of 3072 with one full image is all pairs
    assert flops.pair_count([3072]) == 3072**2


def test_attention_forward_and_backward_by_hand():
    # 2 images of 3 and 1 tokens, 2 heads of width 4: 10 pairs
    ops, nbytes = flops.attention_fwd(pairs=10, tokens=4, heads=2, head_dim=4)
    assert ops == 4 * 4 * 2 * 10 == 320
    assert nbytes == 4 * 2 * (4 * 4 * 2 + 4) == 288  # q, k, v, o bf16 and lse fp32 of the valid tokens
    ops, nbytes = flops.attention_bwd(pairs=10, tokens=4, heads=2, head_dim=4)
    assert ops == 8 * 4 * 2 * 10 == 640
    assert nbytes == 4 * 2 * (7 * 4 * 2 + 8) == 512


def test_bound_is_the_larger_side():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_dct_bytes_by_hand():
    # 2 images 28 x 42, p 14: 2 x 3 patches of 3 channels each = 18 tokens an image
    assert flops.dct_bytes(2, 28, 42, 36, 14) == 2 * 3 * 28 * 42 + 36 * 196 * 4
    assert flops.idct_bytes(2, 28, 42, 36, 14) == 36 * 196 * 4 + 2 * 3 * 28 * 42


def test_patch14l_weights_and_model_flops():
    # 16 layers of 4 d^2 + 2 d ff, the patch embedding and output projection, LFQ's two projections
    stacks = 16 * (4 * 1024**2 + 2 * 1024 * 4096)
    assert stacks == 201_326_592
    assert flops.matmul_weights(CFG) == stacks + 2 * 1024 * 196 + 2 * 1024 * 208
    w = flops.matmul_weights(CFG)
    # a train step of one row holding images of 200 and 56 tokens
    pairs = 200**2 + 56**2
    assert flops.model_flops(CFG, 256, pairs, train=True) == 6 * w * 256 + 12 * 64 * 16 * 16 * pairs
    assert flops.model_flops(CFG, 256, pairs, train=False) == 2 * w * 256 + 4 * 64 * 16 * 16 * pairs


def test_attention_bound_sums_each_layer_and_kernel():
    pairs, tokens = 3072**2 * 8, 3072 * 8
    fwd = flops.bound_s(*flops.attention_fwd(pairs, tokens, 16, 64))
    bwd = flops.bound_s(*flops.attention_bwd(pairs, tokens, 16, 64))
    assert flops.attention_bound_s(CFG, tokens, pairs, backward=False) == pytest.approx(16 * fwd)
    assert flops.attention_bound_s(CFG, tokens, pairs, backward=True) == pytest.approx(16 * (fwd + bwd))
    # at one 448^2 image a row, the forward is bound by its operations
    assert fwd == pytest.approx(4 * 64 * 16 * pairs / 989e12)
