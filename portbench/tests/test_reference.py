"""The plain reference at small sizes: its DCT against the definition in
float64, its colour transform, token order, budgets and packing, and its model
against the port's own float32 path on the CPU (the port is imported by the
test only; the reference imports nothing of it)."""
import math
import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import frontend as F
from portbench.reference import model as R


def test_dct_matrix_is_the_orthonormal_dct_ii_by_definition():
    n = 7
    d = F.dct_matrix(n).numpy()
    for k in range(n):
        s = math.sqrt(1 / n) if k == 0 else math.sqrt(2 / n)
        for i in range(n):
            assert d[k, i] == pytest.approx(s * math.cos(math.pi * (2 * i + 1) * k / (2 * n)), abs=1e-15)
    assert np.allclose(d @ d.T, np.eye(n), atol=1e-14)


def test_whole_image_dct_against_the_double_sum_in_float64():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((1, 3, 28, 42), generator=g, dtype=torch.float64)
    tok = F.dct_tokens(x, 14)  # (1, 6, 3, 196)
    ipt = F.rgb_to_ipt(x)[0].numpy()
    h, w = 28, 42
    u, v = 15, 30  # patch (1, 2), coefficient (1, 2)
    su = math.sqrt(2 / h)
    sv = math.sqrt(2 / w)
    want = sum(ipt[1, i, j] * su * math.cos(math.pi * (2 * i + 1) * u / (2 * h)) * sv * math.cos(math.pi * (2 * j + 1) * v / (2 * w))
               for i in range(h) for j in range(w))
    assert tok[0, 1 * 3 + 2, 1, 1 * 14 + 2].item() == pytest.approx(want, rel=1e-12, abs=1e-12)


def test_ipt_round_trip_and_back_end_inverts_front_end():
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 3, 28, 28), generator=g, dtype=torch.float64)
    assert torch.allclose(F.ipt_to_rgb(F.rgb_to_ipt(x)), x, atol=1e-12)
    tok = F.dct_tokens(x, 14)
    planes = tok.reshape(2, 2, 2, 3, 14, 14).permute(0, 3, 1, 4, 2, 5).reshape(2, 3, 28, 28)
    assert torch.allclose(F.planes_to_rgb(planes, 28, 28), x, atol=1e-12)


def test_token_budget_and_packing_by_hand():
    assert F.token_budget(math.exp(-1.0), 0.02, 1000, 256) == 50
    assert F.token_budget(1e-12, 0.02, 243, 256) == 243  # capped at the image's tokens
    assert F.token_budget(0.999999, 0.02, 243, 256) == 1  # at least one
    assert F.token_budget(0.5, 0.0, 3072, 3072) == 3072  # beta 0 keeps everything
    assert F.pack([100, 100, 60, 200, 56, 1], 256) == [[0, 1], [2], [3, 4], [5]]


def _port_batch(cfg, seed, dtype):
    import dct_autoencoder_torch as dt

    model, proc = dt.get_model_and_processor(dt.DCTAutoencoderConfig.from_dict(cfg), dtype=dtype,
                                             sample_patches_beta=0.02, seed=0, device="cpu")
    w = inputs.make_weights(cfg, seed, "cpu")
    with torch.no_grad():
        for k, p in model.module.named_parameters():
            p.copy_(w[k])
    return model, proc, w


def test_reference_model_equals_the_port_in_float32():
    from dct_autoencoder_torch.models.patchnorm import PatchNormState, apply_patchnorm
    from dct_autoencoder_torch.train.losses import step_autoencoder, weighted_total
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell("train-lfq-64x256")
    cfg, tr = cell.config, cell.traffic
    model, proc, w = _port_batch(cfg, 5, torch.float32)
    norm = inputs.make_norm(cfg, tr["norm_side"], "cpu")
    c, mh, mw = 3, cfg["max_patch_h"], cfg["max_patch_w"]
    model.patchnorm = PatchNormState(n=torch.ones((c, mh, mw)), median=norm["median"], b=norm["b"])
    from portbench.kinds import train

    _, draws = train.pool_plan(tr, cell.seed)
    pool = train.preprocess_pool(proc, train.pool_images(tr, cell.seed, "cpu"), draws)
    batch = next(proc.iter_batches(train.feed(pool, tr["feed_images"]), tr["rows"]))
    losses = step_autoencoder(model.module, model.patchnorm, batch, batch.replace(patches=apply_patchnorm(model.patchnorm, batch)))
    weighted_total(losses).backward()
    ref_batch = train.reference_batches(cell, 1, "cpu")[0]
    assert ref_batch["images"] == len(batch.original_sizes)
    assert torch.allclose(ref_batch["patches"], batch.patches, atol=1e-4)
    assert torch.equal(ref_batch["pad"], batch.key_pad_mask)
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    totals = R.train_losses(R.Plain(params, cfg), ref_batch, norm, block_rows=3)
    for k in ("rec_loss", "commit_loss", "entropy_loss", "rec_loss_unnormalized"):
        assert totals[k] == pytest.approx(float(losses[k]), rel=1e-4), k
    # the entropy loss's temperature of 0.01 turns float32 round-off into ~1e-3 of a gradient
    from portbench.reference.compare import worst_leaf

    ref_norms = {k: float(v.grad.norm()) for k, v in params.items()}
    port_norms = {k: float(p.grad.norm()) for k, p in model.module.named_parameters()}
    assert worst_leaf(port_norms, ref_norms, ref_norms)[0] < 1e-2
    cos = {k: float(torch.nn.functional.cosine_similarity(params[k].grad.flatten(), p.grad.flatten(), dim=0))
           for k, p in model.module.named_parameters() if float(p.grad.norm()) > 1e-6}
    assert min(cos.values()) > 0.999
