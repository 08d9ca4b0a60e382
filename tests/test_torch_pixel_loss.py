"""The port's pixel loss (train/pixel_loss.py) against the JAX package's.

The counterparts of the six tests of tests/test_pixel_loss.py: the same
bucketed batches, packed by the JAX extractor from seeded numpy images,
go through both packages' functions in fp32 on the CPU.

The pixel loss in the train step (the counterparts of tests/test_train.py's
pixel-loss tests) is held to JAX's step as tests/test_torch_train.py holds
the other losses: losses rtol 1e-4, each parameter's gradient atol 2e-3 x its
largest entry, the pre-clip grad norm rtol 1e-3, parameters after 2 steps
as test_train_steps_match_jax holds them; accumulation 2 against 1: losses
rtol 1e-4, gradients atol 1e-4 x the largest entry.

Tolerances of the functions: the losses rtol 1e-5; their gradients with respect to the
reconstructed patches atol 1e-6 (both packages run the IDCT as fp32 matrix
products, summed in another order); RGB images atol 1e-5; the grid sizes
and row offsets equal.  One case differs: `pixel_loss` on patches shifted
by 0.1 (pixels up to ~72, errors summed over 12k values) is 1.6e-5 from its
float64 value in JAX and 6e-7 in the port, so there the port is held to
float64 at rtol 2e-6 and to JAX at rtol 3e-5.  Against the port's own host
postprocess (the IDCT kernel's plain version), atol 1e-3 and rtol 1e-4, as
the JAX tests hold their package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.ops.colorspace import ipt_to_rgb
from dct_autoencoder_torch.ops.dct import idct2
from dct_autoencoder_torch.patches.extractor import DCTAutoencoderFeatureExtractor as TorchExtractor
from dct_autoencoder_torch.train import pixel_loss as tpl
from dct_autoencoder_tpu.train import pixel_loss as jpl
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_torch.train import losses as tlosses
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_model_and_processor
from dct_autoencoder_tpu.train import loop as jloop
from dct_autoencoder_tpu.train import losses as jlosses
from test_model import tiny_config
from test_pixel_loss import make_bucketed_batch
from test_torch_model import to_torch_batch
from test_torch_train import GRAD_REL_ATOL, _assert_params_close, flat, make_case, port_of
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-6
IMAGE_ATOL = 1e-5


def _port_proc(proc):
    """The port's extractor with the JAX extractor's settings, on the CPU."""
    return TorchExtractor(
        channels=3, patch_size=proc.patch_size, sample_patches_beta=0.0, max_patch_h=proc.max_patch_h,
        max_patch_w=proc.max_patch_w, max_seq_len=proc.max_seq_len, device="cpu",
    )


def _noisy(rng, batch, scale=0.05):
    noise = rng.standard_normal(batch.patches.shape).astype(np.float32) * scale
    return np.asarray(batch.patches) + noise * (~np.asarray(batch.key_pad_mask))[..., None]


def _packed_both(rec, target, batch, tb, gs_j, grid, p, **micro):
    """packed_pixel_loss and its gradient w.r.t. rec in both packages."""
    jmicro = {k: jnp.asarray(v) for k, v in micro.items()}
    jl, jg = jax.value_and_grad(
        lambda r: jpl.packed_pixel_loss(r, jnp.asarray(target), batch, gs_j, grid, p, 3, **jmicro)
    )(jnp.asarray(rec))
    trec = torch.tensor(rec, requires_grad=True)
    tl = tpl.packed_pixel_loss(
        trec, torch.from_numpy(np.asarray(target)), tb, torch.from_numpy(np.asarray(gs_j)), grid, p, 3,
        **{k: torch.from_numpy(np.asarray(v)) for k, v in micro.items()},
    )
    tl.backward()
    return (float(jl), np.asarray(jg)), (tl.item(), trec.grad.numpy())


def test_unpatch_matches_postprocess():
    rng = np.random.default_rng(0)
    proc, ims, batch = make_bucketed_batch(rng)
    tb = to_torch_batch(batch)
    offsets, n_images = jpl.make_row_offsets(batch)
    t_offsets, t_n = tpl.make_row_offsets(tb)
    assert t_n == n_images
    np.testing.assert_array_equal(t_offsets.numpy(), np.asarray(offsets))
    grid = batch.patch_sizes[0]

    want = np.asarray(jpl.unpatch_to_images(batch.patches, batch, offsets, grid, proc.patch_size, 3, n_images))
    got = tpl.unpatch_to_images(tb.patches, tb, t_offsets, grid, proc.patch_size, 3, n_images).numpy()
    np.testing.assert_allclose(got, want, atol=IMAGE_ATOL, rtol=0)
    post = _port_proc(proc).postprocess(tb.replace(patch_sizes=batch.patch_sizes, original_sizes=batch.original_sizes))
    for i in range(n_images):
        np.testing.assert_allclose(got[i], post[i], atol=1e-3)


def test_pixel_loss_zero_on_perfect_reconstruction():
    rng = np.random.default_rng(1)
    proc, ims, batch = make_bucketed_batch(rng)
    tb = to_torch_batch(batch)
    offsets, n_images = jpl.make_row_offsets(batch)
    t_offsets, _ = tpl.make_row_offsets(tb)
    grid = batch.patch_sizes[0]
    targets = np.stack(ims)
    valid = np.ones((n_images,), dtype=bool)

    def both(patches):
        want = float(jpl.pixel_loss(jnp.asarray(patches), batch, jnp.asarray(targets), jnp.asarray(valid), offsets,
                                    grid, proc.patch_size))
        got = tpl.pixel_loss(torch.from_numpy(np.asarray(patches)), tb, torch.from_numpy(targets),
                             torch.from_numpy(valid), t_offsets, grid, proc.patch_size).item()
        return want, got

    want, got = both(np.asarray(batch.patches))
    assert got < 1e-5
    np.testing.assert_allclose(got, want, atol=1e-9)
    shifted = np.asarray(batch.patches) + 0.1
    want2, got2 = both(shifted)
    planes = tpl.unpatch_to_planes(torch.from_numpy(shifted), tb, t_offsets, grid, proc.patch_size, 3, n_images)
    f64 = ((ipt_to_rgb(idct2(planes.double())) - torch.from_numpy(targets).double()) ** 2).mean().item()
    np.testing.assert_allclose(got2, f64, rtol=2e-6)
    np.testing.assert_allclose(got2, want2, rtol=3e-5)
    assert got2 > got


def test_pixel_loss_differentiable():
    rng = np.random.default_rng(2)
    proc, ims, batch = make_bucketed_batch(rng, n_images=2)
    tb = to_torch_batch(batch)
    offsets, n_images = jpl.make_row_offsets(batch)
    grid = batch.patch_sizes[0]
    targets = np.stack(ims)
    valid = np.ones((n_images,), dtype=bool)
    x = np.asarray(batch.patches) + 0.05

    jg = np.asarray(jax.grad(
        lambda pt: jpl.pixel_loss(pt, batch, jnp.asarray(targets), jnp.asarray(valid), offsets, grid, proc.patch_size)
    )(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    tpl.pixel_loss(tx, tb, torch.from_numpy(targets), torch.from_numpy(valid), tpl.make_row_offsets(tb)[0], grid,
                   proc.patch_size).backward()
    g = tx.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, jg, atol=GRAD_ATOL, rtol=0)
    valid_tok = ~np.asarray(batch.key_pad_mask)
    assert np.abs(g[valid_tok]).sum() > 0
    np.testing.assert_allclose(g[~valid_tok], 0.0, atol=1e-12)


def test_packed_pixel_loss_matches_jax_and_eager_reference():
    rng = np.random.default_rng(3)
    proc, ims, batch = make_bucketed_batch(rng, n_images=5)
    tb = to_torch_batch(batch)
    grid = (proc.max_patch_h, proc.max_patch_w)
    gs = jpl.make_grid_sizes(batch, max_images=8, clip_grid=grid)
    tgs = tpl.make_grid_sizes(tb.replace(patch_sizes=batch.patch_sizes), max_images=8, clip_grid=grid)
    assert tgs.dtype == torch.int32
    np.testing.assert_array_equal(tgs.numpy(), np.asarray(gs))
    rec = _noisy(rng, batch)

    (jl, jg), (tl, tg) = _packed_both(rec, batch.patches, batch, tb, gs, grid, proc.patch_size)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, atol=GRAD_ATOL, rtol=0)
    assert tl > 0
    # the reference's eager computation (main.py:95-106) through the port's
    # host postprocess: per-image MSE, mean over images
    tproc = _port_proc(proc)
    meta = dict(patch_sizes=batch.patch_sizes, original_sizes=batch.original_sizes)
    rec_images = tproc.postprocess(tb.replace(patches=torch.from_numpy(rec), **meta))
    tgt_images = tproc.postprocess(tb.replace(**meta))
    want = float(np.mean([np.mean((r - t) ** 2) for r, t in zip(rec_images, tgt_images)]))
    np.testing.assert_allclose(tl, want, rtol=1e-4)


def test_packed_pixel_loss_micro_slot_alignment():
    """Per-half losses with global row offsets and slot windows: each equals
    JAX's, and recombined by image count they give the full-batch loss."""
    rng = np.random.default_rng(5)
    proc, ims, batch = make_bucketed_batch(rng, n_images=4)
    tb = to_torch_batch(batch)
    b = batch.patches.shape[0]
    assert b % 2 == 0 and b >= 2
    grid = (proc.max_patch_h, proc.max_patch_w)
    gs = jpl.make_grid_sizes(batch, max_images=8, clip_grid=grid)
    rec = _noisy(rng, batch)
    full = _packed_both(rec, batch.patches, batch, tb, gs, grid, proc.patch_size)[1][0]

    offsets, n_per_row = (t.numpy() for t in tpl.row_image_layout(tb))
    j_offsets, j_n = jax.tree_util.tree_map(np.asarray, jpl.row_image_layout(batch))
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(n_per_row, j_n)
    mb = b // 2
    halves = []
    for i in range(2):
        sl = slice(i * mb, (i + 1) * mb)
        micro = jax.tree_util.tree_map(lambda x: x[sl], batch)
        start, count = offsets[i * mb], n_per_row[sl].sum()
        slot_valid = (np.arange(8) >= start) & (np.arange(8) < start + count)
        (jl, jg), (tl, tg) = _packed_both(
            rec[sl], np.asarray(batch.patches)[sl], micro, to_torch_batch(micro), gs, grid, proc.patch_size,
            row_offsets=offsets[sl], slot_valid=slot_valid,
        )
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tg, jg, atol=GRAD_ATOL, rtol=0)
        halves.append((tl, int(count)))

    want = sum(loss * n for loss, n in halves) / sum(n for _, n in halves)
    np.testing.assert_allclose(full, want, rtol=LOSS_RTOL)
    assert halves[0][0] != halves[1][0]


def test_packed_pixel_loss_masks_overflow_images():
    rng = np.random.default_rng(4)
    proc, ims, batch = make_bucketed_batch(rng, n_images=4)
    tb = to_torch_batch(batch)
    grid = (proc.max_patch_h, proc.max_patch_w)
    rec = np.asarray(batch.patches) + 0.1
    losses = {}
    for max_images in (2, 8):  # 2 < 4 packed images: the overflow must be dropped
        gs = jpl.make_grid_sizes(batch, max_images=max_images, clip_grid=grid)
        (jl, jg), (tl, tg) = _packed_both(rec, batch.patches, batch, tb, gs, grid, proc.patch_size)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tg, jg, atol=GRAD_ATOL, rtol=0)
        losses[max_images] = tl
    assert np.isfinite(losses[2]) and np.isfinite(losses[8])
    assert 0.2 < losses[2] / losses[8] < 5.0


def test_micro_mode_needs_slot_valid():
    rng = np.random.default_rng(6)
    proc, ims, batch = make_bucketed_batch(rng, n_images=2)
    tb = to_torch_batch(batch)
    gs = tpl.make_grid_sizes(tb.replace(patch_sizes=batch.patch_sizes), 4, (4, 4))
    with pytest.raises(ValueError, match="slot_valid"):
        tpl.packed_pixel_loss(tb.patches, tb.patches, tb, gs, (4, 4), 8, 3, row_offsets=tpl.row_image_layout(tb)[0])


# ---------------------------------------------------------------- the pixel loss in the train step


PIXEL_ONLY = dict(rec_loss=0.0, rec_loss_unnormalized=0.0, commit_loss=0.0, entropy_loss=0.0, pixel_loss=1.0)


def test_step_autoencoder_pixel_loss_matches_jax():
    """losses['pixel_loss'] and every parameter's gradient of the total with it, against JAX."""
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    grid = (jm.config.max_patch_h, jm.config.max_patch_w)
    _, jgs = jloop.prepare_train_batch(batch, pixel_loss_max_images=8, clip_grid=grid)
    nb = jm.normalize_(batch)

    def f(params):
        losses = jlosses.step_autoencoder(jm.module, params, jm.patchnorm, batch, nb, training=True, pixel_grid_sizes=jgs)
        return jlosses.weighted_total(losses), losses

    (jtotal, jl), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(jm.params)
    jg = flat(jg)
    tb, tgs = tloop.prepare_train_batch(to_torch_batch(batch), pixel_loss_max_images=8, clip_grid=grid)
    np.testing.assert_array_equal(tgs.numpy(), np.asarray(jgs))
    tl = tlosses.step_autoencoder(tm.module, tm.patchnorm, tb, tm.normalize_(tb), training=True, pixel_grid_sizes=tgs)
    total = tlosses.weighted_total(tl)
    total.backward()
    tg = jax_arrays_from_state_dict({k: p.grad for k, p in tm.module.named_parameters()}, tm.config)
    np.testing.assert_allclose(tl["pixel_loss"].item(), float(jl["pixel_loss"]), rtol=1e-4)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)
    floor = 1e-6 * max(np.abs(g).max() for g in jg.values())
    for k, want in jg.items():
        np.testing.assert_allclose(tg[k], want, atol=GRAD_REL_ATOL * np.abs(want).max() + floor, rtol=0, err_msg=k)


def test_pixel_loss_in_train_step_matches_jax():
    """The pixel loss alone: its gradient reaches the parameters, the step's
    metrics equal JAX's, and parameters after 2 steps too; without the flag
    the objective differs."""
    jm, raw = make_case("tiny_block")
    grid = (jm.config.max_patch_h, jm.config.max_patch_w)
    kw = dict(learning_rate=1e-4, max_iters=100, warmup_steps=0)
    jbatch, jgs = jloop.prepare_train_batch(raw, pixel_loss_max_images=8, clip_grid=grid)
    jtx = jloop.make_optimizer(**kw)
    jstep = jax.jit(jloop.make_train_step(jm.module, jtx, loss_weights=PIXEL_ONLY, use_pixel_loss=True))
    jstate = jloop.TrainState.create(jm.params, jtx)

    tm = port_of(jm)
    tb, tgs = tloop.prepare_train_batch(to_torch_batch(raw), pixel_loss_max_images=8, clip_grid=grid)
    ttx = tloop.make_optimizer(**kw)
    tstep = tloop.make_train_step(tm.module, ttx, loss_weights=PIXEL_ONLY, use_pixel_loss=True)
    tstate = tloop.TrainState.create(tm.module, ttx)
    with pytest.raises(ValueError, match="grid sizes"):
        tstep(tstate, tm.patchnorm, tb)
    for i in range(2):
        jstate, jm_ = jstep(jstate, jm.patchnorm, jbatch, jgs)
        tstate, tm_ = tstep(tstate, tm.patchnorm, tb, tgs)
        assert tm_.keys() == jm_.keys() and "pixel_loss" in tm_
        for k in ("pixel_loss", "loss"):
            np.testing.assert_allclose(tm_[k].item(), float(jm_[k]), rtol=1e-4, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(tm_["grad_norm"].item(), float(jm_["grad_norm"]), rtol=1e-3)
        _assert_params_close(tm, jstate.params, kw["learning_rate"] * (i + 1), f"step {i}")
    assert tm_["pixel_loss"].item() > 0 and tm_["grad_norm"].item() > 0

    off = port_of(jm)
    otx = tloop.make_optimizer(**kw)
    off_step = tloop.make_train_step(off.module, otx)
    with pytest.raises(ValueError, match="grid sizes"):
        off_step(tloop.TrainState.create(off.module, otx), off.patchnorm, tb, tgs)
    _, m_off = off_step(tloop.TrainState.create(off.module, otx), off.patchnorm, tb)
    assert "pixel_loss" not in m_off


class _RecordingOptimizer(tloop.Optimizer):
    """The optimizer of make_optimizer that keeps the gradients it was handed."""

    def apply(self, adamw, params, count, lr_scale=1.0):
        self.grads = [p.grad.clone() for p in params]
        return super().apply(adamw, params, count, lr_scale)


@pytest.mark.parametrize("sizes", [(32, 32, 32, 32), (32, 16, 16, 32, 16)], ids=["even", "uneven"])
def test_accumulation_with_pixel_loss_matches_accumulation_1(sizes):
    """accum=2 equals accum=1 with the pixel loss in the objective, also
    when packing spreads images unevenly over rows ([1, 2, 1, 1] images:
    micro-batches of 3 and 2), where both are also held to JAX's step.  The
    entropy loss is off: it is the one loss nonlinear in the split."""
    jm, _ = make_case("tiny_block")
    proc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    rng = np.random.default_rng(0)
    ds = [proc.preprocess(rng.uniform(0.1, 0.9, size=(3, s, s)).astype(np.float32)) for s in sizes]
    raw = next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]), batch_size=None))
    assert raw.patches.shape[0] == 4
    ids, valid = np.asarray(raw.batched_image_ids), ~np.asarray(raw.key_pad_mask)
    per_row = [len(set(ids[r][valid[r]].tolist())) for r in range(4)]
    assert (sum(per_row[:2]) != sum(per_row[2:])) == (len(sizes) == 5), per_row
    grid = (8, 8)
    weights = dict(entropy_loss=0.0, pixel_loss=1.0)
    jbatch, jgs = jloop.prepare_train_batch(raw, pixel_loss_max_images=8, clip_grid=grid)
    tb, tgs = tloop.prepare_train_batch(to_torch_batch(raw), pixel_loss_max_images=8, clip_grid=grid)

    got, grads = {}, {}
    for accum in (1, 2):
        tm = port_of(jm)
        ttx = _RecordingOptimizer(**vars(tloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0)))
        step = tloop.make_train_step(tm.module, ttx, loss_weights=weights, accum_steps=accum, use_pixel_loss=True)
        _, got[accum] = step(tloop.TrainState.create(tm.module, ttx), tm.patchnorm, tb, tgs)
        grads[accum] = ttx.grads
        if len(sizes) == 5:  # the uneven packing: JAX's step too (a compile each, so once)
            jtx = jloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0)
            jstep = jloop.make_train_step(jm.module, jtx, loss_weights=weights, accum_steps=accum, use_pixel_loss=True)
            _, want = jax.jit(jstep)(jloop.TrainState.create(jm.params, jtx), jm.patchnorm, jbatch, jgs)
            for k in ("pixel_loss", "loss"):
                np.testing.assert_allclose(got[accum][k].item(), float(want[k]), rtol=1e-4, err_msg=f"accum {accum} {k}")
            np.testing.assert_allclose(got[accum]["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-3)
    for k in ("pixel_loss", "loss"):
        np.testing.assert_allclose(got[2][k].item(), got[1][k].item(), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got[2]["grad_norm"].item(), got[1]["grad_norm"].item(), rtol=1e-3)
    for g2, g1 in zip(grads[2], grads[1]):
        np.testing.assert_allclose(g2.numpy(), g1.numpy(), atol=1e-4 * g1.abs().max().item() + 1e-9, rtol=0)
