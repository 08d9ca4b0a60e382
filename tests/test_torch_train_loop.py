"""The port's optimizer steps against the JAX package (optax), in fp32 on the CPU:
the learning-rate schedule, optimizer steps with accumulation 1 and 2, the
clip, a loss that falls over steps, accumulation's row padding and token
weights; and train()'s loop with prefetch against without, and a model
with attention dropout 0 trained and served.

Split out of tests/test_torch_train.py, whose models, batches and helpers it
imports (its docstring states the tolerances), so that pytest's
`--dist loadfile` spreads the training tests over three workers.
"""
import random
import threading

import jax
import numpy as np
import optax
import pytest
import torch
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_model_and_processor
from dct_autoencoder_tpu.train import loop as jloop
from test_torch_train import (
    _dropout_config,
    _port_setup,
    _stream,
    _assert_params_close,
    make_case,
    port_of,
    tiny_config,
    to_torch_batch,
)
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


@pytest.mark.parametrize("max_iters,warmup", [(40, 8), (10000, 200), (5, 200), (30, 0), (1, 200)])
def test_learning_rate_schedule_matches_optax(max_iters, warmup):
    """make_optimizer's schedule, its clamps on warmup_steps and decay_steps included."""
    lr = 3e-4
    tx = tloop.make_optimizer(lr, max_iters, warmup)
    w = min(warmup, max(max_iters - 1, 0))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, w, max(max_iters, w + 1), 0.0)
    steps = list(range(0, min(max_iters, 400) + 5))
    got = np.array([tx.schedule(i) for i in steps])
    want = np.array([float(sched(i)) for i in steps])
    np.testing.assert_allclose(got, want, atol=1e-7 * lr, rtol=1e-5)
    if w > 0:
        assert got[0] == 0.0


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(accum):
    """Parameters, losses and the pre-clip grad norm over 3 steps (warmup 2: rates 0, 5e-5, 1e-4)."""
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tb = to_torch_batch(batch)
    kw = dict(learning_rate=1e-4, max_iters=100, warmup_steps=2)

    jtx = jloop.make_optimizer(**kw)
    jstate = jloop.TrainState.create(jm.params, jtx)
    jstep = jax.jit(jloop.make_train_step(jm.module, jtx, accum_steps=accum))
    ttx = tloop.make_optimizer(**kw)
    tstate = tloop.TrainState.create(tm.module, ttx)
    tstep = tloop.make_train_step(tm.module, ttx, accum_steps=accum)

    lr_sum = 0.0
    for i in range(3):
        jstate, jmet = jstep(jstate, jm.patchnorm, batch)
        tstate, tmet = tstep(tstate, tm.patchnorm, tb)
        lr_sum += ttx.schedule(i)
        assert tmet.keys() == jmet.keys()
        for k in jmet:
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-3, err_msg=f"step {i} {k}")
        _assert_params_close(tm, jstate.params, lr_sum, f"step {i}")
    assert tstate.step == int(jstate.step) == 3


def test_clip_scales_like_optax():
    """A gradient above the limit is scaled to the limit; grad_norm reports the norm before."""
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tx = tloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0, grad_clip=1e-3)
    state = tloop.TrainState.create(tm.module, tx)
    seen = {}
    orig = state.adamw.step
    state.adamw.step = lambda: seen.update(norm=torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in tm.module.parameters()]))) or orig()
    _, met = tloop.make_train_step(tm.module, tx)(state, tm.patchnorm, to_torch_batch(batch))
    assert met["grad_norm"].item() > 1e-3
    assert seen["norm"].item() == pytest.approx(1e-3, rel=1e-4)


def test_train_step_reduces_loss():
    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    tx = tloop.make_optimizer(learning_rate=3e-3, max_iters=100, warmup_steps=0)
    state = tloop.TrainState.create(tm.module, tx)
    step = tloop.make_train_step(tm.module, tx)
    tb = to_torch_batch(batch)
    losses = []
    for _ in range(12):
        state, metrics = step(state, tm.patchnorm, tb)
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert state.step == 12


def test_accumulation_pads_and_weights_by_tokens():
    """Uneven token counts per micro-batch: the token-mean losses of accum=2 equal accum=1."""
    jm, _ = make_case("tiny_block")
    proc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    rng = np.random.default_rng(0)
    ims = [rng.uniform(0.1, 0.9, size=(3, s, s)).astype(np.float32) for s in (32, 16, 16, 32, 16)]
    ds = [proc.preprocess(im) for im in ims]
    batch = next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]), batch_size=None))
    tb = to_torch_batch(batch)
    assert tb.patches.shape[0] == 4
    tok = (~tb.key_pad_mask).sum(dim=1)
    assert tok[:2].sum() != tok[2:].sum()
    mets = {}
    for accum in (1, 2):
        tm = port_of(jm)
        tx = tloop.make_optimizer(learning_rate=0.0, max_iters=10, warmup_steps=0)
        _, mets[accum] = tloop.make_train_step(tm.module, tx, accum_steps=accum)(
            tloop.TrainState.create(tm.module, tx), tm.patchnorm, tb
        )
    for k in ("rec_loss", "rec_loss_unnormalized", "commit_loss"):
        np.testing.assert_allclose(mets[2][k].item(), mets[1][k].item(), rtol=1e-5, err_msg=k)
    padded = tloop.pad_batch_rows(tb, 3)
    assert padded.patches.shape[0] == 6 and padded.key_pad_mask[4:].all() and not padded.key_pad_mask[:4].all()
    with pytest.raises(ValueError, match="accum_steps"):
        tm = port_of(jm)
        tx = tloop.make_optimizer()
        tloop.make_train_step(tm.module, tx, accum_steps=3)(tloop.TrainState.create(tm.module, tx), tm.patchnorm, tb)


def test_train_loop_with_prefetch_equals_without(tmp_path):
    """Batches made on the prefetch thread train exactly as batches made inline."""
    runs = {}
    for n in (0, 2):
        model, proc = _port_setup(seed=5)
        logs = []
        tloop.train(model, proc, iter(list(_stream(_port_setup()[1], 3, seed=21, n_images=3))), batch_size=None,
                    max_iters=3, learning_rate=1e-4, prefetch_batches=n, log_every=1, save_every=0, log=logs.append)
        runs[n] = [d["loss"] for d in logs]
        assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())
    assert len(runs[2]) == 3 and runs[2] == runs[0]


def test_sec_per_step_is_the_time_since_the_previous_log_line():
    """sec_per_step is the wall time since the previous log line over the steps since then: a pause of
    the stream between two logs shows in the second one alone."""
    import time

    def stream(pulls):
        for i, pull in enumerate(pulls):
            if i == 3:
                time.sleep(1.0)
            yield pull

    model, proc = _port_setup(seed=5)
    pulls = list(_stream(_port_setup()[1], 5, seed=21, n_images=3))
    logs, at = [], []
    tloop.train(model, proc, stream(pulls), batch_size=None, max_iters=5, prefetch_batches=0, log_every=2,
                save_every=0, log=lambda d: (logs.append(d), at.append(time.time())))
    sps = {d["step"]: d["sec_per_step"] for d in logs}
    assert sorted(sps) == [0, 2, 4]
    assert sps[4] >= 0.5 and sps[4] == pytest.approx((at[2] - at[1]) / 2, abs=0.02)
    assert sps[2] < sps[4] - 0.3


def test_attention_dropout_zero_trains_and_serves_as_before():
    """With attention_dropout 0 the same config trains (MLP dropout from the
    generator) and serving ignores dropout, as in JAX."""
    model, proc = torch_model_and_processor(_dropout_config(0.0), sample_patches_beta=0.0, device="cpu")
    proc.rng = random.Random(0)
    logs = []
    model, state = tloop.train(model, proc, _stream(proc, 3), batch_size=None, max_iters=3, log_every=1, log=logs.append)
    assert state.step == 3 and all(np.isfinite(m["loss"]) for m in logs)
    served = _dropout_config(0.3)  # serving (training=False) never reads the rate
    model, proc = torch_model_and_processor(served, sample_patches_beta=0.0, device="cpu")
    batch = model.normalize_(next(proc.iter_batches(_stream(proc, 1), batch_size=None)))
    assert torch.equal(model.forward(batch)["codes"], model.forward(batch)["codes"])
