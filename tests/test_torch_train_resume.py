"""train()'s loop against the JAX package, in fp32 on the CPU: the norm
calibration phase, checkpoints that the JAX package loads, exact resume, the
NaN policies, an empty stream, what train() and the CLI refuse or check by
name, the pixel loss with 8-bit moments, a prefetch worker's error, image
grids, the RSS and stall watchdogs.

Split out of tests/test_torch_train.py, whose models, batches and helpers it
imports (its docstring states the tolerances), so that pytest's
`--dist loadfile` spreads the training tests over three workers.
"""
import os
import threading
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_torch.models.patchnorm import PatchNormState as TorchPatchNorm
from dct_autoencoder_torch.train import checkpoint as tckpt
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.models.factory import get_model_and_processor as jax_model_and_processor
from test_torch_train import (
    _port_setup,
    _stream,
    assert_codes_match,
    deterministic,  # noqa: F401  (fixture)
    flat,
    jax_pre_sign,
    make_batch,
    make_case,
    port_of,
    tiny_config,
    to_torch_batch,
)
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)


def test_train_patch_norm_phase():
    model, proc = _port_setup(beta=0.05)
    proc.max_seq_len = 64
    logs = []
    state = tloop.train_patch_norm(model, proc, _stream(proc, 3), steps=3, batch_size=None, log=logs.append)
    assert state.n.max().item() > 0 and model.patchnorm is state
    assert len(logs) == 3
    assert proc.sample_patches_beta == 0.05 and proc.max_seq_len == 64
    # restored after a failure inside the phase as well
    with pytest.raises(ZeroDivisionError):
        tloop.train_patch_norm(model, proc, _stream(proc, 1), log=lambda _: 1 / 0, batch_size=None)
    assert proc.sample_patches_beta == 0.05 and proc.max_seq_len == 64


def test_train_writes_a_checkpoint_the_jax_package_loads(tmp_path):
    """A few steps of train(); the saved model gives the same codes in both packages."""
    model, proc = _port_setup()
    tloop.train_patch_norm(model, proc, _stream(proc, 2), steps=2, batch_size=None, log=lambda _: None)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    logs = []
    model, state = tloop.train(
        model, proc, _stream(proc, 5, seed=2), batch_size=None, learning_rate=1e-3, max_iters=4, log_every=1,
        save_every=2, keep_checkpoints=True, out_dir=str(tmp_path), log=logs.append,
    )
    assert state.step == 4
    assert [m["step"] for m in logs] == [0, 1, 2, 3] and all(np.isfinite(m["loss"]) for m in logs)
    assert any(not torch.equal(before[k], v) for k, v in model.module.state_dict().items())
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000002", "model", "train_state.pt"]
    assert sorted(os.listdir(tmp_path / "model")) == ["config.json", "params.npz", "patchnorm.npz"]

    jm = JaxAE.from_pretrained(str(tmp_path / "model"), dtype=jnp.float32)
    want = flat(jm.params)
    got = jax_arrays_from_state_dict(model.module.state_dict(), model.config)
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    np.testing.assert_array_equal(np.asarray(jm.patchnorm.median), model.patchnorm.median.numpy())

    jproc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    batch = make_batch(jproc, np.random.default_rng(9), n_images=3)
    jcodes = np.asarray(jm.forward(jm.normalize_(batch), training=False)["codes"])
    tb = to_torch_batch(batch)
    tcodes = model.forward(model.normalize_(tb))["codes"].numpy()
    valid = ~np.asarray(batch.key_pad_mask)
    # equal; a bit may differ only where JAX's pre-sign value is within 1e-4 of 0
    assert_codes_match(tcodes, jcodes, jax_pre_sign(jm, jm.normalize_(batch)), model.module.vq_model.codebook_dim, valid)
    reloaded = TorchAE.from_pretrained(str(tmp_path / "model"), device="cpu")
    np.testing.assert_array_equal(reloaded.forward(reloaded.normalize_(tb))["codes"].numpy(), tcodes)


def test_resume_is_exact(tmp_path, deterministic):
    """train 4 == train 2 + resume 2, bit for bit: parameters, moments and step."""
    kw = dict(batch_size=None, learning_rate=1e-3, log_every=1, log=lambda _: None)

    def fresh():
        model, proc = _port_setup(seed=3)
        model.patchnorm = TorchPatchNorm.create(3, 8, 8, model.config.patch_dim)
        return model, proc

    pulls = list(_stream(_port_setup()[1], 4, seed=4))
    m4, p4 = fresh()
    m4, s4 = tloop.train(m4, p4, iter(pulls), max_iters=4, **kw)

    m2, p2 = fresh()
    # max_iters counts total steps: the schedule must be the 4-step one in both legs
    tx = tloop.make_optimizer(1e-3, 4)
    state = tloop.TrainState.create(m2.module, tx)
    step = tloop.make_train_step(m2.module, tx)
    for pull in pulls[:2]:
        batch = next(p2.iter_batches(iter([pull]), batch_size=None))
        state, _ = step(state, m2.patchnorm, tloop.prepare_train_batch(batch)[0])
    tckpt.save_train_state(str(tmp_path), state, m2.patchnorm)
    assert tckpt.has_train_state(str(tmp_path)) and not tckpt.has_train_state(str(tmp_path / "nowhere"))

    m3, p3 = _port_setup(seed=7)  # other weights: the checkpoint must replace them
    logs = []
    m3, s3 = tloop.train(m3, p3, iter(pulls[2:]), max_iters=4, resume_path=str(tmp_path), **{**kw, "log": logs.append})
    assert logs[0] == {"resumed_from": str(tmp_path), "step": 2}
    assert s3.step == s4.step == 4
    for (k, a), b in zip(m4.module.state_dict().items(), m3.module.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = s4.adamw.state_dict()["state"], s3.adamw.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) and torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])


@pytest.mark.parametrize("policy", ["abort", "restore"])
def test_nan_policy(policy, tmp_path):
    """A poisoned batch: 'abort' stops there; 'restore' rolls back to the last save and goes on."""
    model, proc = _port_setup()
    logs = []
    _, state = tloop.train(
        model, proc, _stream(proc, 6, poison_at=3), batch_size=None, max_iters=6, log_every=1, save_every=2,
        nan_policy=policy, out_dir=str(tmp_path), log=logs.append,
    )
    errors = [m for m in logs if "error" in m]
    warnings = [m for m in logs if "warning" in m]
    if policy == "abort":
        assert errors == [{"step": 3, "error": "NAN LOSS: aborting"}] and state.step == 4
    else:
        assert not errors and len(warnings) == 1 and "restored last checkpoint (step 3)" in warnings[0]["warning"]
        assert state.step == 5 and all(torch.isfinite(p).all() for p in model.module.parameters())


def test_restore_without_a_checkpoint_aborts():
    model, proc = _port_setup()
    logs = []
    tloop.train(model, proc, _stream(proc, 3, poison_at=0), batch_size=None, max_iters=3, log_every=1,
                nan_policy="restore", log=logs.append)
    assert len(logs) == 1 and "needs a checkpoint" in logs[0]["error"]


def test_zero_batches_is_reported():
    model, proc = _port_setup()
    logs = []
    tloop.train(model, proc, iter([]), log=logs.append)
    assert len(logs) == 1 and "ZERO batches" in logs[0]["error"]


def _write_cfg(tmp_path, cfg) -> str:
    path = str(tmp_path / "cfg.json")
    cfg.to_json_file(path)
    return path


def _cli(tmp_path, **flags):
    from dct_autoencoder_torch.train import cli

    return cli.main(
        preprocessed_dataset_path_or_url=str(tmp_path / "none"), model_config_path=_write_cfg(tmp_path, tiny_config()),
        should_save=False, device="cpu", **flags,
    )


def _train_empty_stream(model, proc, **kw):
    """train() on an empty stream: it reports zero batches and returns, and
    tears down the world of one it made for the parallel flags."""
    logs = []
    tloop.train(model, proc, iter([]), log=logs.append, **kw)
    assert any("ZERO batches" in entry.get("error", "") for entry in logs), logs
    assert not torch.distributed.is_initialized()


def _cli_train_kwargs(tmp_path, monkeypatch, **flags) -> dict:
    """What the CLI hands train() (its norm phase skipped): train's keyword
    arguments and the model's config."""
    from dct_autoencoder_torch.train import cli

    seen = {}

    def fake_train(model, proc, data, **kw):
        seen.update(kw, config=model.config)
        return model, None

    monkeypatch.setattr(cli, "train", fake_train)
    _cli(tmp_path, train_norm_iters=0, **flags)
    assert not torch.distributed.is_initialized()
    return seen


def _cli_sequence_parallel(tmp_path, monkeypatch):
    cfg = _cli_train_kwargs(tmp_path, monkeypatch, sequence_parallel=True)["config"]
    assert cfg.encoder_config.sequence_parallel and cfg.decoder_config.sequence_parallel


def _cli_zero1(tmp_path, monkeypatch):
    kw = _cli_train_kwargs(tmp_path, monkeypatch, zero1=True)
    assert kw["zero1"] is True and kw["n_model_parallel"] == 1


def _dropout_config():
    import dataclasses

    cfg = tiny_config()
    return dataclasses.replace(cfg, encoder_config=dataclasses.replace(cfg.encoder_config, dropout=0.1))


def _cli_pipeline_with_dropout(tmp_path):
    from dct_autoencoder_torch.train import cli

    cli.main(
        preprocessed_dataset_path_or_url=str(tmp_path / "none"),
        model_config_path=_write_cfg(tmp_path, _dropout_config()), should_save=False, device="cpu",
        n_model_parallel=2, pipeline_microbatches=2,
    )


def _pipelined_decode_step(model):
    """decode_step on a stack staged as one stage of two (a mesh's shape is all staging reads)."""
    import types

    from dct_autoencoder_torch.models.transformer import KVCache
    from dct_autoencoder_torch.parallel.pipeline import make_pipelined_module

    make_pipelined_module(model.module, types.SimpleNamespace(n_model=2, model_rank=0, n_data=1), 2)
    cfg = model.config.decoder_config
    model.module.decoder.decode_step(torch.zeros(1, 1, cfg.hidden_size), KVCache(cfg, 1, 4, torch.float32, "cpu"))


# the multi-device flags, in train() and in the CLI: what a pipeline refuses
# by name (fewer than two stages, dropout in a pipelined stack, layers that
# do not divide into the stages, a KV-cached decode), before any process
# group exists; n_model_parallel must divide the world, which is one process
# here, and says so by name; ZeRO-1 and sequence parallelism train over that
# world of one (their parity with JAX, and the pipeline's, is held over
# several processes in tests/test_torch_parallel_ranks*.py and
# tests/test_torch_pipeline_*.py).  what -> (error, words it names, run)
REFUSED = {
    "n_model_parallel": (
        ValueError, "n_model_parallel", lambda m, p, t, mp: tloop.train(m, p, iter([]), n_model_parallel=2)
    ),
    "pipeline_microbatches": (
        ValueError, "pipeline_microbatches=2 needs n_model_parallel > 1",
        lambda m, p, t, mp: tloop.train(m, p, iter([]), pipeline_microbatches=2),
    ),
    "zero1": (None, None, lambda m, p, t, mp: _train_empty_stream(m, p, zero1=True)),
    "cli_n_model_parallel": (ValueError, "n_model_parallel", lambda m, p, t, mp: _cli(t, n_model_parallel=2)),
    "cli_pipeline_microbatches": (ValueError, "dropout", lambda m, p, t, mp: _cli_pipeline_with_dropout(t)),
    "cli_sequence_parallel": (None, None, lambda m, p, t, mp: _cli_sequence_parallel(t, mp)),
    "cli_zero1": (None, None, lambda m, p, t, mp: _cli_zero1(t, mp)),
    "cli_pipeline_one_stage": (
        ValueError, "n_model_parallel > 1", lambda m, p, t, mp: _cli(t, pipeline_microbatches=2)
    ),
    "pipeline_dropout": (
        ValueError, "dropout=0.1",
        lambda m, p, t, mp: tloop.train(TorchAE(_dropout_config(), dtype=torch.float32, device="cpu"), p, iter([]),
                                        n_model_parallel=2, pipeline_microbatches=2),
    ),
    "pipeline_stages": (
        ValueError, "2 layers not divisible into 4 pipeline stages",
        lambda m, p, t, mp: tloop.train(m, p, iter([]), n_model_parallel=4, pipeline_microbatches=2),
    ),
    "pipeline_kv_cache": (ValueError, "KV-cached decode", lambda m, p, t, mp: _pipelined_decode_step(m)),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_train_refuses_what_is_not_ported(what, tmp_path, monkeypatch):
    """Each multi-device flag of train() and the CLI: what cannot run
    (n_model_parallel beyond a world of one, a pipeline of one stage, dropout
    or a KV cache in a pipelined stack, layers that do not divide into the
    stages) raises by name; ZeRO-1 and sequence parallelism train.  The name
    and the first seven case ids date from when every one of these flags was
    refused as unported; they are kept so each case keeps its record."""
    model, proc = _port_setup()
    error, words, run = REFUSED[what]
    if error is None:
        run(model, proc, tmp_path, monkeypatch)
        return
    with pytest.raises(error, match=words):
        run(model, proc, tmp_path, monkeypatch)
    assert not torch.distributed.is_initialized()


def test_train_loop_with_pixel_loss_and_8bit_moments():
    model, proc = _port_setup()
    logs = []
    _, state = tloop.train(
        model, proc, _stream(proc, 3, seed=11, n_images=3), batch_size=None, max_iters=3, learning_rate=1e-4,
        use_pixel_loss=True, pixel_loss_max_images=8, opt_8bit=True, log_every=1, save_every=0, log=logs.append,
    )
    from dct_autoencoder_torch.train.opt8bit import AdamW8bit

    assert isinstance(state.adamw, AdamW8bit) and state.adamw.param_groups[0]["count"] == 3
    px = [d["pixel_loss"] for d in logs if "pixel_loss" in d]
    assert len(px) == 3 and all(np.isfinite(px)), logs


def test_prefetch_worker_error_reaches_the_loop():
    model, proc = _port_setup()

    def broken():
        yield from _stream(proc, 1)
        raise OSError("shard vanished")

    with pytest.raises(OSError, match="vanished"):
        tloop.train(model, proc, broken(), batch_size=None, max_iters=5, prefetch_batches=2, log=lambda _: None)
    assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())


def _jax_grid_pixel_mse(jm, jproc, batch) -> float:
    """The JAX loop's image-grid metric (its train/loop.py, log_images_every) on a JAX model."""
    out = jm.forward(jm.normalize_(batch), training=False)
    rec = jm.inv_normalize_(out["dct_patches"]).replace(patch_sizes=batch.patch_sizes, original_sizes=batch.original_sizes)
    recs, origs = jproc.postprocess(rec), jproc.postprocess(batch)
    return float(np.mean([np.mean((np.clip(r, 0, 1) - o) ** 2) for r, o in zip(recs, origs)]))


def test_image_grid_logging_matches_jax(tmp_path):
    """train(log_images_every=1) writes a grid a step; the logged RGB pixel
    MSE of a batch equals the JAX loop's on the same weights (rtol 1e-3:
    fp32 IDCTs and forwards summed in other orders)."""
    from dct_autoencoder_torch.train.loop import _log_image_grid

    jm, batch = make_case("tiny_block")
    tm = port_of(jm)
    jproc = jax_model_and_processor(tiny_config(), sample_patches_beta=0.0)[1]
    tproc = torch_model_and_processor(TorchConfig.from_dict(tiny_config().to_dict()), sample_patches_beta=0.0,
                                      device="cpu")[1]
    logs = []
    _log_image_grid(tm, tproc, to_torch_batch(batch), 7, 2, str(tmp_path), logs.append)
    assert logs[0]["step"] == 7 and os.path.exists(tmp_path / "train_image_000007.png")
    np.testing.assert_allclose(logs[0]["pixel_loss"], _jax_grid_pixel_mse(jm, jproc, batch), rtol=1e-3)

    model, proc = _port_setup()
    out_dir = tmp_path / "run"
    logs = []
    tloop.train(model, proc, _stream(proc, 2, seed=9, n_images=3), batch_size=None, max_iters=2,
                log_images_every=1, n_log_images=2, save_every=0, out_dir=str(out_dir), log=logs.append)
    assert sorted(f for f in os.listdir(out_dir) if f.startswith("train_image_")) == [
        "train_image_000000.png", "train_image_000001.png"]
    assert all(np.isfinite(d["pixel_loss"]) for d in logs if "pixel_loss" in d)


def test_rss_watchdog_checkpoints_and_raises(tmp_path):
    """rss_limit_gb below any process's RSS: a resumable checkpoint after at
    least one step, then RssLimitExceeded; off by default (0)."""
    model, proc = _port_setup()
    logs = []
    with pytest.raises(tloop.RssLimitExceeded) as e:
        tloop.train(model, proc, _stream(proc, 5, n_images=3), batch_size=None, max_iters=5, rss_limit_gb=0.001,
                    log_every=1, save_every=0, out_dir=str(tmp_path), log=logs.append)
    assert e.value.step >= 1 and e.value.out_dir == str(tmp_path)
    assert tckpt.has_train_state(str(tmp_path))
    assert any("checkpointed" in str(d.get("warning", "")) for d in logs)
    assert not any(t.name == "batch-prefetch" and t.is_alive() for t in threading.enumerate())
    assert tloop._rss_gb() > 0 and tloop._auto_rss_limit_gb() > 0
    import inspect

    assert inspect.signature(tloop.train).parameters["rss_limit_gb"].default == 0.0


def test_stall_watchdog_fires_on_wedged_step():
    """No step completes within stall_timeout_s after the first: on_stall
    fires from the watchdog thread."""
    model, proc = _port_setup()
    fired = threading.Event()

    def batches():
        yield from _stream(proc, 2, n_images=3)
        while not fired.wait(0.1):  # the stream blocks: no step completes
            pass

    tloop.train(model, proc, batches(), batch_size=2, max_iters=10, prefetch_batches=0, stall_timeout_s=1.0,
                on_stall=fired.set, log=lambda _: None)
    assert fired.is_set(), "stall watchdog never fired"


