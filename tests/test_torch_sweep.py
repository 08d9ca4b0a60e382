"""The sweep in the port (train/sweep.py), the train step's
dynamic_hparams and the training CLI with a VQ config, against the JAX
package, on the CPU.

  * dynamic_hparams: a step with lr_scale s over a unit-peak optimizer and
    loss weights w equals the static step at peak s with weights w, for
    fp32 AdamW and AdamW8bit (loss rtol 1e-6, parameters rtol 2e-5 /
    atol 1e-7: the tolerance of the JAX package's
    test_dynamic_hparams_step_matches_static_and_reuses_program);
  * TPESuggester and sample: JAX's suggestions for a seed, exactly;
  * main (the CLI per trial) and run_onchip (the shared step) run 2 trials
    each on the tiny configs of tests/test_model.py, on PNG shards written
    here from seeded numpy images;
  * the CLI with a VQ config: its checkpoint's vq_stats.npz loads in JAX
    bit for bit, and its pipeline's codes equal JAX's pipeline's on >= 99 %
    of ids.
"""
import json
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.models.convert import vq_stats_from_state_dict
from dct_autoencoder_torch.models.patchnorm import calibrate_patchnorm_batch
from dct_autoencoder_torch.train import sweep as tsweep
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from dct_autoencoder_tpu.train import sweep as jsweep
from test_model import tiny_config
from test_torch_train import TorchConfig, flat, tloop, torch_model_and_processor
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shards(path, n=6, size=48):
    import io

    from PIL import Image

    from dct_autoencoder_torch.data.shards import ShardWriter

    rng = np.random.default_rng(2)
    os.makedirs(path, exist_ok=True)
    with ShardWriter(os.path.join(path, "r-%06d.tar")) as w:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray((rng.uniform(0, 1, size=(size, size, 3)) * 255).astype(np.uint8)).save(buf, format="PNG")
            w.write({"__key__": f"{i:08d}", "png": buf.getvalue(), "json": {"height": size, "width": size}})
    return os.path.join(path, "*.tar")


def _cfg_file(tmp_path, vq_type) -> str:
    path = str(tmp_path / f"{vq_type}.json")
    tiny_config(vq_type).to_json_file(path)
    return path


def test_cli_trains_a_vq_config_and_the_checkpoint_serves(tmp_path, monkeypatch):
    """The CLI with a VQ config and the VQ flags (expiry every step): its
    checkpoint holds vq_stats.npz, loads in JAX with the same statistics, and
    the port's pipeline encodes with it, giving JAX's pipeline's codes."""
    from dct_autoencoder_torch.train import cli as tcli

    monkeypatch.chdir(tmp_path)
    logs = []
    orig = tcli.train
    monkeypatch.setattr(tcli, "train", lambda *a, **k: orig(*a, **{**k, "log": lambda d: logs.append(d) or k["log"](d)}))
    model = tcli.main(
        image_dataset_path_or_url=_shards(str(tmp_path / "raw")), model_config_path=_cfg_file(tmp_path, "vq"),
        dtype="float32", batch_size=2, train_norm_iters=1, max_iters=2, sample_patches_beta=0.0, log_every=1,
        save_every=100, out_base=str(tmp_path / "out"), vq_expire_every=1, vq_expire_threshold=15.0, device="cpu",
    )
    assert [d["step"] for d in logs if "loss" in d] == [0, 1] and all(np.isfinite(d["loss"]) for d in logs if "loss" in d)
    (out,) = list((tmp_path / "out").iterdir())
    assert (out / "model" / "vq_stats.npz").exists()
    jm = JaxAE.from_pretrained(str(out / "model"))
    for k, v in vq_stats_from_state_dict(model.module.state_dict()).items():
        np.testing.assert_array_equal(flat(jm.vq_stats)[k], v)
    assert model.module.vq_model.cluster_size.max() >= 15.0  # expiry reset some usage to the threshold

    pipe = dt.DCTPipeline.from_pretrained(str(out / "model"), dtype=torch.float32, device="cpu")
    jpipe = JaxPipeline.from_pretrained(str(out / "model"), dtype=jnp.float32)
    ims = [np.random.default_rng(3).uniform(0.1, 0.9, size=(3, 32, 40)).astype(np.float32)]
    pipe.processor.rng, jpipe.processor.rng = random.Random(0), random.Random(0)
    tr, jr = pipe.encode(ims), jpipe.encode(ims)
    codes = lambda r: [d["data"] for d in r[0]["codes"]]  # noqa: E731
    assert len(codes(tr)) == len(codes(jr)) > 0
    agree = np.mean([a == b for ta, ja in zip(codes(tr), codes(jr)) for a, b in zip(ta, ja)])
    assert agree >= 0.99, agree


@pytest.mark.parametrize("opt_8bit", [False, True], ids=["adamw", "adamw8bit"])
def test_dynamic_hparams_step_matches_static(opt_8bit):
    """A step with lr_scale s over a unit-peak optimizer and weights w equals
    the static step at peak s with weights w (tolerance of the JAX package's
    test_dynamic_hparams_step_matches_static_and_reuses_program), for fp32
    AdamW and AdamW8bit, decoupled weight decay included."""
    lw = {"rec_loss": 0.3, "rec_loss_unnormalized": 1.2, "commit_loss": 0.05, "entropy_loss": 0.2}
    lr = 2.5e-3
    cfg = TorchConfig.from_dict(tiny_config().to_dict())
    model, proc = torch_model_and_processor(cfg, sample_patches_beta=0.0, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    ds = proc.preprocess_many([rng.uniform(0.1, 0.9, size=(3, 32, 32)).astype(np.float32) for _ in range(4)])
    tb = tloop.prepare_train_batch(next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]))))[0]
    model.patchnorm, _ = calibrate_patchnorm_batch(model.patchnorm, tb)
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    results = []
    for dynamic in (False, True):
        model.module.load_state_dict(init)
        tx = tloop.make_optimizer(learning_rate=1.0 if dynamic else lr, max_iters=100, warmup_steps=2, opt_8bit=opt_8bit)
        state = tloop.TrainState.create(model.module, tx)
        if dynamic:
            step = tloop.make_train_step(model.module, tx, dynamic_hparams=True)
            hp = {k: torch.tensor(v, dtype=torch.float32) for k, v in lw.items()}
            hp["lr_scale"] = lr
            for _ in range(3):
                state, met = step(state, model.patchnorm, tb, None, hp)
        else:
            step = tloop.make_train_step(model.module, tx, loss_weights=lw)
            for _ in range(3):
                state, met = step(state, model.patchnorm, tb)
        results.append((met, {k: v.clone() for k, v in model.module.state_dict().items()}))
    (m_static, p_static), (m_dyn, p_dyn) = results
    np.testing.assert_allclose(m_dyn["loss"].item(), m_static["loss"].item(), rtol=1e-6)
    for k in p_static:
        np.testing.assert_allclose(p_dyn[k].numpy(), p_static[k].numpy(), rtol=2e-5, atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="lr_scale"):
        step(state, model.patchnorm, tb, None, {k: v for k, v in hp.items() if k != "lr_scale"})


def test_tpe_and_sample_give_jax_suggestions():
    """The same seed gives JAX's suggestions, through startup and TPE trials."""
    assert tsweep.DEFAULT_SPACE == jsweep.DEFAULT_SPACE
    for seed in (0, 1):
        suggesters = [m.TPESuggester(m.DEFAULT_SPACE, random.Random(seed)) for m in (tsweep, jsweep)]
        for t in range(10):
            got, want = (s.suggest() for s in suggesters)
            assert got == want, (seed, t)
            score = sum((v - 0.3) ** 2 for k, v in got.items() if k != "learning_rate") + abs(np.log(got["learning_rate"]) + 9)
            for s in suggesters:
                s.observe(got, score)
        assert tsweep.sample(tsweep.DEFAULT_SPACE, random.Random(seed)) == jsweep.sample(jsweep.DEFAULT_SPACE, random.Random(seed))


def test_sweep_main_runs_two_trials_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out_file = str(tmp_path / "trials.jsonl")
    best = tsweep.main(image_dataset_path_or_url=_shards(str(tmp_path / "raw")), model_config_path=_cfg_file(tmp_path, "lfq"),
                       trials=2, max_iters=2, batch_size=2, out_file=out_file, device="cpu")
    recs = [json.loads(x) for x in open(out_file)]
    assert [r["trial"] for r in recs] == [0, 1] and all(np.isfinite(r["rec_loss"]) for r in recs)
    assert best["rec_loss"] == min(r["rec_loss"] for r in recs)


@pytest.mark.parametrize("vq_type", ["lfq", "vq"])
def test_run_onchip_runs_both_methods_and_the_noise_floor(tmp_path, vq_type):
    out_file = str(tmp_path / "trials.jsonl")
    logs = []
    results = tsweep.run_onchip(
        _shards(str(tmp_path / "raw")), model_config_path=_cfg_file(tmp_path, vq_type), trials=2, max_iters=2,
        batch_size=2, score_last=2, calib_steps=1, noise_repeats=1, out_file=out_file, device="cpu", log=logs.append,
    )
    recs = [json.loads(x) for x in open(out_file)]
    assert [(r["method"], r["trial"]) for r in recs] == [("tpe", 0), ("tpe", 1), ("random", 0), ("random", 1), ("noise", 0)]
    assert all(np.isfinite(r["rec_loss"]) and np.isfinite(r["loss"]) for r in recs)
    assert set(results) == {"tpe", "random", "noise_floor"} and results["noise_floor"]["n"] == 1
    # every trial starts from the same weights: TPE's first trial is a random
    # draw from the same seed as random search's, and scores the same
    assert recs[0]["hp"] == recs[2]["hp"] and recs[0]["rec_loss"] == pytest.approx(recs[2]["rec_loss"], rel=1e-5)


def test_sweep_flags_and_entry(tmp_path):
    p = tsweep._parser()
    a = p.parse_args(["--onchip", "--device", "cpu", "--lr_hi", "1e-3", "--noise_repeats", "2"])
    assert a.onchip and a.device == "cpu" and a.lr_hi == 1e-3 and a.noise_repeats == 2
    jflags = {"--image_dataset_path_or_url", "--preprocessed_dataset_path_or_url", "--model_config_path", "--trials",
              "--max_iters", "--batch_size", "--seed", "--method", "--out_file", "--fixed_init", "--rss_limit_gb",
              "--onchip", "--lr_hi", "--noise_repeats"}
    flags = {o for act in p._actions for o in act.option_strings if o.startswith("--") and o != "--help"}
    assert flags == jflags | {"--device"}


def test_new_modules_import_no_jax():
    code = (
        "import sys, dct_autoencoder_torch.models.vq, dct_autoencoder_torch.train.sweep\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'dct_autoencoder_tpu'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
