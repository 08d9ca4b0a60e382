"""The port's training CLI (train/cli.py) against the JAX package's, on the CPU.

Counterparts of tests/test_tools.py::test_train_cli_smoke,
tests/test_augment.py::test_cli_augment_flag_trains and
tests/test_train.py::test_restart_argv_* and ::test_stall_handler_cli_vs_library,
run with device="cpu" on shards written here from seeded numpy images; plus
--help, the flag set, the token-shard route and the profiler trace.  The
two packages' restart argv are equal; a checkpoint the port's CLI writes
loads in the JAX package with the same parameters.
"""
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from dct_autoencoder_torch.data.shards import ShardWriter
from dct_autoencoder_torch.train import cli as tcli
from dct_autoencoder_tpu.train import cli as jcli
from test_model import tiny_config
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raw_shard(path, n=8, size=64, fmt="JPEG"):
    from PIL import Image

    rng = np.random.default_rng(1)
    with ShardWriter(str(path / "r-%06d.tar")) as w:
        for i in range(n):
            arr = (rng.uniform(0, 1, size=(size, size, 3)) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format=fmt)
            w.write({"__key__": f"{i:08d}", fmt.lower().replace("jpeg", "jpg"): buf.getvalue(),
                     "json": {"height": size, "width": size}})


def _cfg(tmp_path) -> str:
    path = tmp_path / "cfg.json"
    tiny_config("lfq").to_json_file(str(path))
    return str(path)


def test_train_cli_smoke(tmp_path, monkeypatch):
    """Two steps through the CLI; the saved model loads in the JAX package."""
    from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
    from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
    from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE

    _raw_shard(tmp_path / "raw")
    monkeypatch.chdir(tmp_path)
    model = tcli.main(
        image_dataset_path_or_url=str(tmp_path / "raw" / "*.tar"), model_config_path=_cfg(tmp_path), dtype="float32",
        batch_size=2, train_norm_iters=2, max_iters=2, sample_patches_beta=0.0, learning_rate=1e-4, log_every=1,
        save_every=100, should_save=True, out_base=str(tmp_path / "out"), device="cpu",
    )
    (out,) = list((tmp_path / "out").iterdir())
    assert (out / "model" / "config.json").exists() and (out / "train_state.pt").exists()
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [d["step"] for d in lines] == [0, 1] and all(np.isfinite(d["loss"]) for d in lines)
    jm = JaxAE.from_pretrained(str(out / "model"))
    got = jax_arrays_from_state_dict(model.module.state_dict(), model.config)
    want = {JaxAE._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    assert TorchAE.from_pretrained(str(out / "model"), device="cpu").n_params == model.n_params


def test_cli_augment_flag_trains(tmp_path, monkeypatch):
    _raw_shard(tmp_path / "raw", n=4, size=96)
    monkeypatch.chdir(tmp_path)
    tcli.main(
        image_dataset_path_or_url=str(tmp_path / "raw" / "*.tar"), model_config_path=_cfg(tmp_path), dtype="float32",
        batch_size=2, train_norm_iters=1, max_iters=2, sample_patches_beta=0.0, learning_rate=1e-4, log_every=1,
        save_every=100, should_save=False, augment=True, augment_color_jitter=0.2, device="cpu",
    )


def test_cli_trains_from_token_shards_with_the_slice_s_options(tmp_path):
    """--preprocessed_dataset_path_or_url (token shards of tools/preproc_dataset.py)
    with 8-bit moments, the pixel loss, prefetch, image grids, checkpoints and
    a profiler trace."""
    from dct_autoencoder_torch.tools import preproc_dataset

    _raw_shard(tmp_path / "raw", n=6, size=48, fmt="PNG")
    cfg = _cfg(tmp_path)
    assert preproc_dataset.main(str(tmp_path / "raw" / "*.tar"), str(tmp_path / "tok"), model_config_path=cfg,
                                sample_patches_beta=0.0, device="cpu") == 6
    tcli.main(
        preprocessed_dataset_path_or_url=str(tmp_path / "tok"), model_config_path=cfg, dtype="float32", batch_size=2,
        epochs=3, train_norm_iters=1, max_iters=4, sample_patches_beta=0.0, log_every=1, save_every=2,
        keep_checkpoints=True, log_images_every=2, opt_8bit=True, use_pixel_loss=True, pixel_loss_max_images=8,
        prefetch_batches=2, stall_timeout_s=600.0, out_base=str(tmp_path / "out"), profile_dir=str(tmp_path / "prof"),
        device="cpu",
    )
    (out,) = list((tmp_path / "out").iterdir())
    names = sorted(os.listdir(out))
    assert {"ckpt_000002", "model", "train_state.pt", "train_image_000000.png", "train_image_000002.png"} <= set(names)
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [d for d in lines if "loss" in d]
    assert [d["step"] for d in losses] == [0, 1, 2, 3]
    assert all(np.isfinite(d["loss"]) and np.isfinite(d["pixel_loss"]) for d in losses)
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


def test_restart_argv_matches_jax():
    argv = ["cli.py", "--batch_size", "4", "--train_state_resume_path", "/old", "--model_resume_path=/old/model",
            "--max_iters=5000"]
    out = tcli._restart_argv(argv, "/new")
    assert out == jcli._restart_argv(argv, "/new")
    assert "--batch_size" in out and "4" in out and "--max_iters=5000" in out
    assert "/old" not in out and "--model_resume_path=/old/model" not in out
    assert out[-4:] == ["--train_state_resume_path=/new", "--model_resume_path=/new/model", "--resume_out_dir=/new",
                        "--restart_count=1"]
    out2 = tcli._restart_argv(out, "/new")
    assert out2 == jcli._restart_argv(out, "/new") and out2[-1] == "--restart_count=2"
    assert sum(a.startswith("--restart_count=") for a in out2) == 1


def test_restart_argv_exact_flag_match():
    argv = ["cli.py", "--restart_count_foo=7", "--model_resume_path_x", "keepme", "--restart_count=3"]
    out = tcli._restart_argv(argv, "/new")
    assert out == jcli._restart_argv(argv, "/new")
    assert "--restart_count_foo=7" in out and "--model_resume_path_x" in out and "keepme" in out
    assert out[-1] == "--restart_count=4"


def test_stall_handler_cli_vs_library(tmp_path, monkeypatch):
    """The handler exec-restarts the port's CLI module only when this process
    is the CLI and a checkpoint exists; otherwise os._exit(73)."""
    from dct_autoencoder_torch.models.factory import get_model_and_processor
    from dct_autoencoder_torch.models.config import DCTAutoencoderConfig
    from dct_autoencoder_torch.train import checkpoint, loop

    calls = []
    monkeypatch.setattr(tcli.os, "execv", lambda *a: calls.append(("execv", a)))
    monkeypatch.setattr(tcli.os, "_exit", lambda code: calls.append(("exit", code)))
    model, _ = get_model_and_processor(DCTAutoencoderConfig.from_dict(tiny_config().to_dict()), device="cpu")
    tx = loop.make_optimizer(1e-4, 10)
    checkpoint.save_train_state(str(tmp_path), loop.TrainState.create(model.module, tx), model.patchnorm)

    monkeypatch.setattr(tcli, "_CLI_INVOKED", False)
    tcli._make_stall_handler(str(tmp_path))()
    assert calls == [("exit", 73)]

    calls.clear()
    monkeypatch.setattr(tcli, "_CLI_INVOKED", True)
    monkeypatch.setattr(sys, "argv", ["cli.py", "--batch_size", "4", "--stall_timeout_s=300"])
    tcli._make_stall_handler(str(tmp_path))()
    assert calls[0][0] == "execv"
    exe, argv = calls[0][1]
    assert argv[:3] == [sys.executable, "-m", "dct_autoencoder_torch.train.cli"]
    assert f"--resume_out_dir={tmp_path}" in argv and "--stall_timeout_s=300" in argv and "--restart_count=1" in argv
    assert calls[-1] == ("exit", 73)  # the stubbed execv returned

    calls.clear()
    (tmp_path / "empty").mkdir()
    tcli._make_stall_handler(str(tmp_path / "empty"))()
    assert calls == [("exit", 73)]


def test_flags_are_jax_s_plus_device():
    """The same flags with the same defaults, plus --device; bare bool flags parse."""
    ours, theirs = tcli._build_parser(), jcli._build_parser()
    defaults = lambda p: {a.dest: a.default for a in p._actions if a.dest != "help"}  # noqa: E731
    d_ours, d_theirs = defaults(ours), defaults(theirs)
    assert set(d_ours) == set(d_theirs) | {"device"}
    differ = {k for k in d_theirs if d_ours[k] != d_theirs[k]}
    assert differ == {"rss_limit_gb"} and d_ours["rss_limit_gb"] == 0.0 and d_ours["device"] == "cuda"
    args = ours.parse_args(["--opt_8bit", "--use_pixel_loss", "true", "--augment=false", "--batch_size", "3"])
    assert args.opt_8bit is True and args.use_pixel_loss is True and args.augment is False and args.batch_size == 3


def test_help_runs():
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "dct_autoencoder_torch.train.cli", "--help"], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120, check=True).stdout
    assert "--use_pixel_loss" in out and "--opt_8bit" in out and "--device" in out


@pytest.mark.parametrize("entry", ["cli", "preproc_dataset"])
def test_cli_runs_on_the_card_by_default(entry, tmp_path, monkeypatch):
    import torch

    from dct_autoencoder_torch.tools import preproc_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "cli":
            tcli.main(preprocessed_dataset_path_or_url=str(tmp_path), model_config_path=_cfg(tmp_path), should_save=False)
        else:
            preproc_dataset.main(str(tmp_path / "*.tar"), str(tmp_path / "out"), model_config_path=_cfg(tmp_path))
