"""Training CLI (reference: main.py:283-461), on the card.

Usage:
  python -m dct_autoencoder_torch.train.cli \
      --image_dataset_path_or_url 'shards/{000000..000009}.tar' \
      --model_config_path conf/patch14-l.json --batch_size 32 \
      --opt_8bit --use_pixel_loss

Counterpart of dct_autoencoder_tpu/train/cli.py with the same flags and
defaults, plus --device (cuda unless --device cpu).  Metrics go to
out/<timestamp>/metrics.jsonl, with image grids and checkpoints beside them.
Not ported, and refused by name when set: --n_model_parallel,
--pipeline_microbatches, --sequence_parallel, --zero1, and any VQ config.
--profile_dir writes a torch.profiler trace (trace.json) of the main
training phase.  One default differs from JAX: --rss_limit_gb is 0 (off).
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import random
from typing import Optional

import numpy as np

from ..data.dataset import batched, load_and_transform_dataset, load_preprocessed_dataset
from ..models.config import DCTAutoencoderConfig
from ..models.factory import get_model_and_processor
from ..train.loop import RssLimitExceeded, _refuse_unported, train, train_patch_norm

_MODULE = "dct_autoencoder_torch.train.cli"


def create_output_directory(base: str = "out") -> str:
    name = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(os.getcwd(), base, name)
    os.makedirs(path, exist_ok=True)
    return path


def _restart_argv(argv, out_dir: str):
    """argv for the watchdogs' self-restart: strip any existing resume flags
    (both `--flag value` and `--flag=value` forms) and point them at the
    just-checkpointed out_dir, which is also reused as the output dir."""
    drop = (
        "--train_state_resume_path",
        "--model_resume_path",
        "--resume_out_dir",
        "--restart_count",
    )
    out, restarts = [], 0
    i = 0
    while i < len(argv):
        a = argv[i]
        # exact flag-name match: a prefix match would delete any flag that
        # shares a prefix with a drop name
        name = a.split("=", 1)[0]
        if name in drop:
            if "=" in a:
                value = a.split("=", 1)[1]
            else:
                value = argv[i + 1] if i + 1 < len(argv) else ""
                i += 1  # two-token form: drop the value too
            if name == "--restart_count" and value:
                restarts = int(value)
        else:
            out.append(a)
        i += 1
    out += [
        f"--train_state_resume_path={out_dir}",
        f"--model_resume_path={out_dir}/model",
        f"--resume_out_dir={out_dir}",
        f"--restart_count={restarts + 1}",
    ]
    return out


# set by cli_entry(): the stall handler may exec-restart only when this
# process is the CLI (a library caller's sys.argv belongs to its own program)
_CLI_INVOKED = False


def _make_stall_handler(out_dir):
    """Process-level stall recovery, called from the watchdog thread (the
    main thread may be blocked in a device call, out of an exception's reach)."""

    def _on_stall():
        import sys

        from ..train.checkpoint import has_train_state

        if _CLI_INVOKED and out_dir and has_train_state(out_dir):
            argv = _restart_argv(sys.argv, out_dir)
            print(f"stall watchdog: exec-restarting from {out_dir}", flush=True)
            try:
                os.execv(sys.executable, [sys.executable, "-m", _MODULE] + argv[1:])
            except OSError as e:
                print(f"stall restart exec failed: {e}", flush=True)
        # library caller, no checkpoint yet, or exec failed: exit so a
        # supervisor can restart; 73 is the stall code
        os._exit(73)

    return _on_stall


def main(
    image_dataset_path_or_url: Optional[str] = None,
    preprocessed_dataset_path_or_url: Optional[str] = None,
    model_config_path: str = "./conf/patch14-l.json",
    model_resume_path: Optional[str] = None,
    train_state_resume_path: Optional[str] = None,
    dtype: str = "bfloat16",
    batch_size: int = 32,
    epochs: int = 1,
    train_norm_iters: int = 10,
    max_iters: int = 10000,
    sample_patches_beta: float = 0.02,
    learning_rate: float = 1e-4,
    seed: int = 42,
    log_every: int = 200,
    save_every: int = 1000,
    log_images_every: int = 0,
    profile_dir: str = None,
    grad_accumulation_steps: int = 1,
    # not ported: refused when set (multi-device parallelism)
    n_model_parallel: int = 1,
    pipeline_microbatches: int = 0,
    sequence_parallel: bool = False,
    zero1: bool = False,
    # blockwise 8-bit Adam moments (the reference's default PagedAdamW8bit,
    # main.py:420-425; train/opt8bit.py)
    opt_8bit: bool = False,
    rec_loss_unnormalized: float = 1.0,
    rec_loss: float = 0.1,
    commit_loss: float = 0.1,
    entropy_loss: float = 0.1,
    # RGB-space MSE in the training objective (reference main.py:167, 221:
    # decode_pixels=use_pixel_loss; terms absent from loss_weight get 1.0)
    use_pixel_loss: bool = False,
    pixel_loss: float = 1.0,
    pixel_loss_max_images: int = 64,
    # batches prefetched by a background host thread (0 disables)
    prefetch_batches: int = 2,
    # 'abort' (reference parity) or 'restore' (roll back to the last saved
    # train state on a non-finite loss and continue)
    nan_policy: str = "abort",
    # host-RSS watchdog: checkpoint and self-restart before the OOM killer
    # fires (train/loop.py:RssLimitExceeded). <0 = auto (75% of MemTotal),
    # 0 = off (the port's default)
    rss_limit_gb: float = 0.0,
    # internal (set by the self-restart): reuse this out dir instead of
    # creating a new timestamped one
    resume_out_dir: Optional[str] = None,
    # stall watchdog (train/loop.py): if no step completes for this many
    # seconds after the first, restart the process from the last checkpoint
    # (CLI invocations exec-resume; library callers get os._exit(73)). 0 = off
    stall_timeout_s: float = 0.0,
    # internal (incremented by the self-restart): offsets the data shuffle
    # seed so a restarted process draws a fresh shuffle order
    restart_count: int = 0,
    # keep per-step model checkpoints (out/<ts>/ckpt_<step>)
    keep_checkpoints: bool = False,
    # host-side augmentation on the raw-image path (data/augment.py):
    # shape-preserving random-resized-crop + hflip + optional color jitter,
    # seeded from the data seed (fresh draws per epoch and per restart)
    augment: bool = False,
    augment_scale_min: float = 0.3,
    augment_hflip: float = 0.5,
    augment_color_jitter: float = 0.0,
    # VQ training knobs: VQ mode is not ported (a VQ config is refused);
    # on an LFQ config they are unused, as in JAX
    vq_kmeans_init: bool = True,
    vq_expire_threshold: float = 15.0,
    vq_expire_every: int = 50,
    should_save: bool = True,
    out_base: str = "out",
    # where the model and the preprocess run: the card unless 'cpu'
    device: str = "cuda",
):
    import torch

    _refuse_unported(
        n_model_parallel=(n_model_parallel, 1, "model parallelism"),
        pipeline_microbatches=(pipeline_microbatches, 0, "pipeline parallelism"),
        sequence_parallel=(sequence_parallel, False, "sequence parallelism"),
        zero1=(zero1, False, "ZeRO-1 optimizer sharding"),
    )
    model_config = DCTAutoencoderConfig.from_json_file(model_config_path)
    if model_config.vq_type != "lfq":
        raise NotImplementedError(
            f"vq_type={model_config.vq_type!r}: VQ mode (and its flags vq_kmeans_init, vq_expire_threshold, "
            "vq_expire_every) is not ported yet"
        )
    loss_weights = dict(
        rec_loss=rec_loss,
        rec_loss_unnormalized=rec_loss_unnormalized,
        commit_loss=commit_loss,
        entropy_loss=entropy_loss,
        pixel_loss=pixel_loss,
    )

    random.seed(seed)
    np.random.seed(seed)

    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    model, processor = get_model_and_processor(
        model_config, dtype=tdtype, sample_patches_beta=sample_patches_beta,
        resume_path=model_resume_path, seed=seed, device=device,
    )
    processor.rng = random.Random(seed)

    data_seed = seed + 1000003 * restart_count  # fresh shuffle per restart
    epoch_counter = [0]  # fresh shuffle + augmentation draws per epoch

    def make_data():
        stream_seed = data_seed + 7919 * epoch_counter[0]
        epoch_counter[0] += 1
        if image_dataset_path_or_url is not None:
            aug = None
            if augment:
                from ..data.augment import AugmentConfig, Augmenter

                aug = Augmenter(
                    AugmentConfig(
                        scale=(augment_scale_min, 1.0),
                        hflip=augment_hflip,
                        color_jitter=augment_color_jitter,
                    ),
                    seed=stream_seed,
                )
            return load_and_transform_dataset(
                image_dataset_path_or_url, processor, shuffle_buffer=1000,
                seed=stream_seed, augment=aug,
            )
        if preprocessed_dataset_path_or_url is None:
            raise ValueError("pass --image_dataset_path_or_url or --preprocessed_dataset_path_or_url")
        return load_preprocessed_dataset(
            preprocessed_dataset_path_or_url, shuffle_buffer=1000, seed=stream_seed
        )

    if resume_out_dir:
        out_dir = resume_out_dir
    else:
        out_dir = create_output_directory(out_base) if should_save else None
    run_info = dict(
        sample_patches_beta=sample_patches_beta,
        max_seq_len=processor.max_seq_len,
        learning_rate=learning_rate,
        n_params=model.n_params,
        grad_accumulation_steps=grad_accumulation_steps,
        patch_size=model_config.patch_size,
        vq_num_codebooks=model_config.vq_num_codebooks,
        vq_codebook_size=model_config.vq_codebook_size,
        device=str(model.device),
        **loss_weights,
    )
    print("starting run:", run_info)

    metrics_path = os.path.join(out_dir, "metrics.jsonl") if out_dir else None

    def log(d):
        print(d)
        if metrics_path and isinstance(d, dict):
            with open(metrics_path, "a") as f:
                f.write(json.dumps({k: v for k, v in d.items() if not hasattr(v, "shape")}) + "\n")

    # ----------- Norm calibration phase (reference main.py:388-404) --------
    # skipped on a watchdog self-restart: train() restores the checkpointed
    # patchnorm anyway
    if train_norm_iters > 0 and not resume_out_dir:
        print("training norm")
        train_patch_norm(
            model,
            processor,
            batched(make_data(), min(batch_size, 32)),
            steps=train_norm_iters,
            batch_size=min(batch_size, 32),
        )
        print("done training norm")

    # --------------------------- Main training ----------------------------
    def epoch_stream():
        # re-open the (shuffled) stream each epoch (reference main.py:174-181)
        for _ in range(max(epochs, 1)):
            yield from batched(make_data(), batch_size)

    with _profiler(profile_dir, model.device):
        # RssLimitExceeded propagates: cli_entry exec-restarts this CLI from
        # the checkpoint; a library caller catches it and resumes itself
        model, _ = train(
            model,
            processor,
            epoch_stream(),
            batch_size=batch_size,
            learning_rate=learning_rate,
            max_iters=max_iters,
            grad_accumulation_steps=grad_accumulation_steps,
            loss_weights=loss_weights,
            opt_8bit=opt_8bit,
            use_pixel_loss=use_pixel_loss,
            pixel_loss_max_images=pixel_loss_max_images,
            prefetch_batches=prefetch_batches,
            nan_policy=nan_policy,
            rss_limit_gb=rss_limit_gb,
            stall_timeout_s=stall_timeout_s,
            on_stall=_make_stall_handler(out_dir) if stall_timeout_s > 0 else None,
            log_every=log_every,
            save_every=save_every,
            keep_checkpoints=keep_checkpoints,
            log_images_every=log_images_every,
            out_dir=out_dir,
            resume_path=train_state_resume_path,
            seed=seed,
            log=log,
        )
    if out_dir:
        model.save_pretrained(os.path.join(out_dir, "model"))
        print("saved", out_dir)
    print("done with all training")
    return model


@contextlib.contextmanager
def _profiler(profile_dir: Optional[str], device):
    """A torch.profiler trace of the block, written to profile_dir/trace.json
    (the device's kernels too on the card); nothing without a profile_dir."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print("profiler trace written to", path)


def _build_parser() -> argparse.ArgumentParser:
    import inspect

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    for name, param in inspect.signature(main).parameters.items():
        default = param.default
        if default is None:
            p.add_argument(f"--{name}", type=str, default=None)
        elif isinstance(default, bool):
            # "--flag", "--flag true" and "--flag=false" all parse
            p.add_argument(
                f"--{name}", type=lambda v: v.lower() in ("1", "true", "yes"), nargs="?", const=True, default=default
            )
        else:
            p.add_argument(f"--{name}", type=type(default), default=default)
    return p


def cli_entry() -> None:
    """Real CLI entry: owns the RSS watchdog's self-restart (never runs for
    library callers of main())."""
    import sys

    global _CLI_INVOKED
    _CLI_INVOKED = True  # the stall handler may exec this process's argv
    args = _build_parser().parse_args()
    try:
        main(**vars(args))
    except RssLimitExceeded as e:
        # a fresh process; exact-resume checkpoints make the restart invisible in the metrics
        print(f"restarting after RSS limit: {e}")
        argv = _restart_argv(sys.argv, e.out_dir)
        sys.stdout.flush()
        sys.stderr.flush()
        try:
            os.execv(sys.executable, [sys.executable, "-m", _MODULE] + argv[1:])
        except OSError as exec_err:
            raise RuntimeError(
                f"self-restart exec failed ({exec_err}); the run IS checkpointed at {e.out_dir}: resume with "
                f"--train_state_resume_path={e.out_dir} --model_resume_path={e.out_dir}/model "
                f"--resume_out_dir={e.out_dir}"
            ) from exec_err


if __name__ == "__main__":
    cli_entry()
