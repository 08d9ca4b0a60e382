"""Training CLI (reference: main.py:283-461), on the card.

Usage:
  python -m dct_autoencoder_torch.train.cli \
      --image_dataset_path_or_url 'shards/{000000..000009}.tar' \
      --model_config_path conf/patch14-l.json --batch_size 32 \
      --opt_8bit --use_pixel_loss

Over several cards, one process a card:
  torchrun --nproc_per_node 4 -m dct_autoencoder_torch.train.cli \
      --image_dataset_path_or_url 'shards/*.tar' --model_config_path conf/patch14-l.json \
      --batch_size 64 --n_model_parallel 2 --sequence_parallel --zero1

or, with the model axis as a pipeline of 2 stages and 4 microbatches:
  torchrun --nproc_per_node 4 -m dct_autoencoder_torch.train.cli \
      --image_dataset_path_or_url 'shards/*.tar' --model_config_path conf/patch14-l.json \
      --batch_size 64 --n_model_parallel 2 --pipeline_microbatches 4 --zero1

Counterpart of dct_autoencoder_tpu/train/cli.py with the same flags and
defaults, plus --device (cuda unless --device cpu).  Metrics go to
out/<timestamp>/metrics.jsonl, with image grids and checkpoints beside them.
A VQ config (vq_type 'vq') trains with k-means init and dead-code expiry
(--vq_kmeans_init, --vq_expire_threshold, --vq_expire_every, JAX's
defaults).  --n_model_parallel (tensor parallelism, or the pipeline's
stages with --pipeline_microbatches), --sequence_parallel and --zero1 train
over the torchrun world, a (world / n_model_parallel, n_model_parallel)
mesh (train/loop.py's train()); without torchrun the world is one process,
and --n_model_parallel 2 raises by name, as --pipeline_microbatches does
without --n_model_parallel > 1.  Every rank reads the same stream with the
same seeds and packs the same global batch, then runs its rows of it; rank 0
writes the metrics, grids and checkpoints.
--profile_dir writes a torch.profiler trace (trace.json) of the main
training phase, every thread recorded, and the device's time put down to the
program's spans with its counters (spans.json).  One default differs from JAX: --rss_limit_gb is 0 (off).
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
from ..models.config import DCTAutoencoderConfig, with_sequence_parallel
from ..models.factory import get_model_and_processor
from ..train.loop import RssLimitExceeded, check_pipeline, train, train_patch_norm

_MODULE = "dct_autoencoder_torch.train.cli"
PROFILED_SPAN = "cli.profiled"  # the profiled block: the edges spans.json reads between


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
    # tensor parallelism over this many ranks of the torchrun world
    n_model_parallel: int = 1,
    # GPipe pipeline parallelism over the n_model_parallel ranks of the model
    # axis, with this many microbatches a step (0: none)
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
    # VQ training knobs (reference threshold_ema_dead_code=15, kmeans_init=True;
    # train/loop.py make_train_step); unused on an LFQ config, as in JAX
    vq_kmeans_init: bool = True,
    vq_expire_threshold: float = 15.0,
    vq_expire_every: int = 50,
    should_save: bool = True,
    out_base: str = "out",
    # where the model and the preprocess run: the card unless 'cpu'
    device: str = "cuda",
):
    model_config = DCTAutoencoderConfig.from_json_file(model_config_path)
    if sequence_parallel:
        model_config = with_sequence_parallel(model_config)
    if pipeline_microbatches:  # before any process joins a group
        check_pipeline(model_config, n_model_parallel, pipeline_microbatches)
    with _process_group(zero1 or n_model_parallel > 1 or sequence_parallel, device):
        import torch
        import torch.distributed as dist

        from ..parallel.mesh import check_model_parallel, is_main_process

        distributed = dist.is_initialized()
        # before any data is read
        check_model_parallel(n_model_parallel, dist.get_world_size() if distributed else 1)
        main_rank = is_main_process()
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
            out_dir = create_output_directory(out_base) if should_save and main_rank else None
            if distributed:  # rank 0's timestamped directory for every rank
                box = [out_dir]
                dist.broadcast_object_list(box, src=0)
                out_dir = box[0]
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
            world_size=dist.get_world_size() if distributed else 1,
            n_model_parallel=n_model_parallel,
            pipeline_microbatches=pipeline_microbatches,
            sequence_parallel=sequence_parallel,
            zero1=zero1,
            **loss_weights,
        )
        if main_rank:
            print("starting run:", run_info)

        metrics_path = os.path.join(out_dir, "metrics.jsonl") if out_dir else None

        def log(d):
            if not main_rank:
                return
            print(d)
            if metrics_path and isinstance(d, dict):
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({k: v for k, v in d.items() if not hasattr(v, "shape")}) + "\n")

        # ----------- Norm calibration phase (reference main.py:388-404) --------
        # skipped on a watchdog self-restart: train() restores the checkpointed
        # patchnorm anyway
        if train_norm_iters > 0 and not resume_out_dir:
            if main_rank:
                print("training norm")
            train_patch_norm(
                model,
                processor,
                batched(make_data(), min(batch_size, 32)),
                steps=train_norm_iters,
                batch_size=min(batch_size, 32),
                log=print if main_rank else (lambda _: None),
            )
            if distributed:  # every rank normalizes with rank 0's statistics
                for t in (model.patchnorm.n, model.patchnorm.median, model.patchnorm.b):
                    dist.broadcast(t, src=0)
            if main_rank:
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
                n_model_parallel=n_model_parallel,
                pipeline_microbatches=pipeline_microbatches,
                zero1=zero1,
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
                vq_kmeans_init=vq_kmeans_init,
                vq_expire_threshold=vq_expire_threshold,
                vq_expire_every=vq_expire_every,
                log=log,
            )
        if out_dir and main_rank:
            model.save_pretrained(os.path.join(out_dir, "model"))
            print("saved", out_dir)
        if main_rank:
            print("done with all training")
        return model


@contextlib.contextmanager
def _process_group(wanted: bool, device):
    """Join the process group for the block (torchrun's, or a world of one
    when parallelism is asked for without torchrun); a group made here is
    destroyed after it."""
    from ..parallel import mesh as pm

    own = pm.initialize_distributed(device) if wanted or pm.launched_by_torchrun() else False
    try:
        yield
    finally:
        if own:
            import torch.distributed as dist

            dist.destroy_process_group()


@contextlib.contextmanager
def _profiler(profile_dir: Optional[str], device):
    """A torch.profiler trace of the block, written to profile_dir/trace.json
    (the device's kernels too on the card), of every thread: the batch-prefetch
    thread's spans too (obs.py); and the device's time put down to the
    program's spans, with the program's counters over the block, in
    profile_dir/spans.json (obs_trace.py).  Nothing without a profile_dir."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .. import obs, obs_trace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities, experimental_config=obs.all_threads_config()) as prof:
        before = obs.counts()
        with record_function(PROFILED_SPAN):
            yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        after = obs.counts()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print("profiler trace written to", path)
    summary = obs_trace.summarize(prof.profiler.kineto_results.events(), PROFILED_SPAN, before, after)
    path = os.path.join(profile_dir, "spans.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    shares = ", ".join(f"{k} {100 * v:.1f}%" for k, v in summary["root_share"].items())
    print(f"program spans written to {path}; the device's operation time by outermost span: {shares or 'none'}")


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
