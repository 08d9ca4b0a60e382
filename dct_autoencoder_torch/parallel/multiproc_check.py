"""Two-process full-train-step check (JAX: parallel/multiproc_check.py).

Two OS processes form a torch.distributed group (NCCL with one card each
when the host has two or more cards, else gloo on the CPU), each takes its block of the rows of one
global packed batch and runs the sharded train step that train() runs
(train/loop.py's make_train_step with a mesh), and checks that

  * loss and grad_norm match the single-process step (the gradient and
    statistic all-reduces across the process boundary are right), and
  * a data-parallel encode gives, on the rows each process owns, the token
    ids of the single-process encode.

With pipeline_microbatches > 0 the two processes are instead the two stages
of a GPipe pipeline (parallel/pipeline.py; each holds half of each stack's
layers) over the whole batch: the same step within the same limits, and
the pipelined encode of every row gives the single-process token ids.

The parent (`run_two_process_check`) builds a payload (config, parameters,
calibrated patchnorm, the packed batch, the single-process expectations),
spawns the two workers (this module's __main__) and checks their output.
Used by tests/test_torch_multihost.py and chip_smoke.py.
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BATCH_FIELDS = ("patches", "key_pad_mask", "batched_image_ids", "patch_channels", "patch_positions")


def _tiny_config():
    from ..models.config import DCTAutoencoderConfig, TransformerConfig

    tc = TransformerConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4)
    return DCTAutoencoderConfig(
        image_channels=3, patch_size=4, max_patch_h=8, max_patch_w=8, vq_codebook_size=64, vq_num_codebooks=4,
        vq_type="lfq", encoder_config=tc, decoder_config=tc,
    )


def _step(module, tx, patchnorm, batch, mesh=None):
    from ..train.loop import TrainState, make_train_step

    state = TrainState.create(module, tx, mesh=mesh)
    step = make_train_step(module, tx, mesh=mesh)
    _, metrics = step(state, patchnorm, batch)
    return float(metrics["loss"]), float(metrics["grad_norm"])


def build_payload(
    payload_path: str, config=None, device=None, n_images: int = 4, image_size: int = 32
) -> Dict[str, float]:
    """The single-process reference run (fp32, on `device`: by default card 0
    where the workers take cards, else the CPU); saves what the workers need."""
    from ..models.factory import get_model_and_processor
    from ..models.patchnorm import apply_patchnorm, calibrate_patchnorm_batch
    from ..parallel.mesh import pad_batch_rows
    from ..train.loop import make_optimizer, prepare_train_batch

    cfg = config if config is not None else _tiny_config()
    device = device or ("cuda:0" if default_device() == "cuda" else "cpu")
    model, proc = get_model_and_processor(cfg, dtype=torch.float32, sample_patches_beta=0.0, device=device)
    rng = np.random.default_rng(0)
    ims = [rng.uniform(0.1, 0.9, size=(3, image_size, image_size)).astype(np.float32) for _ in range(n_images)]
    ds = [proc.preprocess(im) for im in ims]
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    batch = next(proc.iter_batches(iter([cols]), batch_size=None)).to(model.device)
    model.patchnorm, _ = calibrate_patchnorm_batch(model.patchnorm, batch)
    sb = pad_batch_rows(prepare_train_batch(batch)[0], 2)
    weights = {k: v.detach().cpu().clone() for k, v in model.module.state_dict().items()}
    with torch.no_grad():
        codes = model.module(sb.replace(patches=apply_patchnorm(model.patchnorm, sb)), training=False)["codes"]
    loss, grad_norm = _step(model.module, make_optimizer(1e-3, 10, warmup_steps=0), model.patchnorm, sb)
    expected = {"loss": loss, "grad_norm": grad_norm}
    pn = model.patchnorm
    torch.save({
        "config": cfg.to_dict(), "params": weights,
        "patchnorm": {k: getattr(pn, k).cpu() for k in ("n", "median", "b")},
        "batch": {k: getattr(sb, k).cpu() for k in _BATCH_FIELDS}, "codes": codes.cpu(), **expected,
    }, payload_path)
    return expected


def default_device() -> str:
    """'cuda' (NCCL, one card a process) where the host has two or more cards, else 'cpu' (gloo)."""
    return "cuda" if torch.cuda.device_count() >= 2 else "cpu"


def worker_main(
    payload_path: str, init_method: str, pid: int, device: Optional[str] = None, nprocs: int = 2,
    pipeline_microbatches: int = 0,
) -> None:
    from ..models.autoencoder import DCTAutoencoder
    from ..models.config import DCTAutoencoderConfig
    from ..models.patchnorm import PatchNormState, apply_patchnorm
    from ..parallel.mesh import initialize_distributed, load_full_state_dict, make_mesh, row_block, take_rows
    from ..parallel.pipeline import make_pipelined_module
    from ..patches.container import DCTPatches
    from ..train.loop import make_optimizer

    device = device or default_device()
    dev = torch.device(f"cuda:{pid}" if device == "cuda" else device)
    initialize_distributed(dev, init_method, nprocs, pid, timeout_s=300)
    payload = torch.load(payload_path, weights_only=True)
    model = DCTAutoencoder(DCTAutoencoderConfig.from_dict(payload["config"]), dtype=torch.float32, device=dev)
    model.module.load_state_dict(payload["params"])
    patchnorm = PatchNormState(**payload["patchnorm"]).to(dev)
    batch = DCTPatches(**payload["batch"]).to(dev)
    if pipeline_microbatches:  # the processes are the stages of one pipeline
        mesh = make_mesh(nprocs, dev)
        assert mesh.n_model == nprocs and mesh.model_rank == pid, (mesh.n_model, mesh.model_rank)
        make_pipelined_module(model.module, mesh, pipeline_microbatches)
    else:
        mesh = make_mesh(1, dev)
        assert mesh.n_data == nprocs and mesh.data_rank == pid, (mesh.n_data, mesh.data_rank)

    # every process is given the global batch and runs its block of rows (all of them in a pipeline)
    loss, grad_norm = _step(
        model.module, make_optimizer(1e-3, 10, warmup_steps=0), patchnorm, batch, mesh
    )
    assert np.isfinite(loss) and np.isfinite(grad_norm)
    # the sums across the process boundary give the single-process numbers
    # (summation order only)
    np.testing.assert_allclose(loss, payload["loss"], rtol=2e-4)
    np.testing.assert_allclose(grad_norm, payload["grad_norm"], rtol=2e-3)

    # data-parallel or pipelined encode (the step left the weights updated: load them again)
    load_full_state_dict(model.module, payload["params"], mesh)
    rows = row_block(batch.patches.shape[0], mesh.data_rank, mesh.n_data)
    mine = take_rows(batch, rows.start, rows.stop)
    with torch.no_grad():
        codes = model.module(mine.replace(patches=apply_patchnorm(patchnorm, mine)), training=False)["codes"]
    np.testing.assert_array_equal(codes.cpu().numpy(), payload["codes"][rows].numpy())
    torch.distributed.destroy_process_group()
    print(
        f"proc {pid} full-step ok loss={loss:.6f} grad_norm={grad_norm:.4f} "
        f"{'pipelined ' if pipeline_microbatches else ''}encode rows {rows.start}:{rows.stop} identical",
        flush=True,
    )


def run_two_process_check(
    tmpdir: str, timeout: float = 420.0, config=None, device: Optional[str] = None, n_images: int = 4, image_size: int = 32,
    pipeline_microbatches: int = 0,
) -> Dict:
    """Parent side: the payload, two workers, their output checked.  The
    device is `default_device()` unless given: on 'cuda' the reference runs
    on card 0 and worker i on card i (NCCL); on 'cpu' over gloo.
    pipeline_microbatches > 0: the workers are two pipeline stages.
    Returns {'loss', 'grad_norm', 'outputs': [stdout0, stdout1]}; raises on
    any worker failure."""
    from .mesh import free_port

    device = device or default_device()
    payload_path = os.path.join(tmpdir, "multiproc_payload.pt")
    expected = build_payload(payload_path, config, "cuda:0" if device == "cuda" else device, n_images, image_size)
    init_method = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=_REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "dct_autoencoder_torch.parallel.multiproc_check", payload_path, init_method,
             str(pid), device, str(pipeline_microbatches)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"proc {pid} full-step ok" not in out:
            raise RuntimeError(f"2-process worker {pid} failed:\n{out}")
    return {**expected, "outputs": outs}


if __name__ == "__main__":
    torch.set_num_threads(1)
    worker_main(
        sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4] if len(sys.argv) > 4 else None,
        pipeline_microbatches=int(sys.argv[5]) if len(sys.argv) > 5 else 0,
    )
