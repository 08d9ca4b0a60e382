"""Hyperparameter sweep runner (reference: wandb_main.py + sweep.yaml).

Counterpart of the JAX package's train/sweep.py.  The reference drives a
wandb Bayes sweep over the learning rate and the four loss weights,
minimizing the train rec_loss.  Two methods over the same space:

  * 'tpe' (default, the Bayes-like method): a dependency-free
    Tree-structured Parzen Estimator: after a few random startup trials,
    observed trials split into good/bad quantiles, per-dimension Parzen
    (Gaussian-kernel) densities l(x)/g(x) are fit over each set, and the
    candidate maximizing the density ratio is suggested (Bergstra et al.
    2011);
  * 'random': log-uniform/uniform sampling.

`TPESuggester` and `sample` draw from Python's `random.Random` exactly as
the JAX package's do, so a seed gives the same suggestions in both.

Short training runs, JSONL results, best-trial report.

Usage:
  python -m dct_autoencoder_torch.train.sweep \\
      --image_dataset_path_or_url 'shards/*.tar' --trials 8 --max_iters 200
  python -m dct_autoencoder_torch.train.sweep --onchip \\
      --image_dataset_path_or_url 'shards/*.tar' --model_config_path conf/small-448.json

--device cpu runs either on the CPU (the card is the default).
"""
from __future__ import annotations

import argparse
import json
import math
import random
import time
from typing import Dict, List, Tuple

# reference sweep.yaml: lr log-uniform [1e-5, 4e-4]; weights uniform-ish
DEFAULT_SPACE = {
    "learning_rate": ("log_uniform", 1e-5, 4e-4),
    "rec_loss": ("uniform", 0.0, 1.0),
    "rec_loss_unnormalized": ("uniform", 0.5, 1.5),
    "commit_loss": ("uniform", 0.0, 0.5),
    "entropy_loss": ("uniform", 0.0, 0.5),
}


def sample(space: Dict, rng: random.Random) -> Dict[str, float]:
    out = {}
    for k, (kind, lo, hi) in space.items():
        if kind == "log_uniform":
            out[k] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            out[k] = rng.uniform(lo, hi)
    return out


class TPESuggester:
    """Minimal per-dimension TPE (minimization).

    Each dimension is mapped to the unit interval (log-transformed for
    log_uniform), observations are split at the `gamma` score quantile into
    good (l) and bad (g) sets, both modeled as Parzen mixtures of Gaussians
    with a 1/sqrt(n) bandwidth, and `n_candidates` draws from l are ranked
    by the l/g density ratio.  Dimensions are treated independently.
    """

    def __init__(self, space: Dict, rng: random.Random, n_startup: int = 4, gamma: float = 0.25, n_candidates: int = 24):
        self.space = space
        self.rng = rng
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.trials: List[Tuple[Dict[str, float], float]] = []

    def _to_unit(self, key: str, x: float) -> float:
        kind, lo, hi = self.space[key]
        if kind == "log_uniform":
            return (math.log(x) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return (x - lo) / (hi - lo)

    def _from_unit(self, key: str, u: float) -> float:
        kind, lo, hi = self.space[key]
        u = min(max(u, 0.0), 1.0)
        if kind == "log_uniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            x = lo + u * (hi - lo)
        return min(max(x, lo), hi)  # the exp/log round trip can overshoot by 1 ulp

    @staticmethod
    def _log_density(u: float, centers: List[float], sigma: float) -> float:
        # mixture of Gaussians (+ a uniform floor so the ratio stays finite)
        if not centers:
            return 0.0
        acc = 1e-12
        for c in centers:
            z = (u - c) / sigma
            acc += math.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi))
        return math.log(acc / len(centers) + 1e-3)

    def observe(self, params: Dict[str, float], score: float) -> None:
        self.trials.append((params, score))

    def suggest(self) -> Dict[str, float]:
        if len(self.trials) < self.n_startup:
            return sample(self.space, self.rng)
        ordered = sorted(self.trials, key=lambda t: t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good, bad = ordered[:n_good], ordered[n_good:]

        out: Dict[str, float] = {}
        for key in self.space:
            gl = [self._to_unit(key, p[key]) for p, _ in good]
            bl = [self._to_unit(key, p[key]) for p, _ in bad] or gl
            sg = max(1.0 / math.sqrt(len(gl) + 1), 0.08)
            sb = max(1.0 / math.sqrt(len(bl) + 1), 0.08)
            best_u, best_ratio = None, -math.inf
            for _ in range(self.n_candidates):
                # draw from l: pick a good center, jitter by its bandwidth
                c = self.rng.choice(gl)
                u = min(max(self.rng.gauss(c, sg), 0.0), 1.0)
                ratio = self._log_density(u, gl, sg) - self._log_density(u, bl, sb)
                if ratio > best_ratio:
                    best_u, best_ratio = u, ratio
            out[key] = self._from_unit(key, best_u)
        return out


def _append(out_file: str, record: dict) -> None:
    with open(out_file, "a") as f:
        f.write(json.dumps(record) + "\n")


def run_onchip(
    image_dataset_path_or_url: str,
    model_config_path: str = "./conf/small-448.json",
    trials: int = 8,
    max_iters: int = 60,
    batch_size: int = 4,
    seed: int = 0,
    methods: Tuple[str, ...] = ("tpe", "random"),
    out_file: str = "sweep_results.jsonl",
    score_last: int = 8,
    calib_steps: int = 3,
    # widen the learning-rate dimension above the reference's ceiling (4e-4); 0 keeps it
    lr_hi: float = 0.0,
    # re-run the campaign-best config this many times from fresh model-init
    # seeds: the spread is the seed-noise floor that makes a TPE-vs-random
    # margin readable (data order and packing are fixed here, and the
    # in-step gumbel stream is keyed by (seed, step), so init is the only
    # trial-to-trial randomness at fixed hyper-parameters)
    noise_repeats: int = 0,
    device: str = "cuda",
    log=print,
):
    """Shared-step sweep: one model, one calibration and one batch set, with
    the train step built once and replayed for every trial.

    "Shared" means: the model is initialised, its patchnorm calibrated and
    the packed batches made once (beta 0, so every batch is full sequences,
    padded to one row count); the train step is built once with
    dynamic_hparams=True over a unit-peak optimizer, and every trial of
    every method restores the initial weights and statistics, makes fresh
    optimizer state and replays that step with its own (loss weights,
    lr_scale).  lr_scale times the unit-peak warmup-cosine schedule is the
    schedule at that peak (exact for AdamW, see loop.Optimizer.apply).
    The JAX package shares one compiled program this way; here nothing is
    compiled, and what is shared is the set-up.  The per-process path
    (`main`) runs the whole CLI per trial instead.  The model computes in
    fp32, as the JAX function's does.
    """
    import numpy as np
    import torch

    from ..data.dataset import batched, load_and_transform_dataset
    from ..models.autoencoder import DCTAutoencoder
    from ..models.config import DCTAutoencoderConfig
    from ..models.factory import get_model_and_processor
    from .loop import TrainState, make_optimizer, make_train_step, pad_batch_rows, prepare_train_batch, train_patch_norm

    space = dict(DEFAULT_SPACE)
    if lr_hi:
        kind, lo, _ = space["learning_rate"]
        space["learning_rate"] = (kind, lo, lr_hi)

    cfg = DCTAutoencoderConfig.from_json_file(model_config_path)
    model, proc = get_model_and_processor(cfg, sample_patches_beta=0.0, seed=seed, device=device)

    def stream():
        return load_and_transform_dataset(image_dataset_path_or_url, proc, shuffle_buffer=1000, seed=seed)

    train_patch_norm(model, proc, batched(stream(), batch_size), steps=calib_steps, batch_size=batch_size, log=log)

    # one fixed batch set: beta 0 packing is deterministic; rows padded to one count
    raw = list(proc.iter_batches(batched(stream(), batch_size), batch_size, drain=True))
    if not raw:
        raise ValueError(f"no batch from {image_dataset_path_or_url!r}: check the path and the resolution filter")
    prepared = [prepare_train_batch(b)[0].to(model.device) for b in raw]
    fixed_rows = max(b.patches.shape[0] for b in prepared)
    batches = [pad_batch_rows(b, fixed_rows) for b in prepared]
    log(f"sweep data: {len(batches)} packed batches of shape {tuple(batches[0].patches.shape)} (one step for all trials)")

    # unit-peak schedule; each trial's rate rides as lr_scale
    tx = make_optimizer(learning_rate=1.0, max_iters=max_iters)
    step_fn = make_train_step(model.module, tx, loss_weights=None, seed=seed, dynamic_hparams=True)
    init_state = {k: v.clone() for k, v in model.module.state_dict().items()}
    weight_keys = [k for k in space if k != "learning_rate"]

    def run_trial(params_hp: Dict[str, float], init_override=None) -> Dict[str, float]:
        model.module.load_state_dict(init_state if init_override is None else init_override)
        state = TrainState.create(model.module, tx)
        # 0-d fp32 tensors, as JAX's jnp.float32 arguments: a weight always contributes
        hparams = {k: torch.tensor(params_hp[k], dtype=torch.float32, device=model.device) for k in weight_keys}
        hparams["lr_scale"] = float(np.float32(params_hp["learning_rate"]))
        recs, losses = [], []
        for i in range(max_iters):
            state, metrics = step_fn(state, model.patchnorm, batches[i % len(batches)], None, hparams)
            if i >= max_iters - score_last:
                recs.append(float(metrics["rec_loss"]))
                losses.append(float(metrics["loss"]))
        return {"rec_loss": float(np.mean(recs)), "loss": float(np.mean(losses))}

    results = {}
    for method in methods:
        rng = random.Random(seed)
        suggester = TPESuggester(space, rng) if method == "tpe" else None
        best = None
        for t in range(trials):
            hp = suggester.suggest() if suggester else sample(space, rng)
            t0 = time.monotonic()
            scores = run_trial(hp)
            # {**hp, **scores}: the 'rec_loss' score overwrites the 'rec_loss'
            # weight in the flat record (the reference's sweep.yaml names both
            # so); the hyper-parameters themselves ride under "hp"
            record = {"trial": t, "method": method, **hp, **scores, "hp": dict(hp),
                      "wall_s": round(time.monotonic() - t0, 1)}
            _append(out_file, record)
            if suggester:
                suggester.observe(hp, scores["rec_loss"])
            if best is None or scores["rec_loss"] < best["rec_loss"]:
                best = record
            log(f"[{method}] trial {t}: rec_loss={scores['rec_loss']:.4f} ({record['wall_s']}s) best={best['rec_loss']:.4f}")
        results[method] = best
    log(f"best per method: {results}")

    if noise_repeats:
        best_overall = min(results.values(), key=lambda r: r["rec_loss"])
        # the "hp" sub-dict, not the flat record, whose 'rec_loss' is the score
        hp = {k: best_overall["hp"][k] for k in space}
        floor_scores = []
        for r in range(noise_repeats):
            m2 = DCTAutoencoder(cfg, device=model.device, seed=seed + 1001 + r)
            t0 = time.monotonic()
            scores = run_trial(hp, init_override=m2.module.state_dict())
            del m2
            record = {"trial": r, "method": "noise", **hp, **scores, "hp": dict(hp), "init_seed": seed + 1001 + r,
                      "wall_s": round(time.monotonic() - t0, 1)}
            _append(out_file, record)
            floor_scores.append(scores["rec_loss"])
            log(f"[noise] repeat {r}: rec_loss={scores['rec_loss']:.4f}")
        results["noise_floor"] = {
            "mean": float(np.mean(floor_scores)), "std": float(np.std(floor_scores)),
            "min": float(np.min(floor_scores)), "max": float(np.max(floor_scores)), "n": noise_repeats,
        }
        log(f"seed-noise floor at best config: {results['noise_floor']}")
    return results


def main(
    image_dataset_path_or_url: str = None,
    preprocessed_dataset_path_or_url: str = None,
    model_config_path: str = "./conf/patch14-l.json",
    trials: int = 8,
    max_iters: int = 200,
    batch_size: int = 8,
    seed: int = 0,
    method: str = "tpe",
    out_file: str = "sweep_results.jsonl",
    # the same model init and data order in every trial, so trials differ only
    # in their hyper-parameters; false also resamples the init per trial
    fixed_init: bool = True,
    # the RSS watchdog restarts the process, which would end the campaign: off
    rss_limit_gb: float = 0.0,
    device: str = "cuda",
):
    """Per-trial sweep: the training CLI (train/cli.py) once per trial, its
    last logged rec_loss as the score."""
    from . import cli as cli_mod

    rng = random.Random(seed)
    suggester = TPESuggester(DEFAULT_SPACE, rng) if method == "tpe" else None
    best = None
    for t in range(trials):
        params = suggester.suggest() if suggester else sample(DEFAULT_SPACE, rng)
        print(f"--- trial {t}: {params}")
        final_metrics = {}
        orig_train = cli_mod.train

        def capturing_train(*args, log=print, **kwargs):
            def wrap_log(d):
                if isinstance(d, dict) and "rec_loss" in d:
                    final_metrics.update(d)
                log(d)

            return orig_train(*args, log=wrap_log, **kwargs)

        # the CLI calls the train() it imported; capture the last logged metrics there
        cli_mod.train = capturing_train
        try:
            cli_mod.main(
                image_dataset_path_or_url=image_dataset_path_or_url,
                preprocessed_dataset_path_or_url=preprocessed_dataset_path_or_url,
                model_config_path=model_config_path,
                batch_size=batch_size,
                max_iters=max_iters,
                train_norm_iters=2,
                learning_rate=params["learning_rate"],
                rec_loss=params["rec_loss"],
                rec_loss_unnormalized=params["rec_loss_unnormalized"],
                commit_loss=params["commit_loss"],
                entropy_loss=params["entropy_loss"],
                log_every=max(max_iters // 4, 1),
                should_save=False,
                seed=seed if fixed_init else seed + t,
                rss_limit_gb=rss_limit_gb,
                device=device,
            )
        finally:
            cli_mod.train = orig_train

        record = {"trial": t, "method": method, **params,
                  **{k: v for k, v in final_metrics.items() if isinstance(v, (int, float))}}
        _append(out_file, record)
        score = record.get("rec_loss", float("inf"))
        if suggester:
            suggester.observe(params, score)
        if best is None or score < best.get("rec_loss", float("inf")):
            best = record
        print(f"--- trial {t} rec_loss={score}")

    print("best trial:", best)
    return best


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_dataset_path_or_url", default=None)
    p.add_argument("--preprocessed_dataset_path_or_url", default=None)
    p.add_argument("--model_config_path", default="./conf/patch14-l.json")
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--max_iters", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--method", default="tpe", choices=("tpe", "random"))
    p.add_argument("--out_file", default="sweep_results.jsonl")
    p.add_argument("--fixed_init", type=lambda v: v.lower() in ("1", "true", "yes"), default=True)
    p.add_argument("--rss_limit_gb", type=float, default=0.0)
    p.add_argument("--device", default="cuda", help="where the model trains: the card unless 'cpu'")
    # shared-step campaign (run_onchip): both methods, one set-up for all trials
    p.add_argument("--onchip", action="store_true")
    p.add_argument("--lr_hi", type=float, default=0.0,
                   help="widen the lr dimension's upper bound (0 = the reference sweep.yaml ceiling 4e-4)")
    p.add_argument("--noise_repeats", type=int, default=0,
                   help="re-run the campaign-best config N times with fresh init seeds (onchip)")
    return p


def cli_entry(argv=None) -> None:
    a = _parser().parse_args(argv)
    if a.onchip:
        run_onchip(
            a.image_dataset_path_or_url, model_config_path=a.model_config_path, trials=a.trials,
            max_iters=a.max_iters, batch_size=a.batch_size, seed=a.seed, out_file=a.out_file, lr_hi=a.lr_hi,
            noise_repeats=a.noise_repeats, device=a.device,
        )
    else:
        kw = vars(a)
        for k in ("onchip", "lr_hi", "noise_repeats"):
            kw.pop(k)
        main(**kw)


if __name__ == "__main__":
    cli_entry()
