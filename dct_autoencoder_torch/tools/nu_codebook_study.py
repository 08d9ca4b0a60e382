"""nu-codebook error study on real Adam moments (docs/opt8bit_nu_codebook_r4.md).

Counterpart of the JAX package's tools/nu_codebook_study.py, with the same
flags, candidates and results, over the port's own training state: it reads
``train_state.pt`` (train/checkpoint.py) on the host, pairs every fp32
(exp_avg, exp_avg_sq) AdamW moment pair (optax's mu and nu) with its
parameter's name, and measures —
for several candidate 256-level unsigned codebooks — the error each one
induces in the quantity that actually matters: the Adam update direction
``mu / (sqrt(nu) + eps)``.  The round-4 study ran as a /tmp scratch script;
this tool commits the method so the numbers in the doc are reproducible
from the repo alone.

Usage:
    python -m dct_autoencoder_torch.tools.nu_codebook_study \
        --train_state out_ab_augment/<ts> --out results.json

`--train_state` accepts either a run out-dir (containing ``train_state.pt``)
or the file itself.  Everything runs in host numpy; a checkpoint with 8-bit
moments is refused, as in JAX.

Candidates (mirroring the round-4 study):
  * ``u4``     — the shipped codebook, ``linspace(0,1,256)**4``
                 (the port's train/opt8bit.py:_unsigned_codebook)
  * ``u2``     — quadratic concentration
  * ``log7``   — 0 + 255 log-spaced levels over 7 decades
  * ``log5``   — 0 + 255 log-spaced levels over 5 decades
  * ``bnbdyn`` — a bitsandbytes-style exponent+fraction dynamic map
                 (log-placed decades, linear fractions inside each decade)
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

BLOCK = 256
EPS = 1e-8


# ---------------------------------------------------------------- codebooks
def cb_u4() -> np.ndarray:
    return np.linspace(0.0, 1.0, 256) ** 4


def cb_u2() -> np.ndarray:
    return np.linspace(0.0, 1.0, 256) ** 2


def cb_log(decades: int) -> np.ndarray:
    return np.concatenate([[0.0], np.logspace(-decades, 0.0, 255)])


def cb_bnbdyn() -> np.ndarray:
    """bitsandbytes-style dynamic map (unsigned): 0, then for each of 7
    decades a linear ramp of fractions — exponent bits buy range, fraction
    bits buy within-decade precision."""
    levels = [0.0]
    n_decades = 7
    # 36 fractions in the first six decades, 39 (incl. the 1.0 endpoint) in
    # the last: 1 + 6*36 + 39 = 256 levels exactly
    counts = [36] * (n_decades - 1) + [39]
    for e, n in enumerate(counts):
        lo, hi = 10.0 ** (e - n_decades), 10.0 ** (e - n_decades + 1)
        last = e == n_decades - 1
        levels.extend(np.linspace(lo, hi, n, endpoint=last))
    return np.asarray(levels)


CANDIDATES = {
    "u4": cb_u4,
    "u2": cb_u2,
    "log7": lambda: cb_log(7),
    "log5": lambda: cb_log(5),
    "bnbdyn": cb_bnbdyn,
}


# ------------------------------------------------------------- quantization
def quant_roundtrip(x: np.ndarray, cb: np.ndarray, block: int = BLOCK) -> np.ndarray:
    """Blockwise absmax-normalize, round to nearest codebook level, dequant."""
    flat = x.reshape(-1).astype(np.float64)
    pad = (-flat.size) % block
    if pad:
        flat = np.pad(flat, (0, pad))
    xb = flat.reshape(-1, block)
    absmax = np.abs(xb).max(axis=1)
    scale = np.where(absmax > 0, absmax, 1.0)
    norm = xb / scale[:, None]
    hi = np.clip(np.searchsorted(cb, norm), 1, cb.size - 1)
    lo = hi - 1
    idx = np.where((cb[hi] - norm) < (norm - cb[lo]), hi, lo)
    deq = cb[idx] * scale[:, None]
    return deq.reshape(-1)[: x.size].reshape(x.shape)


# ------------------------------------------------------------ moment access
def resolve_train_state(path: str) -> str:
    """A run out-dir holding train_state.pt, or the file itself -> the file."""
    if os.path.isdir(path):
        path = os.path.join(path, "train_state.pt")
    return os.path.abspath(path)


def collect_moment_pairs(train_state_file: str):
    """Yield (name, mu, nu) for every AdamW moment pair of a train_state.pt.

    The file's opt_state is torch.optim.AdamW.state_dict(), whose moments
    are keyed by the parameter's index in the optimizer, which the trainer
    builds from module.parameters().  The names come from the saved
    state_dict without VQ's statistics (its only persistent buffers): in
    that order they are module.named_parameters()'s.  Each pair is named
    and laid out as the JAX package's parameter (models/convert.py: a Dense
    weight's moments are transposed to the (in, out) kernel), so the blocks
    of 256 and the order of the pairs are JAX's."""
    import torch

    from ..models.convert import _jax_key, is_vq_stat

    payload = torch.load(train_state_file, map_location="cpu", weights_only=True)
    opt_state = payload["opt_state"]
    states = opt_state["state"]
    if not states or any("exp_avg" not in st or "exp_avg_sq" not in st for st in states.values()):
        raise SystemExit("no exp_avg/exp_avg_sq moments found in opt_state (8-bit run? this "
                         "study needs an fp32-moment checkpoint)")
    names = [k for k in payload["params"] if not is_vq_stat(k)]
    (group,) = opt_state["param_groups"]
    if len(group["params"]) != len(names):
        raise ValueError(f"{len(group['params'])} optimizer parameters but {len(names)} named parameters")
    pairs = {}
    for name, index in zip(names, group["params"]):
        st = states[index]
        shape = tuple(payload["params"][name].shape)
        if tuple(st["exp_avg"].shape) != shape:
            raise ValueError(f"{name}: moment of shape {tuple(st['exp_avg'].shape)}, parameter {shape}")
        key = _jax_key(name, len(shape))
        mu, nu = (st[k].float().numpy() for k in ("exp_avg", "exp_avg_sq"))
        if key.endswith("/kernel"):
            mu, nu = mu.T, nu.T
        pairs["/" + key] = (mu, nu)
    for name in sorted(pairs):
        yield (name, *pairs[name])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train_state", required=True,
                    help="run out-dir (containing train_state.pt) or the file")
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args(argv)

    ts = resolve_train_state(args.train_state)

    pairs = list(collect_moment_pairs(ts))
    print(f"{len(pairs)} moment tensor pairs from {ts}")

    results = {}
    for cb_name, make in CANDIDATES.items():
        cb = np.sort(make())
        nu_errs, upd_errs = [], []
        for _, mu, nu in pairs:
            mu = mu.astype(np.float64)
            nu = nu.astype(np.float64)
            nu_hat = quant_roundtrip(nu, cb)
            # nu is a second moment: clamp the roundtrip at 0 like the
            # optimizer's sqrt path effectively does
            nu_hat = np.maximum(nu_hat, 0.0)
            upd = mu / (np.sqrt(nu) + EPS)
            upd_hat = mu / (np.sqrt(nu_hat) + EPS)
            denom_nu = np.mean(np.abs(nu)) + 1e-30
            denom_upd = np.mean(np.abs(upd)) + 1e-30
            nu_errs.append(float(np.mean(np.abs(nu_hat - nu)) / denom_nu))
            upd_errs.append(float(np.mean(np.abs(upd_hat - upd)) / denom_upd))
        results[cb_name] = {
            "median_rel_err_nu": float(np.median(nu_errs)),
            "median_update_err": float(np.median(upd_errs)),
            "max_update_err": float(np.max(upd_errs)),
        }
        r = results[cb_name]
        print(f"{cb_name:8s} nu_err={r['median_rel_err_nu']:.4g} "
              f"upd_err={r['median_update_err']:.4g} "
              f"max_upd_err={r['max_update_err']:.4g}")

    payload = {
        "train_state": ts,
        "n_tensor_pairs": len(pairs),
        "block_size": BLOCK,
        "eps": EPS,
        "results": results,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
