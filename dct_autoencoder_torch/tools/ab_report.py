"""Augmentation A/B report generator.

A copy of the JAX package's tools/ab_report.py (host JSON only, no device):
it reads the run directories either package's trainer and eval tool write.

Merges two training runs' `metrics.jsonl` + `eval.jsonl` (held-out) +
`eval_train.jsonl` (train fixtures) into one comparable record, mapping each
checkpoint step to ESTIMATED cumulative images seen — the round-4 A/B's
confound: augmented crops change DCT content and therefore the stochastic
token budget, so the augment arm packs fewer images per fixed-row batch
(11–15 vs 15–24 at matched steps) and consumes data at a different
effective rate.  Comparing held-out PSNR at matched images-seen (not
matched steps) removes that confound.

Images-seen estimator: `images_per_batch` is logged every `log_every`
steps; cumulative count at step s is the trapezoidal integral of the logged
series up to s.  With log_every=25–50 over >2k steps the estimator's
standard error is a few percent — small against the ~40% between-arm rate
difference it corrects for.  (Earlier segments of a resumed run keep their
own logged cadence; duplicate step ranges from watchdog restarts are
deduplicated keeping the LAST occurrence, matching what the resumed
optimizer actually consumed.)

Usage:
  python -m dct_autoencoder_torch.tools.ab_report \
      --arm augment=out_ab_augment/<ts> --arm control=out_ab_control/<ts> \
      --out docs/aug_ab_r4/report.json
"""
from __future__ import annotations

import argparse
import json
import os


def load_jsonl(path):
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def images_seen_series(metrics):
    """[(step, cumulative_images_estimate)] via trapezoidal integration of
    the sampled images_per_batch series (duplicates deduped, last wins)."""
    pts = {}
    for m in metrics:
        if "images_per_batch" in m and "step" in m:
            pts[int(m["step"])] = float(m["images_per_batch"])
    steps = sorted(pts)
    if not steps:
        return []
    series = []
    cum = 0.0
    prev_s, prev_v = None, None
    for s in steps:
        v = pts[s]
        if prev_s is None:
            # steps 0..first sample: assume the first sampled rate
            cum += v * s
        else:
            cum += 0.5 * (v + prev_v) * (s - prev_s)
        series.append((s, cum))
        prev_s, prev_v = s, v
    return series


def images_at(series, step):
    """Linear interpolation (extrapolation clamps to the last rate)."""
    if not series:
        return None
    if step <= series[0][0]:
        return series[0][1] * (step / max(series[0][0], 1))
    for (s0, c0), (s1, c1) in zip(series, series[1:]):
        if s0 <= step <= s1:
            t = (step - s0) / (s1 - s0)
            return c0 + t * (c1 - c0)
    # beyond the last sample: extend at the final average rate
    s_last, c_last = series[-1]
    rate = c_last / max(s_last, 1)
    return c_last + rate * (step - s_last)


def ckpt_step(name):
    """'ckpt_000600' -> 600; 'model' -> None (resolved by caller)."""
    if name.startswith("ckpt_"):
        return int(name.split("_")[1])
    return None


def arm_record(path):
    metrics = load_jsonl(os.path.join(path, "metrics.jsonl"))
    series = images_seen_series(metrics)
    max_step = max((int(m["step"]) for m in metrics if "step" in m), default=0)

    def eval_rows(fname):
        rows = []
        for r in load_jsonl(os.path.join(path, fname)):
            step = ckpt_step(r["step"])
            if step is None:
                step = max_step
            rows.append(
                {
                    "step": step,
                    "images_seen_est": round(images_at(series, step) or 0.0, 0),
                    "psnr": round(r["psnr"], 3),
                    "psnr_per_image": r.get("psnr_per_image"),
                    "perplexity": round(r.get("perplexity", 0.0), 1),
                }
            )
        return sorted(rows, key=lambda r: r["step"])

    return {
        "run_dir": path,
        "max_step": max_step,
        "total_images_est": round(images_at(series, max_step) or 0.0, 0),
        "held_out": eval_rows("eval.jsonl"),
        "train_fixtures": eval_rows("eval_train.jsonl"),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arm", action="append", required=True,
                    help="name=run_dir (repeatable)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    report = {}
    for spec in args.arm:
        name, path = spec.split("=", 1)
        report[name] = arm_record(path)

    # side-by-side held-out table at matched steps + the images-seen view
    lines = ["| arm | step | images-seen (est) | held-out PSNR | train PSNR |",
             "|---|---|---|---|---|"]
    for name, rec in report.items():
        train_by_step = {r["step"]: r for r in rec["train_fixtures"]}
        for r in rec["held_out"]:
            tr = train_by_step.get(r["step"], {})
            lines.append(
                f"| {name} | {r['step']} | {int(r['images_seen_est'])} "
                f"| {r['psnr']:.2f} | {tr.get('psnr', float('nan')):.2f} |"
            )
    table = "\n".join(lines)
    print(table)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
