"""The numbers that decide `correct`, each against its limit (the readings
they were set from are in PERF.md, section 2).

Training, over the checked steps and weights:
* loss_rec: each step's reconstruction term (the normalized L1, weight 0.1
  in the objective), its largest gap relative to the reference's.  The whole
  loss is reported beside it and not compared: 84 % of it is the entropy
  term at temperature 0.01, which bf16 arithmetic alone moves as far as fp8
  moves the whole loss.  The entropy term is reported beside for the same
  reason: sound runs read as far from the reference as the fp8 control.
* loss_commit: each step's commitment term, the same largest relative gap.
* grad_gap: the first gradient's norm by weight, |program - reference| over
  the larger of the reference's norm of that weight and the median weight's,
  at the median weight.  The worst weight (a LayerNorm's, whose gradient the
  entropy term makes spiky) reads a tenth and more in bf16 alone; it is
  reported beside.
* update_gap: the norm of the change the checked steps made, by weight, the
  same gap at the worst weight.  Weights whose reference gradient is under a
  thousandth of the median weight's (a key's bias under softmax) move under
  Adam by round-off alone: they are left out.
* images_differ: steps whose image count differs from the reference's packing.
Serving, over every answer of the window:
* pixel_mse: the answers' mean squared difference from the reference's pixels;
* bad_answers: answers whose RMS difference exceeds `answer_rmse`;
* failed_calls: calls whose answer never came or is not an image.
"""
from __future__ import annotations

import statistics
from typing import Dict

NEGLIGIBLE_GRADIENT = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    keys = list(keys)
    floor = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor) for k in keys}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keys) -> tuple:
    gaps = leaf_gaps(prog, ref, keys)
    k = max(gaps, key=gaps.get)
    return gaps[k], k


TERMS = ("rec_loss", "commit_loss", "entropy_loss", "rec_loss_unnormalized", "grad_norm")


def term_gaps(prog_terms, ref_terms) -> Dict[str, float]:
    """Each logged term's largest relative gap over the checked steps."""
    out = {}
    for k in TERMS:
        gaps = [abs(p.get(k, float("nan")) - r[k]) / abs(r[k]) for p, r in zip(prog_terms, ref_terms)]
        out[k] = max(gaps) if gaps else float("nan")
    return out


def train_checks(prog: dict, ref: dict, limits: Dict[str, float]) -> Dict[str, dict]:
    steps = len(ref["losses"])
    losses = prog["losses"] + [float("nan")] * (steps - len(prog["losses"]))
    loss_rel = max(abs(p - r["loss"]) / r["scale"] for p, r in zip(losses, ref["losses"]))
    terms = term_gaps(prog.get("terms", []), ref["losses"])
    if len(prog.get("terms", [])) < steps:
        terms["rec_loss"] = terms["commit_loss"] = float("nan")
    rec, commit = terms.pop("rec_loss"), terms.pop("commit_loss")
    grads = leaf_gaps(prog["first_grad"], ref["first_grad"], ref["first_grad"])
    grad_leaf = max(grads, key=grads.get)
    floor = statistics.median(ref["first_grad"].values())
    moved = [k for k, g in ref["first_grad"].items() if g >= NEGLIGIBLE_GRADIENT * floor]
    update_gap, update_leaf = worst_leaf(prog["change"], ref["change"], moved)
    images_differ = sum(a != b for a, b in zip(prog["images"], ref["images"])) + abs(len(prog["images"]) - steps)
    checks = {
        "loss_rec": {"value": rec, "limit": limits["loss_rec"], "loss_rel": loss_rel,
                     "ref_grad_norm": [r["grad_norm"] for r in ref["losses"]], **terms},
        "loss_commit": {"value": commit, "limit": limits["loss_commit"]},
        "grad_gap": {"value": statistics.median(grads.values()), "limit": limits["grad_gap"],
                     "worst": grads[grad_leaf], "leaf": grad_leaf},
        "update_gap": {"value": update_gap, "limit": limits["update_gap"], "leaf": update_leaf},
        "images_differ": {"value": images_differ, "limit": 0},
    }
    return checks


def pixel_checks(errors, failed: int, limits: Dict[str, float]) -> Dict[str, dict]:
    """errors: (mse, rmse) of every answer of the window against the reference's pixels."""
    mse = [e[0] for e in errors] or [float("nan")]
    rmse = [e[1] for e in errors] or [float("nan")]
    return {
        "pixel_mse": {"value": sum(mse) / len(mse), "limit": limits["pixel_mse"], "worst_rmse": max(rmse),
                      "median_rmse": statistics.median(rmse)},
        "bad_answers": {"value": sum(r > limits["answer_rmse"] for r in rmse), "limit": 0},
        "failed_calls": {"value": failed, "limit": 0},
    }


def passed(checks: Dict[str, dict]) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
