"""The readings the limits are set from, on the card at the cell's own size.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--program] [--control] [--faults a,b]
                                   [--seconds 2] [--out chiprun_out/calib.jsonl] [--device cpu]

--program: sound runs of the program (the harness's own run, a short window),
each compared number as the run reads it (the lower readings);
--control: the reference computed in float8 in the program's place, against
the float32 reference (the upper readings); --look: the same in bfloat16,
the configurations' own precision (what that precision alone reads);
--faults: the program with each fault of faults.py planted under the timed path.
One JSON line a reading, with the device it was read on, on standard output
and appended to --out.  Without a CUDA device it exits 3, as a run does;
--device cpu reads on the CPU instead (for a small cell in the tests).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import common, inputs, run  # noqa: E402
from portbench.reference import compare  # noqa: E402


def lower_precision(cell: common.Cell, device, quant: str = "fp8") -> dict:
    """The reference computed in `quant` in the program's place, against the float32 reference."""
    from portbench.kinds import recon, train
    from portbench.reference import model as ref_model

    if cell.traffic["kind"] == "train":
        tr = cell.traffic
        batches = train.reference_batches(cell, tr["checked_steps"], device)
        weights = inputs.make_weights(cell.config, cell.seed, device)
        norm = inputs.make_norm(cell.config, tr["norm_side"], device)
        ref = ref_model.train_steps(weights, cell.config, batches, norm, tr["block_rows"])
        low = ref_model.train_steps(weights, cell.config, batches, norm, tr["block_rows"], quant=quant)
        prog = {"losses": [s["loss"] for s in low["losses"]], "terms": low["losses"],
                "images": [b["images"] for b in batches], "first_grad": low["first_grad"], "change": low["change"]}
        ref["images"] = prog["images"]
        return compare.train_checks(prog, ref, cell.limits)
    images = recon.pool(cell, device)
    ref = recon.reference_pixels(cell, images, device)
    low = recon.reference_pixels(cell, images, device, quant=quant)
    errors = [recon.pixel_error(a.cpu().numpy(), b.cpu().numpy()) for a, b in zip(low, ref)]
    return compare.pixel_checks(errors, 0, cell.limits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--look", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    common.cache_dirs()
    if a.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the readings are taken on the card (--device cpu reads on the CPU)", file=sys.stderr)
        return 3
    device = torch.device("cuda:0" if a.device == "cuda" else "cpu")
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    jobs = [("program", None)] * a.program + [("control", "fp8")] * a.control + [("look", "bf16")] * a.look
    jobs += [("fault", f) for f in a.faults.split(",") if f]
    for seed in [int(s) for s in a.seeds.split(",")]:
        for what, fault in jobs:
            args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
            cell = run.make_cell(args, device=device.type, t0=time.perf_counter())
            t = time.perf_counter()
            if what in ("control", "look"):
                checks = lower_precision(cell, device, fault)
            else:
                cell.fault = fault
                checks = run.kind(cell).run(cell)["checks"]
            row = {"workload": a.workload, "device": device_name, "seed": seed, "reading": what, "fault": fault, "s": time.perf_counter() - t,
                   "checks": {k: v["value"] for k, v in checks.items()},
                   "more": {k: {n: x for n, x in v.items() if n not in ("value", "limit")} for k, v in checks.items()}}
            print(json.dumps(row), flush=True)
            if a.out:
                os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
                with open(a.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
