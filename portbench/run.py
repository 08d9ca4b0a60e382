"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and limits are files found by the names
in BENCHMARK.json (configs/, traffic/, limits/); its kind of traffic names the
driver (kinds/<kind>.py) and each per-layer metric its reader
(metrics/<metric>.py).  The last line of standard output is one JSON object;
the compared numbers and their limits are the last lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import common  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_cell(args, device: str = "cuda", t0: float = T0) -> common.Cell:
    spec = common.find_cell(args.workload)
    chips = spec["workload"]["chips"]
    return common.Cell(
        name=args.workload, config=spec["config"], traffic=spec["traffic"], chips=chips, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), end_to_end=spec["end_to_end"], per_layer=spec["per_layer"],
        limits=spec["limits"], device=device, t0=t0,
    )


def kind(cell: common.Cell):
    return importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")


def reader(metric: str, root: str = common.HERE):
    """The reader of a per-layer metric: metrics/<metric>.py's `read(cell, counters)`."""
    path = os.path.join(root, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def result_line(cell: common.Cell, res: dict, torch) -> dict:
    counters = res["counters"]
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(cell, counters)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: res["e2e"][m["name"]] for m in cell.end_to_end}
    device = common.device_info(torch, cell.chips, res["peak_bytes"])
    line = {"correct": None, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
            "device": device}
    if cell.trace and "trace" in counters:
        t = counters["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": [list(g) for g in t["idle_gaps"]]}
    from portbench.reference.compare import passed

    line["correct"] = passed(res["checks"]) and res["failed"] == 0
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in res["checks"].items()}
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _args(argv)
    common.cache_dirs()
    cell = make_cell(args)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    res = kind(cell).result(cell, kind(cell).run(cell))
    line = result_line(cell, res, torch)
    banned = common.banned_modules()
    if banned:
        print(f"modules of JAX or the JAX package were loaded: {banned}", file=sys.stderr)
        return 4
    print("set-up phases, s from the start: " + json.dumps(res["phases"]), file=sys.stderr)
    extra = {k: {n: x for n, x in v.items() if n not in ("value", "limit")} for k, v in res["checks"].items()}
    print("beside the checks: " + json.dumps({k: v for k, v in extra.items() if v}), file=sys.stderr)
    common.report_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
