"""What every kind of cell shares: the cell's files found by name, the cache
directories, the device's description, the check for JAX, and the limits."""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "dct_autoencoder_tpu")
PROGRAM = "dct_autoencoder_torch"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One run of one cell, as the command line and the cell's files describe it."""

    name: str
    config: dict  # the model configuration as it is run
    traffic: dict  # the traffic mix's parameters
    chips: int
    seed: int
    seconds: float
    trace: bool
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    device: str = "cuda"
    t0: float = 0.0  # the process's start, perf_counter
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)  # the compared numbers' limits
    fault: Optional[str] = None  # a fault of faults.py to plant (tests and calibrate.py only)


def in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, here: str = HERE) -> dict:
    """The cell's entry in BENCHMARK.json and its files, found by the names there."""
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == name:
            return dict(
                workload=w,
                config=dict(load_json(os.path.join(here, "configs", w["config"] + ".json")), name=w["config"]),
                traffic=load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                end_to_end=[m for m in bench["end_to_end"] if in_cell(m, name)],
                per_layer=[m for m in bench["per_layer"] if in_cell(m, name)],
                limits=load_json(os.path.join(here, "limits", name + ".json")),
            )
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def cache_dirs(root: str = ROOT) -> None:
    """Fixed compile-cache directories inside the checkout, for whatever the program builds with them."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BANNED))


def device_info(torch, chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": int(peak_bytes)}


def report_checks(checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit, as the last lines on standard error."""
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
