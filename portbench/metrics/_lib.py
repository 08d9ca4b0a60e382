"""What the per-layer readers share.  A reader returns None where its run has
nothing for it to read, and the metric is then left out of the line."""
from __future__ import annotations

import json
import os
from typing import Optional

from .. import flops
from ..trace import family_seconds

KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernels")


def patterns(family: str):
    with open(os.path.join(KERNELS, family + ".json")) as f:
        return json.load(f)["patterns"]


def mfu(cell, counters) -> Optional[float]:
    """Model FLOPs of the window over its wall time and the cell's chips' bf16 peak, in %."""
    if not counters.get("window_s"):
        return None
    return 100.0 * counters["model_flops"] / (counters["window_s"] * cell.chips * flops.BF16_FLOPS)


def idle_share(cell, counters) -> Optional[float]:
    """The traced span's share, in %, in which no operation ran on the device."""
    t = counters.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def share(bound_s: float, seconds: float) -> Optional[float]:
    return 100.0 * bound_s / seconds if seconds > 0 else None


def family_time(counters, *families) -> float:
    t = counters["trace"]["device_s_by_name"]
    return sum(family_seconds(t, patterns(f)) for f in families)
