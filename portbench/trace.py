"""The benchmark's device trace: torch.profiler (CUPTI) over a short steady
span, read from the raw events, without the profiler's own aggregation.

`Trace.start()` and `Trace.stop()` bracket the span (the device synchronized
at both ends); `summary()` gives what the per-layer readers need: the span's
length, the union of device operations (kernels, copies, fills) within it,
device seconds by operation name, and the longest idle gaps labelled by what
the host was doing (the innermost benchmark span and host operation open at
the gap's start).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.traced"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(intervals: Iterable[Tuple[int, int]]) -> int:
    return sum(b - a for a, b in intervals)


class Trace:
    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def summary(self, top: int = 10) -> dict:
        events = self.prof.profiler.kineto_results.events()
        lo = hi = None
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str, bool]] = []
        for e in events:
            a, n = e.start_ns(), e.duration_ns()
            annotation = bool(getattr(e, "is_user_annotation", lambda: False)())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a span's shadow on the device timeline is no operation
                if not annotation and "annotation" not in str(getattr(e, "activity_type", lambda: "")()):
                    device.append((a, a + n, e.name()))
            else:
                if e.name() == WINDOW_SPAN:
                    lo, hi = a, a + n
                host.append((a, a + n, e.name(), annotation))
        if lo is None:
            raise RuntimeError("the traced span's marker is missing from the profiler's events")
        device = [(max(a, lo), min(b, hi), name) for a, b, name in device if b > lo and a < hi]
        busy = _union([(a, b) for a, b, _ in device])
        by_name: Dict[str, int] = defaultdict(int)
        for a, b, name in device:
            by_name[name] += b - a
        gaps = [(a, b) for a, b in zip([lo] + [b for _, b in busy], [a for a, _ in busy] + [hi]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        host.sort()
        starts = [h[0] for h in host]
        labelled = [(self._label(host, starts, a), (b - a) * 1e-9) for a, b in gaps[:top]]
        return {
            "window_s": (hi - lo) * 1e-9,
            "busy_s": _length(busy) * 1e-9,
            "device_s_by_name": {k: v * 1e-9 for k, v in by_name.items()},
            "device_ops": sorted(([k, v * 1e-9] for k, v in by_name.items()), key=lambda r: -r[1])[:top],
            "idle_gaps": labelled,
        }

    @staticmethod
    def _label(host, starts, t: int) -> str:
        """The innermost benchmark span and host operation open at time t."""
        span: Optional[Tuple[int, str]] = None
        op: Optional[Tuple[int, str]] = None
        for a, b, name, annotation in host[: bisect.bisect_right(starts, t)]:
            if b >= t and name != WINDOW_SPAN:
                if annotation and (span is None or b - a < span[0]):
                    span = (b - a, name)
                elif not annotation and (op is None or b - a < op[0]):
                    op = (b - a, name)
        parts = [x[1] for x in (span, op) if x is not None]
        return " / ".join(parts) if parts else "host"


def family_seconds(device_s_by_name: Dict[str, float], patterns: Iterable[str]) -> float:
    """Device seconds of the operations whose name holds any of `patterns`."""
    pats = list(patterns)
    return sum(v for k, v in device_s_by_name.items() if any(p in k for p in pats))
