"""Device time, idle time and host time of a profile put down to the program's spans.

The program opens `dct.<layer>.<what>` spans (`obs.span`) where its work
happens; they are the profiler's host events, on the clock of its device
operations.  `summarize` reads a finished profile's raw events between the
edges of a marker span that the caller opened around the profiled block
(`train/cli.py --profile_dir` writes the result to `spans.json`):

- a device operation goes to the innermost `dct.` span open on its launching
  thread at its runtime call; the call and the operation share a correlation
  id;
- a launch inside an autograd `evaluate_function` event goes to the innermost
  `dct.` span around the forward op that has the event's `sequence_nr` on its
  `fwd_thread_id`, and counts as that span's backward time (a checkpoint's
  recompute runs inside such an event, and lands there too);
- a launch that neither rule puts down, from a thread with no `dct.` span
  open (autograd's own work, such as gradient accumulation), goes to the
  main thread's innermost `dct.` span at its runtime call;
- device-idle time goes to the innermost `dct.` span open on each thread at
  that moment; `copy_idle_s` is the idle time during which any thread's
  innermost span is a copy (`dct.copy.*`), so it never exceeds the idle time.

A span's device time counts every operation put down to it or to a span
nested in it; `root_device_s` only those whose outermost span it is, so the
roots' sum is the device time the spans cover, and `root_share` gives it by
layer (a root span's first two name parts) as a share of all the device
operations' time.  Host time is clipped to the marker's span; `host_self_s`
leaves out the span's `dct.` children.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

PREFIX = "dct."
COPY_PREFIX = "dct.copy."
BACKWARD_EVENT = "autograd::engine::evaluate_function"
NO_CALL = "(no runtime call)"


@dataclasses.dataclass(frozen=True)
class HostEvent:
    """A host event of the trace: a span, an op, or a runtime call (`cuda*`, `cu*`)."""

    name: str
    start: int  # ns
    end: int
    thread: int  # the profiler's id of the thread (the forward ops' `fwd_thread_id` uses the same)
    corr: int = 0  # a runtime call's correlation id, which its device operation shares
    seq: int = -1  # autograd's sequence number (forward ops and `evaluate_function` events)
    fwd_thread: int = 0  # on an `evaluate_function` event: the thread of its forward op
    annotation: bool = False  # a `record_function` span


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: int
    end: int
    corr: int


def is_runtime_call(e: HostEvent) -> bool:
    return not e.annotation and e.name.startswith("cu")


class Timeline:
    """The stack of spans open on one thread, piecewise constant between span edges."""

    def __init__(self, spans: Iterable[HostEvent]):
        edges: List[Tuple[int, int, int, HostEvent]] = []
        for e in spans:
            # at one instant, closes before opens; the longer span opens first and closes last
            edges.append((e.start, 1, -(e.end - e.start), e))
            edges.append((e.end, 0, e.end - e.start, e))
        edges.sort(key=lambda x: x[:3])
        self.times: List[int] = []
        self.stacks: List[Tuple[HostEvent, ...]] = []
        self.parent: Dict[HostEvent, Optional[HostEvent]] = {}
        stack: List[HostEvent] = []
        for t, opening, _, e in edges:
            if opening:
                self.parent[e] = stack[-1] if stack else None
                stack.append(e)
            elif e in stack:
                stack.remove(e)
            if self.times and self.times[-1] == t:
                self.stacks[-1] = tuple(stack)
            else:
                self.times.append(t)
                self.stacks.append(tuple(stack))

    def at(self, t: int) -> Tuple[HostEvent, ...]:
        """The spans open at time t, outermost first."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.stacks[i] if i >= 0 else ()

    def segments(self, lo: int, hi: int):
        """(a, b, stack) for each stretch of [lo, hi) with one stack."""
        bounds = self.times + [hi]
        for i, stack in enumerate(self.stacks):
            a, b = max(bounds[i], lo), min(bounds[i + 1], hi)
            if b > a:
                yield a, b, stack


def _overlap(a: int, b: int, gaps: Sequence[Tuple[int, int]], gap_starts: Sequence[int]) -> int:
    """Length of [a, b) inside the sorted, disjoint `gaps`."""
    total = 0
    for g0, g1 in gaps[max(bisect.bisect_right(gap_starts, a) - 1, 0):]:
        if g0 >= b:
            break
        total += max(0, min(b, g1) - max(a, g0))
    return total


def attribute(host: Sequence[HostEvent], device: Sequence[DeviceOp], lo: int, hi: int,
              gaps: Sequence[Tuple[int, int]], main_thread: Optional[int]) -> dict:
    """`spans` (per span name: opened, host_s, host_self_s, device_s, device_bwd_s, root_device_s, idle_s),
    `copy_idle_s`, `unattributed_s` and `unattributed_by_op` (the ten largest, and of them the time whose runtime call
    is missing from the events under the key "(no runtime call)") of the traced span [lo, hi), whose idle gaps are
    `gaps`."""
    backward: Dict[int, List[HostEvent]] = defaultdict(list)
    runtime: Dict[int, HostEvent] = {}
    forward: Dict[Tuple[int, int], HostEvent] = {}
    for e in host:
        if e.annotation:
            continue
        if e.name.startswith(BACKWARD_EVENT):
            backward[e.thread].append(e)
        elif is_runtime_call(e):
            runtime[e.corr] = e
        elif e.seq >= 0 and e.fwd_thread == 0:
            key = (e.thread, e.seq)
            if key not in forward or e.start < forward[key].start:
                forward[key] = e
    lines = timelines(host)
    autograd = {th: Timeline(evs) for th, evs in backward.items()}
    stats: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(
        ("opened", "host_s", "host_self_s", "device_s", "device_bwd_s", "root_device_s", "idle_s"), 0))

    def chain_at(thread: int, t: int) -> Tuple[HostEvent, ...]:
        line = lines.get(thread)
        return line.at(t) if line is not None else ()

    unattributed: Dict[str, int] = defaultdict(int)
    for op in device:
        a, b = max(op.start, lo), min(op.end, hi)
        call = runtime.get(op.corr)
        if b <= a:
            continue
        if call is None:
            unattributed[NO_CALL] += b - a
            continue
        chain, key = (), "device_s"
        node = autograd[call.thread].at(call.start) if call.thread in autograd else ()
        if node and node[-1].seq >= 0:
            fwd = forward.get((node[-1].fwd_thread, node[-1].seq))
            if fwd is not None:
                chain, key = chain_at(fwd.thread, fwd.start), "device_bwd_s"
        if not chain:
            chain, key = chain_at(call.thread, call.start), "device_s"
        if not chain and main_thread is not None:
            chain = chain_at(main_thread, call.start)
        if not chain:
            unattributed[op.name] += b - a
            continue
        for name in {s.name for s in chain}:
            stats[name][key] += b - a
        stats[chain[0].name]["root_device_s"] += b - a

    gap_starts = [g[0] for g in gaps]
    copy_idle: List[Tuple[int, int]] = []
    for th, line in lines.items():
        for e, parent in line.parent.items():
            a, b = max(e.start, lo), min(e.end, hi)
            if lo <= e.start < hi:
                stats[e.name]["opened"] += 1
            if b > a:
                stats[e.name]["host_s"] += b - a
                stats[e.name]["host_self_s"] += b - a
                if parent is not None:
                    stats[parent.name]["host_self_s"] -= b - a
        for a, b, stack in line.segments(lo, hi):
            if stack:
                stats[stack[-1].name]["idle_s"] += _overlap(a, b, gaps, gap_starts)
                if stack[-1].name.startswith(COPY_PREFIX):
                    copy_idle.append((a, b))
    copy_idle_ns = sum(_overlap(a, b, gaps, gap_starts) for a, b in union(copy_idle))
    spans = {name: {k: (v if k == "opened" else v * 1e-9) for k, v in s.items()} for name, s in sorted(stats.items())}
    largest = sorted(unattributed.items(), key=lambda kv: -kv[1])[:10]
    return {"spans": spans, "copy_idle_s": copy_idle_ns * 1e-9, "unattributed_s": sum(unattributed.values()) * 1e-9,
            "unattributed_by_op": {name[:100]: ns * 1e-9 for name, ns in largest}}


def timelines(host: Iterable[HostEvent]) -> Dict[int, Timeline]:
    """Each thread's timeline of its `dct.` spans."""
    by_thread: Dict[int, List[HostEvent]] = defaultdict(list)
    for e in host:
        if e.annotation and e.name.startswith(PREFIX):
            by_thread[e.thread].append(e)
    return {th: Timeline(spans) for th, spans in by_thread.items()}


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The sorted, disjoint union of half-open intervals."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read_events(events, marker: str):
    """(host events, device operations, the marker's start and end, its thread) of a profile's raw events."""
    host: List[HostEvent] = []
    device: List[DeviceOp] = []
    window = None
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        annotation = e.is_user_annotation()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not annotation:  # a span's shadow on the device timeline is no operation
                device.append(DeviceOp(e.name(), a, b, e.correlation_id()))
            continue
        if e.name() == marker:
            window = (a, b, e.start_thread_id())
        host.append(HostEvent(name=e.name(), start=a, end=b, thread=e.start_thread_id(), corr=e.correlation_id(),
                              seq=e.sequence_nr(), fwd_thread=e.fwd_thread_id(), annotation=annotation))
    if window is None:
        raise ValueError(f"the marker span {marker!r} is missing from the profile's events")
    return host, device, *window


def summarize(events, marker: str, counts_before: Dict[str, int], counts_after: Dict[str, int]) -> dict:
    """The profile's device and idle time by program span, between the edges of the span `marker`, with the
    program's counters that changed over it and by how much."""
    host, device, lo, hi, main = read_events(events, marker)
    device = [DeviceOp(d.name, max(d.start, lo), min(d.end, hi), d.corr) for d in device if d.end > lo and d.start < hi]
    busy = union((d.start, d.end) for d in device)
    gaps = [(a, b) for a, b in zip([lo] + [b for _, b in busy], [a for a, _ in busy] + [hi]) if b > a]
    out = attribute(host, device, lo, hi, gaps, main)
    device_s = sum(d.end - d.start for d in device) * 1e-9
    roots: Dict[str, float] = defaultdict(float)
    for name, s in out["spans"].items():
        roots[".".join(name.split(".")[:2])] += s["root_device_s"]
    out.update(
        window_s=(hi - lo) * 1e-9, busy_s=sum(b - a for a, b in busy) * 1e-9, device_s=device_s,
        root_share={k: v / device_s for k, v in sorted(roots.items()) if v} if device_s else {},
        counts={k: v - counts_before.get(k, 0) for k, v in counts_after.items() if v != counts_before.get(k, 0)},
    )
    return out
