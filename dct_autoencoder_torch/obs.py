"""The program's spans and counters, read from a profiler's trace.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler is
running, else one shared no-op context: with the profiler off a span costs a
flag read.  The gate is ``torch.autograd.profiler._is_profiler_enabled``,
which the profiler sets for the whole process; ``torch.autograd._profiler_enabled()``
is per thread and reads False on a thread other than the one that started
the profiler.  Spans are named ``dct.<layer>.<what>``.  They are the
profiler's host events, so they share the trace's clock with the device's
operations; a thread started before the profiler is recorded only when the
profiler records every thread (``all_threads_config``).

``count`` and ``counts`` keep a dict of numbers; ``train/cli.py
--profile_dir`` writes their change over the profiled block into
``spans.json`` (``obs_trace.py``).

``to_device`` and ``to_host`` are the host path's copies:
``torch.from_numpy(a).to(device)`` and ``.cpu()``, pageable, without
``non_blocking``.  A copy that crosses between the host and the device opens
``dct.copy.<h2d|d2h>.<site>`` and adds its bytes to ``copy.pageable_bytes``;
a copy from the host to the host counts nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_LOCK = threading.Lock()


def span(name: str):
    """A profiler span named `name` while a profiler runs, else the shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def all_threads_config():
    """The profiler's `experimental_config` that records every thread, those started before it too."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A snapshot of the program's counters."""
    with _LOCK:
        return dict(_COUNTS)


def _pageable_copy(t: torch.Tensor, span_name: str, copy):
    with span(span_name):
        out = copy()
    count("copy.pageable_bytes", t.numel() * t.element_size())
    return out


def to_device(a: np.ndarray, device, site: str) -> torch.Tensor:
    """`torch.from_numpy(a).to(device)`; a copy to a device opens `dct.copy.h2d.<site>`."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cpu":
        return t.to(device)
    return _pageable_copy(t, f"dct.copy.h2d.{site}", lambda: t.to(device))


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """`t.cpu()`: a new pageable tensor on the host when `t` is on the device (span `dct.copy.d2h.<site>`)."""
    if t.device.type == "cpu":
        return t.cpu()
    return _pageable_copy(t, f"dct.copy.d2h.{site}", t.cpu)
