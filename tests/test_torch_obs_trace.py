"""dct_autoencoder_torch/obs_trace.py's reading of the program's spans, on stub
events: a launch put down to its span by correlation id, a backward launch put
down to its forward op's span, the copy-idle rule, a span's shadow on the
device timeline, and the share of the device's time under each layer's
outermost spans."""
import random

import pytest
import torch

from dct_autoencoder_torch import obs_trace as sp
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

MARKER = "cli.profiled"

MAIN, AUTOGRAD, PREFETCH = 1, 2, 3
MS = 1_000_000  # ns


def span(name, a, b, thread=MAIN):
    return sp.HostEvent(name, a * MS, b * MS, thread, annotation=True)


def call(corr, t, thread=MAIN):
    return sp.HostEvent("cudaLaunchKernel", t * MS, t * MS + MS // 10, thread, corr=corr)


def op(corr, a, b):
    return sp.DeviceOp(f"kernel{corr}", a * MS, b * MS, corr)


def attribute(host, device, gaps=(), lo=0, hi=100):
    return sp.attribute(host, device, lo * MS, hi * MS, [(a * MS, b * MS) for a, b in gaps], MAIN)


def ms(x):
    return round(x * 1e3, 6)


def test_a_launch_goes_to_the_innermost_span_open_at_its_runtime_call():
    host = [span("dct.train.forward", 0, 50), span("dct.model.encoder", 10, 20), span("dct.loss.entropy", 30, 40),
            call(7, 15), call(8, 35), call(9, 45), call(10, 60)]
    # the operations run later than their calls; the correlation id, not the time, says which call
    out = attribute(host, [op(7, 36, 38), op(8, 46, 50), op(9, 61, 62), op(10, 70, 71), op(11, 80, 81)])
    s = out["spans"]
    assert ms(s["dct.model.encoder"]["device_s"]) == 2 and ms(s["dct.loss.entropy"]["device_s"]) == 4
    assert ms(s["dct.train.forward"]["device_s"]) == 7  # nested spans count in their parent too
    assert ms(s["dct.train.forward"]["root_device_s"]) == 7 and s["dct.model.encoder"]["root_device_s"] == 0
    assert ms(out["unattributed_s"]) == 2  # a call outside every span, and an operation with no call
    assert {k: ms(v) for k, v in out["unattributed_by_op"].items()} == {"kernel10": 1, sp.NO_CALL: 1}
    assert s["dct.train.forward"]["opened"] == s["dct.model.encoder"]["opened"] == 1


def test_a_backward_launch_goes_to_its_forward_op_s_span_and_is_kept_apart():
    fwd = sp.HostEvent("aten::_log_softmax", 32 * MS, 33 * MS, MAIN, seq=41)
    node = sp.HostEvent("autograd::engine::evaluate_function: LogSoftmaxBackward0", 60 * MS, 70 * MS, AUTOGRAD,
                        seq=41, fwd_thread=MAIN)
    acc = sp.HostEvent("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", 72 * MS, 74 * MS,
                       AUTOGRAD)
    host = [span("dct.train.forward", 0, 50), span("dct.loss.entropy", 30, 40), fwd, call(1, 31),
            span("dct.train.backward", 55, 80), node, call(2, 65, AUTOGRAD), acc, call(3, 73, AUTOGRAD)]
    s = attribute(host, [op(1, 31, 32), op(2, 66, 69), op(3, 74, 75)])["spans"]
    assert ms(s["dct.loss.entropy"]["device_s"]) == 1 and ms(s["dct.loss.entropy"]["device_bwd_s"]) == 3
    assert ms(s["dct.train.forward"]["device_bwd_s"]) == 3
    # autograd's own work, with no forward op, goes to the main thread's span at its call
    assert ms(s["dct.train.backward"]["device_s"]) == 1 and s["dct.train.backward"]["device_bwd_s"] == 0


def test_copy_idle_is_idle_time_under_any_thread_s_copy_span_and_never_exceeds_the_idle_time():
    host = [span("dct.serve.reconstruct", 0, 100), span("dct.copy.d2h.tokens", 10, 30),
            span("dct.pack.rows", 5, 60, PREFETCH), span("dct.copy.h2d.batch", 20, 40, PREFETCH)]
    out = attribute(host, [], gaps=[(0, 15), (25, 35), (50, 100)])
    assert ms(out["copy_idle_s"]) == 5 + 10  # [10, 15) and [25, 35): the two threads' copies counted once
    s = out["spans"]
    assert ms(s["dct.copy.d2h.tokens"]["idle_s"]) == 5 + 5 and ms(s["dct.copy.h2d.batch"]["idle_s"]) == 10
    assert ms(s["dct.pack.rows"]["idle_s"]) == 10 + 10  # [5, 15) and [50, 60): where the copy is not innermost
    assert ms(s["dct.serve.reconstruct"]["host_self_s"]) == 80
    rng = random.Random(3)
    for _ in range(200):
        host = []
        for th in (MAIN, AUTOGRAD, PREFETCH):
            t = 0
            while t < 95:
                a = t + rng.randint(0, 5)
                b = min(a + rng.randint(1, 20), 100)
                host.append(span(rng.choice(["dct.copy.h2d.batch", "dct.pack.rows"]), a, b, th))
                if rng.random() < 0.5 and b - a > 2:
                    host.append(span("dct.copy.d2h.tokens", a + 1, b - 1, th))
                t = b
        edges = sorted(rng.sample(range(1, 100), 8))
        gaps = list(zip(edges[::2], edges[1::2]))
        out = attribute(host, [], gaps=gaps)
        assert out["copy_idle_s"] <= sum(b - a for a, b in gaps) * 1e-3 + 1e-12


class _Kineto:
    """A stub of the profiler's event, as obs_trace.read_events reads it."""

    def __init__(self, name, a, b, thread=MAIN, device=False, annotation=False, corr=0, seq=-1, fwd_thread=0):
        self._v = dict(name=name, start_ns=a * MS, duration_ns=(b - a) * MS, start_thread_id=thread,
                       is_user_annotation=annotation, correlation_id=corr, sequence_nr=seq, fwd_thread_id=fwd_thread)
        self._device = device

    def __getattr__(self, k):
        return lambda: self._v[k]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU


def test_a_span_s_shadow_on_the_device_timeline_stays_out_of_busy_and_time_outside_the_marker_is_cut():
    events = [
        _Kineto(MARKER, 0, 100, annotation=True),
        _Kineto("dct.train.backward", 10, 90, annotation=True),
        _Kineto("cudaLaunchKernel", 12, 13, corr=5),
        _Kineto("dct.train.backward", 10, 90, device=True, annotation=True),  # its shadow on the device
        _Kineto("gemm", 20, 30, device=True, corr=5),
        _Kineto("gemm", 95, 110, device=True, corr=6),  # runs past the marker's end
    ]
    s = sp.summarize(events, MARKER, {"copy.pageable_bytes": 10, "y": 2}, {"copy.pageable_bytes": 25, "x": 1, "y": 2})
    assert ms(s["window_s"]) == 100 and ms(s["busy_s"]) == 15 and ms(s["device_s"]) == 15
    assert ms(s["spans"]["dct.train.backward"]["device_s"]) == 10 and ms(s["unattributed_s"]) == 5
    assert s["root_share"] == {"dct.train": pytest.approx(10 / 15)}
    assert s["counts"] == {"copy.pageable_bytes": 15, "x": 1}
    assert ms(s["spans"]["dct.train.backward"]["idle_s"]) == 80 - 10  # [10, 90) less the gemm's [20, 30)


def test_the_layer_shares_are_the_outermost_spans_device_time_and_with_the_rest_make_the_whole():
    """root_share reckoned from root_device_s and unattributed_s: every operation's time counted once."""
    rng = random.Random(5)
    for _ in range(50):
        events = [_Kineto(MARKER, 0, 200, annotation=True)]
        t = 0
        for name in ("dct.train.step", "dct.model.encoder", "dct.prefetch.wait"):
            a = t + rng.randint(0, 10)
            t = a + rng.randint(20, 60)
            events.append(_Kineto(name, a, t, annotation=True))
            if name == "dct.train.step":
                events.append(_Kineto("dct.loss.entropy", a + 5, t - 5, annotation=True))
        for corr in range(1, 40):
            a = rng.randint(0, 195)
            events += [_Kineto("cudaLaunchKernel", a, a + 1, corr=corr),
                       _Kineto("k", a + 1, a + 1 + rng.randint(1, 4), device=True, corr=corr)]
        s = sp.summarize(events, MARKER, {}, {})
        roots = sum(v["root_device_s"] for v in s["spans"].values())
        assert roots + s["unattributed_s"] == pytest.approx(s["device_s"])
        assert sum(s["root_share"].values()) == pytest.approx(roots / s["device_s"])
        assert set(s["root_share"]) <= {"dct.train", "dct.model", "dct.prefetch"}


def test_a_profile_without_the_marker_is_refused():
    with pytest.raises(ValueError, match="cli.profiled"):
        sp.summarize([_Kineto("dct.train.step", 0, 10, annotation=True)], MARKER, {}, {})
