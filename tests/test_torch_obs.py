"""The port's spans and counters (dct_autoencoder_torch/obs.py), on the CPU.

The gate of a span, a thread started before the profiler, the copies' byte
counts, the spans that a tiny LFQ train step and a tiny
``reconstruct_direct`` open, and the link from a backward event to its
forward op under ``dct.loss.entropy`` by autograd's sequence number.
"""
import random
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dct_autoencoder_torch as dt
from dct_autoencoder_torch import obs
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig, TransformerConfig
from dct_autoencoder_torch.train import loop as tloop
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

BACKWARD_EVENT = "autograd::engine::evaluate_function"


def _config() -> DCTAutoencoderConfig:
    tc = TransformerConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2)
    return DCTAutoencoderConfig(
        image_channels=3, patch_size=4, max_patch_h=8, max_patch_w=8, vq_codebook_size=64, vq_num_codebooks=2,
        vq_type="lfq", encoder_config=tc, decoder_config=tc,
    )


def _images(n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.1, 0.9, size=(3, size, size)).astype(np.float32) for _ in range(n)]


def _profile():
    return profile(activities=[ProfilerActivity.CPU], experimental_config=obs.all_threads_config())


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _names(prof):
    return {e.name() for e in _events(prof)}


def test_a_span_with_the_profiler_off_is_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert obs.span("dct.x.y") is obs.span("dct.z.w") is obs._OFF
    with obs.span("dct.x.y") as s:
        assert s is None


def test_no_record_function_runs_with_the_profiler_off(monkeypatch):
    """A train step, a packed batch and reconstruct_direct call no record_function unless a profiler runs."""
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: calls.append(a) or real(*a, **k))
    model, proc = dt.get_model_and_processor(_config(), sample_patches_beta=0.0, device="cpu")
    proc.rng = random.Random(0)
    ds = proc.preprocess_many(_images(3))
    stream = iter([{k: [d[k] for d in ds] for k in ds[0]}] * 2)
    tloop.train(model, proc, stream, batch_size=None, max_iters=2, prefetch_batches=1, log_every=1,
                log=lambda _: None)
    dt.DCTPipeline(model, proc).reconstruct_direct(_images(2), as_uint8=True)
    assert calls == []


def test_a_thread_started_before_the_profiler_is_recorded_under_all_threads():
    """The gate reads the process-wide flag: a worker started before the profiler opens its spans."""
    stop, ready = threading.Event(), threading.Event()

    def worker():
        ready.set()
        while not stop.is_set():
            with obs.span("dct.test.worker"):
                torch.ones(4).sum()
            stop.wait(0.002)

    t = threading.Thread(target=worker, name="obs-worker")
    t.start()
    try:
        assert ready.wait(10)
        with _profile() as prof:
            with obs.span("dct.test.main"):
                stop.wait(0.05)
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    events = _events(prof)
    spans = [e for e in events if e.name() == "dct.test.worker"]
    (main,) = [e for e in events if e.name() == "dct.test.main"]
    assert spans and all(e.is_user_annotation() for e in spans)
    assert {e.start_thread_id() for e in spans} == {spans[0].start_thread_id()} != {main.start_thread_id()}


def test_copies_count_bytes_across_host_and_device_only(monkeypatch):
    monkeypatch.setattr(obs, "_COUNTS", {})
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    same = obs.to_device(a, "cpu", "batch")
    assert torch.equal(same, torch.from_numpy(a).to("cpu"))
    assert torch.equal(obs.to_host(same, "tokens"), same.cpu())
    assert obs.counts() == {}

    # the meta device stands in for a card: the copy crosses from the host
    up = obs.to_device(a, "meta", "batch")
    want = torch.from_numpy(a).to("meta")
    assert up.device == want.device and up.shape == want.shape and up.dtype == want.dtype
    obs.to_device(np.ones(5, dtype=np.int32), torch.device("meta"), "images")

    class OnDevice:  # a tensor on a card, as to_host sees it
        device = torch.device("meta")

        def numel(self):
            return 6

        def element_size(self):
            return 2

        def cpu(self):
            return torch.zeros(6, dtype=torch.float16)

    down = obs.to_host(OnDevice(), "pixels")
    assert torch.equal(down, torch.zeros(6, dtype=torch.float16))
    assert obs.counts() == {"copy.pageable_bytes": 48 + 20 + 12}


def test_a_copy_opens_its_span_under_the_profiler(monkeypatch):
    monkeypatch.setattr(obs, "_COUNTS", {})
    with _profile() as prof:
        obs.to_device(np.zeros(3, dtype=np.float32), "meta", "batch")
        obs.to_device(np.zeros(3, dtype=np.float32), "cpu", "images")
    names = _names(prof)
    assert "dct.copy.h2d.batch" in names and "dct.copy.h2d.images" not in names


@pytest.fixture(scope="module")
def train_trace():
    """A tiny LFQ train step under the CPU profiler, with its prefetch thread started before it."""
    torch.manual_seed(0)
    model, proc = dt.get_model_and_processor(_config(), sample_patches_beta=0.0, device="cpu")
    proc.rng = random.Random(0)
    pulls = []
    for i in range(5):  # the worker packs the last two while the profiler runs
        ds = proc.preprocess_many(_images(3, seed=i))
        pulls.append({k: [d[k] for d in ds] for k in ds[0]})
    seen = []

    def log(d):
        seen.append(d["step"])
        if d["step"] == 0:
            log.prof = _profile()
            log.prof.start()

    tloop.train(model, proc, iter(pulls), batch_size=None, max_iters=5, prefetch_batches=1, log_every=1, log=log)
    log.prof.stop()
    assert seen == [0, 1, 2, 3, 4]
    return log.prof


def test_a_tiny_lfq_train_step_opens_the_train_and_loss_spans(train_trace):
    names = _names(train_trace)
    for span in ("dct.train.step", "dct.train.forward", "dct.train.backward", "dct.train.optimizer",
                 "dct.train.log", "dct.loss.entropy", "dct.loss.rec", "dct.loss.commit", "dct.model.encoder", "dct.model.quantize",
                 "dct.model.decoder", "dct.prefetch.wait", "dct.prefetch.produce", "dct.pack.rows",
                 "dct.pack.collate"):
        assert span in names, span
    # the packer's spans are on the prefetch thread, which started before the profiler
    threads = {e.name(): e.start_thread_id() for e in _events(train_trace)}
    assert threads["dct.pack.rows"] == threads["dct.prefetch.produce"] != threads["dct.train.forward"]


def test_backward_events_map_by_sequence_number_to_a_forward_op_under_the_entropy_loss(train_trace):
    events = _events(train_trace)
    entropy = [e for e in events if e.name() == "dct.loss.entropy"]
    forward = {(e.start_thread_id(), e.sequence_nr()): e for e in events
               if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0 and not e.name().startswith(BACKWARD_EVENT)}
    mapped = []
    for e in events:
        if e.name().startswith(BACKWARD_EVENT) and e.sequence_nr() >= 0:
            f = forward.get((e.fwd_thread_id(), e.sequence_nr()))
            if f is not None and any(s.start_thread_id() == f.start_thread_id()
                                     and s.start_ns() <= f.start_ns() <= s.start_ns() + s.duration_ns()
                                     for s in entropy):
                mapped.append(e.name().split(":")[-1].strip())
    assert {"LogSoftmaxBackward0", "ExpBackward0"} <= set(mapped), mapped


def test_a_tiny_reconstruct_direct_opens_the_serving_front_and_packing_spans(monkeypatch):
    monkeypatch.setattr(obs, "_COUNTS", {})
    pipe = dt.DCTPipeline.from_config(_config(), sample_patches_beta=0.0, dtype=torch.float32, device="cpu")
    with _profile() as prof:
        out = pipe.reconstruct_direct(_images(2), as_uint8=True)
    assert len(out) == 2 and out[0].dtype == np.uint8
    names = _names(prof)
    for span in ("dct.serve.reconstruct", "dct.serve.forward", "dct.serve.backend", "dct.front.preprocess",
                 "dct.pack.rows", "dct.pack.collate", "dct.model.encoder", "dct.model.quantize", "dct.model.decoder"):
        assert span in names, span
    assert not any(n.startswith("dct.copy.") for n in names)  # every copy stays on the host here
    assert obs.counts().get("copy.pageable_bytes", 0) == 0
