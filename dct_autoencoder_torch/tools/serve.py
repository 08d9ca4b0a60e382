"""Serving daemon: HTTP in front of a DCTPipeline, with dynamic micro-batching.

Usage:
  python -m dct_autoencoder_torch.tools.serve --model_path docs/calibrated_run_r3b/model \\
      [--port 8080] [--max_batch 16] [--batch_timeout_ms 5] [--ar_model_path out_ar/ar_model]

Counterpart of dct_autoencoder_tpu/tools/serve.py, with the same endpoints,
codecs, flags and overload behaviour.  It loads the checkpoint with
``DCTPipeline.from_pretrained`` (the gated int8 sibling when the checkpoint
earned it) on the card, with the shape buckets on (--pad_rows_to 8,
--pad_tokens_to 128).

Endpoints:
  POST /encode  {"image": [[...]]}           -> token record (to_dict schema)
  POST /decode  {record}                     -> {"image": [[...]]}
  POST /reconstruct {"image": ...}           -> {"image": ...}
  POST /generate {"n_tokens", "temperature", "seed", "prefix"?: [tokens],
                  "return_codes"?: bool}     -> {"image", "record"?}
                 (needs --ar_model_path; prefix tokens use the to_dict
                  schema and are teacher-forced)
  GET  /healthz  -> {"ok", "served", "batches", "queue_depth", "queue_max",
                     "rejected", "expired", "generate"}

Binary codec (the production path): `Content-Type: application/octet-stream`
with an .npy body --
  POST /encode       npy (c, h, w) float32 in [0, 1] or uint8  -> record (JSON)
  POST /reconstruct  npy image                                  -> npy uint8 (c, h, w)
  POST /decode       JSON record + `Accept: application/octet-stream` -> npy uint8

Overload: the request queue is bounded (--max_queue; overflow -> HTTP 429
with Retry-After) and each request carries a deadline for its time in the
queue (--request_deadline_s; exceeded -> HTTP 504, and a request that
expired while queued is dropped before it costs device time).

A batcher thread collects up to max_batch requests (waiting at most
batch_timeout_ms for stragglers) and runs one pipeline call per kind:
/reconstruct goes through ``reconstruct_direct``, whose uniform groups take
one back-end launch and one uint8 copy to the host.  Standard library and
numpy only, besides the port.
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


class QueueFull(Exception):
    """The bounded request queue is full: the HTTP layer answers 429."""


class DeadlineExceeded(Exception):
    """A request passed its deadline before it was served: HTTP 504."""


class _Request:
    __slots__ = ("kind", "payload", "event", "result", "error", "deadline")

    def __init__(self, kind: str, payload, deadline: Optional[float] = None):
        self.kind = kind
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.deadline = deadline  # a time.monotonic() timestamp or None

    def group_key(self):
        """Requests that share a key may ride one pipeline or sampler call."""
        if self.kind == "generate":
            # one batched sampler loop per (s, temperature) bucket
            return ("generate", self.payload["n_tokens"], self.payload["temperature"])
        return (self.kind,)


class BatchingServer:
    """Dynamic micro-batcher in front of a DCTPipeline.

    The queue is bounded (max_queue): overflow fails fast with QueueFull
    instead of stretching tail latency, and the batcher drops requests whose
    deadline passed while they were queued.  `ar_model` (an ARTokenModel,
    models/ar.py) enables /generate."""

    def __init__(
        self,
        pipeline,
        max_batch: int = 16,
        batch_timeout_ms: float = 5.0,
        max_queue: int = 64,
        request_deadline_s: float = 120.0,
        ar_model=None,
    ):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1e3
        self.request_deadline_s = request_deadline_s
        self.ar_model = ar_model
        self.q: "queue.Queue[_Request]" = queue.Queue(maxsize=max(max_queue, 1))
        self.n_served = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.n_expired = 0
        self._rejected_lock = threading.Lock()  # n_rejected is counted from the HTTP threads
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True, name="batcher")
        self._worker.start()

    # ------------------------------------------------------------- client api

    def submit(self, kind: str, payload, timeout: float = 600.0):
        # the deadline governs the time spent waiting in the queue (checked by
        # the batcher at dequeue), not a request already running; `timeout`
        # stays generous because a first request may build the kernels
        deadline = None
        if self.request_deadline_s and self.request_deadline_s > 0:
            deadline = time.monotonic() + self.request_deadline_s
        req = _Request(kind, payload, deadline)
        try:
            self.q.put_nowait(req)
        except queue.Full:
            with self._rejected_lock:
                self.n_rejected += 1
            raise QueueFull(f"request queue full ({self.q.maxsize}); retry later") from None
        if not req.event.wait(timeout):
            raise DeadlineExceeded(f"request exceeded {timeout:.0f}s client timeout")
        if req.error == "deadline":
            raise DeadlineExceeded("request expired while queued")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=10)

    # ---------------------------------------------------------------- batcher

    def _collect(self) -> List[_Request]:
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_timeout
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    self.n_expired += 1
                    r.error = "deadline"
                    r.event.set()
                else:
                    live.append(r)
            by_key = {}
            for r in live:
                by_key.setdefault(r.group_key(), []).append(r)
            for key, reqs in by_key.items():
                try:
                    self._run_group(key[0], reqs)
                except Exception as e:  # a group's failure fails its requests; the batcher keeps serving
                    for r in reqs:
                        r.error = f"{type(e).__name__}: {e}"
                        r.event.set()
            self.n_batches += 1

    def _run_group(self, kind: str, reqs: List[_Request]):
        if kind == "encode":
            records = self.pipeline.encode([np.asarray(r.payload, dtype=np.float32) for r in reqs])
            for r, rec in zip(reqs, records):
                r.result = rec
        elif kind == "decode":
            for r, im in zip(reqs, self.pipeline.decode([r.payload for r in reqs])):
                r.result = im  # the HTTP layer picks the codec
        elif kind in ("reconstruct", "reconstruct_f32"):
            images = [np.asarray(r.payload, dtype=np.float32) for r in reqs]
            # binary clients ('reconstruct') get uint8 made on the device; JSON
            # clients ('reconstruct_f32', a group of their own) keep floats
            fn = getattr(self.pipeline, "reconstruct_direct", None)
            outs = fn(images, as_uint8=(kind == "reconstruct")) if fn else self.pipeline.reconstruct(images)
            for r, im in zip(reqs, outs):
                r.result = im
        elif kind == "generate":
            self._run_generate(reqs)
        else:
            raise ValueError(f"unknown kind {kind}")
        self.n_served += len(reqs)
        for r in reqs:
            r.event.set()

    def generate_grid(self):
        """(patch_h, patch_w) of the /generate layout: the AR model's grid
        clipped to the tokenizer's."""
        ar_cfg, tok_cfg = self.ar_model.config, self.pipeline.model.config
        return min(ar_cfg.max_patch_h, tok_cfg.max_patch_h), min(ar_cfg.max_patch_w, tok_cfg.max_patch_w)

    def generate_max_tokens(self) -> int:
        ph, pw = self.generate_grid()
        return self.ar_model.config.image_channels * ph * pw

    def _run_generate(self, reqs: List[_Request]):
        """AR sampling -> tokenizer decode, micro-batched.

        The group shares (n_tokens, temperature), so one cached sampler loop
        serves it.  Each request draws from a generator of its own, seeded
        from its seed, so its draw does not depend on the batch it landed in,
        and may carry a prefix of tokens (to_dict schema) that the sampler
        teacher-forces.  The layout of a request is its prefix's (c, h, w)
        cells first, then the canonical order with those cells removed, so
        that no cell is written twice."""
        import torch

        from ..models.ar import canonical_layout, sample_codes_scan_batched

        if self.ar_model is None:
            raise RuntimeError("serve started without an AR model (--ar_model_path)")
        model, tok_cfg = self.ar_model, self.pipeline.model.config
        s = reqs[0].payload["n_tokens"]
        temperature = reqs[0].payload["temperature"]
        ph, pw = self.generate_grid()
        full = model.config.image_channels * ph * pw
        c_all, p_all = canonical_layout(model.config, full, patch_h=ph, patch_w=pw)
        c_all, p_all = c_all[0], p_all[0]
        b_real = len(reqs)
        # bucket the batch (1, 2, 4, ... max_batch): each batch size is a
        # captured loop and a KV cache in the sampler's bounded cache
        b = 1
        while b < b_real:
            b *= 2
        b = min(max(b, 1), max(self.max_batch, b_real))
        C = model.config.num_codebooks
        prefix_codes = np.zeros((b, s, C), np.int64)
        prefix_lens = np.zeros((b,), np.int64)
        chans_b = np.zeros((b, s), np.int32)
        poss_b = np.zeros((b, s, 2), np.int32)
        generators = []
        for i in range(b):
            r = reqs[min(i, b_real - 1)]  # padding rows replay the last request
            generators.append(torch.Generator(device=model.device).manual_seed(int(r.payload.get("seed", 0))))
            prefix = (r.payload.get("prefix") or [])[:s]
            used = set()
            for t, tok in enumerate(prefix):
                prefix_codes[i, t] = tok["data"]
                chans_b[i, t] = tok["c"]
                poss_b[i, t] = (tok["h"], tok["w"])
                used.add((int(tok["c"]), int(tok["h"]), int(tok["w"])))
            t = len(prefix)
            for c, (h, w) in zip(c_all, p_all):
                if t >= s:
                    break
                if (int(c), int(h), int(w)) in used:
                    continue
                chans_b[i, t] = c
                poss_b[i, t] = (h, w)
                t += 1
            prefix_lens[i] = len(prefix)
        codes = sample_codes_scan_batched(
            model, chans_b, poss_b, None, temperature=temperature, generators=generators,
            prefix_codes=prefix_codes, prefix_lens=prefix_lens,
        ).cpu().numpy()
        records = []
        for i, r in enumerate(reqs):
            default_size = (ph * tok_cfg.patch_size, pw * tok_cfg.patch_size)
            records.append({
                "size": (ph, pw),
                "original_size": tuple(r.payload.get("original_size", default_size)),
                "codes": [
                    {"c": int(chans_b[i, t]), "h": int(poss_b[i, t, 0]), "w": int(poss_b[i, t, 1]),
                     "data": codes[i, t].tolist()}
                    for t in range(s)
                ],
            })
        images = self.pipeline.decode(records)
        for r, rec, im in zip(reqs, records, images):
            r.result = {"image": im, "record": rec}


def _decode_npy_image(raw: bytes) -> np.ndarray:
    """npy bytes -> (c, h, w) float32 in [0, 1]; uint8 payloads are divided by 255."""
    arr = np.load(io.BytesIO(raw), allow_pickle=False)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim != 3:
        raise ValueError(f"expected a (c, h, w) image, got shape {arr.shape}")
    return np.ascontiguousarray(arr, dtype=np.float32)


def _encode_npy_image(im: np.ndarray) -> bytes:
    """(c, h, w) float image in [0, 1] (or already uint8) -> npy uint8 bytes."""
    buf = io.BytesIO()
    if im.dtype != np.uint8:
        im = (np.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.save(buf, im)
    return buf.getvalue()


def make_handler(server: BatchingServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj, headers=()):
            self._send(code, json.dumps(obj).encode(), "application/json", headers)

        def _npy(self, code: int, arr: np.ndarray):
            self._send(code, _encode_npy_image(arr), "application/octet-stream")

        def do_GET(self):
            if self.path != "/healthz":
                self._json(404, {"error": "not found"})
                return
            self._json(200, {
                "ok": True,
                "served": server.n_served,
                "batches": server.n_batches,
                "queue_depth": server.q.qsize(),
                "queue_max": server.q.maxsize,
                "rejected": server.n_rejected,
                "expired": server.n_expired,
                "generate": server.ar_model is not None,
            })

        def do_POST(self):
            kind = self.path.strip("/")
            if kind not in ("encode", "decode", "reconstruct", "generate"):
                self._json(404, {"error": "not found"})
                return
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                binary_in = "octet-stream" in self.headers.get("Content-Type", "")
                binary_out = binary_in or "octet-stream" in self.headers.get("Accept", "")
                if binary_in and kind in ("encode", "reconstruct"):
                    payload = _decode_npy_image(raw)
                else:
                    payload = json.loads(raw) if raw else {}
                    if kind in ("encode", "reconstruct"):
                        payload = payload["image"]
                submit_kind = kind
                if kind == "reconstruct" and not binary_out:
                    submit_kind = "reconstruct_f32"  # the float-exact JSON path
                if kind == "generate":
                    if server.ar_model is None:
                        self._json(400, {"error": "no AR model loaded (--ar_model_path)"})
                        return
                    # bucket what keys the sampler's loops: token counts to
                    # multiples of 64 (capped at the layout's grid),
                    # temperatures to 2 decimals
                    nt = int(payload.get("n_tokens", 256))
                    nt = max(64, ((nt + 63) // 64) * 64)
                    payload["n_tokens"] = min(nt, server.generate_max_tokens())
                    payload["temperature"] = round(float(payload.get("temperature", 1.0)), 2)
                result = server.submit(submit_kind, payload)
                if kind == "generate":
                    im = np.asarray(result["image"])
                    if binary_out:
                        self._npy(200, im)
                        return
                    out = {"image": im.tolist()}
                    if payload.get("return_codes"):
                        out["record"] = result["record"]
                    self._json(200, out)
                    return
                if kind in ("decode", "reconstruct"):
                    arr = np.asarray(result)
                    if binary_out:
                        self._npy(200, arr)
                        return
                    if arr.dtype == np.uint8:
                        arr = arr.astype(np.float32) / 255.0
                    result = {"image": arr.tolist()}
                self._json(200, result)
            except QueueFull as e:
                self._json(429, {"error": str(e)}, headers=(("Retry-After", "1"),))
            except DeadlineExceeded as e:
                self._json(504, {"error": str(e)})
            except Exception as e:  # the request's failure; the server keeps serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # the default listen backlog (5) resets connections under bursty clients
    request_queue_size = 128


def serve(
    pipeline,
    port: int = 8080,
    max_batch: int = 16,
    batch_timeout_ms: float = 5.0,
    max_queue: int = 64,
    request_deadline_s: float = 120.0,
    ar_model=None,
    host: str = "0.0.0.0",
):
    """The HTTP server (not yet serving: call ``serve_forever``) with its
    batcher at ``httpd.batcher``.  port=0 takes a free port; read it from
    ``httpd.server_address``.  Stop with ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``httpd.batcher.shutdown()``."""
    batcher = BatchingServer(
        pipeline, max_batch, batch_timeout_ms, max_queue=max_queue,
        request_deadline_s=request_deadline_s, ar_model=ar_model,
    )
    httpd = _Server((host, port), make_handler(batcher))
    httpd.batcher = batcher
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--batch_timeout_ms", type=float, default=5.0)
    p.add_argument("--sample_patches_beta", type=float, default=0.02)
    p.add_argument("--data_parallel", action="store_true", help="encode rows over every visible card")
    p.add_argument("--pad_rows_to", type=int, default=8)
    p.add_argument("--pad_tokens_to", type=int, default=128)
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--request_deadline_s", type=float, default=120.0)
    # an AR checkpoint (models/ar.py::save_ar_model, e.g. out_ar/ar_model of
    # tools/train_ar_example.py) enables /generate
    p.add_argument("--ar_model_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..pipeline import DCTPipeline

    pipe = DCTPipeline.from_pretrained(args.model_path, sample_patches_beta=args.sample_patches_beta, device=args.device)
    pipe = DCTPipeline(
        pipe.model, pipe.processor, data_parallel=args.data_parallel,
        pad_rows_to=args.pad_rows_to, pad_tokens_to=args.pad_tokens_to,
    )
    ar_model = None
    if args.ar_model_path:
        from ..models.ar import load_ar_model

        ar_model = load_ar_model(args.ar_model_path, device=args.device)
        print(f"AR model loaded from {args.ar_model_path}: /generate enabled")
    httpd = serve(
        pipe, args.port, args.max_batch, args.batch_timeout_ms, max_queue=args.max_queue,
        request_deadline_s=args.request_deadline_s, ar_model=ar_model, host=args.host,
    )
    print(f"serving on {args.host}:{httpd.server_address[1]} (max_batch={args.max_batch})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        httpd.batcher.shutdown()


if __name__ == "__main__":
    main()
