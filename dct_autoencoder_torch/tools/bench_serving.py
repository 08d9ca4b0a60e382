"""Serving-daemon load client: requests/s and p50/p99 latency.

Counterpart of dct_autoencoder_tpu/tools/bench_serving.py: the same client
(``fire``), flags and one JSON line per (server, codec, concurrency) config.
It drives the port's daemon (tools/serve.py) in this process:
  * codec: binary npy (production) and JSON floats,
  * concurrency: 1, 8 and 64 clients,
  * micro-batching: max_batch 16 with a 5 ms straggler window, and max_batch 1,
against a checkpoint, with the shape buckets of the daemon's defaults.

Usage:
  python -m dct_autoencoder_torch.tools.bench_serving \\
      --model_path docs/calibrated_run_r3b/model --image image.npy [--requests 64]

--image is a (c, h, w) .npy (float in [0, 1] or uint8), or an image file
that PIL reads, resized to --resize (PIL is imported only then).
"""
from __future__ import annotations

import argparse
import http.client
import io
import json
import threading
import time
from typing import Dict, List

import numpy as np


def load_image(path: str, resize: int = 448) -> np.ndarray:
    """(c, h, w) float32 in [0, 1]: an .npy as it is, an image file resized to resize x resize."""
    if path.lower().endswith(".npy"):
        im = np.load(path, allow_pickle=False)
        return im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im.astype(np.float32)
    from PIL import Image

    pil = Image.open(path).convert("RGB").resize((resize, resize), Image.BICUBIC)
    return np.asarray(pil, np.float32).transpose(2, 0, 1) / 255.0


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def fire(
    port: int,
    body: bytes,
    headers: Dict[str, str],
    n_requests: int,
    concurrency: int,
    path: str = "/reconstruct",
    retry_429: bool = True,
) -> Dict[str, float]:
    """Send n_requests to the daemon on 127.0.0.1:port from `concurrency` threads.

    429 (the bounded queue's backpressure) is part of the protocol: the
    client waits Retry-After and retries (retry_429=True), and counts the
    rejected attempts.  504 (deadline) is counted and not retried.  Any other
    status but 200 is an error and raises.  Latency percentiles are over
    completed requests only."""
    lat: List[float] = []
    lock = threading.Lock()
    counter = [0]
    rejected = [0]
    expired = [0]
    errors: List[str] = []

    def worker():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            while True:
                with lock:
                    if counter[0] >= n_requests or errors:
                        return
                    counter[0] += 1
                t0 = time.perf_counter()
                try:
                    while True:
                        conn.request("POST", path, body=body, headers=headers)
                        r = conn.getresponse()
                        data = r.read()
                        if r.status == 429 and retry_429:
                            with lock:
                                rejected[0] += 1
                            time.sleep(float(r.headers.get("Retry-After", "1")))
                            continue
                        break
                    if r.status == 504:
                        with lock:
                            expired[0] += 1
                        continue
                    if r.status != 200:
                        raise RuntimeError(f"{r.status}: {data[:200]}")
                except Exception as e:  # the client's failure is reported by fire()
                    with lock:
                        errors.append(repr(e))
                    return
                with lock:
                    lat.append(time.perf_counter() - t0)
        finally:
            conn.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"client errors: {errors[:3]}")
    lat.sort()
    out = {
        "requests": len(lat),
        "wall_s": round(wall, 3),
        "req_per_s": round(len(lat) / wall, 3) if lat else 0.0,
        "p50_ms": round(lat[len(lat) // 2] * 1e3, 1) if lat else None,
        "p99_ms": round(lat[min(int(len(lat) * 0.99), len(lat) - 1)] * 1e3, 1) if lat else None,
    }
    if rejected[0]:
        out["rejected_429"] = rejected[0]
    if expired[0]:
        out["expired_504"] = expired[0]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True)
    # the JAX tool's default image lies outside the repository: here the flag is required
    p.add_argument("--image", required=True, help="(c, h, w) .npy, or an image file PIL reads")
    p.add_argument("--resize", type=int, default=448)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--json_requests", type=int, default=16)
    p.add_argument("--sample_patches_beta", type=float, default=0.02)
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--request_deadline_s", type=float, default=120.0)
    # an AR checkpoint also benchmarks /generate (tokens -> image)
    p.add_argument("--ar_model_path", default=None)
    p.add_argument("--gen_tokens", type=int, default=256)
    p.add_argument("--gen_requests", type=int, default=16)
    # 'auto' benchmarks what serving loads (the gated int8 form when the
    # checkpoint passed its gate); 'never' the float model
    p.add_argument("--prefer_int8", default="auto", choices=("auto", "never", "always"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..pipeline import DCTPipeline
    from .serve import BatchingServer, _Server, make_handler

    base = DCTPipeline.from_pretrained(
        args.model_path, sample_patches_beta=args.sample_patches_beta, prefer_int8=args.prefer_int8, device=args.device
    )
    pipe = DCTPipeline(base.model, base.processor, pad_rows_to=8, pad_tokens_to=128)

    im = load_image(args.image, args.resize)
    bin_body = npy_bytes((im * 255.0 + 0.5).astype(np.uint8))
    bin_hdr = {"Content-Type": "application/octet-stream"}
    json_body = json.dumps({"image": im.tolist()}).encode()
    json_hdr = {"Content-Type": "application/json"}
    print(f"payload bytes: binary={len(bin_body)} json={len(json_body)}")

    # the pipeline alone (no HTTP): reconstruct_direct is what /reconstruct
    # serves, reconstruct the token-record round trip beside it
    for fn_name in ("reconstruct", "reconstruct_direct"):
        fn = getattr(pipe, fn_name)
        for _ in range(2):
            t0 = time.perf_counter()
            fn([im])
            direct = time.perf_counter() - t0
        print(f"direct pipeline.{fn_name}: {direct * 1e3:.0f} ms")

    ar_model = None
    if args.ar_model_path:
        from ..models.ar import load_ar_model

        ar_model = load_ar_model(args.ar_model_path, device=args.device)

    results = []
    for max_batch, timeout_ms, tag in ((16, 5.0, "batched"), (1, 0.0, "unbatched")):
        batcher = BatchingServer(
            pipe, max_batch=max_batch, batch_timeout_ms=timeout_ms,
            max_queue=args.max_queue, request_deadline_s=args.request_deadline_s, ar_model=ar_model,
        )
        httpd = _Server(("127.0.0.1", 0), make_handler(batcher))
        port = httpd.server_address[1]
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            t0 = time.perf_counter()
            fire(port, bin_body, bin_hdr, 1, 1)
            fire(port, bin_body, bin_hdr, 32, 16)
            print(f"[{tag}] warmup {time.perf_counter() - t0:.1f}s", flush=True)
            configs = [("binary", bin_body, bin_hdr, args.requests)]
            if tag == "batched":
                configs.append(("json", json_body, json_hdr, args.json_requests))
            for codec, body, hdr, n in configs:
                for conc in (1, 8, 64):
                    nn = max(n if conc > 1 else min(n, 16), conc)
                    for _ in range(2):  # keep the second, steady-state pass
                        r = fire(port, body, hdr, nn, conc)
                    line = {"server": tag, "codec": codec, "concurrency": conc, "batches_total": batcher.n_batches, **r}
                    results.append(line)
                    print(json.dumps(line), flush=True)
            if ar_model is not None and tag == "batched":
                gen_body = json.dumps({"n_tokens": args.gen_tokens, "temperature": 1.0, "seed": 1}).encode()
                fire(port, gen_body, json_hdr, 1, 1, path="/generate")
                fire(port, gen_body, json_hdr, 8, 8, path="/generate")
                for conc in (1, 8):
                    r = fire(port, gen_body, json_hdr, max(args.gen_requests, conc), conc, path="/generate")
                    line = {"server": tag, "codec": "generate", "n_tokens": args.gen_tokens, "concurrency": conc, **r}
                    results.append(line)
                    print(json.dumps(line), flush=True)
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.shutdown()
            thread.join(timeout=10)
    return results


if __name__ == "__main__":
    main()
