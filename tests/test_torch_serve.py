"""The port's serving daemon and what it stands on, against the JAX package, on the CPU.

Counterparts of tests/test_serve.py: the micro-batcher, the HTTP endpoints
on JSON and on the binary npy codec, the bounded queue (429), the deadline
(504), /healthz, /generate, the shape buckets and ``reconstruct_direct``;
and the same calls held against the JAX package.  A tiny tokenizer
(tests/test_model.py's tiny_config widths) is made by the JAX package from a
seed and carried into the port (models/convert.py); the AR model for
/generate is made by JAX and loaded by the port from JAX's checkpoint.
Images are seeded numpy arrays.

Tolerances (fp32 on the CPU on both sides):
  * records from the shape buckets identical to the unpadded path's, in
    each package, and the port's equal to JAX's;
  * images decoded with padded tokens within 1e-5 of the unpadded ones;
  * ``reconstruct_direct`` within 1e-5 of ``reconstruct`` in the port, its
    uint8 output exactly the host quantization of its float output, and
    within 1e-4 of JAX's ``reconstruct_direct`` (uniform and mixed sizes);
  * /generate at temperature 0: the same codes as JAX's daemon.
"""
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.kernels import idct_unpatchify as tidct
from dct_autoencoder_torch.models import ar as tar
from dct_autoencoder_torch.tools import bench_serving as tbench
from dct_autoencoder_torch.tools import serve as tserve
from dct_autoencoder_torch.train.pixel_loss import row_image_layout, unpatch_to_planes
from dct_autoencoder_tpu.models import ar as jar
from dct_autoencoder_tpu.models.config import TransformerConfig as JaxTransformerConfig
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from dct_autoencoder_tpu.tools import serve as jserve
from dct_autoencoder_tpu.train import pixel_loss as jpl
from test_model import tiny_config
from test_torch_model import to_torch_batch
from test_torch_train import port_of


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) with the same tiny tokenizer, fp32, no token budget."""
    jpipe = JaxPipeline.from_config(tiny_config("lfq"), sample_patches_beta=0.0, dtype=jnp.float32)
    proc = dt.DCTPipeline.from_config(
        dt.DCTAutoencoderConfig.from_dict(jpipe.model.config.to_dict()), sample_patches_beta=0.0,
        dtype=torch.float32, device="cpu",
    ).processor
    return jpipe, dt.DCTPipeline(port_of(jpipe.model), proc)


def _images(n, seed, sizes=((32, 32),)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.1, 0.9, size=(3, *sizes[i % len(sizes)])).astype(np.float32) for i in range(n)]


def _codes(records):
    return [[(d["c"], d["h"], d["w"], list(d["data"])) for d in r["codes"]] for r in records]


def _http(port, path, data=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/{path}", data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), r.headers.get("Content-Type", "")


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class _Daemon:
    """The port's serve() on 127.0.0.1, a free port, in a thread."""

    def __init__(self, pipe, **kw):
        self.httpd = tserve.serve(pipe, port=0, host="127.0.0.1", **kw)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.batcher.shutdown()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive() and not self.httpd.batcher._worker.is_alive()


# ----------------------------------------------------------- on-device scatter


def test_unpatch_to_planes_matches_jax(pipes):
    """The scatter the fused path runs: same planes as JAX's, padding rows and
    tokens (image id 0) in no image, images past max_images dropped."""
    jpipe, _ = pipes
    ims = _images(5, seed=11)
    proc = jpipe.processor
    ds = [proc.preprocess(im) for im in ims]
    batch = next(proc.iter_batches(iter([{k: [d[k] for d in ds] for k in ds[0]}]), batch_size=None))
    from dct_autoencoder_tpu.parallel.mesh import pad_batch_rows as jax_pad_rows
    from dct_autoencoder_tpu.train.loop import prepare_train_batch

    batch = jax_pad_rows(prepare_train_batch(batch)[0], 4)  # two fully padded rows at least
    tb = to_torch_batch(batch)
    offsets, n_per_row = row_image_layout(tb)
    j_off, j_n = jpl.row_image_layout(batch)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(j_off))
    np.testing.assert_array_equal(n_per_row.numpy(), np.asarray(j_n))
    assert int(n_per_row.sum()) == 5 and (n_per_row[-1] == 0)
    grid = ds[0]["patch_sizes"]
    for max_images in (8, 3):
        want = np.asarray(jpl.unpatch_to_planes(batch.patches, batch, j_off, grid, 4, 3, max_images))
        got = unpatch_to_planes(tb.patches, tb, offsets, grid, 4, 3, max_images)
        assert got.dtype == torch.float32 and got.shape == (max_images, 3, grid[0] * 4, grid[1] * 4)
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- shape buckets


def test_shape_bucketing_matches_unpadded_and_jax(pipes):
    """pad_rows_to / pad_tokens_to change no record and no image, in either
    package, and the two packages' records agree."""
    jpipe, tpipe = pipes
    ims = _images(3, seed=3)
    jpad = JaxPipeline(jpipe.model, jpipe.processor, pad_rows_to=8, pad_tokens_to=128)
    tpad = dt.DCTPipeline(tpipe.model, tpipe.processor, pad_rows_to=8, pad_tokens_to=128)
    rec = {name: pipe.encode(ims) for name, pipe in (("j", jpipe), ("jpad", jpad), ("t", tpipe), ("tpad", tpad))}
    assert _codes(rec["t"]) == _codes(rec["tpad"])
    assert _codes(rec["j"]) == _codes(rec["jpad"])
    assert _codes(rec["t"]) == _codes(rec["j"])
    for a, b in zip(tpipe.decode(rec["t"]), tpad.decode(rec["t"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert all(len(r["codes"]) % 128 for r in rec["t"])  # the token pad was not a no-op


def test_data_parallel_is_refused_by_name(pipes):
    """data_parallel=True is ported now: over two CPU copies the port
    encodes the records of the JAX package's data-parallel pipeline (rows
    over its 8 virtual devices) and of its own single-device pipeline, and
    decodes them to the same images.  The name dates from when the option
    was refused by name; it is kept so the test keeps its record."""
    jpipe, tpipe = pipes
    ims = _images(5, seed=5, sizes=((32, 32), (24, 32), (16, 16)))
    tdp = dt.DCTPipeline(tpipe.model, tpipe.processor, data_parallel=True, devices=["cpu", "cpu"])
    jdp = JaxPipeline(jpipe.model, jpipe.processor, data_parallel=True)
    rec = tdp.encode(ims)
    assert _codes(rec) == _codes(jdp.encode(ims)) == _codes(tpipe.encode(ims))
    for a, b in zip(tdp.decode(rec), tpipe.decode(rec)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- reconstruct_direct


def test_reconstruct_direct_matches_reconstruct(pipes):
    """The fused path equals the token round trip; its uint8 output is the host
    quantization of its float output; one IDCT call for a uniform group."""
    _, base = pipes
    pipe = dt.DCTPipeline(base.model, base.processor, pad_rows_to=4)
    ims = _images(3, seed=4)
    a = pipe.reconstruct(ims)
    calls = []
    real = tidct.fused_idct_unpatchify_rgb_plain
    tidct.fused_idct_unpatchify_rgb_plain = lambda y, h, w, *args: calls.append(tuple(y.shape)) or real(y, h, w, *args)
    try:
        b = pipe.reconstruct_direct(ims)
    finally:
        tidct.fused_idct_unpatchify_rgb_plain = real
    assert calls == [(4, 3, 32, 32)]  # 3 images in the next power of two of slots
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert y.shape == (3, 32, 32) and y.dtype == np.float32
        np.testing.assert_allclose(x, y, atol=1e-5)
    u = pipe.reconstruct_direct(ims, as_uint8=True)
    for x, y in zip(b, u):
        assert y.dtype == np.uint8
        np.testing.assert_array_equal((np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8), y)
    mixed = _images(3, seed=5, sizes=((48, 32), (32, 48), (32, 32)))
    for x, y in zip(pipe.reconstruct(mixed), pipe.reconstruct_direct(mixed)):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=1e-5)


@pytest.mark.parametrize("sizes", [((32, 32),), ((48, 32), (32, 48), (32, 32))], ids=["uniform", "mixed"])
def test_reconstruct_direct_matches_jax(pipes, sizes):
    jpipe, tpipe = pipes
    ims = _images(3, seed=6, sizes=sizes)
    j = JaxPipeline(jpipe.model, jpipe.processor, pad_rows_to=4).reconstruct_direct(ims)
    t = dt.DCTPipeline(tpipe.model, tpipe.processor, pad_rows_to=4).reconstruct_direct(ims)
    for a, b in zip(j, t):
        assert b.shape == np.asarray(a).shape
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4)


# ----------------------------------------------------------- the daemon


def test_batching_server_roundtrip_and_batches(pipes):
    _, pipe = pipes
    srv = tserve.BatchingServer(pipe, max_batch=8, batch_timeout_ms=50.0)
    try:
        ims = _images(6, seed=0)
        results = [None] * 6

        def call(i):
            results[i] = srv.submit("encode", ims[i].tolist())

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None and "codes" in r for r in results)
        assert srv.n_served == 6 and srv.n_batches < 6, "no batching happened"
        assert _codes(results) == _codes(pipe.encode(ims))
        assert np.asarray(srv.submit("decode", results[0])).shape == (3, 32, 32)
    finally:
        srv.shutdown()


def test_http_endpoints_json_and_binary(pipes):
    _, pipe = pipes
    with _Daemon(pipe, max_batch=4, batch_timeout_ms=5.0) as d:
        health = json.loads(_http(d.port, "healthz")[0])
        assert health["ok"] and health["generate"] is False
        im = _images(1, seed=1)[0]
        imu8 = (im * 255.0 + 0.5).astype(np.uint8)
        body = json.dumps({"image": (imu8.astype(np.float32) / 255.0).tolist()}).encode()
        jhdr, bhdr = {"Content-Type": "application/json"}, {"Content-Type": "application/octet-stream"}
        rec_json = json.loads(_http(d.port, "encode", body, jhdr)[0])
        assert tuple(rec_json["original_size"]) == (32, 32) and rec_json["codes"]
        raw, ctype = _http(d.port, "encode", _npy(imu8), bhdr)
        assert "json" in ctype and _codes([json.loads(raw)]) == _codes([rec_json])
        out = np.asarray(json.loads(_http(d.port, "reconstruct", body, jhdr)[0])["image"])
        assert out.shape == (3, 32, 32) and np.isfinite(out).all()
        np.testing.assert_allclose(out, pipe.reconstruct_direct([imu8.astype(np.float32) / 255.0])[0], atol=1e-6)
        raw, ctype = _http(d.port, "reconstruct", _npy(im), bhdr)
        got = np.load(io.BytesIO(raw))
        assert "octet-stream" in ctype and got.dtype == np.uint8 and got.shape == (3, 32, 32)
        np.testing.assert_array_equal(got, pipe.reconstruct_direct([im], as_uint8=True)[0])
        raw, _ = _http(d.port, "decode", json.dumps(rec_json).encode(), {**jhdr, "Accept": "application/octet-stream"})
        assert np.load(io.BytesIO(raw)).dtype == np.uint8
        with pytest.raises(urllib.error.HTTPError) as e:
            _http(d.port, "nothing", b"{}", jhdr)
        assert e.value.code == 404


def test_bench_serving_client_against_the_daemon(pipes):
    """The ported load client: every request answered, percentiles reported."""
    _, pipe = pipes
    im = _images(1, seed=2)[0]
    with _Daemon(pipe, max_batch=8, batch_timeout_ms=5.0) as d:
        r = tbench.fire(d.port, tbench.npy_bytes((im * 255).astype(np.uint8)), {"Content-Type": "application/octet-stream"}, 12, 4)
        health = json.loads(_http(d.port, "healthz")[0])
    assert r["requests"] == 12 and r["req_per_s"] > 0 and r["p50_ms"] <= r["p99_ms"]
    assert health["served"] == 12 and health["batches"] < 12


class _SlowStubPipeline:
    """Pipeline stand-in whose encode blocks: drives the queue and deadline paths."""

    def __init__(self, delay=0.25):
        self.delay = delay

    def encode(self, images):
        time.sleep(self.delay)
        return [{"codes": [], "size": (1, 1), "original_size": (8, 8)}] * len(images)


def _concurrently(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_bounded_queue_rejects_with_queue_full():
    srv = tserve.BatchingServer(_SlowStubPipeline(0.3), max_batch=1, batch_timeout_ms=1.0, max_queue=2)
    errors, oks = [], []

    def call(i):
        try:
            oks.append(srv.submit("encode", [[i]]))
        except tserve.QueueFull as e:
            errors.append(e)

    try:
        _concurrently(call, 8)
        assert errors and oks and srv.n_rejected == len(errors)
    finally:
        srv.shutdown()


def test_request_deadline_expires():
    srv = tserve.BatchingServer(
        _SlowStubPipeline(0.4), max_batch=1, batch_timeout_ms=1.0, max_queue=16, request_deadline_s=0.15
    )
    errors, oks = [], []

    def call(i):
        try:
            oks.append(srv.submit("encode", [[i]]))
        except tserve.DeadlineExceeded as e:
            errors.append(e)

    try:
        _concurrently(call, 4)
        assert errors and srv.n_expired == len(errors) and len(oks) + len(errors) == 4
    finally:
        srv.shutdown()


def test_http_429_and_healthz_metrics():
    statuses = []
    with _Daemon(_SlowStubPipeline(0.5), max_batch=1, batch_timeout_ms=1.0, max_queue=1, request_deadline_s=30.0) as d:

        def call(i):
            try:
                _http(d.port, "encode", json.dumps({"image": [[0.5]]}).encode(), {"Content-Type": "application/json"})
                statuses.append((200, None))
            except urllib.error.HTTPError as e:
                statuses.append((e.code, e.headers.get("Retry-After")))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.1)  # while the queue is full
        health = json.loads(_http(d.port, "healthz")[0])
        for t in threads:
            t.join(timeout=60)
    rejected = [s for s in statuses if s[0] == 429]
    assert rejected and all(ra == "1" for _, ra in rejected), statuses
    assert health["queue_max"] == 1 and "queue_depth" in health and "rejected" in health
    assert health["generate"] is False


# ----------------------------------------------------------- /generate


@pytest.fixture(scope="module")
def ar_models(pipes, tmp_path_factory):
    """A tiny AR model made by JAX from a seed: (JAX (config, params), the port's load of JAX's checkpoint)."""
    jpipe, _ = pipes
    tok = jpipe.model.config
    cfg = jar.ARConfig(
        codebook_size=tok.vq_codebook_size, num_codebooks=tok.vq_num_codebooks, image_channels=tok.image_channels,
        max_patch_h=tok.max_patch_h, max_patch_w=tok.max_patch_w,
        transformer=JaxTransformerConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2),
    )
    C = cfg.num_codebooks
    params = jar.ARTokenModel(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 4, C), np.int32), np.zeros((1, 4), np.int32),
        np.zeros((1, 4, 2), np.int32), np.zeros((1, 4), bool), training=False,
    )["params"]
    path = str(tmp_path_factory.mktemp("ar") / "ar_model")
    jar.save_ar_model(path, cfg, params)
    return (cfg, params), tar.load_ar_model(path, device="cpu")


def test_generate_endpoint_and_batching(pipes, ar_models):
    """/generate: AR sample -> decode, micro-batched; a seed gives the same
    codes whichever batch it lands in; a prefix is forced and its cells are
    not repeated."""
    _, pipe = pipes
    srv = tserve.BatchingServer(pipe, max_batch=8, batch_timeout_ms=50.0, ar_model=ar_models[1])
    payload = lambda seed, **kw: dict(n_tokens=64, temperature=1.0, seed=seed, **kw)
    try:
        results = [None] * 3

        def call(i):
            results[i] = srv.submit("generate", payload(seed=100 + i))

        _concurrently(call, 3)
        assert srv.n_batches < 3
        for r in results:
            assert np.asarray(r["image"]).shape == (3, 32, 32) and len(r["record"]["codes"]) == 64
        solo = srv.submit("generate", payload(seed=101))
        assert [t["data"] for t in solo["record"]["codes"]] == [t["data"] for t in results[1]["record"]["codes"]]
        assert [t["data"] for t in results[0]["record"]["codes"]] != [t["data"] for t in results[1]["record"]["codes"]]
        canon = results[0]["record"]["codes"]
        prefix = [canon[0], canon[7], canon[12]]
        toks = srv.submit("generate", payload(seed=7, prefix=prefix))["record"]["codes"]
        assert [t["data"] for t in toks[:3]] == [t["data"] for t in prefix]
        triples = [(t["c"], t["h"], t["w"]) for t in toks]
        assert len(set(triples)) == len(triples), "duplicate grid cells in the layout"
    finally:
        srv.shutdown()


def test_generate_matches_jax_at_temperature_0(pipes, ar_models):
    """Greedy /generate gives the JAX daemon's codes on the same AR weights,
    with and without a prefix, over HTTP on the port's side."""
    jpipe, tpipe = pipes
    jsrv = jserve.BatchingServer(jpipe, max_batch=4, batch_timeout_ms=1.0, ar_model=ar_models[0])
    try:
        base = jsrv.submit("generate", dict(n_tokens=64, temperature=0.0, seed=0))["record"]["codes"]
        prefix = [base[3], base[9]]
        want = [base, jsrv.submit("generate", dict(n_tokens=64, temperature=0.0, seed=0, prefix=prefix))["record"]["codes"]]
    finally:
        jsrv.shutdown()
    with _Daemon(tpipe, max_batch=4, batch_timeout_ms=1.0, ar_model=ar_models[1]) as d:
        got = []
        for body in (dict(n_tokens=64, temperature=0.0, seed=5), dict(n_tokens=64, temperature=0.0, prefix=prefix, return_codes=True)):
            out = json.loads(_http(d.port, "generate", json.dumps({**body, "return_codes": True}).encode())[0])
            assert np.asarray(out["image"]).shape == (3, 32, 32)
            got.append(out["record"]["codes"])
    for g, w in zip(got, want):
        assert [(t["c"], t["h"], t["w"], list(t["data"])) for t in g] == [(t["c"], t["h"], t["w"], list(t["data"])) for t in w]
