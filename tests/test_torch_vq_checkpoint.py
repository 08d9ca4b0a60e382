"""Checkpoints, resume, the pipeline and the daemon with a VQ model in the
port, against the JAX package, in fp32 on the CPU (the CLI with a VQ config
is in tests/test_torch_sweep.py, beside the sweep that drives the CLI).

Model and tolerances as in tests/test_torch_vq_train.py: the tiny VQ config
of tests/test_model.py, JAX's parameters and vq_stats carried into the port;
ids equal except at JAX's own near ties (1e-5 relative); statistics
written by one package read back bit for bit by the other; resume bit for
bit under torch.use_deterministic_algorithms(True); the codes of the
pipeline equal JAX's pipeline's on >= 99 % of ids.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dct_autoencoder_torch as dt
from dct_autoencoder_torch.models.convert import vq_stats_from_state_dict
from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
from dct_autoencoder_tpu.pipeline import DCTPipeline as JaxPipeline
from test_model import tiny_config
from test_torch_model import to_torch_batch
from test_torch_train import TorchAE, TorchConfig, TorchPatchNorm, flat, tloop, torch_model_and_processor
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)
from test_torch_vq_train import (  # noqa: F401  (fixtures)
    _jax_eval,
    assert_vq_codes_match,
    deterministic,
    jax_normed_codebook,
    no_gumbel,
    vq_case,
    vq_port_of,
)


def test_save_pretrained_vq_stats_both_ways(tmp_path, no_gumbel):
    """The port's vq_stats.npz loads in JAX and JAX's in the port, with the
    same statistics and the same ids."""
    jm, _, batch = vq_case(7)
    nb = jm.normalize_(batch)
    _, new = jm.module.apply({"params": jm.params, "vq_stats": jm.vq_stats}, nb, training=True,
                             rngs={"vq": jax.random.PRNGKey(0)}, mutable=["vq_stats"])
    jm.vq_stats = new["vq_stats"]
    jm.save_pretrained(str(tmp_path / "jax"))
    tm = TorchAE.from_pretrained(str(tmp_path / "jax"), device="cpu")
    for k, v in flat(jm.vq_stats).items():
        np.testing.assert_array_equal(tm.module.vq_stats()[k.split("/")[-1]].numpy(), v)
    tb = to_torch_batch(batch)
    jcodes, jz, _ = _jax_eval(jm, batch)
    valid = ~np.asarray(batch.key_pad_mask)
    tcodes = tm.forward(tm.normalize_(tb))["codes"].numpy()
    assert_vq_codes_match(tcodes, jcodes, jz, jax_normed_codebook(jm.params, jm.vq_stats), valid)

    # the port's statistics move in a training forward, then go back to JAX
    with torch.no_grad():
        tm.module(tm.normalize_(tb), training=True, update_vq_stats=True)
    tm.save_pretrained(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["config.json", "params.npz", "patchnorm.npz", "vq_stats.npz"]
    jm2 = JaxAE.from_pretrained(str(tmp_path / "port"))
    for k, v in vq_stats_from_state_dict(tm.module.state_dict()).items():
        np.testing.assert_array_equal(flat(jm2.vq_stats)[k], v)
    jcodes2, jz2, _ = _jax_eval(jm2, batch)
    tcodes2 = tm.forward(tm.normalize_(tb))["codes"].numpy()
    assert_vq_codes_match(tcodes2, jcodes2, jz2, jax_normed_codebook(jm2.params, jm2.vq_stats), valid)
    assert not np.array_equal(flat(jm2.vq_stats)["vq_model/batch_mean"], flat(jm.vq_stats)["vq_model/batch_mean"])


def test_quantize_model_for_serving_carries_vq_stats():
    from dct_autoencoder_torch.models.quant import quantize_model_for_serving

    jm, _, _ = vq_case(8)
    tm = vq_port_of(jm)
    with torch.no_grad():
        tm.module.vq_model.batch_mean.add_(0.25)
    q = quantize_model_for_serving(tm)
    for k, v in tm.module.vq_stats().items():
        assert torch.equal(q.module.vq_stats()[k], v), k


def _port_vq_setup(seed):
    cfg = TorchConfig.from_dict(tiny_config("vq").to_dict())
    model, proc = torch_model_and_processor(cfg, sample_patches_beta=0.0, seed=seed, device="cpu")
    proc.rng = random.Random(seed)
    model.patchnorm = TorchPatchNorm.create(3, 8, 8, cfg.patch_dim)
    return model, proc


def _pulls(proc, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ds = proc.preprocess_many([rng.uniform(0.1, 0.9, size=(3, 32, 32)).astype(np.float32) for _ in range(4)])
        out.append({k: [d[k] for d in ds] for k in ds[0]})
    return out


def test_resume_is_exact_in_vq_mode(tmp_path, deterministic):
    """train 3 == train 1 + resume 2, bit for bit (parameters, statistics,
    moments), with k-means at step 0 and, after the resume, expiry at step 2."""
    kw = dict(batch_size=None, learning_rate=1e-3, log_every=1, log=lambda _: None, vq_expire_every=3, seed=5)
    pulls = _pulls(_port_vq_setup(0)[1], 3, seed=4)
    m3, p3 = _port_vq_setup(3)
    m3, s3 = tloop.train(m3, p3, iter(pulls), max_iters=3, **kw)

    m1, p1 = _port_vq_setup(3)
    logs = []
    tloop.train(m1, p1, iter(pulls[:1]), max_iters=3, out_dir=str(tmp_path), save_every=0, **kw)
    m2, p2 = _port_vq_setup(7)  # other weights and statistics: the checkpoint replaces them
    m2, s2 = tloop.train(m2, p2, iter(pulls[1:]), max_iters=3, resume_path=str(tmp_path), **{**kw, "log": logs.append})
    assert logs[0] == {"resumed_from": str(tmp_path), "step": 1}
    assert s2.step == s3.step == 3 and s2.vq_replaced is not None and bool(s2.vq_replaced.any())
    for (k, a), b in zip(m3.module.state_dict().items(), m2.module.state_dict().values()):
        assert torch.equal(a, b), k
    assert "vq_model.cluster_size" in m3.module.state_dict()
    sa, sb = s3.adamw.state_dict()["state"], s2.adamw.state_dict()["state"]
    for i in sa:
        assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) and torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])
    payload = torch.load(os.path.join(str(tmp_path), "train_state.pt"), weights_only=True)
    assert "vq_model.batch_mean" in payload["params"]


@pytest.fixture(scope="module")
def vq_pipes():
    jpipe = JaxPipeline.from_config(tiny_config("vq"), sample_patches_beta=0.0, dtype=jnp.float32)
    proc = dt.DCTPipeline.from_config(
        dt.DCTAutoencoderConfig.from_dict(jpipe.model.config.to_dict()), sample_patches_beta=0.0,
        dtype=torch.float32, device="cpu",
    ).processor
    return jpipe, dt.DCTPipeline(vq_port_of(jpipe.model), proc)


def test_vq_pipeline_encode_decode_reconstruct_and_daemon(vq_pipes):
    """A VQ model through DCTPipeline encode, decode, reconstruct and
    reconstruct_direct, and through the daemon's /encode: the records are
    JAX's, and decode in either package to the same images."""
    import threading
    import urllib.request

    from dct_autoencoder_torch.tools import serve as tserve

    jpipe, pipe = vq_pipes
    rng = np.random.default_rng(9)
    ims = [rng.uniform(0.1, 0.9, size=(3, 32, 32)).astype(np.float32) for _ in range(3)]
    tr, jr = pipe.encode(ims), jpipe.encode(ims)
    assert [[d["data"] for d in r["codes"]] for r in tr] == [[d["data"] for d in r["codes"]] for r in jr]
    for a, b in zip(pipe.decode(jr), jpipe.decode(tr)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)
    for a, b in zip(pipe.reconstruct(ims), pipe.reconstruct_direct(ims)):
        np.testing.assert_allclose(a, b, atol=1e-5)

    httpd = tserve.serve(pipe, port=0, host="127.0.0.1", max_batch=4, batch_timeout_ms=5.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/encode",
                                     data=json.dumps({"image": ims[0].tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            served = json.loads(r.read())
        assert [d["data"] for d in served["codes"]] == [d["data"] for d in tr[0]["codes"]]
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.shutdown()
        thread.join(timeout=10)


