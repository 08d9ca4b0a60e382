"""The port's pipeline schedules against the JAX package's, on JAX's toy
layer (a metadata-reading tanh layer, so a skew between a microbatch's
activations and its image ids or padding shows), over a gloo group of 4 CPU
processes spawned once for the file; and the pipeline tools on the CPU.

  * pipeline_stack_apply (GPipe) at pp4 (M = 2, and M = 4: as many
    microbatches as stages), dp2 x pp2 (M = 2, and with
    remat) and dp4 x pp1 (M = 2), against JAX's pipeline_stack_apply on a
    JAX mesh of the same shape (tests/test_parallel.py's problem: L = 4,
    b = 8, s = 16, d = 32): the output within 1e-5, and the gradients of
    sum(out^2) with respect to the layers' parameters and to x within 1e-4;
  * pipeline_1f1b_loss_and_grad at (S, M) in {(2, 2), (4, 2), (2, 6)}, the
    data ranks making up 4, against JAX's pipeline_1f1b_loss_and_grad
    (tests/test_pipeline_1f1b.py's problem: L = 4, b = 48, s = 8, d = 16):
    the loss within rtol 1e-5, the parameter gradients and dx within 1e-5;
  * both refuse JAX's bad shapes with JAX's words;
  * tools/pp_memory_study.py at S = 1 on the CPU: GPipe's saved bytes grow
    with M, 1F1B's stay flat; tools/compile_probe.py on the tiny config.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_torch.parallel.pipeline import PipelineSpec, pipeline_stack_apply
from dct_autoencoder_torch.parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grad
from dct_autoencoder_tpu.parallel import mesh as jmesh
from dct_autoencoder_tpu.parallel.pipeline import PipelineSpec as JaxSpec
from dct_autoencoder_tpu.parallel.pipeline import pipeline_stack_apply as jax_stack_apply
from dct_autoencoder_tpu.parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grad as jax_1f1b
from test_torch_parallel import Ranks

# (name, kind, n_model, microbatches, remat)
CASES = [
    ("gpipe_pp4", "gpipe", 4, 2, False),
    ("gpipe_pp4_m4", "gpipe", 4, 4, False),
    ("gpipe_dp2_pp2", "gpipe", 2, 2, False),
    ("gpipe_dp2_pp2_remat", "gpipe", 2, 2, True),
    ("gpipe_dp4_pp1", "gpipe", 1, 2, False),
    ("f1b_dp2_pp2_m2", "1f1b", 2, 2, False),
    ("f1b_pp4_m2", "1f1b", 4, 2, False),
    ("f1b_dp2_pp2_m6", "1f1b", 2, 6, False),
]

SCHEDULE_WORKER = r'''
import os, sys, time
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import DeviceMesh
from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_torch.parallel.pipeline import PipelineSpec, pipeline_stack_apply
from dct_autoencoder_torch.parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grad

rank, world, port, payload_path, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
pm.initialize_distributed("cpu", f"tcp://127.0.0.1:{port}", world, rank, timeout_s=90)
P = torch.load(payload_path, weights_only=False)


def layer_apply(p, xm, ids_m, pad_m):
    gate = (~pad_m)[..., None].to(xm.dtype)
    return torch.tanh(xm @ p["w"] + p["b"]) * gate + ids_m[..., None] * 0.01


def loss_fn(y, ids_m, pad_m):
    mask = (~pad_m)[..., None].to(y.dtype)
    return ((y * mask) ** 2).mean() + 0.001 * ids_m.to(y.dtype).mean()


for name, kind, n_model, M, remat in P["cases"]:
    prob = P["problems"][kind]
    mesh = pm.Mesh(DeviceMesh("cpu", torch.arange(world).reshape(-1, n_model), mesh_dim_names=("data", "model")),
                   torch.device("cpu"))
    rows = pm.row_block(prob["x"].shape[0], mesh.data_rank, mesh.n_data)
    own = pm.stage_layers(prob["w"].shape[0], n_model, mesh.model_rank)
    params = [{"w": prob["w"][i].clone().requires_grad_(), "b": prob["b"][i].clone().requires_grad_()} for i in own]
    x, ids, pad = prob["x"][rows].clone().requires_grad_(), prob["ids"][rows], prob["pad"][rows]
    spec = PipelineSpec(mesh, M)
    if kind == "gpipe":
        out = pipeline_stack_apply(layer_apply, params, x, ids, pad, spec, remat=remat)
        (out ** 2).sum().backward()
        res = {"out": out.detach(), "dx": x.grad, "grads": [{k: v.grad for k, v in p.items()} for p in params]}
    else:
        loss, grads, dx = pipeline_1f1b_loss_and_grad(layer_apply, loss_fn, params, x.detach(), ids, pad, spec)
        res = {"loss": loss, "dx": dx, "grads": grads}
    res.update(rows=(rows.start, rows.stop), layers=list(own), data_rank=mesh.data_rank, model_rank=mesh.model_rank)
    torch.save(res, os.path.join(out_dir, f"{name}_{rank}.pt"))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"rank {rank} done", flush=True)
'''


def problem(L, b, s, d, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((L, d, d)).astype(np.float32) * 0.2
    bias = rng.standard_normal((L, d)).astype(np.float32) * 0.1
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    ids = rng.integers(0, 3, (b, s)).astype(np.int32)
    pad = rng.random((b, s)) < 0.2
    return {"w": w, "b": bias, "x": x, "ids": ids, "pad": pad}


def jax_layer_apply(p, xm, ids_m, pad_m):
    gate = (~pad_m)[..., None].astype(xm.dtype)
    return jnp.tanh(xm @ p["w"] + p["b"]) * gate + ids_m[..., None] * 0.01


def jax_loss_fn(y, ids_m, pad_m):
    mask = (~pad_m)[..., None].astype(y.dtype)
    return jnp.mean((y * mask) ** 2) + 0.001 * jnp.mean(ids_m.astype(y.dtype))


def jax_reference(kind, prob, n_model, M, remat):
    """JAX's function on a JAX mesh of 4 devices with the port's (data, model) shape."""
    mesh = jmesh.make_mesh(n_model=n_model, devices=jax.devices()[:4])
    spec = JaxSpec(mesh=mesh, n_microbatches=M)
    stacked = {"w": jnp.asarray(prob["w"]), "b": jnp.asarray(prob["b"])}
    x, ids, pad = jnp.asarray(prob["x"]), jnp.asarray(prob["ids"]), jnp.asarray(prob["pad"])
    with mesh:
        if kind == "gpipe":
            def f(p, x):
                return jax_stack_apply(jax_layer_apply, p, x, ids, pad, spec, remat=remat)

            out = jax.jit(f)(stacked, x)
            gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) ** 2), argnums=(0, 1)))(stacked, x)
            return {"out": np.asarray(out), "grads": jax.tree_util.tree_map(np.asarray, gp), "dx": np.asarray(gx)}
        loss, gp, dx = jax.jit(lambda p, x: jax_1f1b(jax_layer_apply, jax_loss_fn, p, x, ids, pad, spec))(stacked, x)
        return {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, gp), "dx": np.asarray(dx)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    problems = {"gpipe": problem(4, 8, 16, 32), "1f1b": problem(4, 48, 8, 16)}
    payload = {
        "cases": CASES,
        "problems": {k: {n: torch.from_numpy(np.asarray(v)) for n, v in p.items()} for k, p in problems.items()},
    }
    ranks = Ranks(tmp_path_factory.mktemp("ranks"), payload, world=4, program=SCHEDULE_WORKER)
    refs = {name: jax_reference(kind, problems[kind], n, M, remat) for name, kind, n, M, remat in CASES}
    ranks.wait()
    return ranks, refs


def _gathered(ranks, name):
    """The ranks' results: x's rows of out and dx reassembled over the data
    ranks (every model rank must hold the same), and each layer's parameter
    gradients as the list of what each data rank of its stage holds."""
    parts = [torch.load(f"{ranks.tmp}/{name}_{r}.pt", weights_only=False) for r in range(4)]
    out = {}
    for key in ("out", "dx"):
        if key in parts[0]:
            rows = {}
            for p in parts:
                if p["rows"] in rows:
                    np.testing.assert_array_equal(p[key].numpy(), rows[p["rows"]], err_msg=f"{name} {key}")
                rows[p["rows"]] = p[key].numpy()
            out[key] = np.concatenate([rows[k] for k in sorted(rows)])
    out["grads"] = {}
    for p in parts:
        for i, g in zip(p["layers"], p["grads"]):
            out["grads"].setdefault(i, []).append({k: v.numpy() for k, v in g.items()})
    if "loss" in parts[0]:
        losses = {float(p["loss"]) for p in parts}
        assert len(losses) == 1, losses
        out["loss"] = losses.pop()
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[1] == "gpipe"])
def test_gpipe_matches_jax(case, name):
    """Output within 1e-5 and gradients within 1e-4 (JAX's test); each data
    rank's parameter gradients are its rows' share, summed here as the
    data-parallel step sums them."""
    ranks, refs = case
    want = refs[name]
    got = _gathered(ranks, name)
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5)
    np.testing.assert_allclose(got["dx"], want["dx"], atol=1e-4)
    for k in ("w", "b"):
        summed = np.stack([sum(g[k] for g in got["grads"][i]) for i in range(4)])
        np.testing.assert_allclose(summed, want["grads"][k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[1] == "1f1b"])
def test_1f1b_matches_jax(case, name):
    """Loss (every rank the same) within rtol 1e-5; each stage's parameter
    gradients, summed over the data group and the same on every data rank,
    and dx within 1e-5."""
    ranks, refs = case
    want = refs[name]
    got = _gathered(ranks, name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k in ("w", "b"):
        for i in range(4):
            for g in got["grads"][i][1:]:
                np.testing.assert_array_equal(g[k], got["grads"][i][0][k], err_msg=f"{k} {i} over the data ranks")
        np.testing.assert_allclose(np.stack([got["grads"][i][0][k] for i in range(4)]), want["grads"][k], atol=1e-5)
    np.testing.assert_allclose(got["dx"], want["dx"], atol=1e-5)


def test_schedules_refuse_bad_shapes():
    """JAX's bad shapes: 3 layers over 4 stages ("stages", "not divisible");
    a data rank's rows that the microbatches do not divide ("divisible")."""
    with pytest.raises(ValueError, match="not divisible into 4 pipeline stages"):
        pm.stage_layers(3, 4, 0)
    spec = PipelineSpec(types.SimpleNamespace(n_model=4, model_rank=0, n_data=2), 2)
    x, ids, pad = torch.zeros(3, 4, 4), torch.zeros(3, 4, dtype=torch.int32), torch.zeros(3, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="divisible"):
        pipeline_stack_apply(lambda p, x, i, m: x, [], x, ids, pad, spec)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_1f1b_loss_and_grad(lambda p, x, i, m: x, lambda y, i, m: y.sum(), [], x, ids, pad, spec)


def test_pp_memory_study_gpipe_grows_and_1f1b_stays_flat(tmp_path):
    """At S = 1 on the CPU (a gloo world of one): the bytes GPipe saves for
    backward grow with M at a fixed microbatch size; 1F1B's stay within 10 %
    of their first value."""
    from dct_autoencoder_torch.tools import pp_memory_study

    out = tmp_path / "pp.json"
    payload = pp_memory_study.main(["--device", "cpu", "--dim", "128", "--seq", "32", "--microbatches", "2", "4", "8",
                                    "--out", str(out)])
    assert not torch.distributed.is_initialized()
    assert json.loads(out.read_text()) == payload and payload["backend"].startswith("cpu")
    rows = payload["rows"]
    assert [r["M"] for r in rows] == [2, 4, 8]
    g, f = [r["gpipe_temp_mb"] for r in rows], [r["f1b_temp_mb"] for r in rows]
    assert g[0] < g[1] < g[2] and g[2] > 3 * g[0], g
    assert max(f) <= 1.1 * f[0] and f[0] > 0, f
    assert all(r["gpipe_arg_mb"] == r["f1b_arg_mb"] for r in rows)


def test_compile_probe_on_the_tiny_config(tmp_path):
    from dct_autoencoder_torch.tools import compile_probe
    from test_model import tiny_config

    path = tmp_path / "tiny.json"
    tiny_config().to_json_file(str(path))
    res = compile_probe.main(str(path), rows=2, seq_len=64, iters=2, dtype="float32",
                             profile_dir=str(tmp_path / "trace"), device="cpu")
    assert res["ms_per_batch"] > 0 and res["images"] > 0 and res["first_call_s"] > 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
