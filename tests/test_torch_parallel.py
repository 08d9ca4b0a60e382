"""The port's parallel layout (dct_autoencoder_torch/parallel/) against the JAX
package's parallel/mesh.py, in one process on the CPU, and
DCTPipeline(data_parallel=True) over two CPU copies.

Pure functions: the tensor-parallel rules by name and the column/row split
of a Dense ``weight`` against the split of JAX's ``kernel``, transposed;
pad_batch_rows and the data blocks of rows against JAX's, bit for bit;
zero1_partition against zero1_opt_spec's choice of leaves, and its 256-value
alignment for AdamW8bit; shard then reassemble gives the state_dict back;
with_sequence_parallel against JAX's.  Exact comparisons throughout.

This file also holds the helpers of the multi-process tests
(tests/test_torch_parallel_ranks*.py): the model and batch they share with
JAX, and the rank program they spawn.
"""
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig as TorchConfig
from dct_autoencoder_torch.models.convert import jax_param_tree
from dct_autoencoder_torch.models.factory import get_model_and_processor as torch_model_and_processor
from dct_autoencoder_torch.models.patchnorm import calibrate_patchnorm_batch as torch_calibrate
from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_tpu.models.config import DCTAutoencoderConfig as JaxConfig
from dct_autoencoder_tpu.models.patchnorm import PatchNormState as JaxPatchNorm
from dct_autoencoder_tpu.parallel import mesh as jmesh
from dct_autoencoder_tpu.patches.container import DCTPatches as JaxPatches
from test_model import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# images of several sizes, so that rows pack several images and end in padding
SIZES = [(32, 32), (16, 16), (24, 24), (16, 32), (32, 16), (24, 16), (16, 16), (32, 24), (8, 16), (24, 32)]
BATCH_FIELDS = ("patches", "key_pad_mask", "batched_image_ids", "patch_channels", "patch_positions")


# ---------------------------------------------------------------- shared helpers


def port_case(vq_type="lfq", seed=0, sizes=SIZES, rows_multiple=4, config=None):
    """(port model, packed batch padded to a multiple of rows_multiple rows):
    the tiny config of tests/test_model.py (or `config`) at random init,
    seeded images of `sizes` packed by the port's extractor, patchnorm
    calibrated (fp32, CPU)."""
    model, proc = torch_model_and_processor(
        config or tiny_config(vq_type), dtype=torch.float32, sample_patches_beta=0.0, seed=seed, device="cpu"
    )
    rng = np.random.default_rng(seed)
    ims = [rng.uniform(0.1, 0.9, size=(3, h, w)).astype(np.float32) for h, w in sizes]
    ds = [proc.preprocess(im) for im in ims]
    cols = {k: [d[k] for d in ds] for k in ds[0]}
    batch = next(proc.iter_batches(iter([cols]), batch_size=None))
    model.patchnorm, _ = torch_calibrate(model.patchnorm, batch)
    return model, pm.pad_batch_rows(batch, rows_multiple)


def jax_batch(tb) -> JaxPatches:
    """The port's packed batch as the JAX package's DCTPatches."""
    return JaxPatches(
        attn_mask=None, patch_sizes=tuple(tb.patch_sizes), original_sizes=tuple(tb.original_sizes),
        **{k: jnp.asarray(getattr(tb, k).numpy()) for k in BATCH_FIELDS},
    )


def jax_patchnorm(pn) -> JaxPatchNorm:
    return JaxPatchNorm(**{k: jnp.asarray(getattr(pn, k).numpy()) for k in ("n", "median", "b")})


def jax_module_and_params(model):
    """The JAX module of the port model's config and the port's weights as its
    parameter tree (and VQ statistics)."""
    from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoderModule
    from dct_autoencoder_torch.models.convert import vq_stats_from_state_dict

    jcfg = JaxConfig.from_dict(model.config.to_dict())
    state = model.module.state_dict()
    params = jax.tree_util.tree_map(jnp.asarray, jax_param_tree(state, model.config))
    stats = vq_stats_from_state_dict(state)
    vq_stats = {"vq_model": {k.split("/")[-1]: jnp.asarray(v) for k, v in stats.items()}} if stats else None
    return DCTAutoencoderModule(jcfg), params, vq_stats


def assert_params_close(got: dict, want: dict, lr_sum: float, atol: float = 1e-5, what: str = "") -> None:
    """Parameters of two fp32 runs of the same steps, whose gradients differ
    by the order of their sums: entries within atol, except where Adam's
    first update g / (|g| + 1e-8) turned the other way on a gradient within
    rounding of 0, which moves an entry by up to 2 x the learning rates
    applied: at most 0.2 % of the model's entries, and of one tensor the
    larger of 2 entries and 1 % (tests/test_torch_train.py's rule), any
    number for a key bias, whose whole gradient is rounding noise."""
    off = total = 0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        assert float(d.max()) <= 2.0 * lr_sum + atol, f"{what} {k}: {float(d.max())}"
        if k.endswith("k_proj.bias"):
            continue
        n_off = int((d > atol).sum())
        assert n_off <= max(2, 0.01 * d.numel()), f"{what} {k}: {n_off} of {d.numel()} entries off by more than {atol}"
        off, total = off + n_off, total + d.numel()
    assert off <= 2e-3 * total, f"{what}: {off} of {total} entries off by more than {atol}"


# the program of one rank of the multi-process tests: it joins a gloo group,
# runs every scenario of the payload in order (every rank builds every mesh,
# which is collective) and the first rank of the first group saves each result
RANK_WORKER = r'''
import os, sys, dataclasses, time
t0 = time.time()
import torch
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder
from dct_autoencoder_torch.models.config import DCTAutoencoderConfig, with_sequence_parallel
from dct_autoencoder_torch.models import vq as tvq
from dct_autoencoder_torch.models.patchnorm import PatchNormState, apply_patchnorm
from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_torch.parallel.pipeline import make_pipelined_module
from dct_autoencoder_torch.patches.container import DCTPatches
from dct_autoencoder_torch.train import checkpoint as tck, loop as tl
from dct_autoencoder_torch.train.opt8bit import opt_state_bytes
from torch.distributed.device_mesh import DeviceMesh

rank, world, port, payload_path, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
pm.initialize_distributed("cpu", f"tcp://127.0.0.1:{port}", world, rank, timeout_s=90)
P = torch.load(payload_path, weights_only=False)
batch = DCTPatches(**P["batch"])
grid_sizes = P.get("grid_sizes")
real_gumbel = tvq._gumbel


def build(sc):
    M = P["models"][sc.get("model", "lfq")]
    cfg = DCTAutoencoderConfig.from_dict(M["config"])
    if sc.get("sp"):
        cfg = with_sequence_parallel(cfg)
    model = DCTAutoencoder(cfg, dtype=torch.float32, device="cpu")
    model.module.load_state_dict(M["state_dict"])
    model.patchnorm = PatchNormState(*M["patchnorm"])
    return model


def trainer(sc, model, mesh):
    if sc.get("pp"):  # the model axis as pipeline stages, sc["pp"] microbatches
        make_pipelined_module(model.module, mesh, sc["pp"])
    elif sc.get("n_model", 1) > 1 or sc.get("sp"):
        pm.shard_params(model.module, mesh)
    tx = tl.make_optimizer(1e-3, 10, warmup_steps=0, opt_8bit=sc.get("opt_8bit", False))
    state = tl.TrainState.create(model.module, tx, mesh=mesh, zero1=sc.get("zero1", False), zero1_min_size=0)
    step = tl.make_train_step(
        model.module, tx, accum_steps=sc.get("accum", 1), use_pixel_loss=grid_sizes is not None and sc.get("pixel", False),
        vq_kmeans_init=sc.get("kmeans", False), vq_expire_every=sc.get("expire_every", 50),
        vq_expire_threshold=sc.get("expire_threshold", 15.0), mesh=mesh,
    )
    return state, step


def snap(tree):
    """A copy: state_dicts share their tensors with the live state."""
    if isinstance(tree, dict):
        return {k: snap(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snap(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def run_steps(model, state, step, n, sc):
    out = []
    for _ in range(n):
        state, m = step(state, model.patchnorm, batch, grid_sizes if sc.get("pixel") else None)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


for sc in P["scenarios"]:
    tvq._gumbel = (lambda shape, g, device: torch.zeros(shape, device=device)) if sc.get("no_gumbel") else real_gumbel
    groups = sc["groups"]
    n = sc.get("n_model", 1)
    # a (data, model) mesh over each group of ranks (DeviceMesh is collective: every rank builds each)
    meshes = [
        pm.Mesh(DeviceMesh("cpu", torch.tensor(g).reshape(-1, n), mesh_dim_names=("data", "model")), torch.device("cpu"))
        for g in groups
    ]
    mine = next(i for i, g in enumerate(groups) if rank in g)
    mesh = meshes[mine]
    if groups == [list(range(world))]:  # make_mesh's layout: rank r sits at (r // n_model, r % n_model)
        assert pm.make_mesh(n, "cpu").device_mesh.mesh.tolist() == mesh.device_mesh.mesh.tolist()
        assert (mesh.data_rank, mesh.model_rank) == (rank // n, rank % n), (rank, mesh.data_rank, mesh.model_rank)
    res = {}
    if sc.get("kind") == "train":
        # train() itself over the whole world, on the payload's image columns
        from dct_autoencoder_torch.models.factory import get_model_and_processor
        model = build(sc)
        _, proc = get_model_and_processor(model.config, dtype=torch.float32, sample_patches_beta=0.0, device="cpu")
        logs = []
        tl.train(
            model, proc, iter(P["columns"]), batch_size=None, max_iters=len(P["columns"]), learning_rate=1e-3,
            n_model_parallel=n, pipeline_microbatches=sc.get("pp", 0), grad_accumulation_steps=sc.get("accum", 1),
            log_every=1, save_every=0, prefetch_batches=0, log=logs.append,
            out_dir=os.path.join(out_dir, "train_" + sc["name"]), log_images_every=1,
        )
        res = {"logs": logs, "params": model.module.state_dict(), "staged": pm.is_sharded(model.module)}
    elif sc.get("kind") == "ema":
        torch.manual_seed(0)
        x = torch.randn(64, 4)
        valid = torch.rand(64) < 0.8
        state = tvq.EMACodebookState.create(8, 4, torch.Generator().manual_seed(1))
        rows = pm.row_block(64, mesh.data_rank, mesh.n_data)
        new = tvq.ema_codebook_update(state, x[rows], valid[rows], group=mesh.data_group)
        res = {"x": x, "valid": valid, "state": dataclasses.asdict(state), "new": dataclasses.asdict(new)}
    else:
        model = build(sc)
        state, step = trainer(sc, model, mesh)
        if sc.get("kind") == "resume":
            state, res["metrics"] = run_steps(model, state, step, 1, sc)
            res["params"], res["opt"] = snap(pm.gather_params(model.module, mesh)), snap(state.adamw.state_dict())
            tck.save_train_state(os.path.join(out_dir, "ck_" + sc["name"]), state, model.patchnorm)
            state, cont = run_steps(model, state, step, 1, sc)
            res["cont"] = (cont, snap(pm.gather_params(model.module, mesh)))
            model2 = build(sc)
            state2, step2 = trainer(sc, model2, mesh)
            state2, model2.patchnorm = tck.load_train_state(os.path.join(out_dir, "ck_" + sc["name"]), state2, model2.patchnorm)
            state2, resumed = run_steps(model2, state2, step2, 1, sc)
            res["resumed"] = (resumed, pm.gather_params(model2.module, mesh))
        else:
            state, res["metrics"] = run_steps(model, state, step, sc.get("steps", 1), sc)
            res["params"], res["opt"] = snap(pm.gather_params(model.module, mesh)), snap(state.adamw.state_dict())
            res["replaced"] = state.vq_replaced
            res["opt_bytes"] = opt_state_bytes(state.adamw.inner)
        if sc.get("kind") == "codes8":
            # the same step with whole-parameter AdamW8bit: the single-device update of the same gradients
            ref_model = build(sc)
            ref_state, ref_step = trainer(dict(sc, zero1=False), ref_model, mesh)
            ref_state, _ = run_steps(ref_model, ref_state, ref_step, sc.get("steps", 1), sc)
            res["opt_whole"] = ref_state.adamw.state_dict()
        if sc.get("kind") == "checkpoint":
            weights = pm.gather_params(model.module, mesh)
            if rank == groups[0][0]:
                model.save_pretrained(os.path.join(out_dir, "ckpt_" + sc["name"]), state_dict=weights)
            with torch.no_grad():
                nb = batch.replace(patches=apply_patchnorm(model.patchnorm, batch))
                out = model.module(nb, training=False)
            res["forward"] = {"codes": out["codes"], "patches": out["dct_patches"].patches}
    if rank == groups[0][0]:
        torch.save(res, os.path.join(out_dir, sc["name"] + ".pt"))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"rank {rank} done in {time.time() - t0:.1f} s", flush=True)
'''


class Ranks:
    """A gloo group of `world` rank processes running `program` (RANK_WORKER
    unless given) over a payload; the constructor returns at once, result()
    waits for them."""

    def __init__(self, tmp, payload: dict, world: int, timeout: float = 150.0, program: str = RANK_WORKER):
        self.tmp, self.world, self.timeout = str(tmp), world, timeout
        payload_path = os.path.join(self.tmp, "payload.pt")
        torch.save(payload, payload_path)
        script = os.path.join(self.tmp, "rank_worker.py")
        with open(script, "w") as f:
            f.write(program)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen(
                [sys.executable, script, str(r), str(world), str(port), payload_path, self.tmp],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
            )
            for r in range(world)
        ]
        self._outs = None

    def wait(self) -> None:
        if self._outs is not None:
            return
        outs = []
        for p in self.procs:
            try:
                out, _ = p.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                out, _ = p.communicate()
                out += "\n[killed at the time limit]"
            outs.append(out)
        self._outs = outs
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0 and f"rank {r} done" in out, f"rank {r} failed:\n{out[-6000:]}"

    def result(self, name: str) -> dict:
        self.wait()
        return torch.load(os.path.join(self.tmp, name + ".pt"), weights_only=False)


def payload_of(models: dict, batch, scenarios, grid_sizes=None, columns=None) -> dict:
    """What the ranks load: the models by name (a scenario's "model", "lfq"
    by default), the global batch, the pixel loss's grid sizes, the
    scenarios, and the image columns that a "train" scenario streams."""
    return {
        "columns": columns,
        "models": {
            name: {
                "config": m.config.to_dict(),
                "state_dict": {k: v.clone() for k, v in m.module.state_dict().items()},
                "patchnorm": (m.patchnorm.n, m.patchnorm.median, m.patchnorm.b),
            }
            for name, m in models.items()
        },
        "batch": {
            **{k: getattr(batch, k) for k in BATCH_FIELDS},
            "patch_sizes": tuple(batch.patch_sizes), "original_sizes": tuple(batch.original_sizes),
        },
        "grid_sizes": grid_sizes,
        "scenarios": scenarios,
    }


# ---------------------------------------------------------------- the tensor-parallel rules


def _jax_param_specs(model):
    _, params, _ = jax_module_and_params(model)
    specs = jmesh.param_spec(params, tensor_parallel=True)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): s for path, s in flat}


def _port_name(jax_path: str) -> str:
    from dct_autoencoder_torch.models.convert import _port_key

    return _port_key(jax_path)


def test_tp_rules_by_name_match_jax():
    """Every parameter's split dim: the port's weight (out, in) is JAX's
    kernel (in, out) transposed, so a kernel split on its out dim (column
    parallel) is a weight split on dim 0, and a kernel split on its in dim
    (row parallel) a weight split on dim 1; a bias split goes with its
    column; everything else is replicated."""
    model, _ = port_case(rows_multiple=1)
    port = pm.param_spec(model.module.state_dict().keys())
    P = jax.sharding.PartitionSpec
    want_of = {P(None, "model"): 0, P("model", None): 1, P("model"): 0, P(): None}
    jax_specs = _jax_param_specs(model)
    assert len(jax_specs) == len(port)
    for path, spec in jax_specs.items():
        assert port[_port_name(path)] == want_of[spec], (path, spec, port[_port_name(path)])
    split = {k for k, d in port.items() if d is not None}
    for layer in ("encoder.layers.0", "decoder.layers.1"):
        assert {f"{layer}.self_attn.{p}.{w}" for p in ("q_proj", "k_proj", "v_proj") for w in ("weight", "bias")} <= split
        assert port[f"{layer}.self_attn.out_proj.weight"] == 1 and port[f"{layer}.self_attn.out_proj.bias"] is None
        assert port[f"{layer}.fc1.weight"] == 0 and port[f"{layer}.fc1.bias"] == 0
        assert port[f"{layer}.fc2.weight"] == 1 and port[f"{layer}.fc2.bias"] is None
        assert port[f"{layer}.layer_norm1.weight"] is None
    assert pm.param_spec(port, tensor_parallel=False) == {k: None for k in port}


def _fake_mesh(n_model, model_rank):
    return types.SimpleNamespace(n_model=n_model, model_rank=model_rank, model_group=None)


@pytest.mark.parametrize("n_model", [2, 4])
def test_shards_are_jax_kernel_splits_transposed(n_model):
    """shard_params keeps block r of each split dim: the transpose of JAX's
    kernel split into n_model blocks on the mesh's model axis."""
    model, _ = port_case(rows_multiple=1)
    _, params, _ = jax_module_and_params(model)
    specs = _jax_param_specs(model)
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    for r in range(n_model):
        m = TorchAE(model.config, dtype=torch.float32, device="cpu")
        m.module.load_state_dict(model.module.state_dict())
        pm.shard_params(m.module, _fake_mesh(n_model, r))
        shard = m.module.state_dict()
        for path, spec in specs.items():
            if spec == jax.sharding.PartitionSpec():
                continue
            axis = list(spec).index("model")
            block = np.split(flat[path], n_model, axis=axis)[r]
            got = shard[_port_name(path)].numpy()
            np.testing.assert_array_equal(got.T if got.ndim == 2 else got, block, err_msg=path)
        heads = {st.mp.size for st in pm._stacks(m.module)}
        assert heads == {n_model}


def test_shard_then_reassemble_gives_the_state_dict():
    """The blocks of every rank, concatenated on their split dims, are the
    state_dict; load_full_state_dict keeps each rank's block of it."""
    model, _ = port_case(rows_multiple=1)
    full = model.module.state_dict()
    spec = pm.param_spec(full)
    shards = []
    for r in range(2):
        m = TorchAE(model.config, dtype=torch.float32, device="cpu")
        m.module.load_state_dict(full)
        pm.shard_params(m.module, _fake_mesh(2, r))
        shards.append(m.module.state_dict())
        again = TorchAE(model.config, dtype=torch.float32, device="cpu")
        pm.shard_params(again.module, _fake_mesh(2, r))
        pm.load_full_state_dict(again.module, full, _fake_mesh(2, r))
        for k, v in again.module.state_dict().items():
            assert torch.equal(v, shards[r][k]), k
    for k, v in full.items():
        whole = shards[0][k] if spec[k] is None else torch.cat([s[k] for s in shards], dim=spec[k])
        assert torch.equal(whole, v), k
        if spec[k] is None:
            assert torch.equal(shards[1][k], v), k


def test_shard_refuses_widths_that_do_not_divide():
    model, _ = port_case(rows_multiple=1)  # 4 heads, 128 hidden units
    with pytest.raises(ValueError, match="num_attention_heads"):
        pm.shard_params(model.module, _fake_mesh(3, 0))


# ---------------------------------------------------------------- rows


@pytest.mark.parametrize("multiple", [1, 4, 5, 8])
def test_pad_batch_rows_matches_jax(multiple):
    _, batch = port_case(rows_multiple=1)
    got = pm.pad_batch_rows(batch, multiple)
    want = jmesh.pad_batch_rows(jax_batch(batch), multiple)
    assert got.patches.shape[0] % multiple == 0
    for k in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)


def test_data_blocks_are_jax_row_shards():
    """batch_rows(batch, i, n) holds the rows that JAX's P('data') places on data index i."""
    _, batch = port_case(rows_multiple=4)
    mesh = jmesh.make_mesh(n_model=1, devices=jax.devices()[:4])
    sharded = jmesh.shard_batch(jax_batch(batch), mesh)
    for k in BATCH_FIELDS:
        leaf = getattr(sharded, k)
        for shard in leaf.addressable_shards:
            i = mesh.devices.reshape(-1).tolist().index(shard.device)
            got = getattr(pm.batch_rows(batch, i, 4), k).numpy()
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=f"{k} block {i}")
    with pytest.raises(ValueError, match="pad_batch_rows"):
        pm.batch_rows(pm.take_rows(batch, 0, 3), 0, 2)


# ---------------------------------------------------------------- ZeRO-1


@pytest.mark.parametrize("n_data,min_size", [(2, 0), (4, 0), (4, 2**13), (8, 64)])
def test_zero1_partition_matches_jax_choice_of_leaves(n_data, min_size):
    """The parameters zero1_partition splits are those whose Adam moments
    JAX's zero1_opt_spec shards over the data axis, at the same min_size."""
    import optax

    model, _ = port_case(rows_multiple=1)
    _, params, _ = jax_module_and_params(model)
    mesh = jmesh.make_mesh(n_model=1, devices=jax.devices()[:n_data])
    mu = optax.adam(1e-3).init(params)[0].mu
    specs = jmesh.zero1_opt_spec(mu, mesh, min_size=min_size)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    jax_split = {_port_name("/".join(str(getattr(p, "key", p)) for p in path)) for path, s in flat if "data" in tuple(s)}
    names, shapes = zip(*[(n, p.shape) for n, p in model.module.named_parameters()])
    chunks = pm.zero1_partition(shapes, n_data, min_size)
    port_split = {n for n, c in zip(names, chunks) if c is not None}
    assert port_split == jax_split
    for shape, chunk in zip(shapes, chunks):
        if chunk is not None:
            numel = int(np.prod(shape))
            assert chunk * n_data >= numel > chunk * (n_data - 1) - 1


@pytest.mark.parametrize("n_data", [2, 3, 4])
def test_zero1_partition_keeps_8bit_blocks_whole(n_data):
    """With block=256 each rank's slice starts on a block edge and ends on one
    or at the parameter's end: the slices' blocks are the parameter's."""
    shapes = [(64, 64), (300,), (1000, 3), (17, 256), (8192,), (5, 7)]
    for shape, chunk in zip(shapes, pm.zero1_partition(shapes, n_data, min_size=0, block=256)):
        numel = int(np.prod(shape))
        if chunk is None:
            assert not any(d >= n_data and d % n_data == 0 for d in shape)
            continue
        assert chunk % 256 == 0
        edges = [min(r * chunk, numel) for r in range(n_data + 1)]
        assert edges[-1] == numel
        assert all(e % 256 == 0 or e == numel for e in edges)


# ---------------------------------------------------------------- sequence parallelism and the pipeline


def test_with_sequence_parallel_matches_jax():
    from dct_autoencoder_torch.models.config import with_sequence_parallel
    from dct_autoencoder_tpu.models.config import with_sequence_parallel as jax_with_sp

    cfg = tiny_config()
    port = with_sequence_parallel(TorchConfig.from_dict(cfg.to_dict()))
    want = jax_with_sp(cfg)
    assert port.to_dict() == TorchConfig.from_dict(want.to_dict()).to_dict()
    assert port.encoder_config.sequence_parallel and port.decoder_config.sequence_parallel
    assert not tiny_config().encoder_config.sequence_parallel


def test_pipeline_data_parallel_equals_the_plain_pipeline():
    """DCTPipeline(data_parallel=True) over two CPU copies: records equal to
    the single-device pipeline's, token ids exactly; the JAX package's
    from_dict reads them to the same ids and positions."""
    from dct_autoencoder_torch.patches.container import from_dict as port_from_dict
    from dct_autoencoder_torch.pipeline import DCTPipeline
    from dct_autoencoder_tpu.patches.container import from_dict as jax_from_dict

    model, proc = torch_model_and_processor(
        tiny_config(), dtype=torch.float32, sample_patches_beta=0.0, seed=4, device="cpu"
    )
    rng = np.random.default_rng(4)
    ims = [rng.uniform(0.05, 0.95, size=(3, h, w)).astype(np.float32) for h, w in SIZES[:7]]
    plain = DCTPipeline(model, proc).encode(ims)
    dp = DCTPipeline(model, proc, data_parallel=True, devices=["cpu", "cpu"])
    assert len(dp._replicas) == 2 and dp._replicas[1][0] is not model.module
    got = dp.encode(ims)
    assert len(got) == len(plain) == len(ims)
    for a, b in zip(got, plain):
        assert a == b
        jdp, jcodes = jax_from_dict(a)
        tdp, tcodes = port_from_dict(a)
        np.testing.assert_array_equal(np.asarray(jcodes), tcodes)
        np.testing.assert_array_equal(np.asarray(jdp.patch_positions), tdp.patch_positions.numpy())
    # one block on one device: the plain forward
    one = DCTPipeline(model, proc, data_parallel=True, devices=["cpu"])
    assert one.encode(ims) == plain
    rec = dp.reconstruct_direct(ims[:2])
    for a, b in zip(rec, DCTPipeline(model, proc).reconstruct_direct(ims[:2])):
        np.testing.assert_array_equal(a, b)
