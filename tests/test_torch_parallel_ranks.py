"""The sharded train step over a gloo group of 4 CPU processes, against the
JAX package's single-device step and the port's single-process step.

One group of 4 ranks is spawned once for the file (a module-scoped
fixture) and runs every scenario: dp4; dp2 x tp2; dp2 x tp2 with sequence
parallelism; dp4 with ZeRO-1 (fp32), with a resume; dp2 with ZeRO-1 and
8-bit moments (two dp2 groups side by side); dp2 x tp2 with ZeRO-1 and 8-bit
moments; accumulation 2 x dp2; a checkpoint written by dp2 x tp2.  The model is tests/test_model.py's tiny
config at random init (fp32), the batch ten seeded images of several sizes
packed into rows that hold several images and padding, padded to 4 rows.
While the ranks run, this process computes the references: JAX's jitted
single-device make_train_step on the same parameters (converted) and batch,
and the port's single-process make_train_step.

Tolerances:
  * loss within rtol 1e-4 and grad_norm within rtol 1e-3 of JAX's, as
    tests/test_parallel.py holds JAX's sharded step to its single device;
  * parameters after the step against the port's single-process step:
    tests/test_torch_parallel.py::assert_params_close (1e-5, but for Adam's
    first direction on gradients within rounding of 0);
  * exact: the coordinates of each rank, a ZeRO-1 resume against the
    continued run, ZeRO-1's 8-bit codes against unsliced AdamW8bit on the
    same gradients, the bytes of a tensor-parallel rank's moments, the
    token ids of a tensor-parallel checkpoint loaded
    in the single-device port (its features within 1e-5), and its weights
    loaded by the JAX package.
"""
import jax
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.models.patchnorm import apply_patchnorm
from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_tpu.train import loop as jloop
from test_torch_parallel import (
    Ranks,
    assert_params_close,
    jax_batch,
    jax_module_and_params,
    jax_patchnorm,
    payload_of,
    port_case,
)

WORLD = [[0, 1, 2, 3]]
PAIRS = [[0, 1], [2, 3]]
SCENARIOS = [
    dict(name="dp4", groups=WORLD),
    dict(name="dp2_tp2", groups=WORLD, n_model=2),
    dict(name="dp2_tp2_sp", groups=WORLD, n_model=2, sp=True),
    dict(name="dp4_zero1", groups=WORLD, zero1=True, kind="resume"),
    dict(name="dp2_zero1_8bit", groups=PAIRS, zero1=True, opt_8bit=True, kind="codes8"),
    dict(name="dp2_tp2_zero1_8bit", groups=WORLD, n_model=2, zero1=True, opt_8bit=True, kind="codes8"),
    dict(name="dp2_accum2", groups=PAIRS, accum=2),
    dict(name="dp2_tp2_checkpoint", groups=WORLD, n_model=2, kind="checkpoint"),
]
LR = 1e-3


def port_step(model, batch, accum=1, opt_8bit=False):
    """The port's single-process step from the case's weights: (metrics, state_dict)."""
    m = TorchAE(model.config, dtype=torch.float32, device="cpu")
    m.module.load_state_dict(model.module.state_dict())
    tx = tloop.make_optimizer(LR, 10, warmup_steps=0, opt_8bit=opt_8bit)
    state = tloop.TrainState.create(m.module, tx)
    state, metrics = tloop.make_train_step(m.module, tx, accum_steps=accum)(state, model.patchnorm, batch)
    return {k: float(v) for k, v in metrics.items()}, m.module.state_dict(), state.adamw.state_dict()


def jax_step(model, batch, accum=1):
    module, params, _ = jax_module_and_params(model)
    tx = jloop.make_optimizer(learning_rate=LR, max_iters=10, warmup_steps=0)
    step = jax.jit(jloop.make_train_step(module, tx, accum_steps=accum))
    jb, _ = jloop.prepare_train_batch(jax_batch(batch))
    _, metrics = step(jloop.TrainState.create(params, tx), jax_patchnorm(model.patchnorm), jb)
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    model, batch = port_case()
    ranks = Ranks(tmp_path_factory.mktemp("ranks"), payload_of({"lfq": model}, batch, SCENARIOS), world=4)
    batch = tloop.prepare_train_batch(batch)[0]
    refs = {
        "jax": {a: jax_step(model, batch, a) for a in (1, 2)},
        "port": {(a, b8): port_step(model, batch, a, b8) for a, b8 in ((1, False), (2, False), (1, True))},
    }
    ranks.wait()
    return model, batch, ranks, refs


@pytest.mark.parametrize(
    "name", ["dp4", "dp2_tp2", "dp2_tp2_sp", "dp4_zero1", "dp2_zero1_8bit", "dp2_accum2", "dp2_tp2_zero1_8bit"]
)
def test_sharded_step_matches_jax_and_the_single_process_step(case, name):
    model, batch, ranks, refs = case
    sc = next(s for s in SCENARIOS if s["name"] == name)
    accum, opt_8bit = sc.get("accum", 1), sc.get("opt_8bit", False)
    got = ranks.result(name)
    metrics = got["metrics"][0]
    want = refs["jax"][accum]
    np.testing.assert_allclose(metrics["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"], want["grad_norm"], rtol=1e-3)
    port_metrics, port_params, _ = refs["port"][(accum, opt_8bit)]
    for k in port_metrics:
        np.testing.assert_allclose(metrics[k], port_metrics[k], rtol=1e-4, err_msg=k)
    assert got["params"].keys() == port_params.keys()
    assert all(got["params"][k].shape == v.shape for k, v in port_params.items())
    assert_params_close(got["params"], port_params, LR, what=name)


def test_zero1_resume_equals_the_continued_run(case):
    """(step, save, load, step) == (step, step), bit for bit, with the state
    saved as one single-device file and loaded back into the slices."""
    _, _, ranks, _ = case
    got = ranks.result("dp4_zero1")
    (cont, cont_params), (resumed, resumed_params) = got["cont"], got["resumed"]
    assert cont == resumed
    for k, v in cont_params.items():
        assert torch.equal(v, resumed_params[k]), k


def test_zero1_state_dict_is_the_single_device_one(case):
    """The ZeRO-1 optimizer's state_dict has the single-device layout (every
    moment whole, shaped as its parameter) and its values."""
    _, _, ranks, refs = case
    _, _, want = refs["port"][(1, False)]
    _assert_state_dict_is(ranks.result("dp4_zero1")["opt"], want)


def test_zero1_8bit_codes_equal_the_whole_parameter_update(case):
    """dp2 with ZeRO-1 and AdamW8bit: each rank quantizes its slices, whose
    edges are 256-value block edges; the gathered codes and absmax equal, bit
    for bit, those of AdamW8bit over the whole parameters on the same summed
    gradients (the step without ZeRO-1)."""
    _, _, ranks, _ = case
    _assert_codes_equal(ranks.result("dp2_zero1_8bit"))


def test_tensor_parallel_zero1_8bit_codes_equal_the_unsliced_update(case):
    """dp2 x tp2 with ZeRO-1 and AdamW8bit: the parameters split on dim 0
    are updated on each rank's block (its own 256-value blocks), those split
    on dim 1 and the small biases whole; sliced over the data ranks too, the
    gathered codes equal, bit for bit, those of the same step without
    ZeRO-1."""
    _, _, ranks, _ = case
    _assert_codes_equal(ranks.result("dp2_tp2_zero1_8bit"))


def test_tensor_parallel_optimizer_keeps_its_blocks(case):
    """dp2 x tp2, fp32 AdamW: a rank's moments are those of its blocks (half
    of each split parameter's, as JAX splits them on the model axis), and
    its state_dict is the single-device one in layout and values."""
    model, _, ranks, refs = case
    got = ranks.result("dp2_tp2")
    _, _, want = refs["port"][(1, False)]
    names = [n for n, _ in model.module.named_parameters()]
    spec = pm.param_spec(names)
    half = 0
    for j, st in want["state"].items():
        for v in st.values():
            half += v.numel() * v.element_size() // (2 if v.ndim and spec[names[j]] is not None else 1)
    assert got["opt_bytes"] == half
    assert any(d is not None for d in spec.values())
    # a tensor-parallel forward sums the model ranks' partial products in
    # another order than one device, which the entropy loss's temperature of
    # 0.01 amplifies: the moments are held as the grad norm is, rtol 1e-3
    # (and atol 1e-6 on moments of about 1e-3)
    _assert_state_dict_is(got["opt"], want, rtol=1e-3, atol=1e-6)


def _assert_state_dict_is(got, want, rtol=1e-7, atol=1e-7):
    assert got["state"].keys() == want["state"].keys()
    assert [g["params"] for g in got["param_groups"]] == [g["params"] for g in want["param_groups"]]
    for j, st in want["state"].items():
        for key, v in st.items():
            assert got["state"][j][key].shape == v.shape, (j, key)
            if key == "exp_avg":
                np.testing.assert_allclose(
                    got["state"][j][key].numpy(), v.numpy(), rtol=rtol, atol=atol, err_msg=f"{j} {key}"
                )


def _assert_codes_equal(got):
    sliced, whole = got["opt"], got["opt_whole"]
    assert sliced["state"].keys() == whole["state"].keys()
    assert sliced["param_groups"][0]["count"] == whole["param_groups"][0]["count"] == 1
    n_codes = 0
    for j, st in whole["state"].items():
        for key, v in st.items():
            assert torch.equal(sliced["state"][j][key], v), (j, key)
            n_codes += v.numel() if key.endswith("codes") else 0
    assert n_codes > 0


def test_tensor_parallel_checkpoint_loads_in_the_single_device_port(case, tmp_path):
    """dp2 x tp2 after a step: rank 0 writes the gathered weights with
    save_pretrained; the single-device port loads them and gives the
    sharded forward's token ids and features."""
    model, batch, ranks, _ = case
    got = ranks.result("dp2_tp2_checkpoint")
    loaded = TorchAE.from_pretrained(f"{ranks.tmp}/ckpt_dp2_tp2_checkpoint", dtype=torch.float32, device="cpu")
    loaded.patchnorm = model.patchnorm
    for k, v in got["params"].items():
        assert torch.equal(loaded.module.state_dict()[k], v), k
    with torch.no_grad():
        out = loaded.module(batch.replace(patches=apply_patchnorm(model.patchnorm, batch)), training=False)
    assert torch.equal(out["codes"], got["forward"]["codes"])
    np.testing.assert_allclose(out["dct_patches"].patches.numpy(), got["forward"]["patches"].numpy(), atol=1e-5)
    # and the JAX package loads the same weights from it
    from dct_autoencoder_torch.models.convert import jax_arrays_from_state_dict
    from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE

    jm = JaxAE.from_pretrained(f"{ranks.tmp}/ckpt_dp2_tp2_checkpoint")
    jflat = {JaxAE._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    want = jax_arrays_from_state_dict(got["params"], model.config)
    assert jflat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
