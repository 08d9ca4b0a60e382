"""The pipelined train step (GPipe over the model axis, parallel/pipeline.py)
over a gloo group of 4 CPU processes, against the JAX package's
single-device step and the port's single-process step.

One group of 4 ranks is spawned once for the file (a module-scoped fixture,
the rank program of tests/test_torch_parallel.py) and runs: pp2 x dp2 (fp32
AdamW, whose optimizer state is held in bytes); pp4; pp2 x dp2 with ZeRO-1
and 8-bit moments (beside the same step without ZeRO-1).  Accumulation is
in tests/test_torch_pipeline_checkpoint.py, so that each file compiles one
JAX step.  The model is tests/test_model.py's tiny
config with 4 + 4 layers (`tiny4`) at random init (fp32), the batch ten seeded images of
several sizes packed into rows, padded to 8 rows (accumulation x data ranks
x microbatches).  While the ranks run, this process computes the references.

Tolerances, as tests/test_torch_parallel_ranks.py holds the other layouts:
  * loss within rtol 1e-4 and grad_norm within rtol 1e-3 of JAX's jitted
    single-device step, as tests/test_parallel.py holds JAX's pipelined step
    to its single device;
  * parameters after the step against the port's single-process step:
    tests/test_torch_parallel.py::assert_params_close;
  * exact: ZeRO-1's 8-bit codes against the unsliced update of the same
    gradients, the optimizer state's layout and the bytes a stage holds.
"""
import numpy as np
import pytest
import torch

from dct_autoencoder_torch.parallel import mesh as pm
from dct_autoencoder_torch.train import loop as tloop
from test_torch_parallel import (
    Ranks,
    assert_params_close,
    payload_of,
    port_case,
)
from test_torch_parallel_ranks import LR, _assert_codes_equal, jax_step, port_step

WORLD = [[0, 1, 2, 3]]


def tiny4():
    """tests/test_model.py's tiny config with 4 layers a stack: 1, 2 or 4 stages."""
    import dataclasses

    from test_model import tiny_config

    cfg = tiny_config()
    stack = dataclasses.replace(cfg.encoder_config, num_hidden_layers=4)
    return dataclasses.replace(cfg, encoder_config=stack, decoder_config=stack)


SCENARIOS = [
    dict(name="pp2_dp2", groups=WORLD, n_model=2, pp=2),
    dict(name="pp4", groups=WORLD, n_model=4, pp=2),
    dict(name="pp2_dp2_zero1_8bit", groups=WORLD, n_model=2, pp=2, zero1=True, opt_8bit=True, kind="codes8"),
]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    torch.set_num_threads(1)
    model, batch = port_case(rows_multiple=8, config=tiny4())
    ranks = Ranks(tmp_path_factory.mktemp("ranks"), payload_of({"lfq": model}, batch, SCENARIOS), world=4)
    batch = tloop.prepare_train_batch(batch)[0]
    refs = {
        "jax": jax_step(model, batch),
        "port": {b8: port_step(model, batch, 1, b8) for b8 in (False, True)},
    }
    ranks.wait()
    return model, batch, ranks, refs


def assert_step_matches(got: dict, jax_metrics: dict, port_ref, what: str) -> None:
    """A pipelined step's metrics against JAX's (loss rtol 1e-4, grad norm
    rtol 1e-3) and the port's single-process step's (rtol 1e-4), and its
    gathered parameters, in the single-device order, against the latter's."""
    metrics = got["metrics"][0]
    np.testing.assert_allclose(metrics["loss"], jax_metrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(metrics["grad_norm"], jax_metrics["grad_norm"], rtol=1e-3)
    port_metrics, port_params, _ = port_ref
    for k in port_metrics:
        np.testing.assert_allclose(metrics[k], port_metrics[k], rtol=1e-4, err_msg=k)
    assert list(got["params"]) == list(port_params)
    assert all(got["params"][k].shape == v.shape for k, v in port_params.items())
    assert_params_close(got["params"], port_params, LR, what=what)


@pytest.mark.parametrize("name", ["pp2_dp2", "pp4", "pp2_dp2_zero1_8bit"])
def test_pipelined_step_matches_jax_and_the_single_process_step(case, name):
    _, _, ranks, refs = case
    opt_8bit = next(s for s in SCENARIOS if s["name"] == name).get("opt_8bit", False)
    assert_step_matches(ranks.result(name), refs["jax"], refs["port"][opt_8bit], name)


def test_pipelined_zero1_8bit_codes_equal_the_unsliced_update(case):
    """pp2 x dp2 with ZeRO-1 and AdamW8bit: a stage-owned parameter is
    updated whole on its stage (its own 256-value blocks), sliced over the
    data ranks; the gathered codes equal, bit for bit, those of the same
    step without ZeRO-1."""
    _, _, ranks, _ = case
    _assert_codes_equal(ranks.result("pp2_dp2_zero1_8bit"))


def test_a_stage_holds_its_layers_and_their_moments(case):
    """pp2 x dp2, fp32 AdamW: rank 0 (stage 0) holds the moments of the
    replicated parameters whole and those of its half of each stack's
    layers, in bytes; its state_dict is the single-device one in layout and
    values (moments of every layer, keyed by single-device index)."""
    model, _, ranks, refs = case
    got = ranks.result("pp2_dp2")
    _, _, want = refs["port"][False]
    names = [n for n, _ in model.module.named_parameters()]
    layer = [".layers." in n for n in names]
    stage_share, layers_total = 0, 0
    for j, st in want["state"].items():
        # every layer's parameter has its twin on the other stage: the stage holds half their bytes
        nbytes = sum(v.numel() * v.element_size() for v in st.values())
        stage_share += nbytes / 2 if layer[j] else nbytes
        layers_total += nbytes if layer[j] else 0
    assert got["opt_bytes"] == stage_share and layers_total > 0
    assert got["opt"]["state"].keys() == want["state"].keys()
    assert [g["params"] for g in got["opt"]["param_groups"]] == [g["params"] for g in want["param_groups"]]
    for j, st in want["state"].items():
        for key, v in st.items():
            assert got["opt"]["state"][j][key].shape == v.shape, (j, key)
            if key == "exp_avg":
                np.testing.assert_allclose(got["opt"]["state"][j][key].numpy(), v.numpy(), rtol=1e-3, atol=1e-6)


def test_stage_layout_and_refusals():
    """stage_layers splits a stack into contiguous stages and names the stage
    count where it does not divide (JAX's words); a staged stack keeps its
    stage's layers under their single-device keys and refuses a KV-cached
    decode, dropout in training and a per-layer int8/bf16 mix by name."""
    import types

    from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
    from dct_autoencoder_torch.models.transformer import KVCache
    from dct_autoencoder_torch.parallel.pipeline import make_pipelined_module
    from test_model import tiny_config

    assert [list(pm.stage_layers(8, 4, s)) for s in range(4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="3 layers not divisible into 4 pipeline stages"):
        pm.stage_layers(3, 4, 0)
    full = TorchAE(tiny4(), dtype=torch.float32, device="cpu").module.state_dict()
    for stage in range(2):
        m = TorchAE(tiny4(), dtype=torch.float32, device="cpu")
        make_pipelined_module(m.module, types.SimpleNamespace(n_model=2, model_rank=stage, n_data=1), 2)
        keys = list(m.module.state_dict())
        owned = [f".layers.{i}." for i in pm.stage_layers(4, 2, stage)]
        assert [k for k in full if ".layers." not in k or any(o in k for o in owned)] == keys
        assert pm.is_sharded(m.module)
        with pytest.raises(ValueError, match="KV-cached decode"):
            m.module.decoder.decode_step(torch.zeros(1, 1, 64), KVCache(tiny_config().decoder_config, 1, 4, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="stages"):
        make_pipelined_module(TorchAE(tiny_config(), device="cpu").module, types.SimpleNamespace(n_model=4, model_rank=0), 2)
    import dataclasses

    mixed = tiny4()
    mixed = dataclasses.replace(mixed, encoder_config=dataclasses.replace(
        mixed.encoder_config, quantize_int8=True, quantize_int8_bf16_layers=(0,)))
    with pytest.raises(ValueError, match="homogeneous"):
        make_pipelined_module(TorchAE(mixed, device="cpu").module, types.SimpleNamespace(n_model=2, model_rank=0), 2)
    with pytest.raises(ValueError, match="dropout"):

        cfg = tiny4()
        cfg = dataclasses.replace(cfg, encoder_config=dataclasses.replace(cfg.encoder_config, dropout=0.1))
        m = TorchAE(cfg, device="cpu")
        make_pipelined_module(m.module, types.SimpleNamespace(n_model=1, model_rank=0, n_data=1), 1)
        x = torch.zeros(1, 4, 64)
        m.module.encoder(x, torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4, dtype=torch.bool), training=True)
