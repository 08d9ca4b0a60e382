"""Attention dropout under data and tensor parallelism, over a gloo group of
2 CPU processes, against the port's single-process step.

The kernels draw the keep bits by (batch row, head, query, key) from one
seed (csrc/attn_dropout.cuh); a data-parallel rank passes where its rows
start in the micro-batch and a tensor-parallel rank where its heads start,
so each draws its block of the single-device mask, and every rank draws the
same seeds from the step's generator.  So the sharded step with attention
dropout gives the single-device step's numbers.  The model is
tests/test_model.py's tiny config at random init (fp32) with attention
dropout 0.3 and MLP dropout 0 (whose masks are drawn per rank), the batch
the multi-process tests' ten packed images (tests/test_torch_parallel.py).

Tolerances: loss rtol 1e-5 and grad norm rtol 1e-4 of the single-process
step (the sums of the losses and gradients over the ranks run in another
order); parameters after the step as
tests/test_torch_parallel.py::assert_params_close holds them.
"""
import dataclasses

import torch

from dct_autoencoder_torch.models.autoencoder import DCTAutoencoder as TorchAE
from dct_autoencoder_torch.train import loop as tloop
from test_model import tiny_config
from test_torch_parallel import Ranks, assert_params_close, payload_of, port_case
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

RATE = 0.3
LR = 1e-3
SCENARIOS = [dict(name="dp2", groups=[[0, 1]]), dict(name="tp2", groups=[[0, 1]], n_model=2)]


def _config(rate):
    cfg = tiny_config()
    return dataclasses.replace(cfg, encoder_config=dataclasses.replace(cfg.encoder_config, attention_dropout=rate))


def single_step(model, batch):
    """The port's single-process step from the case's weights: (metrics, state_dict)."""
    m = TorchAE(model.config, dtype=torch.float32, device="cpu")
    m.module.load_state_dict(model.module.state_dict())
    tx = tloop.make_optimizer(LR, 10, warmup_steps=0)
    state = tloop.TrainState.create(m.module, tx)
    state, metrics = tloop.make_train_step(m.module, tx)(state, model.patchnorm, batch)
    return {k: float(v) for k, v in metrics.items()}, m.module.state_dict()


def test_sharded_steps_draw_the_single_device_masks(tmp_path):
    model, batch = port_case(config=_config(RATE))
    ranks = Ranks(tmp_path, payload_of({"lfq": model}, batch, SCENARIOS), world=2)
    want, want_params = single_step(model, batch)  # meanwhile, in this process
    no_drop, _ = single_step(port_case(config=_config(0.0))[0], batch)
    assert abs(no_drop["loss"] - want["loss"]) > 1e-4 * abs(want["loss"])  # the rate takes effect
    for sc in SCENARIOS:
        res = ranks.result(sc["name"])
        got = res["metrics"][0]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (sc["name"], got["loss"], want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-4 * want["grad_norm"], sc["name"]
        assert_params_close(res["params"], want_params, LR, what=sc["name"])
