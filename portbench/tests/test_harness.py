"""The harness on the CPU: cells and metrics found by name, the contract's
character rules, traffic from the seed, what each cell reports, the JAX check."""
import json
import os
import re
import shutil
import sys

import pytest
import torch

from portbench import common, inputs, run
from portbench.kinds import recon, train

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names():
    out = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    out += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    return out + [k for c in BENCH["configs"] for k in c["reduced"]]


@pytest.mark.parametrize("name", _names())
def test_every_name_is_in_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_unit_and_one_line_field_is_allowed(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    for key in ("layer", "moves"):
        if key in metric:
            assert 1 <= len(metric[key]) <= 200 and "\n" not in metric[key] and "\t" not in metric[key]


def test_names_are_unique_and_files_exist():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names)), group
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        spec = common.find_cell(w["name"])
        assert spec["traffic"]["kind"] in ("train", "recon")
        assert os.path.exists(os.path.join(common.HERE, "kinds", spec["traffic"]["kind"] + ".py"))
    for m in BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_an_end_to_end_metric_every_listed_cell_reports(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert common.in_cell(moved, cell), (metric["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if common.in_cell(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(common.in_cell(m, w["name"]) for m in BENCH["per_layer"])


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(common.HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "recon-full-4x448", "config": "patch14l-lfq", "traffic": "recon-4x448", "chips": 1, "why": "x"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "calls.recon", "unit": "calls", "better": "higher", "source": "program_counter", "layer": "serving entry",
         "moves": "recon_images_per_s", "workloads": ["recon-full-4x448"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "portbench/traffic/recon-8x448.json").read_text())
    (root / "portbench/traffic/recon-4x448.json").write_text(json.dumps(dict(traffic, images_per_call=4)))
    (root / "portbench/limits/recon-full-4x448.json").write_text('{"pixel_mse": 0.0001, "answer_rmse": 0.05}')
    (root / "portbench/metrics/calls.recon.py").write_text("def read(cell, counters):\n    return counters['calls']\n")
    spec = common.find_cell("recon-full-4x448", root=str(root), here=str(root / "portbench"))
    assert spec["traffic"]["images_per_call"] == 4
    assert [m["name"] for m in spec["per_layer"]][-1] == "calls.recon"
    assert run.reader("calls.recon", root=str(root / "portbench"))(None, {"calls": 7}) == 7


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert common.banned_modules() == []
    for name in ("jaxtyping", "dct_autoencoder_torch", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert common.banned_modules() == []
    for name in ("jax.numpy", "flax", "dct_autoencoder_tpu.models", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert common.banned_modules() == ["dct_autoencoder_tpu", "flax", "jax", "jaxlib"]


def test_the_harness_and_reference_load_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.'); import portbench.run, portbench.calibrate, portbench.kinds.train, "
            "portbench.kinds.recon, dct_autoencoder_torch; from portbench import common; print(common.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(common.HERE, "reference")):
        if f.endswith(".py"):
            text = open(os.path.join(common.HERE, "reference", f)).read()
            assert "dct_autoencoder" not in text and "jax" not in text, f


def test_train_pool_packs_alike_for_every_seed_and_its_images_follow_the_seed():
    tr = common.find_cell("train-lfq-64x256")["traffic"]
    assert train.pool_plan(tr, 5) == train.pool_plan(tr, 2**31 + 11)  # the same sizes and draws, in the same order
    sizes, draws = train.pool_plan(tr, 5)
    assert sorted(draws) == list(inputs.stratified(tr["pool_images"]))
    small = dict(tr, pool_images=6, image_sizes=[[28, 42], [56, 56]])
    x, y, z = (train.pool_images(small, s, "cpu") for s in (9, 9, 10))
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert not all(torch.equal(p, q) for p, q in zip(x, z))


def test_recon_pool_and_weights_are_the_same_for_a_seed():
    spec = common.find_cell("recon-full-8x448")
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell("recon-full-8x448", seed=2**31 + 5)
    assert all(torch.equal(p, q) for p, q in zip(recon.pool(cell, "cpu"), recon.pool(cell, "cpu")))
    w1, w2 = inputs.make_weights(cell.config, 3, "cpu"), inputs.make_weights(cell.config, 3, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert spec["traffic"]["beta"] == 0.0


def test_percentile_takes_every_call():
    assert recon.percentile(sorted(range(101)), 0.95) == pytest.approx(95.0)
