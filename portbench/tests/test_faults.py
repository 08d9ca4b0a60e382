"""A run's path below the look for a chip, on the CPU at a small size: sound,
it comes out correct; with a fault planted under the timed path, or with the
reference in float8 in the program's place, it comes out not correct."""
import pytest
import torch

from portbench import calibrate
from portbench.kinds import recon, train
from portbench.reference.compare import passed
from portbench.tests.tiny import tiny_cell

SECONDS = 0.3


def test_a_sound_float32_training_run_is_correct():
    cell = tiny_cell("train-lfq-64x256", seconds=SECONDS)
    cell.config["dtype"] = "float32"
    out = train.run(cell)
    assert passed(out["checks"]), out["checks"]
    assert out["window_steps"] >= 1 and out["images"] == sum(out["images_per_step"])
    assert list(out["logged_images"]) == [0]  # the CLI's cadence: no log, so no wait for the host, in the window


def test_the_images_counted_on_the_device_are_the_trainer_s_own():
    cell = tiny_cell("train-lfq-64x256", seconds=SECONDS, log_every=1)
    out = train.run(cell)
    w0 = cell.traffic["warmup_steps"]
    assert out["images_per_step"] == [out["logged_images"][w0 + i] for i in range(out["window_steps"])]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_training_fault_is_not_correct(fault):
    cell = tiny_cell("train-lfq-64x256", seconds=SECONDS)
    cell.fault = fault
    out = train.run(cell)
    assert not passed(out["checks"]), out["checks"]


def test_a_sound_serving_run_is_correct():
    cell = tiny_cell("recon-full-8x448", seconds=SECONDS)
    cell.config["dtype"] = "float32"
    out = recon.run(cell)
    assert passed(out["checks"]) and out["failed"] == 0, out["checks"]


def test_an_altered_answer_is_not_correct():
    cell = tiny_cell("recon-full-8x448", seconds=SECONDS)
    cell.fault = "answer"
    out = recon.run(cell)
    assert not passed(out["checks"]), out["checks"]


@pytest.mark.parametrize("workload", ["train-lfq-64x256", "recon-full-8x448"])
def test_the_float8_control_reads_worse_than_a_sound_run(workload):
    cell = tiny_cell(workload, seconds=SECONDS)
    control = calibrate.lower_precision(cell, torch.device("cpu"))
    kind = train if workload.startswith("train") else recon
    sound = kind.run(cell)["checks"]
    assert any(control[k]["value"] > sound[k]["value"] for k in control), (control, sound)


def test_calibration_refuses_to_read_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert calibrate.main(["--workload", "train-lfq-64x256", "--seeds", "1", "--program"]) == 3
