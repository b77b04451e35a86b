"""A run with its timed path broken underneath comes out not correct, and the control
(the reference on fp8 operands in the program's place) reads further from the
reference than the program does. On the CPU at the Micro size, with the limits of the
cells that the faults belong to."""

import pytest

from benchmark import calibrate, harness
from test_bench_reference import TRAIN_PARAMS, _cell


@pytest.mark.parametrize("config,fault", [("micro-256", "unchanged"),
                                          ("micro-256", "half_batch"),
                                          ("micro-512", "unchanged"),
                                          ("micro-512", "half_batch")])
def test_a_broken_training_step_is_not_correct(config, fault):
    cell = "xl256-train" if config == "micro-256" else "xl512-train"
    limits = harness.workload(cell)["limits"]
    out = harness.runner("train").run(_cell(config, "train", TRAIN_PARAMS, limits, fault))
    assert not harness.judged(out["checks"]), out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_sampler_is_not_correct(fault):
    params = {"prompts": 4, "steps": 3, "check_per_call": 2}
    limits = harness.workload("xl512-sample")["limits"]
    out = harness.runner("sample").run(_cell("micro-512", "sample-b32", params, limits, fault))
    assert not harness.judged(out["checks"]), out["checks"]


def test_the_control_reads_further_than_the_program():
    """The bf16 program's readings and the fp8 control's, on the same seed: the
    control's widest reading is several times the program's."""
    cell = _cell("micro-512", "train", TRAIN_PARAMS, harness.workload("xl512-train")["limits"])
    out = harness.runner("train").run(cell)
    prog = {**{k: c["value"] for k, c in out["checks"].items()}, **out["readings"]}
    control = calibrate.control_train(cell)
    assert max(control["control"][k] / max(prog[k], 1e-12)
               for k in ("loss", "grad", "update")) > 3, (prog, control)
    assert control["half_batch"]["loss"] > 10 * prog["loss"]


def test_the_sampling_control_reads_further_than_the_program():
    """The fp8 control against the program, and the planted Heun weight and start row
    against the cell's limits, which the program reads under."""
    params = {"prompts": 4, "steps": 3, "check_per_call": 2}
    cell = _cell("micro-512", "sample-b32", params, harness.workload("xl512-sample")["limits"])
    prog = {k: c["value"] for k, c in harness.runner("sample").run(cell)["checks"].items()}
    got = calibrate.control_sample(cell)
    control = got["control"]
    assert control["denoise"] > 3 * prog["denoise"] and control["decode"] > 3 * prog["decode"]
    limits = harness.workload("xl512-sample")["limits"]
    assert got["heun_weight"]["heun"] > limits["heun"] > prog["heun"]
    assert got["start_row"]["start"] > limits["start"] > prog["start"]
