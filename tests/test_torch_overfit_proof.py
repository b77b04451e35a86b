"""The port's learning proof (micro_diffusion_tpu_torch/scripts/overfit_proof.py) on
the CPU: MicroDiT-Micro in fp32, 20 steps with the fresh trainer's autoresume at 10;
the record has the JAX record's keys, and its windows and pass field follow from its
own loss curve by the JAX script's rule (scripts/overfit_proof.py:139-158)."""

import json
import os

import numpy as np
import pytest
import torch

from micro_diffusion_tpu_torch.scripts import overfit_proof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(ROOT, "bench_runs", "overfit_r5_tpu_bf16.json")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Micro's steps are small: more intra-op threads buy little, and in a parallel
    test run they oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_overfit_proof_cpu_record(tmp_path):
    out = tmp_path / "rec.json"
    rc = overfit_proof.main(["--device", "cpu", "--steps", "20", "--out", str(out),
                             "--workdir", str(tmp_path / "work")])
    rec = json.loads(out.read_text())
    with open(JAX_RECORD) as f:
        assert rec.keys() == json.load(f).keys()
    assert rec["steps"] == 20 and rec["resume_at"] == 10
    assert rec["model"] == "MicroDiT_Micro_2 (float32)" and rec["device"] == "cpu"
    # the trainer keeps one checkpoint: the half-way one gave way to the final one
    assert os.listdir(tmp_path / "work" / "ckpts") == ["20"]
    steps, vals = zip(*rec["loss_curve"])
    assert steps == (5, 10, 15, 20)  # a row every METRIC_WINDOW steps, across the resume
    assert all(np.isfinite(vals))
    # the windows of 4 rows: fifths of at least 2 rows, thirds of 1, 1 and 2 rows
    assert rec["loss_first_window"] == pytest.approx(np.mean(vals[:2]), abs=1e-4)
    assert rec["loss_last_window"] == pytest.approx(np.mean(vals[2:]), abs=1e-4)
    np.testing.assert_allclose(rec["loss_thirds"], [vals[0], vals[1], np.mean(vals[2:])],
                               atol=1e-4)
    # before ema_start (50) the EMA follows the parameters: the probe moves already
    assert rec["generate_rel_change_vs_init"] > 0
    assert rec["pass"] == overfit_proof.passes(
        rec["loss_first_window"], rec["loss_last_window"], rec["loss_thirds"],
        rec["generate_rel_change_vs_init"])
    assert rc == (0 if rec["pass"] else 1)


@pytest.mark.parametrize("vals, first, last, thirds", [
    (list(range(1, 16)), 2.0, 14.0, [3.0, 8.0, 13.0]),       # fifths of 3 rows
    ([4.0, 3.0, 2.0, 1.0], 3.5, 1.5, [4.0, 3.0, 1.5]),       # the 2-row floor
])
def test_windows(vals, first, last, thirds):
    w = overfit_proof.windows(vals)
    assert (w["first"], w["last"]) == (first, last)
    assert w["thirds"] == thirds


def test_pass_rule():
    assert overfit_proof.passes(1.0, 0.74, [1.0, 0.8, 0.7], 0.16)
    assert not overfit_proof.passes(1.0, 0.75, [1.0, 0.8, 0.7], 0.16)   # not below 0.75x
    assert not overfit_proof.passes(1.0, 0.5, [0.7, 0.8, 0.7], 0.16)    # last third
    assert not overfit_proof.passes(1.0, 0.5, [1.0, 0.8, 0.7], 0.15)    # generate()


def test_default_device_is_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        overfit_proof.main(["--steps", "2", "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
