"""The port's profiling helpers (micro_diffusion_tpu_torch/utils/profiling.py) on the
CPU: profile_trace writes a Chrome trace of the profiled block; StepTimer records one
time per stop and their mean."""

import json
import os
import time

import torch

from micro_diffusion_tpu_torch.utils.profiling import StepTimer, profile_trace


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum().item()
    assert os.listdir(tmp_path / "trace") == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_step_timer_records_each_stop():
    timer = StepTimer()
    assert timer.mean == 0.0
    dts = []
    for _ in range(3):
        timer.start()
        time.sleep(0.01)
        dts.append(timer.stop(torch.ones(8).sum()))
    timer.start()
    dts.append(timer.stop())  # no scalar: the current CUDA device, none here
    assert timer.times == dts and min(dts[:3]) >= 0.01
    assert abs(timer.mean - sum(dts) / 4) < 1e-12
