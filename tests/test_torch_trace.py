"""The port's trace tools on the CPU: scripts/trace_summary.py (device time by kernel
name and op class, busy and idle) and scripts/attribute_trace.py (device time by
model component) on a small synthetic Chrome trace whose every number is known, and
on a real profile_trace of one MicroDiT-Micro forward under module_scopes."""

import gzip
import json

import numpy as np
import pytest
import torch

from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.scripts import attribute_trace, trace_summary
from micro_diffusion_tpu_torch.utils.profiling import SCOPE_PREFIX, module_scopes, profile_trace

STEP = "attributed step"
DIT = "model:LatentDiffusion/dit:DiT"
BLOCK = f"{DIT}/blocks:ModuleList/0:DiTBlock"


def _x(cat, name, tid, ts, dur, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _scope(path, tid, ts, dur):
    return _x("user_annotation", SCOPE_PREFIX + path, tid, ts, dur)


def _launch(tid, ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, tid, ts, 1, correlation=corr)


def _kernel(name, ts, dur, corr, stream=7, cat="kernel"):
    return _x(cat, name, stream, ts, dur, pid=0, correlation=corr, stream=stream)


def synthetic_trace():
    """One step in a 1000 us window: thread 1 runs the forward and the optimizer,
    thread 2 the backward with a remat recompute; two streams overlap by 10 us."""
    main = [
        _x("user_annotation", STEP, 1, 0, 1000),
        _scope("model:LatentDiffusion", 1, 10, 400),
        _scope(DIT, 1, 15, 300),
        _scope(f"{BLOCK}/attn:SelfAttention", 1, 20, 100),
        _x("cpu_op", "aten::mm", 1, 30, 20, **{"External id": 5, "Sequence number": 7}),
        _launch(1, 35, 101),
        _scope(f"{BLOCK}/mlp:FeedForwardECMoe", 1, 130, 100),
        _x("cpu_op", "aten::bmm", 1, 140, 20),
        _launch(1, 145, 111),
        _x("cpu_op", "aten::gather", 1, 240, 10),
        _launch(1, 242, 102),
        _x("cpu_op", "aten::mse_loss", 1, 330, 10),
        _launch(1, 332, 103),
        _x("cpu_op", "aten::_foreach_mul_", 1, 800, 20),
        _launch(1, 805, 104),
        _x("cpu_op", "aten::copy_", 1, 885, 10),
        _launch(1, 890, 109, "cudaMemcpyAsync"),
        _x("cpu_op", "aten::mm", 1, 1100, 10),
        _launch(1, 1105, 110),
    ]
    backward = [
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2, 500, 50,
           **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cpu_op", "MmBackward0", 2, 501, 40),
        _x("cpu_op", "aten::mm", 2, 505, 10),
        _launch(2, 507, 105),
        _x("cpu_op", "aten::sum", 2, 545, 3),  # the engine's, outside the node's op
        _launch(2, 546, 106),
        _x("cpu_op", "autograd::engine::evaluate_function: CheckpointFunctionBackward",
           2, 600, 100),
        _scope(f"{BLOCK}/norm1:LayerNorm", 2, 610, 30),
        _x("cpu_op", "aten::native_layer_norm", 2, 615, 10),
        _launch(2, 617, 107),
        _x("cpu_op", "autograd::engine::evaluate_function: torch::autograd::AccumulateGrad",
           2, 720, 10),
        _launch(2, 722, 108),
    ]
    flows = [{"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "pid": 1, "tid": 1,
              "ts": 30},
             {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "pid": 1, "tid": 2,
              "ts": 501, "bp": "e"}]
    device = [
        _kernel("void attn_fwd_kernel<64>(CUtensorMap_st)", 40, 50, 101),
        _kernel("void moe_gemm_kernel<256, false, true, 1>(GemmArgs)", 150, 60, 111),
        _kernel("void at::native::indexSelectLargeIndex<float>", 245, 10, 102),
        _kernel("void at::native::reduce_kernel<512, 1>", 335, 5, 103),
        _kernel("void at::native::multi_tensor_apply_kernel<4>", 805, 30, 104),
        _kernel("nvjet_tst_128x128_64x6_2x1_v_bz_TNT", 510, 20, 105),
        _kernel("void at::native::reduce_kernel<512, 1>", 515, 10, 106, stream=8),
        _kernel("void at::native::vectorized_layer_norm_kernel<float>", 620, 15, 107),
        _kernel("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>",
                725, 5, 108),
        # launched inside the step, stamped after it (the device's clock skewed)
        _kernel("Memcpy DtoD (Device -> Device)", 1010, 4, 109, cat="gpu_memcpy"),
        # no launch event
        _kernel("void layernorm_modulate_kernel(const __nv_bfloat16*)", 950, 6, 555),
        # launched after the step, stamped inside it: not the step's
        _kernel("void attn_fwd_kernel<64>(CUtensorMap_st)", 960, 20, 110),
    ]
    return main + backward + flows + device


def test_trace_summary_on_a_synthetic_trace():
    s = trace_summary.summarize(synthetic_trace(), STEP)
    assert s["window_ms"] == pytest.approx(1.0)
    assert s["device_ms"] == pytest.approx(0.215)
    assert s["busy_ms"] == pytest.approx(0.205)  # the two streams overlap 10 us
    assert s["idle_ms"] == pytest.approx(0.795)
    assert s["overlap_ms"] == pytest.approx(0.010)
    assert (s["launches"], s["streams"]) == (11, 2)
    assert s["busy_ms"] + s["idle_ms"] == pytest.approx(s["window_ms"], abs=1e-12)
    want = {"K1/K4/K5 attention forward": (0.050, 1), "K2/K3 MoE GEMM (fwd and bwd)": (0.060, 1),
            "K6 LayerNorm + modulate": (0.006, 1), "GEMM (cuBLAS / cuDNN)": (0.020, 1),
            "memcpy / memset": (0.004, 1), "multi-tensor (foreach)": (0.030, 1),
            "reduction / norm / softmax": (0.030, 3), "gather / scatter / index": (0.010, 1),
            "elementwise": (0.005, 1)}
    assert s["by_class"].keys() == want.keys()
    for cls, (ms, n) in want.items():
        assert s["by_class"][cls][0] == pytest.approx(ms), cls
        assert s["by_class"][cls][1] == n, cls
    assert s["by_name"]["void at::native::reduce_kernel<512, 1>"][1] == 2
    # without --step the window spans every timed event, the kernel after the step too
    whole = trace_summary.summarize(synthetic_trace())
    assert whole["window_ms"] == pytest.approx(1.110)
    assert whole["device_ms"] == pytest.approx(0.235)
    assert whole["busy_ms"] == pytest.approx(0.225)


def test_attribute_trace_on_a_synthetic_trace():
    a = attribute_trace.attribute(synthetic_trace(), STEP)
    want = {  # bucket: (forward, recompute, backward) in ms
        "attention": (0.050, 0.0, 0.030),  # mm's kernel; backward via the flow, twice
        "moe": (0.060, 0.0, 0.0),
        "masking": (0.010, 0.0, 0.0),      # gather at the DiT's own level
        "loss_edm": (0.005, 0.0, 0.0),     # at the model's own level
        "optimizer": (0.034, 0.0, 0.005),  # outside the model; AccumulateGrad
        "norms": (0.0, 0.015, 0.0),        # the recompute inside the backward
        "other": (0.006, 0.0, 0.0),        # no launch event: nothing to join
    }
    for bucket in attribute_trace.BUCKET_NAMES:
        got = a["buckets"][bucket]
        exp = want.get(bucket, (0.0, 0.0, 0.0))
        np.testing.assert_allclose([got[d] for d in attribute_trace.DIRECTIONS], exp,
                                   atol=1e-12, err_msg=bucket)
    total = sum(sum(d.values()) for d in a["buckets"].values())
    assert total == pytest.approx(a["device_ms"]) == pytest.approx(0.215)
    assert a["unlinked_ms"] == pytest.approx(0.006)
    assert a["unjoined_ms"] == pytest.approx(0.005)
    assert a["idle_ms"] == pytest.approx(0.795)
    lines = attribute_trace.report(a)
    assert lines[1].split()[:2] == ["attention", "0.080"]
    assert "other: 0.006 ms  (no launch event) void layernorm_modulate_kernel" in "\n".join(lines)
    modules = {"dit/blocks/*/attn": 0.080, "dit/blocks/*/mlp": 0.060, "dit": 0.010,
               "(the model itself)": 0.005, "(outside the model)": 0.039,
               "dit/blocks/*/norm1": 0.015, "(no launch event)": 0.006}
    assert a["modules"].keys() == modules.keys()
    for key, ms in modules.items():
        assert a["modules"][key] == pytest.approx(ms), key
    assert lines[-7:][0].endswith("dit/blocks/*/attn")  # the by-module table, largest first
    assert any(line.startswith("buckets sum 0.215 ms = the device ops' time 0.215 ms; busy "
                               "0.205 + idle 0.795 = window 1.000 ms; overlap between "
                               "streams 0.010 ms") for line in lines)


def test_tools_cli_on_a_gzipped_trace(tmp_path, capsys):
    path = tmp_path / "t.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": synthetic_trace()}, f)
    assert trace_summary.main([str(path), "--step", STEP, "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("window 0.250 ms = busy 0.051 + idle 0.199 ms (idle share 0.795); "
                          "device ops 0.054 ms in 2.75 launches on 2 stream(s)")
    assert len(out.splitlines()) == 1 + 1 + 9 + 1 + 10  # split, classes, names
    assert attribute_trace.main([str(path), "--step", STEP, "--steps", "4"]) == 0
    assert "buckets sum 0.054 ms" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no scope named"):
        trace_summary.summarize(synthetic_trace(), "no such step")


def test_real_cpu_trace_of_a_micro_forward(tmp_path):
    """profile_trace of one Micro forward under module_scopes: both tools parse it,
    every module call is one scope, the scopes change no value and leave no wrapper."""
    dit = tdit.MicroDiT_Micro_2(caption_channels=32, input_size=16, dtype=torch.float32,
                                device="cpu")
    dit.init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x, t = torch.randn(2, 4, 16, 16, generator=gen), torch.rand(2, generator=gen)
    y = torch.randn(2, 1, 8, 32, generator=gen)
    with torch.no_grad():
        ref = dit(x, t, y)["sample"]
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append(mod))
             for m in dit.modules()]
    with torch.no_grad(), profile_trace(str(tmp_path)) as prof, module_scopes(dit):
        with torch.profiler.record_function(STEP):
            out = dit(x, t, y)["sample"]
    for h in hooks:
        h.remove()
    assert torch.equal(out, ref)
    assert not any("forward" in vars(m) for m in dit.modules())
    events = trace_summary.load(prof.trace_path)
    scopes = [e["name"] for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(SCOPE_PREFIX)]
    assert len(scopes) == len(calls) > 50
    assert SCOPE_PREFIX + "model:DiT/blocks:ModuleList/1:DiTBlock/mlp:FeedForwardECMoe" in scopes
    s = trace_summary.summarize(events, STEP)
    a = attribute_trace.attribute(events, STEP)
    assert s["window_ms"] > 0 and s["device_ms"] == s["busy_ms"] == 0  # no card
    assert a["idle_ms"] == pytest.approx(a["window_ms"])
    assert not any(sum(d.values()) for d in a["buckets"].values())
    assert trace_summary.report(s) and attribute_trace.report(a)


def test_trace_summary_puts_idle_gaps_down_to_port_spans():
    """Each idle gap goes to the innermost port span open at its start, on the host's
    clock: the device's stamps run 15 us early here (a kernel before its launch), so
    every gap start moves 15 us later; a module scope is not a port span."""
    ann = [("w", 0, 1100), ("train.step", 0, 600), ("step.forward", 10, 290),
           ("nn.Module: model:DiT", 200, 100), ("trainer.stage", 650, 50),
           ("trainer.metrics", 700, 200)]
    ev = [_x("user_annotation", name, 1, ts, dur) for name, ts, dur in ann]
    for corr, (launch, ts, dur) in enumerate([(20, 30, 170), (250, 260, 380),
                                              (760, 745, 105), (905, 890, 110)]):
        ev += [_launch(1, launch, corr), _kernel("elementwise_kernel", ts, dur, corr)]
    s = trace_summary.summarize(ev, "w")
    assert s["idle_ms"] == pytest.approx(0.335)
    want = {"step.forward": 0.030 + 0.060, "trainer.stage": 0.105, "trainer.metrics": 0.040,
            "(no span)": 0.100}
    assert s["idle_by_span"].keys() == want.keys()
    for name, ms in want.items():
        assert s["idle_by_span"][name] == pytest.approx(ms), name
    lines = trace_summary.report(s)
    assert lines[1].startswith("idle by port span") and lines[2].endswith("trainer.stage")
    assert trace_summary.summarize(synthetic_trace(), STEP)["idle_by_span"] == {}
