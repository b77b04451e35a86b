"""The span readers (benchmark/spans.py and the six ``program_span`` metrics): which
spans of a synthetic list each reads for a record's window, and on the CPU, a micro
training run with ``--trace 1`` reads the build time and no device time."""

import pytest

from benchmark import harness, spans
from test_bench_reference import TRAIN_PARAMS, _cell

SPAN_METRICS = ("boundary_idle_ms.train", "dispatch_idle_ms.train", "build_s.train",
                "dit_forward_ms.sample", "vae_decode_ms.sample", "text_encode_ms.sample")


def _span(i, name, unit, host, device=None, parent=None):
    return {"id": i, "name": name, "parent": parent, "unit": unit,
            "start_ms": host[0], "end_ms": host[1], "error": False, "tags": None,
            "device_start_ms": device[0] if device else None,
            "device_end_ms": device[1] if device else None}


def train_spans():
    """An earlier run's two steps, then entry.build with a kernels.build inside, a
    kernels.build of a first call, and steps 0-7 of 100 device ms each, every gap
    after step s lasting s ms."""
    out = [_span(0, "train.step", 0, (0, 1), (0, 1)), _span(1, "train.step", 1, (1, 2), (1, 2)),
           _span(2, "kernels.build", None, (5, 7)),
           _span(3, "kernels.build", None, (10, 20), parent=4),
           _span(4, "entry.build", None, (8, 1008))]
    t = 2000.0
    for s in range(8):
        out.append(_span(10 + 2 * s, "data.wait", None, (t, t + 1)))
        out.append(_span(11 + 2 * s, "train.step", s, (t, t + 100), (t, t + 100)))
        t += 100 + s
    out.append(_span(40, "kernels.build", None, (3000, 3004), parent=30))
    return out


def test_training_readers_take_the_window_less_its_last_step():
    # followed steps 0-1, window steps 2-6 (6 synchronised and profiled), traced 7
    record = {"kind": "train", "window": {"steps": 5}, "traced_units": 1,
              "trace": {"busy_s": 0.09}}
    got = spans.train_window(record, train_spans())
    assert [s["unit"] for s in got] == [2, 3, 4, 5]
    assert spans.boundary_ms(record, train_spans()) == pytest.approx((2 + 3 + 4) / 3)
    assert spans.step_ms(record, train_spans()) == pytest.approx(100)
    # entry.build's 1000 ms and the two kernels.build spans outside it
    assert spans.build_s(record, train_spans()) == pytest.approx((1000 + 2 + 4) / 1e3)
    record = dict(record, window={"steps": 3}, traced_units=3)
    assert [s["unit"] for s in spans.train_window(record, train_spans())] == [2, 3]
    assert spans.boundary_ms(record, train_spans()) == pytest.approx(2)
    # a window of one step leaves no step; a list too short reads nothing
    assert spans.train_window(dict(record, window={"steps": 1}), train_spans()) is None
    assert spans.train_window(dict(record, window={"steps": 9}), train_spans()) is None
    assert spans.train_window({"kind": "sample"}, train_spans()) is None
    # without device ends (the CPU) the device readers read nothing
    host_only = [dict(s, device_start_ms=None, device_end_ms=None) for s in train_spans()]
    assert spans.boundary_ms(record, host_only) is None
    assert spans.step_ms(record, host_only) is None
    assert spans.build_s(record, host_only) == pytest.approx(1.006)


def sample_spans():
    """Calls 4 (warm-up), 5, 6, 7 (window) and 8 (traced), each: encode 10 ms, three
    forwards of 20 * unit ms, decode 30 ms."""
    out, i = [], 0
    for unit in range(4, 9):
        parts = [("sample.encode", 10)] + [("sample.forward", 20 * unit)] * 3 + \
            [("sample.decode", 30)]
        t = 1000.0 * unit
        for name, ms in parts:
            out.append(_span(i, name, unit, (t, t + ms), (t, t + ms), parent=100 + unit))
            t, i = t + ms, i + 1
        out.append(_span(100 + unit, "sample.call", unit, (1000 * unit, t)))
    return out


def test_sampling_readers_take_the_window_calls():
    record = {"kind": "sample", "window": {"units": 3}, "traced_units": 1}
    units, parts = spans.sample_window(record, sample_spans())
    assert units == {5, 6, 7} and len(parts) == 15
    assert spans.sample_part_ms(record, "sample.forward", per="span",
                                spans=sample_spans()) == pytest.approx(20 * 6)
    assert spans.sample_part_ms(record, "sample.decode",
                                spans=sample_spans()) == pytest.approx(30)
    assert spans.sample_part_ms(record, "sample.encode",
                                spans=sample_spans()) == pytest.approx(10)
    # forwards summed per call: 3 of 20 * unit
    assert spans.sample_part_ms(record, "sample.forward",
                                spans=sample_spans()) == pytest.approx(3 * 20 * 6)
    assert spans.sample_window(dict(record, window={"units": 5}), sample_spans()) is None
    assert spans.sample_window({"kind": "train"}, sample_spans()) is None


def test_a_port_without_spans_reads_nothing(monkeypatch):
    """The parent commit's port has no recorder: every reader returns None, none
    raises."""
    from micro_diffusion_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.records() is None
    train = {"kind": "train", "window": {"steps": 5, "units": 5}, "traced_units": 1,
             "trace": {"busy_s": 1.0}}
    sample = {"kind": "sample", "window": {"units": 3}, "traced_units": 1}
    for name in SPAN_METRICS:
        for record in (train, sample):
            assert harness.reader(name).read(record) is None, name


def test_a_traced_cpu_run_reads_the_build_and_no_device_time():
    cell = _cell("micro-256", "train", TRAIN_PARAMS,
                 harness.workload("xl256-train")["limits"])
    cell.trace = True
    cell.per_layer = list(SPAN_METRICS)
    out = harness.runner("train").run(cell)
    got = harness.read_per_layer(cell.per_layer, out["record"])
    assert set(got) == {"build_s.train"}, got
    assert 0 < got["build_s.train"]["value"] < 60 and got["build_s.train"]["unit"] == "s"
