"""What the span readers share: the port's spans of the run (the recorder of
``micro_diffusion_tpu_torch/utils/profiling.py``, read in the process after the
runner returns, as ``harness.launch_counts`` reads the kernel counters), and the
spans of the record's timed window.

Training: the ``train.step`` spans in the order they ran, the traced steps' included
(the last ended by the benchmark's exception); the window is the
``record["window"]["steps"]`` steps before the last ``record["traced_units"]``, less
its last step, inside which the benchmark synchronised and started the profiler.
Sampling: the window is the ``record["window"]["units"]`` ``sample.call`` spans before
the last ``traced_units``; a call's parts are the spans of its unit.

Each function returns None where the run kept nothing to read: a port without the
recorder, a record of another kind, a window too short, or device ends missing (a
run on the CPU).
"""


def records():
    """The port's kept spans as ``spans()`` gives them, or None without the recorder."""
    from micro_diffusion_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def _device_ms(span):
    if span["device_start_ms"] is None or span["device_end_ms"] is None:
        return None
    return span["device_end_ms"] - span["device_start_ms"]


def train_window(record, spans=None):
    """The window's ``train.step`` spans less its last, or None."""
    if record.get("kind") != "train":
        return None
    spans = records() if spans is None else spans
    if spans is None:
        return None
    steps = [s for s in spans if s["name"] == "train.step"]
    n, traced = record["window"]["steps"], record["traced_units"]
    if len(steps) < n + traced or n < 2:
        return None
    return steps[len(steps) - traced - n:len(steps) - traced][:-1]


def boundary_ms(record, spans=None):
    """Mean device ms from one window step's end event to the next one's start."""
    steps = train_window(record, spans)
    if steps is None or len(steps) < 2:
        return None
    gaps = [b["device_start_ms"] - a["device_end_ms"] for a, b in zip(steps, steps[1:])
            if a["device_end_ms"] is not None and b["device_start_ms"] is not None]
    return sum(gaps) / len(gaps) if len(gaps) == len(steps) - 1 else None


def step_ms(record, spans=None):
    """Mean device ms from a window step's start event to its end event."""
    steps = train_window(record, spans)
    if not steps:
        return None
    times = [_device_ms(s) for s in steps]
    return None if None in times else sum(times) / len(times)


def sample_window(record, spans=None):
    """({unit of each window call}, the spans of those units), or None."""
    if record.get("kind") != "sample":
        return None
    spans = records() if spans is None else spans
    if spans is None:
        return None
    calls = [s for s in spans if s["name"] == "sample.call"]
    n, traced = record["window"]["units"], record["traced_units"]
    if len(calls) < n + traced or n < 1:
        return None
    units = {c["unit"] for c in calls[len(calls) - traced - n:len(calls) - traced]}
    return units, [s for s in spans if s["unit"] in units and s["name"] != "sample.call"]


def sample_part_ms(record, name, per="call", spans=None):
    """Device ms of the window's ``name`` spans: their mean (``per='span'``) or their
    sum over the window's calls (``per='call'``)."""
    window = sample_window(record, spans)
    if window is None:
        return None
    units, parts = window
    times = [_device_ms(s) for s in parts if s["name"] == name]
    if not times or None in times:
        return None
    return sum(times) / (len(times) if per == "span" else len(units))


def build_s(record, spans=None):
    """Host s of the run's ``entry.build`` span and of every ``kernels.build`` span
    outside it."""
    if record.get("kind") != "train":
        return None
    spans = records() if spans is None else spans
    if spans is None:
        return None
    entry = [s for s in spans if s["name"] == "entry.build"]
    if not entry:
        return None
    e = entry[-1]
    total = e["end_ms"] - e["start_ms"]
    for s in spans:
        if s["name"] == "kernels.build" and not e["start_ms"] <= s["start_ms"] <= e["end_ms"]:
            total += s["end_ms"] - s["start_ms"]
    return 1e-3 * total
