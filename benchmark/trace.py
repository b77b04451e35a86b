"""Device time from a ``torch.profiler`` Chrome trace: the window, busy and idle
time, device time by kernel, and the idle gaps by what the host was doing.

The window arithmetic is a frozen copy of the port's
``micro_diffusion_tpu_torch/scripts/trace_summary.py`` (``window``, ``device_ops``,
``union_us``): the window is the span of a ``record_function`` scope; its device ops
are the kernels, memcpys and memsets launched inside it (by the launch's time on the
host clock, which the window is on: the device's timestamps can be skewed from it),
or with no launch event starting inside it; busy time is the union of their
intervals. An idle gap is an interval of the window that no device op covers; it is
named by the host operator that launched the op ending it (what the host was doing
while the device waited), or 'window end'.
"""

import collections
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 160  # of a kernel's name in the breakdown (templates run to thousands)


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _timed(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def window(events, scope: str) -> tuple:
    spans = [e for e in _timed(events)
             if e.get("cat") == "user_annotation" and e["name"] == scope]
    if not spans:
        raise ValueError(f"the trace has no scope named {scope!r}")
    return min(e["ts"] for e in spans), max(e["ts"] + e["dur"] for e in spans)


def _launches(timed):
    return {e["args"]["correlation"]: e for e in timed
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}


def device_ops(events, lo, hi):
    timed = _timed(events)
    launched = _launches(timed)

    def at(e):
        launch = launched.get(e.get("args", {}).get("correlation"))
        return launch["ts"] if launch is not None else e["ts"]
    return [e for e in timed if e.get("cat") in DEVICE_CATS and lo <= at(e) < hi]


def union_us(ops) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted((o["ts"], o["ts"] + o["dur"]) for o in ops):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _host_op_at(host, ts):
    """The innermost host operator open at ``ts`` (host ops sorted by start)."""
    best = None
    for e in host:
        if e["ts"] > ts:
            break
        if e["ts"] + e["dur"] >= ts and (best is None or e["ts"] >= best["ts"]):
            best = e
    return best["name"] if best is not None else "host (no operator)"


def summarize(events, scope: str) -> dict:
    """{'window_s', 'busy_s', 'ops': [(name, seconds)], 'device_ops', 'idle_gaps'}:
    the ops of the window, and the breakdown's two lists (at most ``TOP`` each)."""
    lo, hi = window(events, scope)
    ops = device_ops(events, lo, hi)
    busy = union_us(ops)
    by_name = collections.defaultdict(float)
    for o in ops:
        by_name[o["name"]] += o["dur"] * 1e-6
    timed = _timed(events)
    launched = _launches(timed)
    host = sorted((e for e in timed if e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
    gaps, end = [], lo
    for o in sorted(ops, key=lambda o: o["ts"]):
        if o["ts"] > end:
            launch = launched.get(o.get("args", {}).get("correlation"))
            gaps.append((o["ts"] - end, launch["ts"] if launch else None))
        end = max(end, o["ts"] + o["dur"])
    if hi > end:
        gaps.append((hi - end, None))
    gaps.sort(key=lambda g: -g[0])
    idle = [[_host_op_at(host, ts) if ts is not None else "window end", us * 1e-6]
            for us, ts in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "ops": [(o["name"], o["dur"] * 1e-6) for o in ops],
            "device_ops": [[n[:NAME_CHARS], s] for n, s in top[:TOP]], "idle_gaps": idle}


def seconds_matching(ops, patterns) -> float:
    """Device seconds of the ops whose kernel name matches one of ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    return sum(s for name, s in ops if any(r.search(name) for r in rx))
