"""Device time in a Chrome trace of ``torch.profiler``, by kernel name and by op
class: the port's counterpart of ``scripts/xplane_summary.py`` (totals by op name)
and ``scripts/xplane_categories.py`` (totals by op class).

    python -m micro_diffusion_tpu_torch.scripts.trace_summary TRACE [--steps N]
        [--step NAME]

``TRACE`` is the JSON (or ``.json.gz``) that ``utils/profiling.py profile_trace``
writes. The device's work is its kernels, memcpys and memsets. The window is the
span of the ``record_function`` scope ``--step`` (the first start to the last end
of the scopes of that name), or, without it, of every timed event in the trace; its
device ops are those launched inside it (by the launch's time on the host's clock,
which the window is on: the device's timestamps can be skewed from it by a good part
of a step), and those with no launch event that start inside it. Busy time is the
union of their intervals, idle time the rest of the window, so busy + idle = the
window; the device ops' summed time exceeds the busy time by the overlap between
streams. Every time is divided by ``--steps``.

Where the trace holds the port's spans (``utils/profiling.py`` ``SPAN_NAMES``: under
a profiler each span is a ``record_function`` scope of its name), the idle time is
also split by span: each idle gap of the window goes to the innermost span open on
the host at the gap's start, '(no span)' where none is. The gap's start is a device
time; where the trace's device clock runs early (a kernel stamped before its own
launch), it is moved by the largest such lead first.
"""

import argparse
import collections
import gzip
import json
import re
import sys
from bisect import bisect_right

from ..utils.profiling import SPAN_NAMES

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 12  # kernel names listed

# (op class, regex over the kernel name), first match wins: the port's hand kernels
# by name, then the library's kernel families. The one MoE GEMM kernel serves the
# forwards and the backwards of K2 and K3 (csrc/moe_gemm.cuh).
OP_CLASSES = [
    ("K1/K4/K5 attention forward", r"attn_fwd_kernel"),
    ("K1b/K4b/K5b attention backward", r"attn_bwd_(dq|dkdv)_kernel"),
    ("K2/K3 MoE GEMM (fwd and bwd)", r"moe_gemm_kernel"),
    ("K6 LayerNorm + modulate", r"layernorm_modulate_kernel"),
    ("NCCL", r"(?i)nccl"),
    ("GEMM (cuBLAS / cuDNN)", r"(?i)gemm|nvjet|xmma|cutlass|cublas|cudnn|wgrad|dgrad|"
                              r"implicit_convolve|conv2d"),
    ("attention (library)", r"(?i)flash_fwd|flash_bwd|fmha|efficient_attention"),
    ("memcpy / memset", r"^Mem(cpy|set)"),
    ("cast to bf16", r"bfloat16_copy_kernel"),
    ("copy (direct_copy: copies and casts)", r"copy_kernel"),
    ("multi-tensor (foreach)", r"multi_tensor_apply"),
    ("reduction / norm / softmax", r"(?i)reduce_kernel|softmax|layer_norm|norm_kernel|"
                                   r"welford|cub::|Reduce"),
    ("gather / scatter / index", r"(?i)index|gather|scatter|take|put_kernel"),
    ("sort / top-k", r"(?i)sort|topk|radix|bitonic"),
    ("elementwise", r"elementwise_kernel"),
]


def op_class(name: str) -> str:
    for cls, rx in OP_CLASSES:
        if re.search(rx, name):
            return cls
    return "other"


def load(path: str) -> list:
    """The trace's events."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _timed(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def window(events, step: str | None = None) -> tuple:
    """(start, end) in the trace's microseconds: the span of the ``record_function``
    scopes named ``step``, or of every timed event."""
    timed = _timed(events)
    if step is not None:
        timed = [e for e in timed if e.get("cat") == "user_annotation" and e["name"] == step]
        if not timed:
            raise ValueError(f"the trace has no scope named {step!r}")
    if not timed:
        raise ValueError("the trace has no timed event")
    return (min(e["ts"] for e in timed), max(e["ts"] + e["dur"] for e in timed))


def _launch_times(timed) -> dict:
    return {e["args"]["correlation"]: e["ts"] for e in timed
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}


def device_ops(events, lo: float, hi: float) -> list:
    """The device's kernels, memcpys and memsets launched inside [lo, hi), or, with no
    launch event, starting inside it."""
    timed = _timed(events)
    launched = _launch_times(timed)
    return [e for e in timed if e.get("cat") in DEVICE_CATS
            and lo <= launched.get(e.get("args", {}).get("correlation"), e["ts"]) < hi]


def union_us(ops) -> float:
    """The length of the union of the ops' intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((o["ts"], o["ts"] + o["dur"]) for o in ops):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(ops, lo: float, hi: float) -> list:
    """(start, end) of each interval of [lo, hi) that no op covers."""
    gaps, end = [], lo
    for o in sorted(ops, key=lambda o: o["ts"]):
        if o["ts"] > end:
            gaps.append((end, min(o["ts"], hi)))
        end = max(end, o["ts"] + o["dur"])
        if end >= hi:
            break
    if hi > end:
        gaps.append((end, hi))
    return [g for g in gaps if g[1] > g[0]]


def idle_by_span(events, ops, lo: float, hi: float) -> dict:
    """{span name: idle us} over the idle gaps of [lo, hi), each put down to the
    innermost port span open on the host at its start ('(no span)' where none is);
    empty when the trace holds no port span."""
    timed = _timed(events)
    scopes = sorted((e for e in timed if e.get("cat") == "user_annotation"
                     and e["name"] in SPAN_NAMES), key=lambda e: e["ts"])
    if not scopes:
        return {}
    launched = _launch_times(timed)
    leads = [o["ts"] - launched[c] for o in ops
             if (c := o.get("args", {}).get("correlation")) in launched]
    early = min(min(leads, default=0.0), 0.0)  # the device clock's lead over the host's
    starts = [e["ts"] for e in scopes]
    out = collections.defaultdict(float)
    for g0, g1 in idle_gaps(ops, lo, hi):
        t = g0 - early
        name = "(no span)"
        for e in reversed(scopes[:bisect_right(starts, t)]):
            if e["ts"] + e["dur"] >= t:  # the latest-starting span still open
                name = e["name"]
                break
        out[name] += g1 - g0
    return dict(out)


def time_split(events, step: str | None = None, steps: int = 1) -> dict:
    """Window, busy, idle, the device ops' summed time and the overlap between
    streams, in ms a step; and the ops themselves."""
    lo, hi = window(events, step)
    ops = device_ops(events, lo, hi)
    busy = union_us(ops)
    total = sum(o["dur"] for o in ops)
    ms = 1e-3 / steps
    return {"window_ms": (hi - lo) * ms, "busy_ms": busy * ms,
            "idle_ms": (hi - lo - busy) * ms, "device_ms": total * ms,
            "overlap_ms": max(total - busy, 0.0) * ms, "launches": len(ops) / steps,
            "streams": len({o.get("args", {}).get("stream", o.get("tid")) for o in ops}),
            "idle_by_span": {k: v * ms for k, v in idle_by_span(events, ops, lo, hi).items()},
            "ops": ops}


def summarize(events, step: str | None = None, steps: int = 1) -> dict:
    """``time_split`` plus device time and count by kernel name and by op class
    (ms a step)."""
    out = time_split(events, step, steps)
    by_name, by_class = collections.defaultdict(lambda: [0.0, 0]), \
        collections.defaultdict(lambda: [0.0, 0])
    for o in out.pop("ops"):
        for table, key in ((by_name, o["name"]), (by_class, op_class(o["name"]))):
            table[key][0] += o["dur"] * 1e-3 / steps
            table[key][1] += 1
    out["by_name"] = {k: (v[0], v[1] / steps) for k, v in by_name.items()}
    out["by_class"] = {k: (v[0], v[1] / steps) for k, v in by_class.items()}
    return out


def split_line(s: dict) -> str:
    share = s["idle_ms"] / s["window_ms"] if s["window_ms"] else 0.0
    return (f"window {s['window_ms']:.3f} ms = busy {s['busy_ms']:.3f} + idle "
            f"{s['idle_ms']:.3f} ms (idle share {share:.3f}); device ops "
            f"{s['device_ms']:.3f} ms in {s['launches']:g} launches on {s['streams']} "
            f"stream(s), overlap between streams {s['overlap_ms']:.3f} ms")


def table(rows: dict, total: float, top: int | None = None) -> list:
    """Lines of ``rows`` ({key: (ms, count)}), largest first."""
    items = sorted(rows.items(), key=lambda kv: -kv[1][0])
    lines = [f"{ms:10.3f} ms {ms / total if total else 0.0:6.1%}  x{n:<7g} {key[:100]}"
             for key, (ms, n) in items[:top]]
    if top is not None and len(items) > top:
        rest = sum(v[0] for _, v in items[top:])
        lines.append(f"{rest:10.3f} ms {rest / total if total else 0.0:6.1%}  "
                     f"({len(items) - top} more names)")
    return lines


def report(s: dict) -> list:
    """The tables as lines: the split, idle by port span (where the trace has spans),
    the op classes, the top kernel names."""
    lines = [split_line(s)]
    if s["idle_by_span"]:
        idle = sum(s["idle_by_span"].values())
        lines += ["idle by port span (ms a step, share of the idle gaps):"]
        lines += [f"{ms:10.3f} ms {ms / idle if idle else 0.0:6.1%}  {name}" for name, ms
                  in sorted(s["idle_by_span"].items(), key=lambda kv: -kv[1])]
    return (lines + ["by op class (ms a step, share of the device ops' time):"]
            + table(s["by_class"], s["device_ms"])
            + [f"by kernel name, top {TOP}:"] + table(s["by_name"], s["device_ms"], TOP))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--steps", type=int, default=1, help="steps in the window")
    ap.add_argument("--step", default=None, help="the record_function scope that "
                    "bounds the window (default: the whole trace)")
    args = ap.parse_args(argv)
    for line in report(summarize(load(args.trace), args.step, args.steps)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
