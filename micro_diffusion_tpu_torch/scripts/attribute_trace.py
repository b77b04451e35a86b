"""Device time by model component: the port's counterpart of
``scripts/attribute_trace.py``, with its buckets.

    python -m micro_diffusion_tpu_torch.scripts.attribute_trace TRACE [--steps N]
        [--step NAME]

``TRACE`` is a Chrome trace that ``utils/profiling.py profile_trace`` wrote while
``utils/profiling.py module_scopes`` named the model's module calls (scopes
``nn.Module: model:LatentDiffusion/dit:DiT/...``). Each device op (kernel, memcpy,
memset) is joined to model code in three steps:

  1. to the CPU runtime or driver call that launched it, by the trace's correlation
     id (an op with no such call is 'other', and counted apart);
  2. to the CPU ops and scopes open on that thread at the launch (its stack);
  3. from the innermost of those outward: a module scope first means the op ran in
     that module's forward (its remat recompute, when a backward op is open further
     out); a backward node first (``MmBackward0``, ``_ExpertFFNBackward``..., or the
     engine's ``evaluate_function`` around it) means the backward, and the trace's
     forward-backward flow ("fwdbwd") leads to the forward op that recorded the
     node, whose own module scopes name the module (a node recorded inside another
     node's backward, outside every module, hands on to that outer node).

The tag ``<module path>/ | <op names> | <kernel name>`` then goes through
``BUCKETS`` (first match wins), JAX's buckets on the port's module names; what the
train step launches outside the model (its gradient sums, clipping, AdamW, the EMA)
is 'optimizer'. The window, busy and idle
times are ``trace_summary``'s; the buckets sum to the device ops' time, which
exceeds the busy time by the overlap between streams. Every time is divided by
``--steps``.
"""

import argparse
import collections
import re
import sys

from ..utils.profiling import SCOPE_PREFIX
from .trace_summary import LAUNCH_CATS, load, time_split

BUCKETS = [
    ("attention", r":(SelfAttention|CrossAttention)/"),
    ("moe", r":FeedForwardECMoe/"),
    ("dense_ffn", r":(FeedForward|Mlp)/"),
    # the adaLN MLPs, K6 forward and backward (``layernorm_modulate``), and the
    # block's gates and gated residual sums
    ("adaln_mod", r"adaLN_modulation:|:DiTBlock/ \||modulate"),
    # the train step's own work outside the model: the microbatches' slices, the
    # gradient sums, clipping, AdamW, the EMA
    ("optimizer", r"^ \|"),
    ("norms", r":(LayerNorm|NormLinear)/"),
    ("embed_patch", r"(x_embedder|t_embedder|y_embedder|pooled_y_emb_process|final_layer):"),
    ("masking", r":DiT/ \|.*(gather|index|take_along|scatter|mask|sort|topk)"),
    ("loss_edm", r"^[^/]*:LatentDiffusion/ \|"),
]
BUCKET_NAMES = [b for b, _ in BUCKETS] + ["other"]
TOP_MODULES = 12  # rows of the by-module table
DIRECTIONS = ("forward", "recompute", "backward")
BACKWARD_OP = "autograd::engine::evaluate_function"


def classify(tag: str) -> str:
    for bucket, rx in BUCKETS:
        if re.search(rx, tag, re.I):  # case-blind, as JAX's classify
            return bucket
    return "other"


def _stacks(cpu: dict, queries: dict) -> dict:
    """{(tid, ts): the events open on thread tid at ts, outermost first} for each
    queried point; ``cpu`` {tid: events}, ``queries`` {tid: times}."""
    out = {}
    for tid, times in queries.items():
        evs = sorted(cpu.get(tid, ()), key=lambda e: (e["ts"], -e["dur"]))
        active, i = [], 0
        for t in sorted(set(times)):
            while i < len(evs) and evs[i]["ts"] <= t:
                active.append(evs[i])
                i += 1
            active = [e for e in active if e["ts"] + e["dur"] >= t]
            out[tid, t] = list(active)
    return out


def _scope_of(stack) -> tuple:
    """(the innermost module path, the op names inside it) of a stack."""
    ops = []
    for e in reversed(stack):
        if e["name"].startswith(SCOPE_PREFIX):
            return e["name"][len(SCOPE_PREFIX):], ops[::-1]
        if e.get("cat") == "cpu_op":
            ops.append(e["name"])
    return "", ops[::-1]


def module_key(path: str) -> str:
    """A module path without its classes and with every block index as '*', so the
    same module of every block adds up: ``dit/blocks/*/attn/ln_q``."""
    if not path:
        return "(outside the model)"
    names = [part.split(":")[0] for part in path.split("/")[1:]]
    return "/".join("*" if n.isdigit() else n for n in names) or "(the model itself)"


def _resolve(stack, forward_of: dict, stacks: dict) -> tuple:
    """(direction, module path, op names) of a launch with CPU ``stack``: from the
    innermost event outward, a module scope means its forward (a recompute inside a
    backward); a backward node with a flow, its forward op's scopes. A node made
    inside another node's backward (a custom Function's backward running autograd)
    has no scope of its own and hands on to the outer node. Direction None: a
    backward op that no flow joins."""
    in_backward = any(e["name"].startswith(BACKWARD_OP) for e in stack)
    joined = None
    for e in reversed(stack):
        if e["name"].startswith(SCOPE_PREFIX):
            return ("recompute" if in_backward else "forward", *_scope_of(stack))
        fwd = forward_of.get((e["tid"], e["ts"]))
        if fwd is not None:
            path, names = _scope_of(stacks[fwd])
            names = names + [f"bwd {e['name']}"]
            if path:
                return "backward", path, names
            joined = joined or names
    if joined is not None:
        return "backward", "", joined
    names = [e["name"] for e in stack if e.get("cat") == "cpu_op"]
    return (None if in_backward else "forward"), "", names


def attribute(events, step: str | None = None, steps: int = 1) -> dict:
    """``trace_summary.time_split`` plus ``buckets`` {bucket: {direction: ms a step}},
    the ms of device ops with no launch event (``unlinked_ms``) and of backward ops
    with no forward flow (``unjoined_ms``), and the largest tags of 'other'."""
    split = time_split(events, step, steps)
    ops = split.pop("ops")
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    cpu = collections.defaultdict(list)
    launch = {}
    for e in timed:
        cat, args = e.get("cat"), e.get("args", {})
        if cat in ("cpu_op", "user_annotation"):
            cpu[e["tid"]].append(e)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = (e["tid"], e["ts"])
    starts, ends = {}, {}
    for e in events:
        if e.get("cat") == "fwdbwd":
            (starts if e.get("ph") == "s" else ends)[e["id"]] = (e["tid"], e["ts"])
    forward_of = {ends[i]: starts[i] for i in ends if i in starts}

    origins = [launch.get(o.get("args", {}).get("correlation")) for o in ops]
    queries = collections.defaultdict(list)
    for point in [p for p in origins if p] + list(forward_of) + list(forward_of.values()):
        queries[point[0]].append(point[1])
    stacks = _stacks(cpu, queries)
    # the flow ends on the node's op inside the engine's evaluate_function; the
    # engine's own work on the node's outputs (a broadcast gradient's sum) runs
    # in the latter, outside the node's op
    for end, fwd in list(forward_of.items()):
        for e in reversed(stacks[end]):
            if e["name"].startswith(BACKWARD_OP):
                forward_of.setdefault((e["tid"], e["ts"]), fwd)
                break

    buckets = {b: dict.fromkeys(DIRECTIONS, 0.0) for b in BUCKET_NAMES}
    modules, other = collections.Counter(), collections.Counter()
    unlinked = unjoined = 0.0
    ms = 1e-3 / steps
    for op, point in zip(ops, origins):
        if point is None:
            unlinked += op["dur"]
            bucket, direction, tag = "other", "forward", f"(no launch event) {op['name']}"
        else:
            direction, path, names = _resolve(stacks[point], forward_of, stacks)
            if direction is None:  # a backward op with no forward flow
                direction = "backward"
                unjoined += op["dur"]
            tag = f"{path}/ | {' '.join(names)} | {op['name']}" if path else \
                f" | {' '.join(names)} | {op['name']}"
            bucket = classify(tag)
        buckets[bucket][direction] += op["dur"] * ms
        modules[module_key(path) if point is not None else "(no launch event)"] += \
            op["dur"] * ms
        if bucket == "other":
            other[tag[:160]] += op["dur"] * ms
    split.update(buckets=buckets, unlinked_ms=unlinked * ms, unjoined_ms=unjoined * ms,
                 modules=dict(modules), other_tags=other.most_common(3))
    return split


def report(a: dict) -> list:
    """The tables as lines: one row a bucket (ms a step: total, forward, recompute,
    backward, share of the device ops' time), then idle, the checks' sums, the
    largest tags of 'other', and the ``TOP_MODULES`` modules with the most time."""
    total = a["device_ms"]
    lines = [f"{'bucket':<12}{'ms':>11}{'forward':>11}{'recompute':>11}{'backward':>11}"
             f"{'share':>8}"]
    rows = sorted(a["buckets"].items(), key=lambda kv: -sum(kv[1].values()))
    for bucket, d in rows:
        ms = sum(d.values())
        lines.append(f"{bucket:<12}{ms:11.3f}{d['forward']:11.3f}{d['recompute']:11.3f}"
                     f"{d['backward']:11.3f}{ms / total if total else 0.0:8.1%}")
    lines.append(f"{'idle':<12}{a['idle_ms']:11.3f}  (of the window; not device time)")
    summed = sum(sum(d.values()) for d in a["buckets"].values())
    lines.append(f"buckets sum {summed:.3f} ms = the device ops' time {total:.3f} ms; busy "
                 f"{a['busy_ms']:.3f} + idle {a['idle_ms']:.3f} = window "
                 f"{a['window_ms']:.3f} ms; overlap between streams {a['overlap_ms']:.3f} "
                 f"ms; no launch event {a['unlinked_ms']:.3f} ms, a backward op with no "
                 f"forward flow {a['unjoined_ms']:.3f} ms")
    for tag, ms in a["other_tags"]:
        lines.append(f"other: {ms:.3f} ms  {tag}")
    lines.append(f"by module (every block's alike summed), top {TOP_MODULES}:")
    for key, ms in sorted(a["modules"].items(), key=lambda kv: -kv[1])[:TOP_MODULES]:
        lines.append(f"{ms:10.3f} ms {ms / total if total else 0.0:6.1%}  {key}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--steps", type=int, default=1, help="steps in the window")
    ap.add_argument("--step", default=None, help="the record_function scope that "
                    "bounds the window (default: the whole trace)")
    args = ap.parse_args(argv)
    for line in report(attribute(load(args.trace), args.step, args.steps)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
