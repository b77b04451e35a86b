"""What the runner finds by name: the benchmark's cells, configurations, traffic
mixes, runners, per-layer metric readers and kernel-name tables, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric sits in a
file of its own, found by the name that ``BENCHMARK.json`` gives it:

  benchmark/workloads/<cell>.json     the cell: config, traffic, chips, why, its
                                      check's limits and parameters
  benchmark/configs/<config>.json     the model's sizes, the recipe it is run by
  benchmark/traffic/<traffic>.json    a traffic mix: its kind and parameters
  benchmark/traffic/<kind>.py         the runner of a kind (``run(cell)``)
  benchmark/metrics/<metric>.py       a per-layer metric's reader (``read(record)``)
  benchmark/work/kernels/*.json       which kernels compute which function

so that a new cell, configuration, mix or metric is new files and entries, and no
edit of a file that is there.
"""

import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
JAX_NAMES = ("jax", "jaxlib", "flax", "micro_diffusion_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _file(kind: str, name: str, ext: str = ".json") -> str:
    path = os.path.join(BENCH, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def workload(name: str) -> dict:
    return load_json(_file("workloads", name))


def config(name: str) -> dict:
    return load_json(_file("configs", name))


def traffic(name: str) -> dict:
    return load_json(_file("traffic", name))


def _module(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def runner(kind: str):
    return _module(_file("traffic", kind, ".py"), f"benchmark_runner_{kind}")


def reader(metric: str):
    mod = _module(_file("metrics", metric, ".py"),
                  "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))
    for attr in ("LAYER", "UNIT", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric reader {metric!r} lacks {attr}")
    return mod


def kernel_tables() -> dict:
    """{function: [kernel-name regex]} from every table in work/kernels/."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH, "work", "kernels", "*.json"))):
        table = load_json(path)
        out.setdefault(table["function"], []).extend(table["kernels"])
    return out


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports, as entries of
    ``bench``."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


@dataclasses.dataclass
class Cell:
    """One run of one cell, as a runner gets it."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str                 # 'cuda'; 'cpu' only in the benchmark's own tests
    tmpdir: str
    t0: float                   # the process's start, for setup_s
    per_layer: list             # names of the per-layer metrics to read
    fault: str = None           # the tests' planted faults

    @property
    def params(self) -> dict:
        """The traffic mix's parameters under the cell's own."""
        return {**self.traffic.get("params", {}), **self.workload.get("params", {})}


def read_per_layer(names, record: dict) -> dict:
    """Each named metric that its reader finds something for, with its unit."""
    out = {}
    for name in names:
        mod = reader(name)
        value = mod.read(record)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def judged(checks: dict) -> bool:
    """Every compared number within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def build_kernels(device) -> None:
    """On a card, the port's kernels built before the set-up's first call (one nvcc
    each, into the port's own build cache, so that only a checkout's first run
    compiles) and the native MDS gather."""
    import torch

    if torch.device(device).type == "cuda":
        from benchmark import port

        port.build_kernels()


def launch_counts(names) -> dict:
    """The port's kernel counters, ``ops.<module>.<wrapper>.launches``, by name."""
    out = {}
    for name in names:
        mod, fn = name.rsplit(".", 1)
        ops = importlib.import_module(f"micro_diffusion_tpu_torch.ops.{mod}")
        out[name] = getattr(ops, fn).launches
    return out


def jax_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
