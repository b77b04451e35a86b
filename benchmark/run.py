"""Run one cell of the benchmark of ``micro_diffusion_tpu_torch`` once, on the
machine it is started on, and print the result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics (BENCHMARK.json). Every run checks what its timed path produced against the
plain reference (benchmark/reference) and prints each compared number beside its
limit, last on standard error and last in the result line. The run exits non-zero
and prints no result without the cards the cell asks for, without the port beside
the benchmark, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PORT = "micro_diffusion_tpu_torch"


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them, for the log."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(BENCH, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if importlib.util.find_spec(PORT) is None:
        return fail(f"the program ({PORT}) is not beside the benchmark in {ROOT}")

    from benchmark import harness

    bench = harness.spec()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        return fail(f"BENCHMARK.json has no workload {args.workload!r}")
    wl = harness.workload(args.workload)
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            return fail(f"workloads/{args.workload}.json says {key} {wl[key]!r}, "
                        f"BENCHMARK.json {entry[key]!r}")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        return fail(f"the cell needs {entry['chips']} CUDA device(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    print(f"benchmark: {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr,
          flush=True)
    mix = harness.traffic(wl["traffic"])
    e2e, per = harness.cell_metrics(bench, args.workload)
    tmp = tempfile.mkdtemp(prefix="microdit-bench-")
    try:
        cell = harness.Cell(name=args.workload, workload=wl, config=harness.config(wl["config"]),
                            traffic=mix, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda", tmpdir=tmp, t0=T0,
                            per_layer=[m["name"] for m in per])
        out = harness.runner(mix["kind"]).run(cell)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    found = harness.jax_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {found}", 3)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"], "memory_peak_bytes": int(out["peak"])}
    breakdown = None
    if args.trace:
        metrics = harness.read_per_layer(cell.per_layer, out["record"])
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        breakdown = {"device_ops": out["trace"]["device_ops"],
                     "idle_gaps": out["trace"]["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in e2e}
    checks = out["checks"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"benchmark: {json.dumps(out['e2e'])}; {json.dumps(out.get('log', {}))}; host peak "
          f"{rss:.2f} GiB", file=sys.stderr)
    for name, value in out["readings"].items():
        print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(harness.judged(checks), out["attempted"], out["failed"],
                              metrics, device, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
