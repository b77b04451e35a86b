"""The harness finds its cells, configurations, mixes and metrics by name, meets the
rules for its files, and keeps JAX and the port where they belong."""

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH, ROOT = harness.BENCH, harness.ROOT


def bench():
    return harness.spec()


def test_every_cell_config_mix_and_metric_loads_by_name():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        wl = harness.workload(w["name"])
        assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        cfg = harness.config(w["config"])
        entry = configs[w["config"]]
        assert os.path.join(ROOT, entry["file"]) == os.path.join(BENCH, "configs",
                                                                 w["config"] + ".json")
        assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
        mix = harness.traffic(w["traffic"])
        assert callable(harness.runner(mix["kind"]).run)
        e2e, per = harness.cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per
        for m in per:
            r = harness.reader(m["name"])
            assert (r.UNIT, r.MOVES, r.LAYER) == (m["unit"], m["moves"], m["layer"])
            assert m["moves"] in names
        for key in wl["limits"]:
            assert wl["limits"][key] >= 0
    assert set(harness.kernel_tables()) == {"attention", "moe"}


def test_a_new_cell_config_and_metric_are_new_files(tmp_path, monkeypatch):
    """A copy of the benchmark with one more workload, configuration and metric, each
    a new file plus its entry: the harness finds them without an edit elsewhere."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    (root / "benchmark" / "configs" / "xl512-copy.json").write_text(
        (root / "benchmark" / "configs" / "microdit-xl-512.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="xl512-copy",
                             file="benchmark/configs/xl512-copy.json"))
    cell = dict(config="xl512-copy", traffic="sample-b32", chips=1, why="a copy")
    b["workloads"].append(dict(cell, name="xl512-copy.sample"))
    wl = dict(harness.workload("xl512-sample"), **cell)
    (root / "benchmark" / "workloads" / "xl512-copy.sample.json").write_text(json.dumps(wl))
    (root / "benchmark" / "metrics" / "calls.sample.py").write_text(
        'LAYER = "sampler"\nUNIT = "1"\nMOVES = "sample_img_per_s"\n\n\n'
        'def read(record):\n    return 2.0 if record.get("kind") == "sample" else None\n')
    b["per_layer"].append({"name": "calls.sample", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "sampler",
                           "moves": "sample_img_per_s"})
    b["end_to_end"][1]["workloads"].append("xl512-copy.sample")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "BENCH", str(root / "benchmark"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    spec = harness.spec()
    assert harness.workload("xl512-copy.sample")["config"] == "xl512-copy"
    assert harness.config("xl512-copy")["model"]["dim"] == 1024
    e2e, per = harness.cell_metrics(spec, "xl512-copy.sample")
    assert {m["name"] for m in e2e} == {"sample_img_per_s", "setup_s"}
    assert "calls.sample" in {m["name"] for m in per}
    assert harness.read_per_layer(["calls.sample"], {"kind": "sample"}) == \
        {"calls.sample": {"value": 2.0, "unit": "1"}}
    # the metric without a "workloads" key reaches every cell reporting what it moves
    assert "calls.sample" in {m["name"] for m in harness.cell_metrics(spec, "xl512-sample")[1]}


def test_benchmark_json_is_well_formed():
    raw = open(os.path.join(ROOT, "BENCHMARK.json")).read()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and not b["paths"][0].endswith("_torch")
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    cells = {w["name"]: w for w in b["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells) == len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"train_img_per_s", "sample_img_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"] + b["configs"]:
        assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for path in glob.glob(os.path.join(BENCH, "**", "*"), recursive=True):
        rel = os.path.relpath(path, ROOT)
        if "__pycache__" not in rel and ".cache" not in rel:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_configs_agree_with_the_recipes_they_run():
    """What the reference follows is what the recipe runs under the configuration's
    overrides: the stage's batch, microbatch, mask, sigma, optimizer, clip and EMA,
    and the model's arch and sizes."""
    from micro_diffusion_tpu_torch.train.config import load_config

    for c in bench()["configs"]:
        cfg = harness.config(c["name"])
        r, tr, m = cfg["recipe"], cfg["train"], cfg["model"]
        rec = load_config(os.path.join(ROOT, r["config_path"]), r["config_name"],
                          r.get("overrides", []))
        assert rec["model"]["dit_arch"] == m["arch"]
        assert rec["model"]["latent_res"] == m["latent_res"]
        assert rec["model"]["pos_interp_scale"] == m["pos_interp_scale"]
        assert rec["dataset"]["image_size"] == r["image_size"] == 8 * m["latent_res"]
        assert rec["dataset"]["train_batch_size"] == tr["batch"] == cfg["train_batch_size"]
        assert rec["trainer"]["device_train_microbatch_size"] == tr["microbatch"]
        assert rec["model"]["train_mask_ratio"] == tr["mask_ratio"]
        assert (rec["model"]["p_mean"], rec["model"]["p_std"]) == (tr["p_mean"], tr["p_std"])
        assert rec["dataset"]["cap_drop_prob"] == tr["cap_drop_prob"]
        assert rec["dataset"]["train"]["shuffle_algo"] == tr["shuffle_algo"]
        opt = rec["optimizer"]
        assert float(opt["lr"]) == tr["schedule"]["lr"]
        assert (opt["weight_decay"], list(opt["betas"]), float(opt["eps"])) == \
            (tr["weight_decay"], tr["betas"], tr["eps"])
        assert rec["algorithms"]["gradient_clipping"]["clip_norm"] == tr["clip_norm"]
        ema = rec["algorithms"].get("ema")
        if tr["ema"] is None:
            assert ema is None
        else:
            assert ema["smoothing"] == tr["ema"]["smoothing"]
            assert int(str(ema["ema_start"]).rstrip("ba")) == tr["ema"]["start"]
        sched = rec["scheduler"]
        if tr["schedule"]["kind"] == "cosine_warmup":
            assert int(str(sched["t_warmup"]).rstrip("ba")) == tr["schedule"]["warmup"]
            assert sched["alpha_f"] == tr["schedule"]["alpha_f"]
            assert int(str(rec["trainer"]["max_duration"]).rstrip("ba")) == \
                tr["schedule"]["total"]
        else:
            assert sched["_target_"].endswith("ConstantScheduler") and sched["alpha"] == 1.0


TOP = ("jax", "jaxlib", "flax", "micro_diffusion_tpu")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_sampling_window_checks_every_batch_position():
    """The calls of a window of ``run_seconds`` (no call is shorter than 10 s) check
    every batch position between them."""
    drv = harness.runner("sample")
    for w in bench()["workloads"]:
        p = harness.Cell(name=w["name"], workload=harness.workload(w["name"]), config={},
                         traffic=harness.traffic(w["traffic"]), seed=0, seconds=0.0,
                         trace=False, device="cpu", tmpdir="", t0=0.0, per_layer=[]).params
        if harness.traffic(w["traffic"])["kind"] != "sample":
            continue
        calls = -(-bench()["run_seconds"] // 10)
        for seed in (0, 2**31 + 5, 2**40 + 3):
            seen = set()
            for i in range(1, calls + 1):
                rows = drv.check_rows(seed, i, p["prompts"], p["check_per_call"])
                assert len(set(rows)) == p["check_per_call"]
                seen.update(rows)
            assert seen == set(range(p["prompts"])), (w["name"], seed)


def test_the_port_s_private_parts_are_reached_in_one_place():
    """Only benchmark/port.py touches the trainer's private attributes, and a training
    run keeps the recipe's metric window (no synchronise of the benchmark's per step)."""
    from benchmark.traffic import train

    private = re.compile(r"\._stage_batch|\._step_fn|\.opt_state|\.tx\b|ops\._build|\b_build\b")
    for path in glob.glob(os.path.join(harness.BENCH, "**", "*.py"), recursive=True):
        if os.path.basename(path) == "port.py" or "tests" in path.split(os.sep):
            continue
        code = open(path).read()
        assert not private.search(code), (path, private.search(code).group(0))
    assert not any("metric_window" in a for a in train.recipe_argv(
        harness.Cell(name="t", workload={}, config=harness.config("microdit-xl-512"),
                     traffic={}, seed=1, seconds=0.0, trace=False, device="cpu",
                     tmpdir="", t0=0.0, per_layer=[]), "data"))


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")) + \
            [os.path.join(BENCH, "inputs.py"), os.path.join(BENCH, "checks.py")]:
        for name in _imports(path):
            assert name.split(".")[0] not in TOP + ("micro_diffusion_tpu_torch",), (path, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.follow, benchmark.reference.encoders, "
            "benchmark.reference.bpe\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    loaded = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                       text=True, check=True).stdout.replace("'", '"'))
    assert not set(loaded) & set(TOP + ("micro_diffusion_tpu_torch",))


def test_the_chip_path_loads_no_jax():
    """Every module a run loads (the harness, its runners, readers and reference, and
    the port's modules they call), compared by whole top-level name."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run\n"
            "from benchmark import harness, trace, readings\n"
            "for k in ('train', 'sample'): harness.runner(k)\n"
            "for m in harness.spec()['per_layer']: harness.reader(m['name'])\n"
            "from micro_diffusion_tpu_torch.train import cli\n"
            "from micro_diffusion_tpu_torch.models import text_encoders, vae, diffusion\n"
            "from micro_diffusion_tpu_torch.datasets import MDSWriter, native\n"
            "from micro_diffusion_tpu_torch.ops import _build\n"
            "print(harness.jax_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip() == "[]"


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "micro_diffusion_tpu_torch_like", object())
    assert harness.jax_modules() == [] or all(
        m.split(".")[0] in TOP for m in harness.jax_modules())
    monkeypatch.setitem(sys.modules, "micro_diffusion_tpu.ops", object())
    assert "micro_diffusion_tpu.ops" in harness.jax_modules()


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "xl512-train",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0",
                           *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "not beside the benchmark" in out.stderr


def test_result_line_puts_the_checks_last():
    checks = {"loss": {"value": 1e-3, "limit": 1e-2}}
    line = json.loads(harness.result_line(True, 10, 0, {}, {"platform": "gpu"}, checks,
                                          {"device_ops": [], "idle_gaps": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert harness.judged(checks)
    assert not harness.judged({"x": {"value": float("nan"), "limit": 1.0}})


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "xl256-train",
                          "--seed", str(2**31 + 101), "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result


def test_trace_arithmetic_on_a_synthetic_trace(tmp_path):
    """Window, busy time, kernel seconds, the idle gaps and their host operators, and
    the readers over them, on a trace with every number known (microseconds)."""
    from benchmark import readings, trace

    ev = [{"ph": "X", "cat": "user_annotation", "name": "w", "ts": 100, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 110, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 150, "dur": 5}]
    for i, (launch, start, dur, name) in enumerate([(111, 120, 20, "attn_fwd_kernel"),
                                                    (112, 130, 20, "moe_gemm_kernel"),
                                                    (151, 170, 10, "elementwise"),
                                                    (90, 95, 10, "before the window")]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": launch, "dur": 1, "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                   "args": {"correlation": i}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(trace.load(str(path)), "w")
    approx = pytest.approx
    assert (s["window_s"], s["busy_s"]) == (approx(100e-6), approx(40e-6))  # [120, 150), [170, 180)
    assert [g[0] for g in s["idle_gaps"]] == ["aten::mm", "aten::mul", "window end"]
    assert [g[1] for g in s["idle_gaps"]] == approx([20e-6] * 3)
    assert trace.seconds_matching(s["ops"], ["attn_fwd"]) == approx(20e-6)
    record = {"kind": "train", "trace": s, "traced_units": 1, "chips": 1,
              "window": {"units": 2, "seconds": 200e-6}, "least_s": {"attention": 5e-6},
              "kernels": {"attention": ["attn_fwd_kernel"]}, "images_per_s": 10.0,
              "model_flops_per_image": 989e12 / 100}
    assert readings.idle(record, "train") == approx(100 * (1 - 40 / 100))
    assert readings.roofline(record, "attention", "train") == approx(25.0)
    assert readings.roofline(record, "moe", "train") is None
    assert readings.mfu(record, "train") == approx(10.0)
    assert readings.idle(record, "sample") is None
