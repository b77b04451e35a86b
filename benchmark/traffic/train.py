"""The runner of training traffic: one stage of the recipe through the port's entry
point, ``train/cli.py main`` -> ``Trainer.fit`` -> ``make_train_step``.

Set-up: the mix's latents are drawn from the seed and written as an MDS dataset
under the run's temporary directory; ``cli.main`` builds the stage from its H100
overlay with the seed as the recipe's ``seed`` (the loader's order and caption drops,
the step draws), the recipe's own metric window, and no eval, checkpoint or image
logging. At ``fit_start`` the benchmark's seeded weights replace the model's, the EMA
mirrors them. The first ``followed_steps`` steps, the first of which compiles and
warms every shape of the stage, are those the reference follows; the program's
readings of them (losses, the first gradient from Adam's moment, the parameters and
EMA after them, the batches the loader delivered) are taken, outside ``setup_s``.

Window: from a synchronised step boundary, the steps the trainer runs as the recipe
runs them (no synchronise of the benchmark's between them) until the host's clock at
a step's return reaches ``--seconds``; then a synchronise ends it. The rate is all
the window's images over all its time. With ``--trace 1`` the same window runs
untraced (for ``mfu`` and the data wait), then ``trace_steps`` more steps run under
``torch.profiler``.

The trainer is reached through ``benchmark/port.py``, the one place that touches its
private parts. Then the program's state is freed, and the reference follows the same
steps (reference/follow.py) to judge the readings (checks.py).
"""

import gc
import os
import time

import numpy as np
import torch

from benchmark import checks, harness, inputs, port
from benchmark.reference import follow as reference
from benchmark.reference import protocol
from benchmark.work import flops


class WindowClosed(Exception):
    """Raised from under the trainer's step when the window (and the trace) is done."""


def write_mds(dirname, caps, lats, image_size):
    """The samples as an MDS latents dataset with the recipes' columns."""
    from micro_diffusion_tpu_torch.datasets import MDSWriter

    col = f"latents_{image_size}"
    with MDSWriter(out=dirname, columns={"caption_latents": "bytes", col: "bytes"}) as w:
        for c, l in zip(caps, lats):
            w.write({"caption_latents": c.tobytes(), col: l.tobytes()})


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The trainer callback that sets the run up; and, around the trainer's step
    function, what takes the program's readings, times the window and takes the
    trace. It sees each step as the step function returns, before the trainer
    stages the next batch."""

    def __init__(self, cell, weight_seed, counters):
        p = cell.params
        self.cell, self.weight_seed, self.counters = cell, weight_seed, counters
        self.followed, self.trace_steps = p["followed_steps"], p["trace_steps"]
        self.trainer = None
        self.losses, self.grad, self.params, self.ema, self.batches = [], None, None, None, []
        self.bookkeeping_s = 0.0
        self.done = 0
        self.window = None
        self.setup_end = None
        self.trace_path = None

    # -- set-up -------------------------------------------------------------------

    def fit_start(self, trainer):
        self.trainer = trainer
        state = trainer.state
        inputs.fill_weights(state.params, self.weight_seed)
        if state.ema_params is not None:
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.copy_(state.params[k])

        def recording(stage):  # the loader's batches of the followed steps
            def staged(batch):
                if len(self.batches) < self.followed:
                    self.batches.append(batch)
                return stage(batch)
            return staged
        self.unwrap_staging = port.wrap_staging(trainer, recording)
        if self.cell.fault:
            port.wrap_step(trainer, FAULTS[self.cell.fault])

        def seen(step):
            def timed(state, batch, gen):
                new, metrics = step(state, batch, gen)
                self.done += 1
                self._after(new, metrics)
                return new, metrics
            return timed
        port.wrap_step(trainer, seen)

    def step_end(self, trainer, metrics):
        pass

    def eval_end(self, trainer, eval_loss):
        raise RuntimeError("the benchmark's training window runs no eval")

    def fit_end(self, trainer):
        pass

    def _readings(self, state, metrics):
        t = time.perf_counter()
        self.losses.append(float(metrics["loss"]))
        if self.done == 1:  # Adam's first moment after one step is (1 - b1) g
            mu = port.moments(state)[0]
            norms = torch.stack(torch._foreach_norm([m.float() for m in mu.values()])).cpu()
            b1 = port.beta1(self.trainer)
            self.grad = {k: float(v) / (1 - b1) for k, v in zip(mu, norms)}
        if self.done == self.followed:
            self.params = {k: p.detach().to("cpu", copy=True) for k, p in state.params.items()}
            if state.ema_params is not None:
                self.ema = {k: e.detach().to("cpu", copy=True)
                            for k, e in state.ema_params.items()}
            self.unwrap_staging()
        self.bookkeeping_s += time.perf_counter() - t

    # -- the window ---------------------------------------------------------------

    def _after(self, state, metrics):
        done, trainer = self.done, self.trainer
        if done <= self.followed:
            self._readings(state, metrics)
            if done == self.followed:
                _sync(self.cell.device)
                self.setup_end = time.perf_counter()
                self.step_ends = [self.setup_end]
                self.wait0 = trainer.data_wait_s
                self.launches0 = harness.launch_counts(self.counters)
            return
        if self.window is None:
            now = time.perf_counter()
            self.step_ends.append(now)
            if now - self.setup_end < self.cell.seconds:
                return
            _sync(self.cell.device)
            steps = done - self.followed
            end = harness.launch_counts(self.counters)
            self.window = {"steps": steps, "units": steps,
                           "seconds": time.perf_counter() - self.setup_end,
                           "images": steps * trainer.global_batch_size,
                           "data_wait_s": trainer.data_wait_s - self.wait0,
                           "step_s": list(np.diff(self.step_ends)),
                           "launches": {k: end[k] - self.launches0[k] for k in end}}
            if not self.cell.trace:
                raise WindowClosed
            self.trace_from = done
            self.profile = torch.profiler.profile(activities=_activities(self.cell.device))
            self.profile.start()
            self.scope = torch.profiler.record_function(TRACE_SCOPE)
            self.scope.__enter__()
            return
        if done - self.trace_from >= self.trace_steps:
            _sync(self.cell.device)
            self.scope.__exit__(None, None, None)
            self.profile.stop()
            self.trace_path = os.path.join(self.cell.tmpdir, "trace.json")
            self.profile.export_chrome_trace(self.trace_path)
            del self.profile
            raise WindowClosed


TRACE_SCOPE = "benchmark.traced_window"


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _unchanged(step):
    """The fault of a step that returns its state as it found it."""
    def unchanged(state, batch, gen):
        tensors = (state.params, *port.moments(state))
        saved = [{k: v.detach().clone() for k, v in d.items()} for d in tensors]
        new, metrics = step(state, batch, gen)
        with torch.no_grad():
            for d, s in zip((new.params, *port.moments(new)), saved):
                for k, v in d.items():
                    v.copy_(s[k])
        return new, metrics
    return unchanged


def _half_batch(step):
    """The fault of a step over the first half of its batch."""
    def half_batch(state, batch, gen):
        return step(state, {k: v[:len(v) // 2] for k, v in batch.items()}, gen)
    return half_batch


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}  # the tests' faults


def recipe_argv(cell, datadir):
    r = cell.config["recipe"]
    return ["--config-path", os.path.join(harness.ROOT, r["config_path"]),
            "--config-name", r["config_name"],
            f"seed={cell.seed}", f"dataset.train.datadir={datadir}",
            f"dataset.eval.datadir={datadir}", "trainer.eval_interval=0",
            "trainer.save_interval=0", "trainer.save_folder=null",
            "trainer.load_path=null", "trainer.autoresume=false",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={os.path.join(cell.tmpdir, 'metrics.jsonl')}",
            "callbacks.image_monitor.prompts_file="
            + os.path.join(harness.ROOT, "configs", "eval_prompts.yaml"),
            *r.get("overrides", [])]


def expected_batches(cfg, caps, lats, seed, steps):
    """The rows, images and caption drops that the protocol gives the first steps."""
    tr = cfg["train"]
    out = []
    for step in range(steps):
        epoch, idx = protocol.batch_indices(len(caps), tr["batch"], seed, step,
                                            tr["shuffle_algo"])
        keep = [protocol.caption_kept(seed, epoch, i, tr["cap_drop_prob"]) for i in idx]
        out.append({"image_latents": lats[idx], "caption_latents": caps[idx],
                    "drop_caption_mask": np.asarray(keep, dtype=np.float32)})
    return out


def run(cell):
    cfg, p = cell.config, cell.params
    m, tr = cfg["model"], cfg["train"]
    device = cell.device
    cuda = torch.device(device).type == "cuda"
    harness.build_kernels(device)
    caps, lats = inputs.latents(cell.seed, p["samples"], m["latent_res"], m["caption_len"],
                                m["caption_channels"], device)
    datadir = os.path.join(cell.tmpdir, "mds")
    write_mds(datadir, caps, lats, cfg["recipe"]["image_size"])
    weight_seed = inputs.sub_seed(cell.seed, 2)
    path = p.get("path", {})
    win = Window(cell, weight_seed, path.get("present", []) + path.get("absent", []))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    from micro_diffusion_tpu_torch.train import cli
    try:
        cli.main(recipe_argv(cell, datadir), callbacks=[win])
    except WindowClosed:
        pass
    if win.window is None or (cell.trace and win.trace_path is None):
        raise RuntimeError("the fit ended before the window closed")
    trainer = win.trainer
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    batch, mb = trainer.global_batch_size, trainer.microbatch_size or tr["batch"]
    if batch != tr["batch"] or mb != tr["microbatch"]:
        raise RuntimeError(f"the recipe ran batch {batch} in microbatches of {mb}; the "
                           f"configuration states {tr['batch']} / {tr['microbatch']}")
    win.trainer = trainer = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    w = win.window
    setup_s = win.setup_end - cell.t0 - win.bookkeeping_s
    rate = w["images"] / w["seconds"]
    out = {"e2e": {"train_img_per_s": rate, "setup_s": setup_s},
           "attempted": w["images"], "failed": 0, "peak": peak,
           "log": {"step_s": [round(float(s), 4) for s in w["step_s"]]}}
    if cell.trace:
        out["record"], out["trace"] = _record(cell, win, rate)

    ref = reference.follow(m, tr, caps, lats, cell.seed, weight_seed, win.followed,
                           p["ref_rows"], device)
    w0 = ref.pop("w0")
    with torch.no_grad():
        prog = {"loss": win.losses, "grad": win.grad,
                "update": {k: float(torch.linalg.vector_norm(v.to(device) - w0[k]))
                           for k, v in win.params.items()}}
        if win.ema is not None:
            prog["ema"] = {k: float(torch.linalg.vector_norm(v.to(device) - w0[k]))
                           for k, v in win.ema.items()}
    numbers = checks.training_numbers(prog, ref)
    numbers["data_rows"] = checks.data_rows(
        win.batches, expected_batches(cfg, caps, lats, cell.seed, win.followed))
    if cuda:
        numbers["path"] = checks.path_violations(w["launches"], path)
    out["checks"], out["readings"] = checks.with_limits(numbers, cell.workload["limits"])
    return out


def _record(cell, win, rate):
    """The readers' record of a traced run, and the trace's summary."""
    from benchmark import trace

    m, tr = cell.config["model"], cell.config["train"]
    summary = trace.summarize(trace.load(win.trace_path), TRACE_SCOPE)
    micro = tr["batch"] // tr["microbatch"]
    work = flops.function_work(m, tr["microbatch"], tr["mask_ratio"], train=True)
    record = {"kind": "train", "chips": 1, "images_per_s": rate,
              "model_flops_per_image": flops.model_flops(m, tr["mask_ratio"], train=True),
              "least_s": {fn: work[fn][2] * micro * win.trace_steps for fn in work},
              "kernels": harness.kernel_tables(), "window": win.window, "trace": summary,
              "traced_units": win.trace_steps}
    return record, summary
