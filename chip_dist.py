#!/usr/bin/env python3
"""The multi-GPU trainer of the PyTorch port on NVIDIA H100s. Imports nothing of JAX.

    python3 chip_dist.py              # one card: the [dist] phase of chip_smoke.py alone
    python3 chip_dist.py --nproc 4    # four cards of one host (NVLink), NCCL

One card (a few minutes): builds the kernels, runs chip_smoke.py's [trainer] phase
(the XL stage-1 recipe through train.cli.main without a process group, on a seeded
synthetic MDS set), then its ``run_dist``: the same recipe through ``cli.main
--multihost`` in a one-rank NCCL group, 3 steps with a save at step 2, an autoresume
bitwise equal to the straight run; then 2 gloo ranks sharing the card.

Four cards (``run_four``, about eleven minutes): builds the kernels and the native MDS
gather once, writes seeded 256px and 512px MDS latent sets, then
  0. reads    - four processes at once read the ranks' shares of a global batch of
                the 256px set through the native gather and through the memmap path,
                from a warm and from a cold page cache: bitwise equal, MB/s;
  1. baseline - MicroDiT-XL stage 1 (configs/h100_1gpu/res_256_pretrain) through
                cli.main on card 0 without a process group: global batch 1024 in
                microbatches of 256 (K = 4), 4 steps; the losses, grad norms, every
                parameter and its init, and each gate and expert leaf's first moment
                after step 4;
  2. meshes   - the same recipe, seed and data on 4 NCCL ranks started by torchrun
                (``python -m torch.distributed.run --standalone --nproc_per_node 4``,
                each rank this script's ``--rank-fit``, which calls cli.main
                --multihost with a probe), at (data, fsdp, tensor) = (4, 1, 1),
                (1, 2, 2) and (1, 4, 1), and (4, 1, 1) once more with the loader on
                the memmap path: each held against the baseline after step 4
                (losses and grad norms 1e-5, all parameters PARAM_TOL, each leaf's
                change since the init against the baseline's UPDATE_TOL, which the
                planted faults must exceed fivefold, under expert parallelism each
                gate and expert leaf's first moment 1e-2), the backend and world and
                every rank's launch counts checked, the global images/s of steps 2-4
                against 4 x the baseline's, rank 0's step 5 under torch.profiler
                (the NCCL kernels' share of the device time, the idle share), every
                rank's peak and data wait from a cold page cache;
  3. checkpoints - the (1, 4, 1) run with the EMA on saves at steps 3 and 5; an
                autoresume from step 3 on 4 ranks saves at 5, bitwise equal to the
                straight run's file in params, mu, nu and EMA; the step-3 file loaded
                strictly by one process (step and loader position); the save and load
                seconds, the time ranks 1-3 wait at the barrier, the bytes;
  4. handoff  - XL stage 2 (res_256_finetune) as the user's command (``-m
                micro_diffusion_tpu_torch.train --multihost`` under torchrun) on 4
                ranks at (1, 4, 1), loading the stage-1 file weights-only, 2 steps and a
                save; stage 3 (res_512_pretrain, latent 64, 'gather') on 4 ranks loading
                it weights-only across the pos_embed change, 2 steps: every loaded
                tensor equal to the saved one, the launches summed over the ranks, the
                step-1 loss against one process that loads the same file.
Every phase's time is printed. At most four XL checkpoints (18.65 GB each) and the
baseline's file are written; each file is deleted once it has served. Exits non-zero
when there are fewer cards than asked or a rank fails, and at the end when any check
failed (a failed check is logged as ``FAILED:`` and the phases after it still run).
"""

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))

NPROC = 4
MESHES = ((4, 1, 1), (1, 2, 2), (1, 4, 1))  # the last one also checkpoints and hands off
MEMMAP_MESH = (4, 1, 1)  # run a second time with the loader on the memmap path alone
GLOBAL_BATCH = 1024  # stage 1: 256 a rank at (4, 1, 1) and (1, 4, 1); 512 at (1, 2, 2)
RES = (256, 512)     # the stage-1/2 and the stage-3 sets
STEPS = 4            # the steps held against the baseline: the lr is 0 at the first
                     # step, and from the adaLN-zero init the EC-MoE blocks get their
                     # first gradient at the fourth, so their first moments are zero
                     # before it (on both sides) and the check would hold vacuously
PROFILE_STEP = 5     # one more step, profiled on rank 0, outside the timed steps 2-4
SAVE_AT = 3          # (1, 4, 1): saves at 3 and at the end (5); the resume starts at 3
EMA = 0.9999         # (1, 4, 1): the EMA from step 1, so the checkpoints carry it
SAMPLES_256, SAMPLES_512 = 2048, 512  # synthetic MDS sets: 2 stage-1 steps an epoch
STAGE_STEPS = 2      # steps of the stage 2 and stage 3 runs
DIST_TOL = 1e-5      # relative: losses and grad norms against the baseline; stage 3's
                     # step-1 loss against one process
PARAM_TOL = {        # relative L2 of all parameters after step 4 against the baseline
    (4, 1, 1): 1e-6,  # the same microbatch gradients, summed in NCCL's order
    (1, 4, 1): 1e-6,
    (1, 2, 2): 1e-4,  # expert parallelism: bf16 partial sums (chip_smoke DIST_B_PARAM_TOL)
}
# Each leaf's change since the init against the baseline's, ||p - p_base|| / ||p_base -
# p_init||, leaf by leaf: the parameters move by only ~lr (<= 3e-7 a step in the
# warm-up), so PARAM_TOL cannot see a wrong update; an update skipped on a quarter or a
# half of a leaf reads ~0.5-0.7 here (``planted_faults``, which must read 5x the bound).
UPDATE_TOL = {
    (4, 1, 1): 1e-3,  # a 1-ulp rounding of p_init + update is ~3e-3 of one element's move
    (1, 4, 1): 1e-3,
    (1, 2, 2): 5e-2,  # and each rank's bf16 input gradient of an EC-MoE block: 3.4e-3
}                     # in a dense leaf upstream of one at Micro on 4 gloo ranks
MOE_MU_TOL = 1e-2    # each gate and expert leaf's first moment (chip_smoke DIST_B_MOE_GRAD_TOL)
RANK_TIMEOUT_S = 420  # one torchrun launch, model builds, saves and loads included
GROUP_TIMEOUT_S = 300  # a collective that waits longer fails the run
XL_FILE_BYTES = 18.65e9  # an XL checkpoint with the EMA (chip_smoke [dist])
BASELINE_BYTES = 12.0e9  # the baseline's parameters, their init and MoE first moments
STAGE1_LAUNCHES = dict(attention=137, attention_bwd=69, moe=32, moe_bwd=16, adaln=137)
# ^ per stage-1 microbatch ([trainer]'s); v per stage-3 step, summed over the ranks
STAGE3_LAUNCHES = dict(attention=1096, attention_bwd=552, em=256, em_bwd=128, adaln=1096)

FAILED = []  # the checks that failed; the run goes on to its end and then exits 1


def expect(ok, msg):
    """A check: logged and kept in FAILED when it fails (the phases after it still
    run, so one call reads them all); ``main`` exits 1 when any failed."""
    if not ok:
        FAILED.append(msg)
        log(f"FAILED: {msg}")
    return ok


def log(msg):
    print(msg, flush=True)


def smi_lines():
    """``nvidia-smi``'s name and power limit, one line a card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()


def _sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timed:
    """Wrap ``obj.name`` so that each call's synchronised start and end times
    (perf_counter seconds) are appended to ``calls``; ``restore`` undoes it."""

    def __init__(self, obj, name):
        self.obj, self.name, self.fn, self.calls = obj, name, getattr(obj, name), []

        def timed(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kwargs)
            finally:
                _sync()
                self.calls.append((t0, time.perf_counter()))

        setattr(obj, name, timed)

    def seconds(self):
        return [b - a for a, b in self.calls]

    def restore(self):
        setattr(self.obj, self.name, self.fn)


def kernel_intervals(trace_path):
    """(start, end) in microseconds of every device kernel in a Chrome trace, split
    into NCCL kernels and the rest."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    nccl, other = [], []
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            (nccl if e["name"].startswith("nccl") else other).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return nccl, other


def union_us(intervals):
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_shares(trace_path, wall_ms):
    """Device busy time (the union of kernel intervals), the NCCL kernels' share of
    it, and the idle share of the wall time; None where no kernel was traced."""
    nccl, other = kernel_intervals(trace_path)
    busy = union_us(nccl + other) / 1e3
    if busy <= 0:
        return None
    nccl_ms, compute_ms = union_us(nccl) / 1e3, union_us(other) / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy, nccl_ms=nccl_ms, compute_ms=compute_ms,
                overlap_ms=nccl_ms + compute_ms - busy, nccl_share=nccl_ms / busy,
                idle_share=1 - busy / wall_ms, nccl_kernels=len(nccl),
                kernels=len(nccl) + len(other))


def planted_faults(name, diff, upd, shard):
    """What the update check would read of a leaf (its difference ``diff`` from the
    baseline, the baseline's change ``upd`` since the init) if part of its update had
    been skipped: there the leaf would still hold its init, so the difference there
    would be -upd. ``shard``: a quarter of the leaf's first axis (one rank's ZeRO-2
    shard at fsdp 4), else the second half of its experts (one rank's at tensor 2).
    A leaf that moved only by rounding may read little; a rank that skips its update
    skips it in all its leaves, so ``_compare`` keeps the worst leaf of each kind."""
    if diff.dim() == 0:
        diff, upd = diff.reshape(1), upd.reshape(1)
    n = diff.shape[0]
    part = slice(n // 4, n // 2) if shard else slice(n // 2, n)
    rest = float(diff.square().sum() - diff[part].square().sum())
    skipped = float(upd[part].square().sum())
    return dict(leaf=name,
                part="rows n/4 to n/2 (one rank's shard)" if shard else
                "experts e/2 to e (one tensor rank's)",
                rel=((rest + skipped) / float(upd.square().sum())) ** 0.5)


# ------------------------------------------------------------------ one rank


class RankProbe:
    """A trainer callback on every rank (and in the baseline's one process): the
    kernel launches, the data wait and the wall clock of every step, the peak; at
    ``compare["step"]`` every parameter and each gate and expert leaf's first moment
    against the baseline's file (gathered to rank 0; collective); one step under
    ``profile_trace`` on rank 0; at the start, the weights a ``check_loaded`` file
    holds against the loaded ones. Writes its record to ``out`` at the end."""

    def __init__(self, spec):
        self.spec = spec
        self.rec = {"steps": [], "launches": [], "wait_ms": [], "t": []}

    def fit_start(self, trainer):
        import torch
        import torch.distributed as dist

        mesh = trainer.mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.rec.update(rank=self.rank, device=str(trainer.device),
                        backend=dist.get_backend() if dist.is_initialized() else None,
                        world=mesh.size if mesh is not None else 1,
                        mesh=[mesh.shape[a] for a in ("data", "fsdp", "tensor")] if mesh else None,
                        start_step=trainer.global_step,
                        microbatches=-(-trainer.train_loader.batch_size
                                       // (trainer.microbatch_size
                                           or trainer.train_loader.batch_size)))
        if self.spec.get("check_loaded"):
            self.rec["loaded"] = self._check_loaded(trainer)
        if self.spec.get("keep_init"):  # the baseline's parameters before step 1
            self.init = {k: p.detach().cpu().clone() for k, p in trainer.state.params.items()}
        if trainer.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(trainer.device)
        self._mark = cs.read_counts()
        self._wait = 0.0
        _sync()
        self.rec["t"].append(time.perf_counter())

    def _check_loaded(self, trainer):
        """Each parameter (this rank's slice) against the file it was loaded from."""
        import torch

        ckpt = torch.load(self.spec["check_loaded"], map_location="cpu", weights_only=True,
                          mmap=True)
        params = trainer.state.params
        equal = 0
        for k, v in ckpt["params"].items():
            v = v.to(trainer.device)
            if trainer.zero is not None:
                v = trainer.zero.param_local(v, k)
            equal += bool(k in params and torch.equal(params[k], v))
        dit = trainer.model.dit
        return dict(equal=equal, saved=len(ckpt["params"]),
                    keys_equal=set(params) == set(ckpt["params"]),
                    pos_embed=list(dit.pos_embed.shape), dim=dit.dim, step=trainer.global_step)

    def step_end(self, trainer, metrics):
        now = cs.read_counts()
        self.rec["launches"].append({k: now[k] - self._mark[k] for k in now})
        self._mark = now
        step = trainer.global_step
        self.rec["t"].append(time.perf_counter())
        self.rec["steps"].append(step)
        self.rec["wait_ms"].append((trainer.data_wait_s - self._wait) * 1e3)
        self._wait = trainer.data_wait_s
        if self.spec.get("compare") and step == self.spec["compare"]["step"]:
            self.rec["compare"] = self._compare(trainer)
        prof_step = self.spec.get("profile_step")
        if prof_step and self.rank == 0:
            if step == prof_step - 1:
                self._start_profile()
            elif step == prof_step:
                self._stop_profile()

    def _compare(self, trainer):
        """Every parameter, whole on rank 0, against the baseline's: relative L2 over
        the model; each leaf's change since the init against the baseline's change
        (``UPDATE_TOL``), and what the planted faults would read; the gate and expert
        leaves' first moments (on rank 0; None elsewhere)."""
        import torch

        zero = trainer.zero
        main = self.rank == 0
        ref = (torch.load(self.spec["compare"]["baseline"], map_location="cpu",
                          weights_only=True, mmap=True) if main else None)
        moe_names = cs.moe_leaf_names(trainer.model.dit)
        diffs, refs, upds, faults = {}, {}, {}, {}
        params = trainer.state.params
        with torch.no_grad():
            for k, p in params.items():  # one order on every rank
                whole = zero.gather_param(p.detach(), k) if zero is not None else p.detach()
                if not main:
                    continue
                w = whole.double()
                b = ref["params"][k].to(w.device).double()
                upd = b - ref["init"][k].to(w.device).double()
                diffs[k] = float((w - b).square().sum())
                refs[k] = float(b.square().sum())
                upds[k] = float(upd.square().sum())
                # a rank that skips its update skips it in every leaf it holds: the
                # check reads the worst of them
                kind = ("expert" if k.endswith((".w1", ".w2")) and k in moe_names else
                        "shard" if k not in moe_names else None)
                if kind and upds[k] > 0:
                    f = planted_faults(k, w - b, upd, shard=kind == "shard")
                    if f["rel"] > faults.get(kind, {"rel": -1.0})["rel"]:
                        faults[kind] = f
            moe, zero_ref = {}, 0
            mu = trainer.state.opt_state.mu
            for k in moe_names:
                whole = zero.gather_state(mu[k], k) if zero is not None else mu[k]
                if main:
                    r = ref["moe_mu"][k].to(whole.device).double()
                    d, n = float((whole.double() - r).norm()), float(r.norm())
                    moe[k] = d / n if n > 0 else (0.0 if d == 0 else math.inf)
                    zero_ref += n == 0
        if not main:
            return None
        leaf = {k: (d / max(refs[k], 1e-300)) ** 0.5 for k, d in diffs.items()}
        update = {k: (d / upds[k]) ** 0.5 if upds[k] > 0 else (0.0 if d == 0 else math.inf)
                  for k, d in diffs.items()}
        worst_leaf = max(leaf, key=leaf.get)
        worst_update = max(update, key=update.get)
        worst_moe = max(moe, key=moe.get)
        return dict(rel_params=(sum(diffs.values()) / sum(refs.values())) ** 0.5,
                    differ=sum(d > 0 for d in diffs.values()), tensors=len(diffs),
                    worst_leaf=worst_leaf, worst_leaf_rel=leaf[worst_leaf],
                    rel_update=(sum(diffs.values()) / sum(upds.values())) ** 0.5,
                    worst_update=worst_update, worst_update_rel=update[worst_update],
                    still=sum(u == 0 for u in upds.values()), faults=faults,
                    worst_moe=worst_moe, worst_moe_rel=moe[worst_moe], moe_leaves=len(moe),
                    moe_zero=zero_ref)

    def _start_profile(self):
        import contextlib
        from micro_diffusion_tpu_torch.utils.profiling import profile_trace

        self._prof_stack = contextlib.ExitStack()
        _sync()
        self._prof_t0 = time.perf_counter()
        self._prof = self._prof_stack.enter_context(profile_trace(self.spec["trace_dir"]))

    def _stop_profile(self):
        _sync()
        wall = (time.perf_counter() - self._prof_t0) * 1e3
        self._prof_stack.close()
        path = self._prof.trace_path
        self.rec["profile"] = dict(trace_shares(path, wall) or {"wall_ms": wall},
                                   step=self.spec["profile_step"])
        os.remove(path)  # tens of MB; the shares are what is kept

    def eval_end(self, trainer, eval_loss):
        pass

    def fit_end(self, trainer):
        import torch

        if trainer.device.type == "cuda":
            self.rec["peak_bytes"] = torch.cuda.max_memory_allocated(trainer.device)


def rank_fit(spec_path):
    """One torchrun rank (or the baseline's one process): cli.main with the spec's
    command line and a RankProbe, the loader's native gather calls counted (with
    the spec's ``memmap`` every batch is sliced from the memory maps instead); the
    record, with the save, load and barrier times, goes to ``<out>/rank<r>.json``.
    Returns the trainer and the probe."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from micro_diffusion_tpu_torch.datasets import mds
    from micro_diffusion_tpu_torch.train import cli
    from micro_diffusion_tpu_torch.train.trainer import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # as the baseline's process
    if spec.get("memmap"):
        mds.NATIVE_MIN_BATCH = math.inf
    probe = RankProbe(spec)
    timers = [Timed(Trainer, "save"), Timed(Trainer, "_resume"), Timed(dist, "barrier")]
    try:
        with cs.counted_gathers() as gathers:
            trainer = cli.main(spec["argv"], callbacks=[probe])
    finally:
        for t in timers:
            t.restore()
    rec = probe.rec
    rec.update(save=timers[0].calls, load_s=timers[1].seconds(), barrier=timers[2].calls,
               gather_calls=gathers[0])
    os.makedirs(spec["out"], exist_ok=True)
    with open(os.path.join(spec["out"], f"rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    return trainer, probe


# ------------------------------------------------------------------ launcher


def train_dir(tmp, res):
    return os.path.join(tmp, f"train{res}")


def overlay():
    return os.path.join(ROOT, "micro_diffusion_tpu_torch", "configs", "h100_1gpu")


def recipe_argv(config, datadir, metrics, *extra):
    return ["--config-path", overlay(), "--config-name", config,
            f"dataset.train.datadir={datadir}", f"dataset.eval.datadir={datadir}",
            "trainer.metric_window=1", "trainer.eval_interval=0", "trainer.save_folder=null",
            "callbacks.speed_monitor.window_size=1",
            f"callbacks.image_monitor.prompts_file={cs.PROMPTS_FILE}",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={metrics}", *extra]


def stage1_argv(tmp, metrics, steps, *extra):
    return recipe_argv("res_256_pretrain", train_dir(tmp, RES[0]), metrics,
                       f"dataset.train_batch_size={GLOBAL_BATCH}",
                       f"trainer.max_duration={steps}ba", *extra)


def mesh_argv(mesh):
    data, fsdp, tensor = mesh
    return [f"misc.mesh_shape.data={data}", f"misc.mesh_shape.fsdp={fsdp}",
            f"misc.mesh_shape.tensor={tensor}"]


def torchrun(args, label):
    """``python -m torch.distributed.run --standalone --nproc_per_node 4 <args>``
    (torchrun), its output passed through; raises when it fails or outlives
    RANK_TIMEOUT_S, and leaves no process behind."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={NPROC}", *args]
    log(f"{label} $ torchrun --standalone --nproc_per_node {NPROC} "
        f"{' '.join(args[:6])} ... ({len(args)} arguments)")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, start_new_session=True)
    try:
        rc = proc.wait(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: torchrun {'timed out' if rc is None else f'exited {rc}'} "
                             f"after {wall:.1f} s")
    return wall


def rank_launch(tmp, label, name, argv, **spec):
    """Run ``argv`` on every rank through this script's ``--rank-fit``; the ranks'
    records, by rank."""
    out = os.path.join(tmp, f"ranks_{name}")
    spec_path = os.path.join(tmp, f"spec_{name}.json")
    spec = dict(argv=["--multihost", "--dist-timeout", str(GROUP_TIMEOUT_S), *argv], out=out,
                trace_dir=os.path.join(tmp, f"trace_{name}"), **spec)
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    wall = torchrun([os.path.abspath(__file__), "--rank-fit", spec_path], label)
    recs = []
    for r in range(NPROC):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(out)
    return recs, wall


def metrics_of(path, steps, label):
    """Rank 0's logged losses and grad norms (one a step, finite)."""
    rows = cs.read_jsonl(path)
    losses = [r["loss/train/total"] for r in rows if "loss/train/total" in r]
    norms = [r["l2_norm/grad/global"] for r in rows if "l2_norm/grad/global" in r]
    if not (len(losses) == len(norms) == steps
            and all(math.isfinite(v) for v in losses + norms)):
        raise AssertionError(f"{label}: {len(losses)} losses, {len(norms)} norms, all finite "
                             f"expected: {losses} {norms}")
    return losses, norms


def rate(rec, first=2, last=STEPS):
    """Images/s of steps ``first``..``last`` from a record's step-end times, the
    saves between them taken out."""
    t = dict(zip([rec["start_step"]] + rec["steps"], rec["t"]))
    t0, t1 = t[first - 1], t[last]
    saves = sum(b - a for a, b in rec["save"] if t0 <= a <= t1)
    return (last - first + 1) * GLOBAL_BATCH / (t1 - t0 - saves)


def check_ranks(label, recs, mesh, want_per_mb=None, steps=None):
    """Every rank: NCCL (gloo on the CPU), the world, the mesh and the launches of
    every step (``want_per_mb`` x the rank's microbatches)."""
    for rec in recs:
        backend = "gloo" if rec["device"] == "cpu" else "nccl"
        expect(rec["backend"] == backend and rec["world"] == NPROC
               and tuple(rec["mesh"]) == tuple(mesh),
               f"{label} rank {rec['rank']}: {rec['backend']}, world {rec['world']}, mesh "
               f"{rec['mesh']}")
        if want_per_mb is not None:
            want = {k: v * rec["microbatches"] for k, v in want_per_mb.items()}
            expect(rec["launches"][:steps] == [want] * steps,
                   f"{label} rank {rec['rank']} launches {rec['launches']} (want {want} a step)")


def short(counts):
    return {k: v for k, v in counts.items() if v}


def run_reads(tmp):
    """The four ranks' shares of one shuffled global batch of the 256px set (split as
    the loader splits it), read by four processes at once through the native gather
    and through the memmap path, from a warm and from a cold page cache
    (``cs.compare_reads``)."""
    import multiprocessing

    import numpy as np

    order = np.random.default_rng(cs.SEED).permutation(SAMPLES_256)
    share = GLOBAL_BATCH // NPROC
    batches = [order[r * share:(r + 1) * share] for r in range(NPROC)]
    with multiprocessing.get_context("spawn").Pool(NPROC) as pool:
        pool.starmap(cs.read_batch, [(train_dir(tmp, RES[0]), b[:4], "gather") for b in batches])
        return cs.compare_reads(train_dir(tmp, RES[0]), batches, "[dist4 reads]", pool=pool)


def run_baseline(tmp):
    """Stage 1 on card 0 without a group: 4 steps at K = 4; the reference losses,
    norms, rate and launches; every parameter, its init and each gate and expert
    leaf's first moment to ``baseline.pt``."""
    import torch

    metrics = os.path.join(tmp, "baseline.jsonl")
    spec = dict(argv=stage1_argv(tmp, metrics, STEPS), out=os.path.join(tmp, "base"),
                keep_init=True)
    spec_path = os.path.join(tmp, "spec_baseline.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    cs.drop_page_cache(train_dir(tmp, RES[0]))
    t0 = time.perf_counter()
    trainer, probe = rank_fit(spec_path)
    rec = probe.rec
    losses, norms = metrics_of(metrics, STEPS, "[dist4 baseline]")
    want = {k: v * rec["microbatches"] for k, v in cs.launch_dict(**STAGE1_LAUNCHES).items()}
    expect(rec["launches"] == [want] * STEPS,
           f"[dist4 baseline] launches {rec['launches']} (want {want})")
    path = os.path.join(tmp, "baseline.pt")
    state = trainer.state
    torch.save({"params": {k: p.detach().cpu() for k, p in state.params.items()},
                "init": probe.init,
                "moe_mu": {k: state.opt_state.mu[k].cpu()
                           for k in cs.moe_leaf_names(trainer.model.dit)}}, path)
    ips = rate(rec)
    log(f"[dist4 baseline] XL stage 1 on one card, batch {GLOBAL_BATCH} in "
        f"{rec['microbatches']} microbatches: losses {losses}, grad norms {norms}; steps "
        f"2-{STEPS} {ips:.2f} img/s; launches per step {short(rec['launches'][0])}; data wait "
        f"ms/step {rec['wait_ms']} (native gather, {rec['gather_calls']} calls); peak "
        f"{rec.get('peak_bytes', 0) / 2**30:.2f} GiB; wrote {os.path.getsize(path) / 1e9:.2f} GB "
        f"of parameters, their init and first moments; {time.perf_counter() - t0:.1f} s")
    del trainer, state, probe
    cs.free_memory()
    return dict(losses=losses, norms=norms, ips=ips, path=path, launches=rec["launches"][0],
                peak=rec.get("peak_bytes"), waits=rec["wait_ms"])


def run_mesh(tmp, base, mesh, *extra, name=None, memmap=False):
    """Stage 1 on the ranks at ``mesh`` from a cold page cache: held against the
    baseline after step 4, the launches of every rank, the rate of steps 2-4, the
    profiled step, the peaks and waits. ``memmap``: the loader slices every batch
    from the memory maps instead of the native gather."""
    name = name or "mesh_" + "".join(map(str, mesh))
    label = f"[dist4 {tuple(mesh)}{' memmap' if memmap else ''}]"
    metrics = os.path.join(tmp, f"{name}.jsonl")
    cs.drop_page_cache(train_dir(tmp, RES[0]))
    recs, wall = rank_launch(tmp, label, name,
                             stage1_argv(tmp, metrics, PROFILE_STEP, *mesh_argv(mesh), *extra),
                             compare=dict(step=STEPS, baseline=base["path"]),
                             profile_step=PROFILE_STEP, memmap=memmap)
    check_ranks(label, recs, mesh, cs.launch_dict(**STAGE1_LAUNCHES), PROFILE_STEP)
    path = "memmap" if memmap else "native gather"
    for r in recs:
        expect((r["gather_calls"] == 0) == memmap,
               f"{label} rank {r['rank']}: {r['gather_calls']} native gather calls on the "
               f"{path} path")
    losses, norms = metrics_of(metrics, PROFILE_STEP, label)
    r0 = recs[0]
    out = dict(mesh=list(mesh), wall=wall, losses=losses, norms=norms,
               microbatches=r0["microbatches"],
               peaks_gib=[r.get("peak_bytes", 0) / 2**30 for r in recs],
               waits_ms=[r["wait_ms"] for r in recs],
               launches=[short(r["launches"][0]) for r in recs],
               recs=recs)
    rel = [abs(x - y) / abs(y) for x, y in zip(losses[:STEPS] + norms[:STEPS],
                                               base["losses"] + base["norms"])]
    c = r0["compare"]
    out.update(rel_loss_norm=max(rel), compare=c, ips=rate(r0))
    out["efficiency"] = out["ips"] / (NPROC * base["ips"])
    tol, utol = PARAM_TOL[tuple(mesh)], UPDATE_TOL[tuple(mesh)]
    faults = "; ".join(f"{f['leaf']}, {f['part']}: {f['rel']:.3f}" for f in c["faults"].values())
    log(f"{label} {NPROC} ranks, {r0['backend']}, batch {GLOBAL_BATCH} "
        f"({r0['microbatches']} microbatch(es) a rank): losses {losses}, grad norms {norms}; "
        f"against the baseline after step {STEPS}: losses and norms largest relative "
        f"difference {max(rel):.3e} (tol {DIST_TOL}), all parameters relative L2 "
        f"{c['rel_params']:.3e} (tol {tol}; {c['differ']} of {c['tensors']} tensors differ, "
        f"the worst alone {c['worst_leaf_rel']:.3e} in {c['worst_leaf']}); the change since "
        f"the init against the baseline's {c['rel_update']:.3e} over the model, the worst "
        f"leaf {c['worst_update_rel']:.3e} in {c['worst_update']} (tol {utol} a leaf; "
        f"{c['still']} leaves unchanged in the baseline); planted faults would read "
        f"{faults}; gate and expert first moments worst {c['worst_moe_rel']:.3e} in "
        f"{c['worst_moe']} ({c['moe_leaves']} leaves, {c['moe_zero']} of them zero in the "
        f"baseline; tol {MOE_MU_TOL})")
    expect(max(rel) <= DIST_TOL and c["rel_params"] <= tol and c["worst_update_rel"] <= utol
           and c["worst_moe_rel"] <= MOE_MU_TOL,
           f"{label} against the baseline: losses/norms {max(rel)}, params {c['rel_params']}, "
           f"worst leaf's change {c['worst_update_rel']}, first moments {c['worst_moe_rel']}")
    expect(len(c["faults"]) == 2, f"{label} no dense or no expert leaf moved: {faults}")
    expect(all(f["rel"] > 5 * utol for f in c["faults"].values()),
           f"{label} a planted fault would read within 5x of the bound {utol}: {faults}")
    log(f"{label} steps 2-{STEPS}: {out['ips']:.2f} img/s global against {NPROC} x "
        f"{base['ips']:.2f} (the baseline): scaling efficiency {out['efficiency']:.3f}")
    prof = r0.get("profile")
    if prof is not None:
        out["profile"] = prof
        if "busy_ms" in prof:
            log(f"{label} rank 0, step {prof['step']} under torch.profiler: wall "
                f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms (idle share "
                f"{prof['idle_share']:.3f}); NCCL kernels {prof['nccl_ms']:.1f} ms = "
                f"{prof['nccl_share']:.3f} of the busy time ({prof['nccl_kernels']} of "
                f"{prof['kernels']} kernels; {prof['overlap_ms']:.1f} ms overlapped with "
                f"compute kernels); the busy time is "
                f"{prof['busy_ms'] * out['ips'] / 1e3 / GLOBAL_BATCH:.3f} of an unprofiled step "
                f"({1e3 * GLOBAL_BATCH / out['ips']:.1f} ms, steps 2-{STEPS})")
        else:
            log(f"{label} rank 0, step {prof['step']}: no device kernels traced (not measured)")
    log(f"{label} launches per step, rank by rank {out['launches']}; peaks GiB "
        f"{[round(p, 2) for p in out['peaks_gib']]}; data wait ms/step ({path}, from a cold "
        f"page cache) {[[round(w, 2) for w in ws] for ws in out['waits_ms']]}; {wall:.1f} s")
    return out


def compare_files(a, b):
    """Two checkpoint files, tensor for tensor: {group: equal tensors}, and the
    step, count and loader of each."""
    import torch

    x = torch.load(a, map_location="cpu", weights_only=True, mmap=True)
    y = torch.load(b, map_location="cpu", weights_only=True, mmap=True)
    groups = {"params": (x["params"], y["params"]),
              "mu": (x["opt_state"]["mu"], y["opt_state"]["mu"]),
              "nu": (x["opt_state"]["nu"], y["opt_state"]["nu"]),
              "ema": (x.get("ema_params") or {}, y.get("ema_params") or {})}
    equal = {g: sum(bool(k in v and torch.equal(u[k], v[k])) for k in u)
             for g, (u, v) in groups.items()}
    return equal, len(x["params"]), dict(
        steps=(x["step"], y["step"]), counts=(x["opt_state"]["count"], y["opt_state"]["count"]),
        loaders=(x["loader"], y["loader"]), ema=(len(groups["ema"][0]), len(groups["ema"][1])))


def run_checkpoints(tmp, base, mesh):
    """The last mesh with the EMA: saves at 3 and 5, an autoresume from 3 on the
    ranks, bitwise; the step-3 file loaded strictly by one process."""
    import torch
    from micro_diffusion_tpu_torch.train import cli
    from micro_diffusion_tpu_torch.train.config import load_config
    from micro_diffusion_tpu_torch.train.trainer import CKPT_FILE, Trainer

    ckpt, straight = os.path.join(tmp, "ckpt1"), os.path.join(tmp, "ckpt1_straight")
    extra = [f"trainer.save_folder={ckpt}", f"trainer.save_interval={SAVE_AT}ba",
             "trainer.save_num_checkpoints_to_keep=2", f"algorithms.ema.smoothing={EMA}",
             "algorithms.ema.ema_start=1ba"]
    res = run_mesh(tmp, base, mesh, *extra, name="straight")
    os.remove(base["path"])  # the baseline has served every mesh
    file_a = os.path.join(ckpt, str(SAVE_AT), CKPT_FILE)
    file_bytes = os.path.getsize(file_a)
    os.makedirs(straight)
    os.rename(os.path.join(ckpt, str(PROFILE_STEP)), os.path.join(straight, str(PROFILE_STEP)))
    file_b = os.path.join(straight, str(PROFILE_STEP), CKPT_FILE)

    label = f"[dist4 resume {mesh}]"
    metrics = os.path.join(tmp, "resume.jsonl")
    recs, wall = rank_launch(tmp, label, "resume",
                             stage1_argv(tmp, metrics, PROFILE_STEP, *mesh_argv(mesh), *extra,
                                         "trainer.autoresume=true"))
    check_ranks(label, recs, mesh, cs.launch_dict(**STAGE1_LAUNCHES), PROFILE_STEP - SAVE_AT)
    metrics_of(metrics, PROFILE_STEP - SAVE_AT, label)
    t0 = time.perf_counter()
    file_c = os.path.join(ckpt, str(PROFILE_STEP), CKPT_FILE)
    equal, n, meta = compare_files(file_b, file_c)
    log(f"{label} autoresume from step {SAVE_AT} on {NPROC} ranks to {PROFILE_STEP}: its "
        f"file against the straight run's, bitwise equal tensors {equal} of {n} each; "
        f"{meta}; compared in {time.perf_counter() - t0:.1f} s; ranks' load seconds "
        f"{[round(r['load_s'][0], 2) for r in recs]}")
    expect(all(v == n for v in equal.values()) and meta["ema"] == (n, n)
           and meta["steps"] == (PROFILE_STEP, PROFILE_STEP)
           and meta["counts"][0] == meta["counts"][1]
           and meta["loaders"][0] == meta["loaders"][1],
           f"{label} not bitwise: {equal} of {n}, {meta}")
    shutil.rmtree(os.path.join(ckpt, str(PROFILE_STEP)))

    # the step-3 file, written by the ranks, in one process without a group
    cfg = load_config(overlay(), "res_256_pretrain",
                      stage1_argv(tmp, os.path.join(tmp, "one.jsonl"), PROFILE_STEP,
                                  *extra, "trainer.autoresume=true")[4:])
    load = Timed(Trainer, "_resume")
    try:
        one = cli.build_from_config(cfg)
    finally:
        load.restore()
    saved = torch.load(file_a, map_location="cpu", weights_only=True, mmap=True)
    same = sum(bool(torch.equal(one.state.params[k].cpu(), v)) for k, v in saved["params"].items())
    per_epoch = SAMPLES_256 // GLOBAL_BATCH
    want_loader = {"epoch": (SAVE_AT - 1) // per_epoch,
                   "step_in_epoch": (SAVE_AT - 1) % per_epoch + 1}
    got = dict(step=one.global_step, loader=one.train_loader.state_dict(), params_equal=same,
               keys_equal=set(one.state.params) == set(saved["params"]))
    log(f"[dist4 one process] the step-{SAVE_AT} file of {NPROC} ranks loaded strictly by "
        f"one process without a group in {load.seconds()[0]:.1f} s: {got} (loader want "
        f"{want_loader}, {len(saved['params'])} tensors)")
    expect(got["step"] == SAVE_AT and got["loader"] == want_loader == saved["loader"]
           and same == len(saved["params"]) and got["keys_equal"],
           f"[dist4 one process] load of the step-{SAVE_AT} file: {got}")
    del one, saved
    cs.free_memory()
    shutil.rmtree(ckpt)
    r0 = res["recs"][0]
    waits = [[b - a for a, b in r["barrier"] if any(s0 <= a <= s1 for s0, s1 in r["save"])]
             for r in res["recs"][1:]]  # the barriers inside the saves
    res.update(file_bytes=file_bytes, resume_wall=wall, resume_load_s=[r["load_s"] for r in recs],
               one_load_s=load.seconds()[0], straight=os.path.dirname(file_b),
               barrier_wait_s=waits, save_s=[b - a for a, b in r0["save"]])
    log(f"[dist4 checkpoints] file {file_bytes} bytes ({file_bytes / 1e9:.2f} GB); rank 0's "
        f"saves {[round(s, 1) for s in res['save_s']]} s (steps {SAVE_AT}, {PROFILE_STEP}); ranks "
        f"1-{NPROC - 1} wait at the save's barrier "
        f"{[[round(w, 1) for w in ws] for ws in waits]} s; the 4-rank load "
        f"{[round(s[0], 2) for s in res['resume_load_s']]} s, the one-process "
        f"load {res['one_load_s']:.1f} s")
    return res


def run_handoff(tmp, stage1_dir, mesh):
    """XL stage 2 as the user's command on the ranks at ``mesh``, loading stage 1
    weights-only; stage 3 on them loading stage 2's file weights-only across the
    pos_embed change, checked as [chain] checks Tiny's; stage 3's step 1 in one
    process."""
    from micro_diffusion_tpu_torch.train import cli
    from micro_diffusion_tpu_torch.train.trainer import CKPT_FILE

    ckpt2 = os.path.join(tmp, "ckpt2")
    m2 = os.path.join(tmp, "stage2.jsonl")
    argv2 = recipe_argv("res_256_finetune", train_dir(tmp, RES[0]), m2,
                        f"trainer.max_duration={STAGE_STEPS}ba", f"trainer.save_folder={ckpt2}",
                        f"trainer.load_path={stage1_dir}", "trainer.load_weights_only=true",
                        *mesh_argv(mesh))
    wall2 = torchrun(["-m", "micro_diffusion_tpu_torch.train", "--multihost",
                      "--dist-timeout", str(GROUP_TIMEOUT_S), *argv2], "[dist4 stage 2]")
    shutil.rmtree(stage1_dir)
    losses2, _ = metrics_of(m2, STAGE_STEPS, "[dist4 stage 2]")
    file_d = os.path.join(ckpt2, str(STAGE_STEPS), CKPT_FILE)
    if not os.path.exists(file_d):
        raise AssertionError(f"[dist4 stage 2] no checkpoint at {file_d}")
    log(f"[dist4 stage 2] XL stage 2 (res_256_finetune) as `torchrun -m "
        f"micro_diffusion_tpu_torch.train --multihost` on {NPROC} ranks at {mesh}: stage 1's "
        f"weights, {STAGE_STEPS} steps, losses {losses2}, saved {os.path.getsize(file_d)} bytes; "
        f"{wall2:.1f} s")

    m3 = os.path.join(tmp, "stage3.jsonl")
    argv3 = recipe_argv("res_512_pretrain", train_dir(tmp, RES[1]), m3,
                        f"trainer.max_duration={STAGE_STEPS}ba", f"trainer.load_path={ckpt2}",
                        "trainer.load_weights_only=true")
    label = "[dist4 stage 3]"
    recs, wall3 = rank_launch(tmp, label, "stage3", [*argv3, *mesh_argv(mesh)],
                              check_loaded=file_d)
    check_ranks(label, recs, mesh)
    losses3, norms3 = metrics_of(m3, STAGE_STEPS, label)
    loaded = [r["loaded"] for r in recs]
    for ld in loaded:
        expect(ld["keys_equal"] and ld["equal"] == ld["saved"] and ld["step"] == 0
               and ld["pos_embed"] == [1, (RES[1] // 16) ** 2, ld["dim"]],
               f"{label} weights-only load across the pos_embed change: {ld}")
    per_step = [{k: sum(r["launches"][s][k] for r in recs) for k in recs[0]["launches"][s]}
                for s in range(STAGE_STEPS)]
    want = cs.launch_dict(**STAGE3_LAUNCHES)
    expect(per_step == [want] * STAGE_STEPS,
           f"{label} launches summed over the ranks {per_step} (want {want} a step)")

    # the same file, stage 3's first step in one process without a group
    m1 = os.path.join(tmp, "stage3_one.jsonl")
    t0 = time.perf_counter()
    one = cli.main(recipe_argv("res_512_pretrain", train_dir(tmp, RES[1]), m1,
                               "trainer.max_duration=1ba", f"trainer.load_path={ckpt2}",
                               "trainer.load_weights_only=true"))
    del one
    cs.free_memory()
    loss1, _ = metrics_of(m1, 1, "[dist4 stage 3 one process]")
    rel = abs(losses3[0] - loss1[0]) / abs(loss1[0])
    shutil.rmtree(ckpt2)
    log(f"{label} XL stage 3 (res_512_pretrain) on {NPROC} ranks at {mesh}, stage 2's "
        f"weights loaded weights-only: {loaded[0]['equal']} of {loaded[0]['saved']} tensors equal "
        f"the saved ones on every rank, pos_embed {loaded[0]['pos_embed']}; losses {losses3}, "
        f"grad norms {norms3}; launches per step summed over the ranks {short(per_step[0])} "
        f"(rank 0 {short(recs[0]['launches'][0])}); step-1 loss {losses3[0]:.6f} against one "
        f"process {loss1[0]:.6f} (relative {rel:.3e}, tol {DIST_TOL}); peaks GiB "
        f"{[round(r.get('peak_bytes', 0) / 2**30, 2) for r in recs]}; {wall3:.1f} s + one "
        f"process {time.perf_counter() - t0:.1f} s")
    expect(rel <= DIST_TOL, f"{label} step-1 loss {losses3[0]} vs one process {loss1[0]}")
    return dict(stage2_losses=losses2, stage2_wall=wall2, stage3_losses=losses3,
                stage3_rel=rel, stage3_launches=per_step[0], stage3_wall=wall3,
                loaded=loaded[0])


def run_four(tmp):
    """The four-card phases (the module docstring); a summary dict."""
    from micro_diffusion_tpu_torch.datasets import native
    from micro_diffusion_tpu_torch.ops import _build

    times = {}
    t_all = t0 = time.perf_counter()
    _build.build_all()
    native.available()
    log(f"[dist4] kernels and the native MDS gather built once ({native.library_path()}) in "
        f"{time.perf_counter() - t0:.1f} s")
    need = 3 * XL_FILE_BYTES + BASELINE_BYTES + 1e9
    free_b = shutil.disk_usage(tmp).free
    log(f"[dist4] {free_b / 1e9:.1f} GB free under {tmp}; at most {need / 1e9:.1f} GB "
        f"held at once (three XL checkpoints, the baseline's parameters, their init and first "
        f"moments, the data); {(4 * XL_FILE_BYTES + BASELINE_BYTES + 1e9) / 1e9:.1f} GB "
        f"written in all")
    if free_b < need:
        raise AssertionError(f"[dist4] {free_b / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed")
    t0 = time.perf_counter()
    cs.write_latents(train_dir(tmp, RES[0]), SAMPLES_256, cs.SEED, res=RES[0])
    cs.write_latents(train_dir(tmp, RES[1]), SAMPLES_512, cs.SEED + 2, res=RES[1])
    times["data"] = time.perf_counter() - t0
    log(f"[dist4] wrote {SAMPLES_256} {RES[0]}px + {SAMPLES_512} {RES[1]}px synthetic MDS "
        f"samples in {times['data']:.1f} s")

    def phase(label, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        times[label] = time.perf_counter() - t
        log(f"[phase] dist4 {label} {times[label]:.1f} s")
        return out

    reads = phase("reads", run_reads, tmp)
    base = phase("baseline", run_baseline, tmp)
    meshes = {}
    for mesh in MESHES[:-1]:
        meshes[str(mesh)] = phase(f"mesh {mesh}", run_mesh, tmp, base, mesh)
    memmap = phase(f"mesh {MEMMAP_MESH} memmap", run_mesh, tmp, base, MEMMAP_MESH,
                   name="memmap", memmap=True)
    ck = phase(f"mesh {MESHES[-1]} + checkpoints", run_checkpoints, tmp, base, MESHES[-1])
    meshes[str(MESHES[-1])] = ck
    ho = phase("stage 2 -> 3", run_handoff, tmp, ck["straight"], MESHES[-1])

    def brief(v):
        return ({f: v.get(f) for f in ("ips", "efficiency", "rel_loss_norm", "peaks_gib",
                                       "waits_ms", "launches", "microbatches")}
                | {f: v["compare"][f] for f in ("rel_params", "rel_update", "worst_update_rel",
                                                "worst_moe_rel", "faults")}
                | {"profile": v.get("profile")})

    summary = dict(
        reads=reads,
        baseline=dict(ips=base["ips"], losses=base["losses"], norms=base["norms"],
                      peak_gib=(base["peak"] or 0) / 2**30, waits_ms=base["waits"]),
        meshes={k: brief(v) for k, v in meshes.items()}, memmap=brief(memmap),
        checkpoints={f: ck[f] for f in ("file_bytes", "save_s", "barrier_wait_s",
                                        "resume_load_s", "one_load_s")},
        handoff=ho, phases=times, total_s=time.perf_counter() - t_all, failed=FAILED)
    log(f"[dist4] {json.dumps(summary)}")
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--nproc", type=int, default=1, choices=(1, NPROC),
                        help="1: the [dist] phase on one card; 4: the four-card run")
    parser.add_argument("--rank-fit", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_fit:
        rank_fit(args.rank_fit)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_dist: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.nproc:
        print(f"chip_dist: {torch.cuda.device_count()} CUDA device(s), {args.nproc} needed",
              file=sys.stderr)
        return 1
    for line in smi_lines():
        cs.log(f"[device] {line}")
    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else nccl
    cs.log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} nccl {nccl}; "
           f"{torch.cuda.device_count()} x "
           f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.nproc == NPROC:
        with tempfile.TemporaryDirectory(prefix="chip_dist4_") as tmp:
            run_four(tmp)
        for line in smi_lines():
            cs.log(f"[device] {line}")
        if FAILED:
            print(f"chip_dist: {len(FAILED)} check(s) failed: {FAILED}", file=sys.stderr)
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    from micro_diffusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_dist_") as tmp:
        t0 = time.perf_counter()
        tn = cs.run_trainer(tmp)
        cs.log(f"[phase] trainer {time.perf_counter() - t0:.1f} s")
        cs.free_memory()
        t0 = time.perf_counter()
        cs.run_dist(tmp, tn)
        cs.log(f"[phase] dist {time.perf_counter() - t0:.1f} s")
    cs.log(f"[device] {cs.smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
