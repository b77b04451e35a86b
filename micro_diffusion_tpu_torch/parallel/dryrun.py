"""One full sharded training step on N gloo ranks on the CPU, held against one
process: the counterpart of ``__graft_entry__.py dryrun_multichip``.

    python -m micro_diffusion_tpu_torch.parallel.dryrun N

starts N processes (``torchrun``'s environment, gloo), lays them out as the JAX
dry run does (``axis_split``: fsdp and tensor 2 where N allows), and runs one step
of its tiny DiT with every structural feature live (patch mixer, width ladders,
EC-MoE blocks whose 4 experts split over ``tensor``, masking, fp32): two
microbatches per rank, AdamW with clipping, the EMA. The same global batch
through the same step in this process, with the per-rank microbatch size, must
give the same loss and grad norm (1e-4 and 1e-3 relative, the JAX dry run's
bounds). Exits non-zero when a rank fails or the numbers disagree.
"""

import argparse
import json
import os
import runpy
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import traceback

import numpy as np
import torch

MODULE = "micro_diffusion_tpu_torch.parallel.dryrun"
SEED = 0
LOSS_TOL, NORM_TOL = 1e-4, 1e-3
RANK_TIMEOUT_S = 120


def axis_split(n: int):
    """(data, fsdp, tensor) with fsdp and tensor as large as 2 allows."""
    for fsdp in (2, 1):
        for tensor in (2, 1):
            if n % (fsdp * tensor) == 0:
                return n // (fsdp * tensor), fsdp, tensor
    return n, 1, 1


def build_model():
    from ..models.diffusion import LatentDiffusion
    from ..models.dit import DiT

    dit = DiT(input_size=16, patch_size=2, in_channels=4, dim=64, depth=4, head_dim=16,
              multiple_of=32, caption_channels=32, qkv_multipliers=(0.5, 1.0),
              ffn_multipliers=(0.5, 4.0), use_patch_mixer=True, patch_mixer_depth=2,
              patch_mixer_dim=48, use_bias=False, num_experts=4, expert_capacity=2.0,
              dtype=torch.float32, device="cpu")
    dit.init_weights(torch.Generator().manual_seed(SEED))
    return LatentDiffusion(dit, latent_res=16, train_mask_ratio=0.75, latent_scale=1.0)


def global_batch(rows: int) -> dict:
    rng = np.random.default_rng(SEED + 1)
    return {"image_latents": torch.from_numpy(rng.standard_normal((rows, 4, 16, 16), np.float32)),
            "caption_latents": torch.from_numpy(rng.standard_normal((rows, 1, 8, 32), np.float32)),
            "drop_caption_mask": torch.ones(rows)}


def one_step(model, batch: dict, microbatch: int, mesh=None) -> dict:
    """One step of ``batch`` (this rank's rows) in microbatches of ``microbatch``."""
    from ..train.optim import build_optimizer, cosine_with_warmup
    from ..train.train_step import create_train_state, make_train_step
    from .sharding import Zero2, shard_params

    zero = None
    if mesh is not None:
        shard_params(model.dit, mesh)
        zero = Zero2(model.dit, mesh)
    sched = cosine_with_warmup(2.4e-4, 10, 1000, 0.33)
    tx = build_optimizer(dict(model.dit.named_parameters()), sched, clip_norm=0.25)
    state = create_train_state(model.dit, tx, use_ema=True, grad_shardings=zero)
    step = make_train_step(model, tx, sched, microbatch_size=microbatch, ema_smoothing=0.99,
                           ema_start=0, grad_shardings=zero)
    state, metrics = step(state, batch, torch.Generator().manual_seed(SEED))
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "step": state.step}


def _rank_main(world: int, rows: int, out: str) -> None:
    from .mesh import batch_sharding, init_distributed, make_mesh

    init_distributed("cpu", timeout=RANK_TIMEOUT_S)
    data, fsdp, tensor = axis_split(world)
    mesh = make_mesh(data=data, fsdp=fsdp, tensor=tensor)
    shard = batch_sharding(mesh)
    mine = {k: v[shard.rows(rows)] for k, v in global_batch(rows).items()}
    res = one_step(build_model(), mine, rows // shard.count // 2, mesh)
    if mesh.rank == 0:
        with open(out, "w") as f:
            json.dump(dict(res, mesh=[data, fsdp, tensor]), f)
    torch.distributed.destroy_process_group()


def free_ports(n: int = 1) -> list:
    """``n`` distinct ports free on this host now (all bound at once, then released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn(world: int, args, env=None, port=None) -> subprocess.Popen:
    """Start ``python <args>`` (a script or ``-m module`` and its arguments) as
    ``world`` ranks with torchrun's environment on this host (rank 0 serves the
    group's store on ``port``, a free one by default). One launcher process imports
    torch once and forks the ranks from it, so a rank's start costs no import; the
    launcher and its ranks form one process group. ``wait`` collects them."""
    port = port or free_ports()[0]
    launcher_env = dict(os.environ, **(env or {}), WORLD_SIZE=str(world),
                        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                        MASTER_PORT=str(port), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", MODULE, "--fork", str(world), "--", *args],
                            env=launcher_env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def wait(launcher: subprocess.Popen, timeout: float = RANK_TIMEOUT_S) -> None:
    """Wait for the ranks of ``spawn``; raises when one fails or they outlive
    ``timeout``, and leaves none running."""
    try:
        out, _ = launcher.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(launcher.pid, signal.SIGKILL)
        out, _ = launcher.communicate()
        raise RuntimeError(f"the ranks outlived {timeout} s:\n{out[-4000:]}") from None
    finally:
        try:
            os.killpg(launcher.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    if launcher.returncode != 0:
        raise RuntimeError(f"the ranks failed ({launcher.returncode}):\n{out[-4000:]}")


def launch(world: int, args, timeout: float = RANK_TIMEOUT_S, env=None, port=None) -> None:
    """``spawn`` then ``wait``."""
    wait(spawn(world, args, env, port), timeout)


def _run_rank(rank: int, args: list) -> int:
    """In a forked child: ``python <args>`` as rank ``rank``; its exit code."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        if args[0] == "-m":
            sys.argv = [args[1], *args[2:]]
            runpy.run_module(args[1], run_name="__main__", alter_sys=True)
        else:
            sys.argv = list(args)
            runpy.run_path(args[0], run_name="__main__")
        return 0
    except SystemExit as exit_:
        code = exit_.code
        return code if isinstance(code, int) else int(code is not None)
    except BaseException:  # noqa: BLE001 - the rank's failure, reported by its exit code
        traceback.print_exc()
        return 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()


def _fork_ranks(world: int, args: list) -> int:
    """The launcher of ``spawn``: fork ``world`` ranks and wait for them. When one
    fails the others are killed (they would wait in a collective); exits 1."""
    import torch  # noqa: F401 - imported once, here, for every rank

    ranks = {}
    for rank in range(world):
        pid = os.fork()
        if pid == 0:
            os._exit(_run_rank(rank, args))
        ranks[pid] = rank
    code = 0
    while ranks:
        pid, status = os.wait()
        rc = os.waitstatus_to_exitcode(status)
        if rc != 0:
            print(f"rank {ranks[pid]} exited {rc}", flush=True)
            code = 1
            for other in ranks:
                if other != pid:
                    os.kill(other, signal.SIGKILL)
        del ranks[pid]
    return code


def start(world: int, port=None) -> tuple:
    """Start the dry run's ``world`` ranks; ``finish`` checks them."""
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    out = os.path.join(tmp, "rank0.json")
    return world, tmp, spawn(world, ["-m", MODULE, "--rank-main", str(world), "--out", out],
                             port=port)


def finish(started: tuple) -> dict:
    """Wait for the ranks of ``start`` and hold their step against one process's."""
    world, tmp, launcher = started
    try:
        wait(launcher)
        with open(os.path.join(tmp, "rank0.json")) as f:
            got = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = 2 * world
    data, fsdp, tensor = axis_split(world)
    ref = one_step(build_model(), global_batch(rows), rows // (data * fsdp) // 2)
    for key, tol in (("loss", LOSS_TOL), ("grad_norm", NORM_TOL)):
        if not abs(got[key] - ref[key]) <= tol * max(1.0, abs(ref[key])):
            raise AssertionError(f"sharded {key} {got[key]} != one process's {ref[key]}")
    print(f"dryrun OK: mesh ({data},{fsdp},{tensor}) on {world} gloo ranks: loss "
          f"{got['loss']:.6f} grad_norm {got['grad_norm']:.6f} step {got['step']} "
          f"(one process: loss {ref['loss']:.6f} grad_norm {ref['grad_norm']:.6f})")
    return {"sharded": got, "one_process": ref}


def dryrun(world: int) -> dict:
    return finish(start(world))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--fork"]:  # spawn's launcher: --fork WORLD -- ARGS...
        return _fork_ranks(int(argv[1]), argv[3:])
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("world", nargs="?", type=int, default=8)
    parser.add_argument("--rank-main", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_main:
        _rank_main(args.rank_main, 2 * args.rank_main, args.out)
    else:
        dryrun(args.world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
