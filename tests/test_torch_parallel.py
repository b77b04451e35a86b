"""The port's parallel layer on the CPU: the sharding rules against the JAX
package's, ZeRO-2 and expert parallelism on 4 gloo ranks against the port's
one-process step and JAX's sharded step, the trainer's ``--multihost`` entry point
with a checkpoint written on 2 ranks and resumed on 1 and on 2, and the dry run.

The multi-process runs all start at once in one module fixture (``runs``), while
JAX's sharded steps compile. Every spawned process has a subprocess timeout and a
process-group timeout of 120 s (parallel/dryrun.py ``wait``,
tests/torch_parallel_worker.py, the CLI's ``--dist-timeout``).
"""

import concurrent.futures
import os
import shutil
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from micro_diffusion_tpu.models import diffusion as jdiffusion
from micro_diffusion_tpu.models import dit as jdit
from micro_diffusion_tpu.ops import masking as jmasking
from micro_diffusion_tpu.parallel import mesh as jmesh
from micro_diffusion_tpu.parallel import sharding as jsharding
from micro_diffusion_tpu.train import optim as joptim
from micro_diffusion_tpu.train import train_step as jtrain
from micro_diffusion_tpu_torch.datasets import MDSWriter
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.parallel import dryrun as tdryrun
from micro_diffusion_tpu_torch.parallel import sharding as tsharding

import torch_parallel_worker as worker
from test_torch_dit import MICRO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
OVERLAYS = os.path.join(ROOT, "micro_diffusion_tpu_torch", "configs", "h100_1gpu")
ENV = {"PYTHONPATH": ROOT}
RTOL, ATOL = 1e-5, 1e-6          # sharded port vs one-process port, fp32
JAX_LOSS_TOL, JAX_NORM_TOL = 1e-4, 1e-3  # vs JAX's sharded step (__graft_entry__.py)
ROWS_PER_RANK, STEPS = 8, 2      # K = 2 microbatches of 4 on every rank
MESHES = [(2, 2, 1), (1, 2, 2)]  # (data, fsdp, tensor) on 4 ranks
# XLA's CPU backend at optimisation level 0 for JAX's sharded step: the same
# program, compiled in about 0.6x the time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The one-process steps are tiny: intra-op threads buy nothing, and in a
    parallel test run they oversubscribe the cores the ranks need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sharding_rules_match_jax():
    """Every leaf of the Micro param tree and of its AdamW state, on a (2, 2, 2)
    mesh over the 8 fake CPU devices: the port's spec is JAX's; and the port's own
    parameters split over tensor are the JAX leaves that are."""
    model = jdit.DiT(dtype=jnp.float32, **MICRO)
    x, t, y = (jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)), jnp.zeros((1, 1, 8, 32)))
    params = jax.eval_shape(lambda r: model.init({"params": r, "mask": r}, x, t, y),
                            jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh(data=2, fsdp=2, tensor=2)
    sizes = {"data": 2, "fsdp": 2, "tensor": 2}
    split = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = jsharding._path_str(path)
        want = tuple(jsharding.param_spec(name, leaf, mesh))
        assert tsharding.param_spec(name, leaf.shape, sizes) == want, name
        split += bool(want)
    assert split == 4  # w1 and w2 of the mixer's and the backbone's MoE block
    tx = joptim.build_optimizer(params, joptim.constant_schedule(1e-3), clip_norm=0.25)
    for leaf in jax.tree_util.tree_leaves(jax.eval_shape(tx.init, params)):
        assert tsharding.opt_state_spec(leaf.shape, sizes) == \
            tuple(jsharding.opt_state_spec(leaf, mesh)), leaf.shape
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, float(bool(jsharding.param_spec(
            jsharding._path_str(path), leaf, mesh))), np.float32), params)
    for name, mark in tinterop.params_to_torch_state_dict(marked).items():
        spec = tsharding.param_spec(name, mark.shape, sizes)
        assert spec == (("tensor", None, None) if mark.all() else ()), name


# ------------------------------------------------------------ 4 gloo ranks


def jax_model():
    return jdiffusion.LatentDiffusion(dit=jdit.DiT(dtype=jnp.float32, **worker.PAR),
                                      latent_res=worker.LATENT, train_mask_ratio=0.75,
                                      latent_scale=1.0)


class _MaskKey(nn.Module):
    """The key a root module's ``make_rng("mask")`` gives: the JAX DiT draws its
    token mask from it (dit.py:540-542), so its mask needs no DiT forward."""

    @nn.compact
    def __call__(self):
        return self.make_rng("mask")


def jax_draws(step, rows):
    """The draws JAX's step ``step`` makes for ``rows`` rows (one microbatch, key
    fold_in(fold_in(base, step), 0), edm_loss's split into sigma / noise / mask
    keys; the mask the DiT's own for its key): rnd_normal, noise, keep."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), step), 0)
    k_sigma, k_noise, k_mask = jax.random.split(key, 3)
    key = _MaskKey().apply({}, rngs={"mask": k_mask})
    mask = jmasking.make_token_mask(key, rows, (worker.LATENT // worker.PAR["patch_size"]) ** 2,
                                    0.75).mask
    return {"rnd_normal": jax.random.normal(k_sigma, (rows, 1, 1, 1)),
            "noise": jax.random.normal(k_noise, (rows, 4, worker.LATENT, worker.LATENT)),
            "keep": mask == 0}


def make_inputs(rows):
    """The weights, a batch per step, and the draws JAX's step makes for each row
    (``jax_draws``, compiled once)."""
    w = worker.weights()
    params = {"params": tinterop.torch_state_dict_to_params({k: v.numpy() for k, v in w.items()})}
    draw = jax.jit(jax_draws, static_argnums=1).lower(0, rows).compile(FAST_COMPILE)
    rng = np.random.default_rng(40)
    batches, draws = [], []
    for s in range(STEPS):
        drop = np.ones((rows,), np.float32)
        drop[-1] = 0.0
        b = {"image_latents": rng.standard_normal((rows, 4, worker.LATENT, worker.LATENT),
                                                  np.float32),
             "caption_latents": rng.standard_normal((rows, 1, *worker.CAPTION), np.float32),
             "drop_caption_mask": drop}
        batches.append({k: torch.from_numpy(v) for k, v in b.items()})
        draws.append({k: torch.from_numpy(np.array(v)) for k, v in draw(s).items()})
    return {"weights": w, "batches": batches, "draws": draws}, params


def jax_sharded_steps(inputs: dict) -> dict:
    """JAX's step on each mesh of ``inputs`` ({shape: (inputs, params)}), built as
    tests/test_train.py builds it (one microbatch: the draws are per row, so JAX's
    microbatching is free); one step function for every mesh, so that its trace
    is reused."""
    _, params = next(iter(inputs.values()))
    model = jax_model()
    sched = joptim.constant_schedule(worker.LR)
    tx = joptim.build_optimizer(params, sched, clip_norm=worker.CLIP)
    train_step = jtrain.make_train_step(model, tx, sched, ema_smoothing=worker.EMA, ema_start=0)

    def create(params):
        return jtrain.create_train_state(params, tx, use_ema=True)

    results = {}
    for (data, fsdp, tensor), (shape_inputs, params) in inputs.items():
        mesh = jmesh.make_mesh(data=data, fsdp=fsdp, tensor=tensor,
                               devices=jax.devices()[:data * fsdp * tensor])
        p_sh = jsharding.param_shardings(params, mesh)
        o_sh = jsharding.opt_state_shardings(jax.eval_shape(create, params).opt_state, mesh)
        state_sh = jtrain.TrainState(step=NamedSharding(mesh, P()), params=p_sh,
                                     opt_state=o_sh, ema_params=p_sh)
        state = jax.jit(create, out_shardings=state_sh).lower(params).compile(FAST_COMPILE)(
            params)
        b_sh = jmesh.batch_sharding(mesh)
        step = jax.jit(train_step, in_shardings=(state_sh, b_sh, None),
                       out_shardings=(state_sh, None))
        out, compiled = {"loss": [], "grad_norm": []}, None
        for batch in shape_inputs["batches"]:
            batch = {k: jax.device_put(v.numpy(), b_sh) for k, v in batch.items()}
            if compiled is None:
                compiled = step.lower(state, batch, jax.random.PRNGKey(7)).compile(FAST_COMPILE)
            state, metrics = compiled(state, batch, jax.random.PRNGKey(7))
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
        results[data, fsdp, tensor] = out
    return results


def sharded_steps(tmp, shape, inputs, port):
    """Every scenario of tests/torch_parallel_worker.py on 4 gloo ranks at ``shape``."""
    name = "x".join(map(str, shape))
    torch.save(inputs, tmp / f"{name}.pt")
    tdryrun.launch(4, [WORKER, str(tmp / f"{name}.pt"), str(tmp / f"{name}.out.pt"),
                       *map(str, shape)], env=ENV, port=port)
    return torch.load(tmp / f"{name}.out.pt", weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run of this file, started at once, as futures that the
    tests read: the dry run's 4 ranks, the CLI round trip, and one 4-rank launch
    per mesh shape running every scenario; JAX's sharded steps are compiled and
    run meanwhile."""
    tmp = tmp_path_factory.mktemp("parallel")
    ports = iter(tdryrun.free_ports(len(MESHES) + 3))
    with concurrent.futures.ThreadPoolExecutor(len(MESHES) + 3) as pool:
        out = {"dryrun": pool.submit(tdryrun.finish, tdryrun.start(4, next(ports))),
               "cli": pool.submit(cli_round_trip, tmp, next(ports), next(ports))}
        inputs = {shape: make_inputs(ROWS_PER_RANK * shape[0] * shape[1]) for shape in MESHES}
        for shape in MESHES:
            out[shape] = pool.submit(sharded_steps, tmp, shape, inputs[shape][0], next(ports))
        out["jax"] = pool.submit(jax_sharded_steps, inputs)
    out["inputs"] = {shape: inp for shape, (inp, _) in inputs.items()}
    return out


@pytest.mark.parametrize("scenario", worker.SCENARIOS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_steps_match_one_process(runs, shape, scenario):
    """Two K = 2 steps on 4 ranks (ZeRO-2 over fsdp, experts over tensor, EMA and
    clipping on) against the same global batches in one process, microbatches of
    the same size: injected draws, and the trainer's generators (each rank skips
    the draws of the rows before its own)."""
    inputs = runs["inputs"][shape]
    got = runs[shape].result()[scenario]
    ref = worker.run(inputs, scenario, ROWS_PER_RANK // 2)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=RTOL, atol=ATOL)
    assert ref["grad_norm"][0] > worker.CLIP  # the clip is live
    for kind in ("params", "mu", "nu", "ema"):
        assert set(got[kind]) == set(ref[kind])
        for name, r in ref[kind].items():
            np.testing.assert_allclose(got[kind][name].numpy(), r.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{shape} {kind} {name}")


@pytest.mark.parametrize("policy", worker.REMAT_POLICIES)
def test_expert_parallel_remat_matches_one_process(runs, policy):
    """Expert parallelism (tensor 2 of mesh (1, 2, 2)) with the blocks under a
    selective remat policy: 'attn_moe' keeps the EC-MoE output, 'dots' the 2-D
    products; the recompute re-issues the sum over tensor on every rank. Two K = 2
    steps with injected draws against the same steps under the same policy in one
    process, to the tolerances of the unrematerialised runs."""
    shape = next(s for s in MESHES if s[2] > 1)
    inputs = runs["inputs"][shape]
    got = runs[shape].result()["remat"][policy]
    ref = worker.run(inputs, "injected", ROWS_PER_RANK // 2, remat_policy=policy)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=RTOL, atol=ATOL)
    for kind in ("params", "mu", "nu", "ema"):
        assert set(got[kind]) == set(ref[kind])
        for name, r in ref[kind].items():
            np.testing.assert_allclose(got[kind][name].numpy(), r.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{policy} {kind} {name}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_steps_match_jax(runs, shape):
    """Loss and grad norm of both steps against JAX's step on the same mesh, with
    JAX's draws injected into the ranks; the multi-node mesh of the same world
    (a node a slice) has the same shape."""
    results, jax_out = runs[shape].result(), runs["jax"].result()[shape]
    assert results["multislice"] == dict(zip(("data", "fsdp", "tensor"), shape))
    got = results["injected"]
    np.testing.assert_allclose(got["loss"], jax_out["loss"], rtol=JAX_LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], jax_out["grad_norm"], rtol=JAX_NORM_TOL)


# ------------------------------------------------------------ the entry point


def write_latents(dirname, n, seed=0):
    rng = np.random.default_rng(seed)
    with MDSWriter(out=str(dirname), columns={"caption_latents": "bytes",
                                              "latents_128": "bytes"}) as w:
        for _ in range(n):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     "latents_128": (0.5 * rng.standard_normal((4, 16, 16)))
                     .astype(np.float16).tobytes()})


def cli_args(ds, save_folder, steps, *extra, multihost=False):
    return ["-m", "micro_diffusion_tpu_torch.train",
            *(["--multihost", "--dist-timeout", "120"] if multihost else []),
            "--config-path", OVERLAYS,
            "--config-name", "res_256_pretrain", "trainer.device=cpu",
            "model.dit_arch=MicroDiT_Micro_2", "model.dtype=float32", "model.latent_res=16",
            "model.fused_adaln=false", "model.remat=false", "dataset.image_size=128",
            f"dataset.train.datadir={ds}", f"dataset.eval.datadir={ds}",
            "dataset.train_batch_size=8", "dataset.eval_batch_size=8",
            "trainer.device_train_microbatch_size=2", f"trainer.max_duration={steps}ba",
            "trainer.eval_interval=0", "trainer.save_interval=2ba",
            "trainer.save_num_checkpoints_to_keep=2", f"trainer.save_folder={save_folder}",
            "algorithms.ema.smoothing=0.9", "algorithms.ema.ema_start=1ba",
            f"callbacks.image_monitor.prompts_file={ROOT}/configs/eval_prompts.yaml",
            "logger.progress._target_=micro_diffusion_tpu_torch.train.callbacks.JSONLLogger",
            f"logger.progress.path={save_folder}.jsonl", *extra]


def read(folder, step):
    return torch.load(os.path.join(folder, str(step), "checkpoint.pt"), weights_only=True)


def cli_round_trip(tmp, port, resume_port):
    """Micro through ``--multihost`` on 2 gloo ranks (fsdp 2), 4 steps with a save
    at 2; then the step-2 checkpoint resumed at once on 2 ranks and in one process
    without a group. Returns the three save folders."""
    ds = tmp / "ds"
    write_latents(ds, 48)
    folders = {name: tmp / name for name in ("straight", "two", "one")}
    tdryrun.launch(2, cli_args(ds, folders["straight"], 4, "misc.mesh_shape.fsdp=2",
                               multihost=True), env=ENV, port=port)
    for name in ("two", "one"):
        shutil.copytree(folders["straight"] / "2", folders[name] / "2")
    two = tdryrun.spawn(2, cli_args(ds, folders["two"], 4, "misc.mesh_shape.fsdp=2",
                                    "trainer.autoresume=true", multihost=True),
                        env=ENV, port=resume_port)
    try:
        one = subprocess.run([sys.executable, *cli_args(ds, folders["one"], 4,
                                                        "trainer.autoresume=true")],
                             env=dict(os.environ, **ENV, OMP_NUM_THREADS="1"),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             timeout=tdryrun.RANK_TIMEOUT_S)
        assert one.returncode == 0, one.stdout[-4000:]
    finally:
        tdryrun.wait(two)
    return folders


def test_cli_multihost_checkpoint_round_trip(runs):
    """The step-2 checkpoint of a 2-rank ``--multihost`` run (``cli_round_trip``),
    resumed on 2 ranks and in one process, equals the straight run at step 4, and
    keeps a one-process checkpoint's keys and shapes."""
    folders = runs["cli"].result()
    straight = folders["straight"]
    ref = read(straight, 4)
    assert ref["step"] == 4 and ref["opt_state"]["count"] == 4
    two, one = read(folders["two"], 4), read(folders["one"], 4)
    for kind in ("params", "ema_params"):
        for k, v in ref[kind].items():
            assert torch.equal(two[kind][k], v), (kind, k)
            np.testing.assert_allclose(one[kind][k].detach(), v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for kind in ("mu", "nu"):
        for k, v in ref["opt_state"][kind].items():
            assert torch.equal(two["opt_state"][kind][k], v), (kind, k)
            np.testing.assert_allclose(one["opt_state"][kind][k].detach(), v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    assert two["loader"] == one["loader"] == ref["loader"]
    # the 2-rank file keeps the one-process format: keys and whole shapes
    two_ranks = read(straight, 2)
    assert two_ranks.keys() == one.keys()
    for kind in ("params", "ema_params"):
        assert {k: v.shape for k, v in two_ranks[kind].items()} == \
            {k: v.shape for k, v in one[kind].items()}
    for kind in ("mu", "nu"):
        assert {k: v.shape for k, v in two_ranks["opt_state"][kind].items()} == \
            {k: v.shape for k, v in one["opt_state"][kind].items()}


def test_dryrun_4_ranks(runs):
    """The dry run of ``python -m micro_diffusion_tpu_torch.parallel.dryrun 4``
    (``start`` and ``finish``) passes: mesh (1, 2, 2), loss and grad norm equal one
    process's."""
    out = runs["dryrun"].result()
    assert out["sharded"]["mesh"] == [1, 2, 2] and out["sharded"]["step"] == 1
