"""The orbax train-state converter, ``scripts/orbax_to_torch.py``: a JAX ``Trainer``
run carried to the port's trainer.

One module fixture trains MicroDiT-Micro with the JAX ``Trainer`` for 3 steps (a tiny
MDS set from the JAX writer, EMA on, saves at steps 2 and 3) and runs the converter as
a subprocess. The reference is the JAX trainer's own restore of its step-3 checkpoint
(``load_orbax_step``). Against it: the port's ``Trainer`` after ``load_path`` and after
``autoresume`` (params, both moments, EMA, step, count and the loader bitwise), a
weights-only load, the DiT forward on the converted weights, one AdamW update against
optax and the eval load. Then optax states that the trainer's recipes build, saved in
the trainer's layout without the trainer: no EMA, two lr groups, bf16 moments, unequal
counts, and a step directory against a manager directory and ``--step``.

Everything runs on the CPU in fp32 at Micro size.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from micro_diffusion_tpu.datasets import MDSWriter as JaxMDSWriter
from micro_diffusion_tpu.models import interop as jinterop
from micro_diffusion_tpu.train import optim as joptim
from micro_diffusion_tpu.train import trainer as jtrainer_module
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.train import cli
from micro_diffusion_tpu_torch.train import optim as toptim

from test_torch_dit import TOL
from test_torch_train import assert_close_tree
from test_torch_trainer import RES, _one_torch_thread, make_config  # noqa: F401
from train import build_from_config as jax_build_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "orbax_to_torch.py")
_spec = importlib.util.spec_from_file_location("orbax_to_torch", SCRIPT)
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)

EMA = {"_target_": "diffusion.algorithms.ema.EMA", "smoothing": 0.9, "ema_start": "1ba",
       "update_interval": "1ba"}


def run_config(datadir, **trainer):
    """The stage-1 Micro recipe of tests/test_torch_trainer.py at batch 4 (K = 1),
    with the EMA on from step 1."""
    cfg = make_config(datadir, device_train_microbatch_size=4, **trainer)
    cfg["dataset"]["train_batch_size"] = 4
    cfg["algorithms"]["ema"] = dict(EMA)
    return cfg


def named(tree):
    """A params-shaped JAX tree as {port name: numpy array}, masked leaves left out."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()
                    if not isinstance(v, optax.MaskedNode)}
        return np.asarray(node)
    return jinterop.params_to_torch_state_dict(strip(tree))


def adam_states(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]


def jax_moments(opt_state):
    """{port name: mu}, {port name: nu} over every Adam state (one per lr group)."""
    mu, nu = {}, {}
    for s in adam_states(opt_state):
        mu.update(named(s.mu))
        nu.update(named(s.nu))
    return mu, nu


def assert_bitwise(got, ref, what):
    """Port tensors against numpy arrays: the same names, dtypes and bits."""
    assert set(got) == set(ref), what
    for k, r in ref.items():
        g = got[k].detach()
        assert str(g.dtype).split(".")[-1] == r.dtype.name, (what, k, g.dtype, r.dtype)
        bits = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        assert bits.contiguous().numpy().tobytes() == np.ascontiguousarray(
            r.view(np.int16) if r.dtype.name == "bfloat16" else r).tobytes(), (what, k)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    rng = np.random.default_rng(0)
    with JaxMDSWriter(out=str(tmp / "ds"), columns={"caption_latents": "bytes",
                                                    "latents_128": "bytes"}) as w:
        for _ in range(16):
            w.write({"caption_latents": rng.standard_normal((1, 77, 1024))
                     .astype(np.float16).tobytes(),
                     "latents_128": (0.5 * rng.standard_normal((4, RES, RES)))
                     .astype(np.float16).tobytes()})
    cfg = run_config(str(tmp / "ds"), save_folder=str(tmp / "jax"), save_interval="2ba",
                     save_num_checkpoints_to_keep=2)
    with pytest.MonkeyPatch.context() as mp:  # one device, as the port's trainer
        make_mesh = jtrainer_module.make_mesh
        mp.setattr(jtrainer_module, "make_mesh", lambda data=None, fsdp=1, tensor=1:
                   make_mesh(data=1, devices=jax.devices()[:1]))
        jtrainer = jax_build_from_config(copy.deepcopy(cfg))
        jtrainer.fit()
        jtrainer.load_orbax_step(3)  # the reference: JAX's own reading of step 3
    proc = subprocess.run([sys.executable, SCRIPT, str(tmp / "jax"), str(tmp / "port")],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    state = jtrainer.state
    mu, nu = jax_moments(state.opt_state)
    return types.SimpleNamespace(
        cfg=cfg, jtrainer=jtrainer, src=tmp / "jax", out=tmp / "port",
        summary=json.loads(proc.stdout.strip().splitlines()[-1]),
        params=named(state.params), mu=mu, nu=nu, ema=named(state.ema_params),
        step=int(state.step), count=int(adam_states(state.opt_state)[0].count),
        loader=jtrainer.train_loader.state_dict())


def port_trainer(run, **trainer):
    cfg = run_config(run.cfg["dataset"]["train"]["datadir"], **trainer)
    return cli.build_from_config(cfg)


@pytest.mark.parametrize("how", ["load_path", "autoresume"])
def test_port_trainer_holds_the_jax_state_bitwise(run, how):
    """The converted folder through ``load_path`` (the full state) and through
    ``save_folder`` + ``autoresume`` (and the loader's position): params, mu, nu, the
    EMA, step and count are the orbax state's bit for bit, under the port model's
    parameter names."""
    assert run.summary["step"] == run.step == 3 and run.summary["ema"]
    kw = (dict(load_path=str(run.out)) if how == "load_path"
          else dict(save_folder=str(run.out), autoresume=True))
    t = port_trainer(run, **kw)
    names = set(dict(t.model.dit.named_parameters()))
    assert set(run.params) == names
    assert_bitwise(t.state.params, run.params, "params")
    assert_bitwise(t.state.opt_state.mu, run.mu, "mu")
    assert_bitwise(t.state.opt_state.nu, run.nu, "nu")
    assert_bitwise(t.state.ema_params, run.ema, "ema_params")
    assert (t.state.step, t.state.opt_state.count) == (run.step, run.count) == (3, 3)
    if how == "autoresume":
        assert t.train_loader.state_dict() == run.loader == {"epoch": 0, "step_in_epoch": 3}


def test_weights_only_load_chains_a_stage(run):
    """``load_path`` with ``load_weights_only`` (the recipe's stage chain): the JAX
    run's weights, a fresh step and optimizer, the EMA a copy of the weights."""
    t = port_trainer(run, load_path=str(run.out), load_weights_only=True)
    assert_bitwise(t.state.params, run.params, "params")
    assert t.state.step == 0 and t.state.opt_state.count == 0
    assert not any(m.any() for m in t.state.opt_state.mu.values())
    assert all(torch.equal(e, t.state.params[k]) for k, e in t.state.ema_params.items())


def test_forward_matches_jax_on_the_converted_weights(run):
    """The port DiT on the converted weights against the JAX DiT on the orbax params,
    under CFG 5 (both halves of the batch); tests/test_torch_dit.py's Micro
    tolerance."""
    t = port_trainer(run, load_path=str(run.out))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, RES, RES)).astype(np.float32)
    sigma = np.array([0.3, 1.7], np.float32)
    y = rng.standard_normal((2, 1, 77, 1024)).astype(np.float32)
    jdit = run.jtrainer.model.dit
    out_j = jax.jit(lambda p, x, s, y: jdit.apply(p, x, s, y, cfg=5.0)["sample"])(
        run.jtrainer.state.params, x, sigma, y)
    with torch.no_grad():
        out_t = t.model.dit(*map(torch.from_numpy, (x, sigma, y)), cfg=5.0)["sample"]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL["micro"],
                               atol=TOL["micro"])


def test_one_adamw_update_matches_optax(run):
    """One seeded gradient applied by optax to the restored JAX state and by the port's
    AdamW to the converted one (clip 0.25, the schedule at count 3): the same params,
    fp32, 1e-6 relative to each tensor's scale. A swapped moment, a missing transpose
    or a count off by one parts them by far more."""
    t = port_trainer(run, load_path=str(run.out))
    state = run.jtrainer.state
    leaves, treedef = jax.tree_util.tree_flatten(state.params)
    rng = np.random.default_rng(11)
    grads = treedef.unflatten([rng.standard_normal(l.shape).astype(np.float32) * 1e-2
                               for l in leaves])
    updates, _ = jax.jit(run.jtrainer.tx.update)(grads, state.opt_state, state.params)
    want = named(optax.apply_updates(state.params, updates))
    t.tx.step(t.state.params, {k: torch.from_numpy(v.copy()) for k, v in named(grads).items()},
              t.state.opt_state)
    assert_close_tree(t.state.params, want, 1e-6, "param")


def test_eval_load_reads_the_ema(run):
    """``load_any_checkpoint`` on the converted folder returns the EMA that the JAX
    package's own ``load_any_checkpoint`` reads from the orbax directory."""
    want = named(jinterop.load_any_checkpoint(str(run.src)))
    assert_bitwise(tinterop.load_any_checkpoint(str(run.out)), want, "eval weights")
    assert_bitwise(tinterop.load_any_checkpoint(str(run.out)), run.ema, "eval weights")


# ------------------------------------------------------ optax states without the trainer
# A few leaves of the DiT's tree, under its names: an MoE block's experts and gate (the
# leaves the matcher 'mlp' puts in the MoE lr group), a dense kernel and a bias.
SHAPES = {"blocks_1": {"mlp": {"w1": (4, 8, 16), "w2": (4, 16, 8), "gate": {"kernel": (8, 4)}}},
          "blocks_0": {"attn": {"qkv": {"kernel": (8, 24)}}},
          "final_layer": {"linear": {"kernel": (8, 16), "bias": (16,)}}}
SCHEDULE = (1e-3, 2, 10, 0.33)  # cosine_with_warmup(base, warmup, t_max, alpha_f)


def small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32),
                                   SHAPES, is_leaf=lambda s: isinstance(s, tuple))}


def optax_run(steps, **opt):
    """``build_optimizer(**opt)`` (clip 0.25) after ``steps`` seeded updates of the small
    tree: (params, opt_state, tx)."""
    params = small_params()
    tx = joptim.build_optimizer(params, joptim.cosine_with_warmup(*SCHEDULE), clip_norm=0.25,
                                **opt)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for i in range(steps):
        updates, opt_state = update(small_params(100 + i), opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state, tx


def save_orbax(mgr_dir, state):
    """``state`` saved as the JAX trainer saves (``Composite(state=..., loader=...)``)."""
    step = int(state["step"])
    mgr = ocp.CheckpointManager(str(mgr_dir), options=ocp.CheckpointManagerOptions(
        max_to_keep=5, create=True))
    mgr.save(step, args=ocp.args.Composite(
        state=ocp.args.StandardSave(state),
        loader=ocp.args.JsonSave({"epoch": 1, "step_in_epoch": step})))
    mgr.wait_until_finished()


def convert_and_load(src, out, **kw):
    return torch.load(converter.convert(str(src), str(out), **kw), weights_only=True)


def test_no_ema_in_the_checkpoint(run, tmp_path):
    """A save without an EMA (before ``ema_start``, a stage without one): no
    ``ema_params`` written, and the port's trainer, its EMA on, starts it from the
    loaded params, as the JAX trainer does."""
    state = run.jtrainer.state
    save_orbax(tmp_path / "jax", {"step": state.step, "params": state.params,
                                  "opt_state": state.opt_state})
    ckpt = convert_and_load(tmp_path / "jax", tmp_path / "port")
    assert "ema_params" not in ckpt
    assert_bitwise(ckpt["opt_state"]["mu"], run.mu, "mu")
    t = port_trainer(run, load_path=str(tmp_path / "port"))
    assert_bitwise(t.state.params, run.params, "params")
    assert all(torch.equal(e, t.state.params[k]) for k, e in t.state.ema_params.items())


@pytest.mark.parametrize("case", ["moe_groups", "bf16_moments"])
def test_optax_states_of_the_recipes(tmp_path, case):
    """Two lr groups (``multi_transform``, the MoE matcher matching): both groups' Adam
    states merged leaf by leaf, and one port AdamW update with the same groups equal to
    optax's on the same gradient (fp32, 1e-6). bf16 moments
    (``low_precision_moments``) and a bf16 EMA: carried bitwise, not through fp32."""
    opt = {"moe_groups": {"moe_matcher": "mlp"},
           "bf16_moments": {"low_precision_moments": True}}[case]
    params, opt_state, tx = optax_run(2, **opt)
    state = {"step": jnp.int32(2), "params": params, "opt_state": opt_state}
    if case == "bf16_moments":
        state["ema_params"] = jax.tree.map(lambda p: (0.5 * p).astype(jnp.bfloat16), params)
    save_orbax(tmp_path / "jax", state)
    ckpt = convert_and_load(tmp_path / "jax", tmp_path / "port")
    mu, nu = jax_moments(opt_state)
    assert len(adam_states(opt_state)) == (2 if case == "moe_groups" else 1)
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2
    assert ckpt["loader"] == {"epoch": 1, "step_in_epoch": 2}
    assert_bitwise(ckpt["params"], named(params), "params")
    assert_bitwise(ckpt["opt_state"]["mu"], mu, "mu")
    assert_bitwise(ckpt["opt_state"]["nu"], nu, "nu")
    if case == "bf16_moments":
        assert next(iter(mu.values())).dtype.name == "bfloat16"
        assert_bitwise(ckpt["ema_params"], named(state["ema_params"]), "ema_params")
        return
    grads = small_params(7)
    updates, _ = jax.jit(tx.update)(grads, opt_state, params)
    want = named(optax.apply_updates(params, updates))
    got = {k: v.clone() for k, v in ckpt["params"].items()}
    ttx = toptim.build_optimizer(got, toptim.cosine_with_warmup(*SCHEDULE), clip_norm=0.25,
                                 moe_matcher="mlp")
    assert set(ttx.labels.values()) == {"rest", "moe"}
    ttx.step(got, {k: torch.from_numpy(v.copy()) for k, v in named(grads).items()},
             toptim.AdamState(count=ckpt["opt_state"]["count"], mu=ckpt["opt_state"]["mu"],
                              nu=ckpt["opt_state"]["nu"]))
    assert_close_tree(got, want, 1e-6, "param")


def test_unequal_counts_raise(tmp_path):
    """The port keeps one update count: a schedule count that parts from the Adam
    count stops the conversion, naming both, and writes nothing."""
    params, opt_state, _ = optax_run(1)
    opt_state = jax.tree.map(
        lambda s: s._replace(count=s.count + 1) if isinstance(s, optax.ScaleByScheduleState)
        else s, opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
    save_orbax(tmp_path / "jax", {"step": jnp.int32(1), "params": params,
                                  "opt_state": opt_state})
    with pytest.raises(ValueError, match=r"counts differ.*count = 1.*count = 2"):
        converter.convert(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()


def test_step_directory_manager_directory_and_step(tmp_path, capsys):
    """A manager directory converts its latest step; ``--step`` and the step's own
    directory convert that step, to equal files; a step that is not there raises."""
    for step in (1, 2):
        params, opt_state, _ = optax_run(step)
        save_orbax(tmp_path / "jax", {"step": jnp.int32(step), "params": params,
                                      "opt_state": opt_state})
    assert convert_and_load(tmp_path / "jax", tmp_path / "latest")["step"] == 2
    assert converter.main([str(tmp_path / "jax"), str(tmp_path / "by_step"), "--step", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["step"] == 1
    a = torch.load(tmp_path / "by_step" / "1" / "checkpoint.pt", weights_only=True)
    b = convert_and_load(tmp_path / "jax" / "1", tmp_path / "step_dir")
    assert a["step"] == b["step"] == 1 and a["loader"] == b["loader"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 1
    for tree in (a["params"], a["opt_state"]["mu"], a["opt_state"]["nu"]):
        assert tree.keys() == named(params).keys()
    for k, v in b["params"].items():
        assert torch.equal(a["params"][k], v)
    for m in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][m][k], v) for k, v in b["opt_state"][m].items())
    with pytest.raises(FileNotFoundError, match="no step 5"):
        converter.convert(str(tmp_path / "jax"), str(tmp_path / "none"), step=5)
