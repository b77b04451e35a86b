"""The EMA placements of the port against the JAX package, on the CPU at Micro size:
the host-EMA classes (``HostEMA``, ``AsyncHostEMA``, ``HostComputeEMA`` with
``offload=False`` as JAX's CPU-testable mode, ``StagedEMAUpdate``) against their
JAX classes over 5 chained decays; the hostcompute checkpoint
(save, autoresume, weights-only load, and across placements); the trainer's
``accum_mode: dispatch`` bitwise against ``scan``; the v5e overlays built in the
port. Tolerances are stated at each test. ``Trainer.fit`` under the host placements
against the JAX trainer is tests/test_torch_placements.py."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.train import train_step as jtrain
from micro_diffusion_tpu_torch.train import cli
from micro_diffusion_tpu_torch.train import config as tconfig
from micro_diffusion_tpu_torch.train import host_ema as thost
from micro_diffusion_tpu_torch.train import trainer as ttrainer

from test_torch_dit import rand
from test_torch_trainer import ROOT, _one_torch_thread, dataset_dir, make_config  # noqa: F401


# ------------------------------------------------------------------ host EMA


def ema_params():
    """The JAX tests' tree (tests/test_train.py:177-179) as a JAX dict and as the
    port's {name: tensor} in the same leaf order."""
    jp = {"a": jnp.linspace(0.0, 3.0, 32, dtype=jnp.float32).reshape(8, 4),
          "b": jnp.arange(6, dtype=jnp.float32),
          "c": {"w": jnp.full((5, 3), -0.75, jnp.float32)}}
    tp = {"a": torch.from_numpy(np.asarray(jp["a"])), "b": torch.from_numpy(np.asarray(jp["b"])),
          "c.w": torch.from_numpy(np.asarray(jp["c"]["w"]))}
    return jp, tp


def chain(i, tree, to):
    """The i-th update's parameters: a seeded perturbation of ``tree``."""
    return {k: to(np.asarray(v) * (1.0 + 0.3 * i) - 0.07 * i
                  + 0.01 * rand(np.shape(v), 200 + i))
            for k, v in tree.items()}


def by_name(jtree):
    return {"a": np.asarray(jtree["a"], np.float32), "b": np.asarray(jtree["b"], np.float32),
            "c.w": np.asarray(jtree["c"]["w"], np.float32)}


@pytest.mark.parametrize("cls", ["HostEMA", "AsyncHostEMA", "HostComputeEMA"])
def test_host_ema_matches_jax_class(cls):
    """Each class at a 32-byte chunk budget (several chunks, leaves split across
    them), 5 chained decays at smoothing 0.9, against its JAX class on the same
    trees: HostEMA (bf16 storage, decayed where the parameters live) within two
    bf16 ulps of each entry (2^-7 relative: XLA on the CPU contracts the decay into
    one fused multiply-add, the port rounds the product and the sum apart, and the
    one-ulp fp32 difference can flip a bf16 rounding that later decays carry);
    AsyncHostEMA and HostComputeEMA (fp32 storage, bf16-rounded contributions;
    exact and bf16 initial copies) within 1e-6, JAX's own bound against the exact
    chain."""
    jp, tp = ema_params()
    jparams = lambda i: {"a": chain(i, {"a": jp["a"]}, jnp.asarray)["a"],
                         "b": chain(i, {"b": jp["b"]}, jnp.asarray)["b"],
                         "c": {"w": chain(i, {"w": jp["c"]["w"]}, jnp.asarray)["w"]}}
    tparams = lambda i: {k: torch.from_numpy(np.asarray(v, np.float32))
                         for k, v in by_name(jparams(i)).items()}
    jcls, tcls = getattr(jtrain, cls), getattr(thost, cls)
    kw = {} if cls == "AsyncHostEMA" else {"offload": False}
    jema, tema = jcls(jp, 0.9, chunk_bytes=32, **kw), tcls(tp, 0.9, chunk_bytes=32, **kw)
    for i in range(1, 6):
        jema.update(jparams(i))
        tema.update(tparams(i))
    if cls == "AsyncHostEMA":
        jema.block()
        tema.block()
        want, got = by_name(jema.ema_tree()), tema.ema_tree()
        jema.close()
        tema.close()
    else:
        want, got = by_name(jema.materialize()), tema.materialize()
        got = {k: v.float().numpy() for k, v in got.items()}
    assert len(tema._layout.bounds) > 1 and set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        if cls == "HostEMA":
            np.testing.assert_allclose(got[k], want[k], rtol=2 ** -7, atol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("lazy", [False, True])
def test_staged_update_equals_update(lazy):
    """stage_update's thunks, run by tick() between other work and drain(), over two
    staged updates, give update()'s EMA bit for bit; with ``lazy`` each thunk takes
    its chunk's copy when it runs, so it must run before the parameters change."""
    _, tp = ema_params()
    upd = [chain(i, tp, lambda a: torch.from_numpy(np.asarray(a, np.float32)))
           for i in (1, 2)]
    a = thost.HostComputeEMA(tp, 0.9, chunk_bytes=32, offload=False)
    b = thost.HostComputeEMA(tp, 0.9, chunk_bytes=32, offload=False)
    for p in upd:
        a.update(p)
        staged = b.stage_update(p, lazy=lazy)
        staged.tick()
        torch.ones(3).mul_(3.0)  # other work between two decays
        staged.tick()
        staged.drain()
        staged.drain()  # nothing left
    for k, v in a.materialize().items():
        assert torch.equal(v, b.materialize()[k]), k
    np_tree = a.materialize_numpy()
    assert np_tree["c.w"].dtype == np.float32 and np_tree["c.w"].shape == (5, 3)


def test_host_ema_failures_raise():
    """No placement falls back: an offloaded EMA needs pinned host memory (a card)
    and raises without one; a failure of the decay worker re-raises in the next
    update and in block()."""
    _, tp = ema_params()
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        thost.HostComputeEMA(tp, 0.9)
    with pytest.raises(RuntimeError):
        thost.HostEMA(tp, 0.9)
    ema = thost.AsyncHostEMA(tp, 0.9)
    ema._host._exc = RuntimeError("boom")  # as the worker stores a failure
    with pytest.raises(RuntimeError, match="boom"):
        ema.update(tp)
    with pytest.raises(RuntimeError, match="boom"):
        ema.block()


# ------------------------------------------------------------------ the trainer


def _ema_cfg(placement, start="2ba", interval="2ba"):
    return {"_target_": "diffusion.algorithms.ema.EMA", "smoothing": 0.9,
            "ema_start": start, "update_interval": interval, "placement": placement}


def _fit(datadir, tmp, name, steps, ema=None, **trainer):
    cfg = make_config(datadir, max_duration=f"{steps}ba", device_train_microbatch_size=4,
                      save_folder=str(tmp / name), **trainer)
    cfg["dataset"]["train_batch_size"] = 8
    if ema:
        cfg["algorithms"]["ema"] = ema
    t = cli.build_from_config(cfg)
    t.fit()
    return t


def test_hostcompute_checkpoints(dataset_dir, tmp_path):
    """The hostcompute EMA (from step 1, every step) through the checkpoint: saved
    reassembled in ``ema_params`` (the file format of in_state); 3 steps and an
    autoresume to 5 give the straight run's parameters bit for bit and its EMA within
    two bf16 ulps (the resume rebuilds the chunks through the placement's bf16
    copy, as JAX's); a weights-only load drops the chunks (they restart at
    ema_start); an in_state checkpoint resumes under hostcompute and a hostcompute
    one under in_state, the EMA carried."""
    hc = _ema_cfg("hostcompute", "1ba", "1ba")
    straight = _fit(dataset_dir, tmp_path, "straight", 5, hc)
    _fit(dataset_dir, tmp_path, "resumed", 3, hc)
    ckpt = torch.load(tmp_path / "resumed" / "3" / ttrainer.CKPT_FILE, weights_only=True)
    assert set(ckpt["ema_params"]) == set(ckpt["params"])
    resumed = _fit(dataset_dir, tmp_path, "resumed", 5, hc, autoresume=True)
    assert resumed.state.step == 5 and resumed._hc_ema is not None
    want, got = straight._ema_weights(), resumed._ema_weights()
    for k, p in straight.state.params.items():
        assert torch.equal(resumed.state.params[k], p), k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2 ** -7, atol=1e-7)

    cfg = make_config(dataset_dir, load_path=str(tmp_path / "resumed"), load_weights_only=True)
    cfg["algorithms"]["ema"] = hc
    t = cli.build_from_config(cfg)
    assert t._hc_ema is None and t._ema_weights() is None and t.state.step == 0

    _fit(dataset_dir, tmp_path, "in_state", 3, _ema_cfg("in_state", "1ba", "1ba"))
    saved = torch.load(tmp_path / "in_state" / "3" / ttrainer.CKPT_FILE, weights_only=True)
    to_hc = _fit(dataset_dir, tmp_path, "in_state", 3, hc, autoresume=True)
    for k, e in to_hc._ema_weights().items():
        assert torch.equal(e, saved["ema_params"][k].bfloat16().float()), k
    to_in = _fit(dataset_dir, tmp_path, "resumed", 5, _ema_cfg("in_state", "1ba", "1ba"),
                 autoresume=True)
    for k, e in to_in.state.ema_params.items():
        assert torch.equal(e, got[k]), k


@pytest.mark.parametrize("accum,flow", [("float32", None), ("bfloat16", "bfloat16")])
def test_trainer_dispatch_equals_scan(dataset_dir, tmp_path, accum, flow):
    """accum_mode 'dispatch' (make_train_step: one make_grad_step call per microbatch
    into a zeroed accumulator, then make_apply_step) against 'scan' over 3 steps of
    batch 8 in 2 microbatches, with ``grad_accum_dtype`` and ``param_flow_dtype``
    reaching both: the losses and every parameter bit for bit."""
    runs = [_fit(dataset_dir, tmp_path, mode, 3, accum_mode=mode, grad_accum_dtype=accum,
                 param_flow_dtype=flow, metric_window=1) for mode in ("scan", "dispatch")]
    assert [r.accum_mode for r in runs] == ["scan", "dispatch"]
    assert runs[1].param_flow_dtype == (torch.bfloat16 if flow else None)
    for k, p in runs[0].state.params.items():
        assert torch.equal(runs[1].state.params[k], p), k


V5E = os.path.join(ROOT, "configs", "tpu_v5e_1chip")


@pytest.mark.parametrize("stage", ["res_256_pretrain", "res_256_finetune",
                                   "res_512_pretrain", "res_512_finetune"])
def test_v5e_overlays_build_in_the_port(dataset_dir, stage):
    """The single-chip TPU overlays in the port: every target resolves to the port,
    the model block builds on the meta device, and their trainer and EMA options
    (accum_mode dispatch with a bf16 accumulator, bf16 moments, the hostcompute
    placement at interval 32) build a trainer with trainer.device=cpu that takes a
    step at Micro size (the EMA from step 0)."""
    over = tconfig.load_config(V5E, stage, ["trainer.device=cpu"])
    for block in (over["model"], over["trainer"], over["dataset"]["train"]):
        fn = tconfig.resolve_target(block["_target_"])
        assert fn.__module__.startswith("micro_diffusion_tpu_torch."), block["_target_"]
    model = tconfig.instantiate(over["model"], device="meta")
    assert model.dit.remat_policy == over["model"]["remat_policy"]
    cfg = make_config(dataset_dir, max_duration="1ba")
    opts = {k: over["trainer"][k] for k in ("accum_mode", "grad_accum_dtype")
            if k in over["trainer"]}
    cfg["trainer"].update(opts)
    cfg["optimizer"]["low_precision_moments"] = over["optimizer"]["low_precision_moments"]
    ema = over["algorithms"].get("ema")
    if ema:  # from step 0, so that the one step makes or decays it
        cfg["algorithms"]["ema"] = dict(copy.deepcopy(ema), ema_start="0ba")
    t = cli.build_from_config(cfg)
    assert t.accum_mode == over["trainer"].get("accum_mode", "scan")
    assert t.ema_placement == (ema or {}).get("placement", "in_state")
    t.fit()
    assert t.state.step == 1
    if t.ema_placement == "hostcompute":  # interval 32: made at step 0
        assert t._hc_ema is not None and t.state.ema_params is None
