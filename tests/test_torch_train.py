"""The port's training path against the JAX package's, in fp32 on numpy inputs with
the JAX weights carried across by the port's load_jax_params: edm_loss (value and
parameter gradients) at mask_ratio 0 and 0.75, one make_train_step step at K = 1
and K = 2 microbatches (loss, grad_norm, new params, Adam moments), the lr
schedules and ema_update.

Both sides run the kernel-shaped config of tests/test_torch_dit.py with
attention_impl="flash": attention goes through the lane kernel's contract (JAX:
the interpret-mode Pallas kernel; the port: its plain forward and backward), and
the patch mixer's MoE block (k = 32, d = 128, f = 512) through the fused expert
kernel's contract; the masked backbone's MoE (k = 8) takes the plain path on both.

JAX's draws are reproduced with its own key chain (make_train_step: fold_in(base,
step), fold_in(., microbatch); edm_loss: split into sigma / noise / mask keys) and
injected into the port. The token mask is the JAX DiT's own 'mask' output for the
same mask key, injected as ids_keep in index order: every block is permutation-
equivariant over tokens (attention and the per-sample expert choice see a set;
the position embedding is added before the gather), so the order of the kept
tokens does not change the function.
"""

import collections
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from micro_diffusion_tpu.models import diffusion as jdiffusion
from micro_diffusion_tpu.models import dit as jdit
from micro_diffusion_tpu.train import optim as joptim
from micro_diffusion_tpu.train import train_step as jtrain
from micro_diffusion_tpu_torch.models import diffusion as tdiffusion
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.models import interop as tinterop
from micro_diffusion_tpu_torch.ops import masking as tmasking
from micro_diffusion_tpu_torch.train import optim as toptim
from micro_diffusion_tpu_torch.train import train_step as ttrain

from test_torch_dit import KERNEL, jax_model_and_params, rand

tlane = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
tmoe = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

RES = KERNEL["input_size"]
# fp32 tolerances, relative to the largest entry of the compared tensor: the
# kernel contract rounds a = x @ w1 and da to bf16, and a one-ulp flip of those
# roundings between the two frameworks' summation orders moves a gradient entry
# by ~1e-3 of the tensor's scale.
LOSS_TOL = 1e-4
GRAD_TOL = 2e-3


def jax_diffusion(mask_ratio):
    dit = jdit.DiT(dtype=jnp.float32, attention_impl="flash", **KERNEL)
    return jdiffusion.LatentDiffusion(dit=dit, latent_res=RES, train_mask_ratio=mask_ratio,
                                      latent_scale=1.0)


def torch_diffusion(params, mask_ratio):
    dit = tdit.DiT(dtype=torch.float32, device="cpu", attention_impl="flash", **KERNEL)
    tinterop.load_jax_params(dit, params)
    return tdiffusion.LatentDiffusion(dit, latent_res=RES, train_mask_ratio=mask_ratio)


@functools.lru_cache(maxsize=None)
def _mask_fn():
    model = jdit.DiT(dtype=jnp.float32, **KERNEL)
    return jax.jit(lambda p, x, t, y, r: model.apply(p, x, t, y, mask_ratio=0.75,
                                                     rngs={"mask": r})["mask"])


def jax_draws(params, rng, x, y, mask_ratio):
    """edm_loss's draws for key ``rng``: rnd_normal, noise, and the DiT's token mask."""
    rng_sigma, rng_noise, rng_mask = jax.random.split(rng, 3)
    draws = {"rnd_normal": torch.from_numpy(np.array(
                 jax.random.normal(rng_sigma, (x.shape[0], 1, 1, 1)))),
             "noise": torch.from_numpy(np.array(jax.random.normal(rng_noise, x.shape)))}
    if mask_ratio > 0:
        t = np.zeros((x.shape[0],), np.float32)
        mask = np.asarray(_mask_fn()(params, x, t, y, rng_mask))
        draws["token_mask"] = tmasking.token_mask_from_keep(torch.from_numpy(mask == 0))
    return draws


def to_torch_names(tree):
    """A params-shaped JAX tree as {port parameter name: numpy array}."""
    return {k: np.asarray(v, np.float32)
            for k, v in tinterop.params_to_torch_state_dict(tree).items()}


def assert_close_tree(got: dict, ref: dict, tol, what):
    assert set(got) == set(ref), what
    for name, r in ref.items():
        g = got[name].detach().float().cpu().numpy() if torch.is_tensor(got[name]) else got[name]
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(g / scale, r / scale, rtol=tol, atol=tol,
                                   err_msg=f"{what} {name}")


def batch(b, seed):
    drop = np.ones((b,), np.float32)
    drop[-1] = 0.0  # one caption dropped, as the recipe's 10% drop does
    return {"image_latents": rand((b, 4, RES, RES), seed),
            "caption_latents": rand((b, 1, 77, KERNEL["caption_channels"]), seed + 1),
            "drop_caption_mask": drop}


def count_backward_contracts(monkeypatch):
    """Count the calls of the two kernels' backward wrappers (on CPU tensors they
    run the plain backward contracts)."""
    calls = collections.Counter()
    for mod, name in ((tlane, "flash_attention_lane_bwd"), (tmoe, "moe_ffn_bwd")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("mask_ratio", [0.0, 0.75])
def test_edm_loss_and_grads_match_jax(mask_ratio, monkeypatch):
    _, params, _ = jax_model_and_params("kernel")
    data = batch(2, 20)
    x, y = data["image_latents"], data["caption_latents"]
    rng = jax.random.PRNGKey(5)
    jld = jax_diffusion(mask_ratio)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jld.edm_loss(p, rng, x, y, mask_ratio)))(params)

    tld = torch_diffusion(params, mask_ratio)
    named = dict(tld.dit.named_parameters())
    calls = count_backward_contracts(monkeypatch)
    loss_t = tld.edm_loss(torch.from_numpy(x), torch.from_numpy(y), mask_ratio,
                          **jax_draws(params, rng, x, y, mask_ratio))
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))
    # the 2 x (2 mixer + 4 backbone) block attentions (the caption block's keeps
    # 'auto', the plain path on a CPU tensor, in both frameworks) and the mixer's
    # MoE block (plus the backbone's at mask 0, k = 32) ran the backward contracts
    moe_calls = 1 if mask_ratio > 0 else 2
    assert calls == {"flash_attention_lane_bwd": 12, "moe_ffn_bwd": moe_calls}, calls
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_TOL)
    assert_close_tree(grads_t, to_torch_names(grads_j), GRAD_TOL, "grad")


def _adam_state(opt_state):
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    (adam,) = [s for s in leaves if hasattr(s, "mu")]
    return adam


@pytest.mark.parametrize("batch_size,microbatch", [(2, None), (4, 2)])
def test_train_step_matches_jax(batch_size, microbatch):
    """One stage-1-style step (mask 0.75, AdamW wd 0.1, clip 0.25, constant lr 1e-3):
    loss, pre-clip grad_norm, lr, the updated params and both Adam moments."""
    _, params, _ = jax_model_and_params("kernel")
    data = batch(batch_size, 30)
    base_rng = jax.random.PRNGKey(7)
    jld = jax_diffusion(0.75)
    jsched = joptim.constant_schedule(1e-3)
    jtx = joptim.build_optimizer(params, jsched, weight_decay=0.1, clip_norm=0.25)
    jstep = jax.jit(jtrain.make_train_step(jld, jtx, jsched, microbatch_size=microbatch))
    jstate, jmetrics = jstep(jtrain.create_train_state(params, jtx),
                             {k: jnp.asarray(v) for k, v in data.items()}, base_rng)

    n = batch_size // (microbatch or batch_size)
    mb = batch_size // n
    step_rng = jax.random.fold_in(base_rng, 0)
    draws = []
    for i in range(n):
        part = slice(i * mb, (i + 1) * mb)
        y = data["caption_latents"][part] * data["drop_caption_mask"][part, None, None, None]
        draws.append(jax_draws(params, jax.random.fold_in(step_rng, i),
                               data["image_latents"][part], y, 0.75))

    tld = torch_diffusion(params, 0.75)
    tsched = toptim.constant_schedule(1e-3)
    ttx = toptim.build_optimizer(dict(tld.dit.named_parameters()), tsched,
                                 weight_decay=0.1, clip_norm=0.25)
    tstep = ttrain.make_train_step(tld, ttx, tsched, microbatch_size=microbatch)
    tstate, tmetrics = tstep(ttrain.create_train_state(tld.dit, ttx),
                             {k: torch.from_numpy(v) for k, v in data.items()}, draws=draws)

    assert tstate.step == 1 and tstate.opt_state.count == 1
    np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(tmetrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=LOSS_TOL)
    assert float(jmetrics["grad_norm"]) > 0.25  # the clip is live
    np.testing.assert_allclose(float(tmetrics["lr"]), float(jmetrics["lr"]), rtol=1e-7)
    adam = _adam_state(jstate.opt_state)
    assert_close_tree(tstate.opt_state.mu, to_torch_names(adam.mu), GRAD_TOL, "mu")
    assert_close_tree(tstate.opt_state.nu, to_torch_names(adam.nu), 2 * GRAD_TOL, "nu")
    # the step moves each param by <= lr (Adam's normalised direction); hold the
    # update itself, relative to lr, where the gradient is not vanishingly small
    old, new = to_torch_names(params), to_torch_names(jstate.params)
    mu_ref = to_torch_names(adam.mu)
    for name, p in tstate.params.items():
        upd_t = p.detach().numpy() - old[name]
        upd_j = new[name] - old[name]
        solid = np.abs(mu_ref[name]) > 1e-2 * np.abs(mu_ref[name]).max()
        np.testing.assert_allclose(upd_t[solid] / 1e-3, upd_j[solid] / 1e-3, rtol=0,
                                   atol=2e-2, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), new[name], rtol=0, atol=2.2e-3,
                                   err_msg=name)


def test_schedules_match_jax():
    cases = [
        ({"_target_": "composer.optim.CosineAnnealingWithWarmupScheduler",
          "t_warmup": "2500ba", "alpha_f": 0.33}, 2.4e-4, 250000),
        ({"_target_": "composer.optim.ConstantScheduler", "alpha": 1.0}, 8e-5, 280000),
        ({"_target_": "composer.optim.ConstantWithWarmupScheduler", "t_warmup": "500ba"},
         8e-5, 50000),
    ]
    for cfg, lr, t_max in cases:
        js, ts = joptim.build_schedule(cfg, lr, t_max), toptim.build_schedule(cfg, lr, t_max)
        for step in (0, 1, 250, 499, 500, 1250, 2500, 2501, 126250, 249999, 250000, 300000):
            np.testing.assert_allclose(float(ts(step)), float(js(step)), rtol=1e-6,
                                       err_msg=f"{cfg['_target_']} step {step}")
    assert float(toptim.cosine_with_warmup(2.4e-4, 2500, 250000, 0.33)(0)) == 0.0


@pytest.mark.parametrize("step,start,interval", [(5, 10, 1), (15, 10, 1), (15, 10, 4),
                                                 (16, 10, 4), (3, 10, 4)])
def test_ema_update_matches_jax(step, start, interval):
    """Mirror before ema_start, decay after it on every interval-th step, fp32 math
    into an fp32 and a bf16 EMA (bf16: exact after the same rounding)."""
    p = {"a": rand((4, 8), 40), "b": rand((16,), 41)}
    e = {"a": rand((4, 8), 42), "b": rand((16,), 43)}
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ej = {k: jnp.asarray(v, dt_j) for k, v in e.items()}
        ref = joptim.ema_update(ej, p, jnp.asarray(step), 0.99975, start, interval)
        et = {k: torch.from_numpy(v).to(dt_t) for k, v in e.items()}
        got = toptim.ema_update(et, {k: torch.from_numpy(v) for k, v in p.items()}, step,
                                0.99975, start, interval)
        for k in p:
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(ref[k], np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_train_state_and_unported_options():
    """EMA is a plain copy; the moments follow mu_dtype; the MoE matcher labels
    nothing by default (modules are named mlp) but is live; the TPU-only options
    raise naming the README record or their ROADMAP item."""
    model = tdiffusion.create_latent_diffusion(dit_arch="MicroDiT_Micro_2", latent_res=16,
                                               train_mask_ratio=0.75, device="cpu")
    named = dict(model.named_parameters())
    tx = toptim.build_optimizer(named, toptim.constant_schedule(1e-4), mu_dtype=torch.bfloat16)
    state = ttrain.create_train_state(model, tx, use_ema=True)
    key = "dit.blocks.0.attn.qkv.weight"
    assert torch.equal(state.ema_params[key], named[key])
    assert state.ema_params[key].data_ptr() != named[key].data_ptr()
    assert state.opt_state.mu[key].dtype == torch.bfloat16
    assert state.opt_state.nu[key].dtype == torch.float32
    assert set(tx.labels.values()) == {"rest"}
    assert set(toptim._label_params(named, "mlp.w").values()) == {"rest", "moe"}
    with pytest.raises(NotImplementedError, match="Not ported"):
        ttrain.make_train_step(model, tx, toptim.constant_schedule(1e-4),
                               param_flow_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="parallelism"):
        ttrain.make_train_step(model, tx, toptim.constant_schedule(1e-4), grad_shardings={})


@pytest.mark.parametrize("opts", [
    dict(clip_norm=0.25),
    dict(clip_norm=None, mu_dtype="bf16"),
    dict(clip_norm=1e3, low_precision_moments=True),
    dict(clip_norm=0.25, moe_matcher="w_moe"),
])
def test_optimizer_matches_optax(opts):
    """Three AdamW steps on a small tree against the JAX package's optax chain:
    global-norm clip (live, and above the norm), the bf16 first moment, both moments
    in bf16, and a live MoE lr group (factor 0.5). Tolerance 1e-6 on params and
    moments, relative to each tensor's scale (2e-2 for bf16-stored moments: one
    bf16 ulp)."""
    opts = dict(opts)
    mu_bf16 = opts.pop("mu_dtype", None) == "bf16"
    params = {"w_moe": rand((8, 16), 50), "b": rand((16,), 51), "w": rand((4, 4), 52)}
    sched_j = joptim.cosine_with_warmup(1e-2, 2, 10, 0.33)
    sched_t = toptim.cosine_with_warmup(1e-2, 2, 10, 0.33)
    tx_j = joptim.build_optimizer(params, sched_j, weight_decay=0.1,
                                  mu_dtype=jnp.bfloat16 if mu_bf16 else None, **opts)
    tx_t = toptim.build_optimizer({k: torch.from_numpy(v) for k, v in params.items()},
                                  sched_t, weight_decay=0.1,
                                  mu_dtype=torch.bfloat16 if mu_bf16 else None, **opts)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for i in range(3):
        grads = {k: rand(v.shape, 60 + 10 * i + j) * (0.5 if i else 3.0)
                 for j, (k, v) in enumerate(params.items())}
        upd, sj = jax.jit(tx_j.update)({k: jnp.asarray(g) for k, g in grads.items()}, sj, pj)
        pj = jax.tree.map(lambda p, u: p + u, pj, upd)
        # the port clips its gradients in place: give it copies, or it rewrites the
        # numpy buffers that JAX's asynchronous update may not have read yet
        st = tx_t.step(pt, {k: torch.from_numpy(g.copy()) for k, g in grads.items()}, st)
    adam_states = [s for s in jax.tree_util.tree_leaves(
        sj, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    mu, nu = {}, {}
    for s in adam_states:  # one state per lr group; masked leaves are empty there
        for k in params:
            if not isinstance(s.mu[k], optax.MaskedNode):
                mu[k], nu[k] = np.asarray(s.mu[k], np.float32), np.asarray(s.nu[k], np.float32)
    moment_tol = 2e-2 if (mu_bf16 or opts.get("low_precision_moments")) else 1e-6
    assert_close_tree(pt, {k: np.asarray(v) for k, v in pj.items()}, 1e-6, "param")
    assert_close_tree(st.mu, mu, moment_tol, "mu")
    assert_close_tree(st.nu, nu, moment_tol, "nu")
    assert st.count == 3
