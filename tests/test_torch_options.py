"""The trainer's options in the port against the JAX package, on the CPU at Micro size:
the split-dispatch accumulation (``make_grad_step`` + ``make_apply_step`` against
JAX's, and bitwise against the port's own ``make_train_step``) and
``param_flow_dtype`` (the loss and gradients against JAX's flow under remat 'full'
and 'dots', where the recompute must read the bf16 copies; a few steps close to the
fp32 flow). The draws are JAX's, injected; tolerances are stated at each test. The
EMA placements are tests/test_torch_host_ema.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.train import optim as joptim
from micro_diffusion_tpu.train import train_step as jtrain
from micro_diffusion_tpu_torch.ops import masking as tmasking
from micro_diffusion_tpu_torch.train import optim as toptim
from micro_diffusion_tpu_torch.train import train_step as ttrain

from test_torch_adaln import _micro_models, _one_torch_thread, jax_mask  # noqa: F401
from test_torch_dit import MICRO, MICRO_CAPTION, rand
from test_torch_train import assert_close_tree, to_torch_names

RES = MICRO["input_size"]
LOSS_TOL = 1e-4  # fp32 on both sides (tests/test_torch_train.py)
GRAD_TOL = 2e-3  # fp32 gradients, relative to each tensor's largest entry
# A gradient stored in bf16 (the flow's, or a bf16 accumulator's sum of two) rounds
# to 8 mantissa bits: where the two frameworks' fp32 values straddle a rounding
# boundary the stored values part by one or two bf16 ulps, up to 2^-7 of the
# tensor's largest entry.
BF16_TOL = 1e-2


def micro_batch(b, seed):
    drop = np.ones((b,), np.float32)
    drop[-1] = 0.0
    return {"image_latents": rand((b, 4, RES, RES), seed),
            "caption_latents": rand((b, 1) + MICRO_CAPTION, seed + 1),
            "drop_caption_mask": drop}


def draws_for(jmodel, params, rng, n, mask_ratio=0.75):
    """The draws of JAX's edm_loss for key ``rng`` (sigma / noise / mask keys split
    from it) on a microbatch of ``n``."""
    r_sigma, r_noise, r_mask = jax.random.split(rng, 3)
    tokens = (RES // MICRO["patch_size"]) ** 2
    mask = jax_mask(jmodel, params, r_mask, n, tokens, mask_ratio)
    return {"rnd_normal": torch.from_numpy(np.array(jax.random.normal(r_sigma, (n, 1, 1, 1)))),
            "noise": torch.from_numpy(np.array(jax.random.normal(r_noise, (n, 4, RES, RES)))),
            "token_mask": tmasking.token_mask_from_keep(torch.from_numpy(np.asarray(mask) == 0))}


def jax_flow_grads(jld, params, rng, x, y, flow):
    cast = (lambda p: jax.tree.map(lambda a: a.astype(flow), p)) if flow else (lambda p: p)
    return jax.jit(jax.value_and_grad(lambda p: jld.edm_loss(p, rng, x, y, 0.75)))(cast(params))


# ------------------------------------------------------------------ split dispatch


ACCUM_FLOW = [pytest.param("float32", None, id="fp32"),
              pytest.param("bfloat16", None, id="bf16-accum"),
              pytest.param("float32", "bfloat16", id="fp32-flow"),
              pytest.param("bfloat16", "bfloat16", id="bf16-accum-flow")]


@pytest.mark.parametrize("accum,flow", [ACCUM_FLOW[0], ACCUM_FLOW[3]])
def test_grad_and_apply_steps_match_jax(accum, flow):
    """One K = 2 step (batch 4, mask 0.75, clip 0.5, constant lr 1e-3) through
    make_grad_step x 2 + make_apply_step in both frameworks, the accumulator in
    ``accum`` (fp32, bf16) and the parameters flowing in ``flow`` (no, bf16): the
    accumulated gradient sums
    (GRAD_TOL; BF16_TOL where bf16 stores them), the loss and grad norm (LOSS_TOL,
    1e-3), the updated parameters within 2.2 lr (Adam moves an entry by about lr a
    step). Then the port's make_train_step on the same draws gives the same step
    bit for bit (every combination: test_dispatch_equals_scan_bitwise)."""
    params, jmodel, jld, tld = _micro_models()
    jaccum, taccum = jnp.dtype(accum), getattr(torch, accum)
    jflow, tflow = (jnp.dtype(flow), getattr(torch, flow)) if flow else (None, None)
    data = micro_batch(4, 60)
    base = jax.random.PRNGKey(3)
    jsched, tsched = joptim.constant_schedule(1e-3), toptim.constant_schedule(1e-3)
    jtx = joptim.build_optimizer(params, jsched, clip_norm=0.5)
    grad_step = jax.jit(jtrain.make_grad_step(jld, param_flow_dtype=jflow))
    apply_step = jax.jit(jtrain.make_apply_step(jtx, jsched), static_argnums=(2,))
    jstate = jtrain.create_train_state(params, jtx)
    acc = jtrain.zero_grad_accumulator(params, jaccum)
    rng = jax.random.fold_in(base, 0)
    draws = []
    for i in range(2):
        mb = {k: jnp.asarray(v[2 * i:2 * i + 2]) for k, v in data.items()}
        acc = grad_step(jstate.params, acc, mb, rng, i)
        draws.append(draws_for(jmodel, params, jax.random.fold_in(rng, i), 2))
    jsum = to_torch_names(acc[1])
    jstate, jm = apply_step(jstate, acc, 2)

    named = dict(tld.dit.named_parameters())
    init = {k: p.detach().clone() for k, p in named.items()}
    ttx = toptim.build_optimizer(named, tsched, clip_norm=0.5)
    state = ttrain.create_train_state(tld.dit, ttx)
    tacc = ttrain.zero_grad_accumulator(state.params, taccum)
    tgrad = ttrain.make_grad_step(tld, tflow)
    micro, n = ttrain._split_microbatches({k: torch.from_numpy(v) for k, v in data.items()}, 2)
    for mb, d in zip(micro, draws):
        tacc = tgrad(state.params, tacc, mb, draws=d)
    assert all(a.dtype == taccum for a in tacc[1].values())
    assert_close_tree({k: a.float() for k, a in tacc[1].items()}, jsum,
                      BF16_TOL if (flow or accum == "bfloat16") else GRAD_TOL, "grad sum")
    state, tm = ttrain.make_apply_step(ttx, tsched)(state, tacc, n)
    assert not tacc[1]  # the apply consumed the accumulator
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
    new = to_torch_names(jstate.params)
    for k, p in state.params.items():
        assert p.dtype == torch.float32  # the master parameters stay fp32
        np.testing.assert_allclose(p.detach().numpy(), new[k], rtol=0, atol=2.2e-3, err_msg=k)
    dispatched = {k: p.detach().clone() for k, p in state.params.items()}

    with torch.no_grad():
        for k, p in named.items():
            p.copy_(init[k])
    state = ttrain.create_train_state(tld.dit, ttx)
    step = ttrain.make_train_step(tld, ttx, tsched, microbatch_size=2, accum_dtype=taccum,
                                  param_flow_dtype=tflow)
    state, sm = step(state, {k: torch.from_numpy(v) for k, v in data.items()}, draws=draws)
    assert sm["loss"].item() == tm["loss"].item()
    for k, p in state.params.items():
        assert torch.equal(p, dispatched[k]), k


@pytest.mark.parametrize("accum,flow", ACCUM_FLOW)
def test_dispatch_equals_scan_bitwise(accum, flow):
    """The trainer's two accumulation modes on the port alone, every accumulator and
    flow dtype: make_grad_step per microbatch into a zeroed accumulator then
    make_apply_step, against make_train_step (K = 2, the draws from one seeded
    generator each): the loss, the grad norm and every parameter bit for bit."""
    _, _, _, tld = _micro_models(remat=True, remat_policy="full")
    named = dict(tld.dit.named_parameters())
    init = {k: p.detach().clone() for k, p in named.items()}
    data = {k: torch.from_numpy(v) for k, v in micro_batch(4, 61).items()}
    taccum, tflow = getattr(torch, accum), getattr(torch, flow) if flow else None
    sched = toptim.constant_schedule(1e-3)
    out = []
    for mode in ("scan", "dispatch"):
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(init[k])
        tx = toptim.build_optimizer(named, sched, clip_norm=0.5)
        state = ttrain.create_train_state(tld.dit, tx)
        gen = torch.Generator().manual_seed(5)
        if mode == "scan":
            state, m = ttrain.make_train_step(tld, tx, sched, microbatch_size=2,
                                              accum_dtype=taccum,
                                              param_flow_dtype=tflow)(state, data, gen)
        else:
            grad_step = ttrain.make_grad_step(tld, tflow)
            acc = ttrain.zero_grad_accumulator(state.params, taccum)
            micro, n = ttrain._split_microbatches(data, 2)
            for mb in micro:
                acc = grad_step(state.params, acc, mb, gen)
            state, m = ttrain.make_apply_step(tx, sched)(state, acc, n)
        out.append((m, {k: p.detach().clone() for k, p in state.params.items()}))
    (ma, pa), (mb_, pb) = out
    assert ma["loss"].item() == mb_["loss"].item()
    assert ma["grad_norm"].item() == mb_["grad_norm"].item()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert sum(not torch.equal(pa[k], init[k]) for k in pa) >= 0.9 * len(pa)


@pytest.mark.parametrize("policy,kw", [
    pytest.param("full", {}, id="full"),
    pytest.param("dots", dict(fused_adaln=True, moe_dispatch="gather"), id="dots-adaln-gather"),
])
def test_param_flow_matches_jax_under_remat(policy, kw, monkeypatch):
    """The loss and every parameter gradient with the parameters flowing in bf16
    against JAX's (value_and_grad of the loss on the bf16-cast tree), under remat
    ``policy``: the backward's recompute of each block must read the same bf16
    copies as the forward. Under 'dots' with the fused adaLN (K6, whose LayerNorm
    weight it reads in fp32) and the 'gather' MoE (K3). Every gradient comes back in
    bf16, its weight's dtype (BF16_TOL); the loss LOSS_TOL. Without the flow the
    gradients are fp32 and differ from these."""
    monkeypatch.setenv("MDT_ATTENTION_INTERPRET", "1")  # JAX's K6 in interpret mode
    params, jmodel, jld, tld = _micro_models(remat=True, remat_policy=policy, **kw)
    x = rand((2, 4, RES, RES), 70)
    y = rand((2, 1) + MICRO_CAPTION, 71)
    rng = jax.random.PRNGKey(12)
    loss_j, grads_j = jax_flow_grads(jld, params, rng, x, y, jnp.bfloat16)
    batch = {"image_latents": torch.from_numpy(x), "caption_latents": torch.from_numpy(y)}
    named = dict(tld.dit.named_parameters())
    d = draws_for(jmodel, params, rng, 2)
    loss_t, grads_t = ttrain._loss_and_grads(tld, named, torch.bfloat16, batch, None, d)
    assert {g.dtype for g in grads_t.values()} == {torch.bfloat16}
    if kw:
        assert named["blocks.0.norm1.weight"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in named.values())  # the module's own again
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_TOL)
    assert_close_tree({k: g.float() for k, g in grads_t.items()}, to_torch_names(grads_j),
                      BF16_TOL, "flow grad")
    _, plain = ttrain._loss_and_grads(tld, named, None, batch, None, d)
    assert sum(not torch.equal(plain[k].bfloat16(), grads_t[k]) for k in plain) > 0


def test_param_flow_trajectory_close_to_fp32():
    """Three K = 2 steps with the parameters flowing in bf16 against the fp32 flow
    from the same start and draws (JAX's test_param_flow_bf16_trajectory_close_to_fp32
    and its bounds): the last loss within 2e-2 and grad norm within 5e-2 relative,
    every parameter within 5e-3 (three lr-sized Adam steps either side), and the
    two trajectories part by under a quarter of the distance each moved."""
    params, jmodel, jld, tld = _micro_models()
    named = dict(tld.dit.named_parameters())
    init = {k: p.detach().clone() for k, p in named.items()}
    data = {k: torch.from_numpy(v) for k, v in micro_batch(4, 80).items()}
    draws = [draws_for(jmodel, params, jax.random.PRNGKey(90 + i), 2) for i in range(2)]
    sched = toptim.constant_schedule(1e-3)
    out = {}
    for name, flow in (("fp32", None), ("bf16", torch.bfloat16)):
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(init[k])
        tx = toptim.build_optimizer(named, sched, clip_norm=0.25)
        state = ttrain.create_train_state(tld.dit, tx)
        step = ttrain.make_train_step(tld, tx, sched, microbatch_size=2, param_flow_dtype=flow)
        for _ in range(3):
            state, m = step(state, data, draws=draws)
        out[name] = ({k: p.detach().clone() for k, p in state.params.items()}, m)
    (p32, m32), (p16, m16) = out["fp32"], out["bf16"]
    np.testing.assert_allclose(m16["loss"].item(), m32["loss"].item(), rtol=2e-2)
    np.testing.assert_allclose(m16["grad_norm"].item(), m32["grad_norm"].item(), rtol=5e-2)
    drift = upd = 0.0
    for k in p32:
        assert p16[k].dtype == torch.float32
        np.testing.assert_allclose(p16[k].numpy(), p32[k].numpy(), rtol=0, atol=5e-3)
        drift += float((p16[k].double() - p32[k].double()).square().sum())
        upd += float((p32[k].double() - init[k].double()).square().sum())
    assert 0 < drift ** 0.5 < 0.25 * upd ** 0.5


def test_step_options_are_checked():
    """A flow dtype other than bf16 / fp16 raises; the standalone EMA step decays
    with no start gating (ema_update(..., ema_start=0, update_interval=1))."""
    _, _, _, tld = _micro_models()
    tx = toptim.build_optimizer(dict(tld.dit.named_parameters()), toptim.constant_schedule(1e-3))
    with pytest.raises(ValueError, match="param_flow_dtype"):
        ttrain.make_train_step(tld, tx, toptim.constant_schedule(1e-3),
                               param_flow_dtype=torch.float32)
    p = {"w": torch.ones(3)}
    state = ttrain.TrainState(step=5, params=p, opt_state=None, ema_params={"w": torch.zeros(3)})
    state = ttrain.make_ema_step(0.9)(state)
    ref = joptim.ema_update({"w": jnp.zeros(3)}, {"w": jnp.ones(3)}, jnp.asarray(5), 0.9, 0)
    np.testing.assert_array_equal(state.ema_params["w"].numpy(), np.asarray(ref["w"]))
