"""The port's named remat policies, 'attn_moe' and 'dots_attn_moe', and the lean
suffixes '_lean', '_xlean' and '_alean' (JAX ``models/dit.py:330-382``): the DiT under
each against the JAX DiT under the policy of the same name (edm_loss value and every
parameter gradient); that the backward re-runs none of the operators that produce
the named outputs (the self-attention, cross-attention and EC-MoE outputs) while
'full' re-runs them; and that a lean name keeps fewer bytes than its base, leaving
out exactly the products its suffixes name."""

import collections

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.models import layers
from micro_diffusion_tpu_torch.ops import masking as tmasking
from micro_diffusion_tpu_torch.ops.remat_names import current_name

from test_torch_adaln import _micro_models, _one_torch_thread, jax_mask  # noqa: F401
from test_torch_dit import MICRO, MICRO_CAPTION, rand
from test_torch_train import assert_close_tree, to_torch_names


@pytest.mark.parametrize("policy,dispatch", [
    pytest.param("attn_moe", "onehot", id="attn_moe"),
    pytest.param("dots_attn_moe", "onehot", id="dots_attn_moe"),
    pytest.param("dots_lean", "unroll", id="dots_lean-unroll"),
    pytest.param("dots_xlean", "onehot_dots", id="dots_xlean-onehot_dots"),
    pytest.param("dots_alean", "onehot", id="dots_alean"),
    pytest.param("dots_attn_moe_xlean_alean", "gather", id="dots_attn_moe_xlean_alean-gather"),
])
def test_named_policies_match_jax(policy, dispatch):
    """fp32, Micro widths, JAX weights carried across, the same draws, the plain
    attention path in both (tests/test_torch_flash_bthd.py holds K5 against JAX).
    Tolerances as tests/test_torch_train.py: 1e-4 on the loss, 2e-3 on the
    gradients."""
    params, jmodel, jld, tld = _micro_models(remat=True, remat_policy=policy,
                                             moe_dispatch=dispatch)
    x = rand((2, 4, MICRO["input_size"], MICRO["input_size"]), 1)
    y = rand((2, 1) + MICRO_CAPTION, 2)
    rng = jax.random.PRNGKey(11)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jld.edm_loss(p, rng, x, y, 0.75)))(params)

    rng_sigma, rng_noise, rng_mask = jax.random.split(rng, 3)
    tokens = (MICRO["input_size"] // MICRO["patch_size"]) ** 2
    mask = jax_mask(jmodel, params, rng_mask, x.shape[0], tokens, 0.75)
    draws = {"rnd_normal": torch.from_numpy(np.array(jax.random.normal(rng_sigma, (2, 1, 1, 1)))),
             "noise": torch.from_numpy(np.array(jax.random.normal(rng_noise, x.shape))),
             "token_mask": tmasking.token_mask_from_keep(torch.from_numpy(np.asarray(mask) == 0))}
    named = dict(tld.dit.named_parameters())
    loss_t = tld.edm_loss(torch.from_numpy(x), torch.from_numpy(y), 0.75, **draws)
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))

    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    assert_close_tree(grads_t, to_torch_names(grads_j), 2e-3, "grad")


class _NamedOps(TorchDispatchMode):
    """The operators that run under a checkpoint_name (detach aside: the
    selective-checkpoint machinery adds those)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if current_name() is not None and func is not torch.ops.aten.detach.default:
            self.ops.append((current_name(), func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dispatch", ["onehot", "gather"])
def test_named_policies_keep_the_named_outputs(dispatch):
    """With K5 (its forward one operator) and each MoE combine: under 'attn_moe' and
    'dots_attn_moe' the backward's recompute runs no operator that produced a named
    output (their outputs come from the cache), under 'full' it runs them for every
    block; the gradients agree with no remat exactly (fp32, 1e-6)."""
    kw = dict(input_size=16, caption_channels=32, device="cpu", dtype=torch.float32,
              moe_dispatch=dispatch, attention_impl="flash_bthd")
    plain = tdit.MicroDiT_Micro_2(**kw).init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():  # make the adaLN-zero gates live
        for p in plain.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(3))
    x, y = torch.from_numpy(rand((2, 4, 16, 16), 3)), torch.from_numpy(rand((2, 8, 32), 4))
    grads, rerun = {}, {}
    for policy in ("none", "full", "attn_moe", "dots_attn_moe"):
        model = tdit.MicroDiT_Micro_2(remat=policy != "none",
                                      remat_policy="full" if policy == "none" else policy, **kw)
        model.load_state_dict(plain.state_dict())
        out = model(x, torch.zeros(2), y, mask_ratio=0.5,
                    generator=torch.Generator().manual_seed(5))["sample"]
        with _NamedOps() as named:
            grads[policy] = torch.autograd.grad(out.square().mean(), list(model.parameters()))
        rerun[policy] = {name for name, _ in named.ops} & set(tdit._NAMES_SAVED)
    assert rerun["none"] == set()
    assert rerun["full"] == {"attn_out", "xattn_out", "moe_out"}
    assert rerun["attn_moe"] == rerun["dots_attn_moe"] == set()
    for policy in ("full", "attn_moe", "dots_attn_moe"):
        for a, b in zip(grads["none"], grads[policy]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


class _Kept:
    """Wraps models.dit.remat_policy_fn: the (name, operator, output bytes) of every
    forward operator that a policy keeps, in order."""

    def __init__(self, policy_fn):
        self.rows = []
        self.policy_fn = policy_fn

    def __call__(self, policy):
        fn = self.policy_fn(policy)
        if fn is None:
            return None

        def recording(ctx, op, *args, **kwargs):
            decision = fn(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                with torch.no_grad():
                    out = op(*args, **kwargs)
                outs = out if isinstance(out, (tuple, list)) else [out]
                self.rows.append((current_name(), op, sum(
                    t.nbytes for t in outs if isinstance(t, torch.Tensor))))
            return decision
        return recording


@pytest.mark.parametrize("base,lean,dispatch,dropped", [
    ("dots", "dots_lean", "unroll", {"expert_dots": 2}),
    ("dots", "dots_lean", "gather", {}),
    ("dots", "dots_xlean", "onehot_dots", {"expert_dots": 2, "ffn_hidden": 2}),
    ("dots", "dots_alean", "onehot", {"attn_proj": 5}),
    ("dots_attn_moe", "dots_attn_moe_xlean_alean", "scan",
     {"expert_dots": 2, "ffn_hidden": 2, "attn_proj": 5, "xattn_out": None}),
])
def test_lean_policies_keep_fewer_bytes(monkeypatch, base, lean, dispatch, dropped):
    """Micro, fp32, one forward and backward under the base policy and under the lean
    name: the outputs that the lean name no longer keeps are exactly the products its
    suffixes name, ``dropped`` per MoE block (expert_dots), dense FFN (ffn_hidden) or
    DiT block (attn_proj: qkv, proj, q_linear, kv_linear, proj; '_alean' under
    'dots_attn_moe' also the cross-attention output, JAX dit.py:367-372, whose region
    holds the several operators of the plain attention here), and it keeps
    as many fewer bytes as those outputs hold; under the fused 'gather' kernel '_lean'
    changes nothing. The gradients are bitwise those of the base."""
    kw = dict(input_size=16, caption_channels=32, device="cpu", dtype=torch.float32,
              moe_dispatch=dispatch, remat=True)
    plain = tdit.MicroDiT_Micro_2(**kw).init_weights(torch.Generator().manual_seed(2))
    x, y = torch.from_numpy(rand((2, 4, 16, 16), 3)), torch.from_numpy(rand((2, 8, 32), 4))
    kept, grads, policy_fn = {}, {}, tdit.remat_policy_fn
    for policy in (base, lean):
        model = tdit.MicroDiT_Micro_2(remat_policy=policy, **kw)
        model.load_state_dict(plain.state_dict())
        rec = _Kept(policy_fn)
        monkeypatch.setattr(tdit, "remat_policy_fn", rec)
        out = model(x, torch.zeros(2), y, mask_ratio=0.5,
                    generator=torch.Generator().manual_seed(5))["sample"]
        grads[policy] = torch.autograd.grad(out.square().mean(), list(model.parameters()))
        kept[policy] = rec.rows
    blocks = list(plain.patch_mixer) + list(plain.blocks)
    moe = sum(isinstance(b.mlp, layers.FeedForwardECMoe) for b in blocks)
    per = {"expert_dots": moe, "ffn_hidden": len(blocks) - moe, "attn_proj": len(blocks)}
    gone = collections.Counter(kept[base]) - collections.Counter(kept[lean])
    assert not collections.Counter(kept[lean]) - collections.Counter(kept[base])
    names = collections.Counter(name for name, _, _ in gone.elements())
    assert set(names) == set(dropped)
    assert {name: n for name, n in names.items() if name != "xattn_out"} == {
        name: n * per[name] for name, n in dropped.items() if name != "xattn_out"}
    saved = {p: sum(nbytes for _, _, nbytes in rows) for p, rows in kept.items()}
    assert saved[base] - saved[lean] == sum(nbytes for _, _, nbytes in gone.elements())
    assert (saved[lean] < saved[base]) == bool(dropped)
    for a, b in zip(grads[base], grads[lean]):
        assert torch.equal(a, b)
