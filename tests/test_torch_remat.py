"""The port's named remat policies, 'attn_moe' and 'dots_attn_moe' (JAX
``models/dit.py:350-382``): the DiT under each against the JAX DiT under the policy
of the same name (edm_loss value and every parameter gradient), and that the
backward re-runs none of the operators that produce the named outputs (the
self-attention, cross-attention and EC-MoE outputs) while 'full' re-runs them."""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.ops import masking as tmasking
from micro_diffusion_tpu_torch.ops.remat_names import current_name

from test_torch_adaln import _micro_models, _one_torch_thread, jax_mask  # noqa: F401
from test_torch_dit import MICRO, MICRO_CAPTION, rand
from test_torch_train import assert_close_tree, to_torch_names


@pytest.mark.parametrize("policy", ["attn_moe", "dots_attn_moe"])
def test_named_policies_match_jax(policy):
    """fp32, Micro widths, JAX weights carried across, the same draws, the plain
    attention path in both (tests/test_torch_flash_bthd.py holds K5 against JAX).
    Tolerances as tests/test_torch_train.py: 1e-4 on the loss, 2e-3 on the
    gradients."""
    params, jmodel, jld, tld = _micro_models(remat=True, remat_policy=policy)
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
        rerun[policy] = {name for name, _ in named.ops}
    assert rerun["none"] == set()
    assert rerun["full"] == {"attn_out", "xattn_out", "moe_out"}
    assert rerun["attn_moe"] == rerun["dots_attn_moe"] == set()
    for policy in ("full", "attn_moe", "dots_attn_moe"):
        for a, b in zip(grads["none"], grads[policy]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
