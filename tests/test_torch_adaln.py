"""The port's fused adaLN (K6, ops/adaln.py) and the slice-3 model options against
the JAX package: layernorm_modulate forward and gradients against the JAX
function with its Pallas kernel in interpret mode (bf16 and fp32, with and
without a weight); the DiT with fused_adaln=True and with remat 'dots' against the
JAX DiT with the same options (edm_loss value and parameter gradients); and that
'dots' keeps the 2-D products (the backward re-runs no aten.mm/addmm) while 'full'
recomputes them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from micro_diffusion_tpu.models import diffusion as jdiffusion
from micro_diffusion_tpu.models import dit as jdit
from micro_diffusion_tpu.models import interop as jinterop
from micro_diffusion_tpu.ops import adaln as jadaln
from micro_diffusion_tpu.ops import masking as jmasking
from micro_diffusion_tpu_torch.models import diffusion as tdiffusion
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.ops import adaln as tadaln
from micro_diffusion_tpu_torch.ops import masking as tmasking

from test_torch_dit import MICRO, MICRO_CAPTION, rand
from test_torch_train import assert_close_tree, to_torch_names

# fp32: the same arithmetic in both frameworks, summed in another order. bf16: the
# output is rounded once, so a one-ulp flip (2^-8 of an entry) is the most that
# may differ; gradients stored in bf16 likewise.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2e-2)}  # (forward, gradients)
# the Micro widths at 4 blocks (1 mixer, 3 backbone, one of them EC-MoE): every
# block kind, fewer to compile
SMALL = dict(MICRO, depth=3, patch_mixer_depth=1, qkv_multipliers=(1.0,),
             ffn_multipliers=(4.0,))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models are Micro-sized: intra-op threads buy nothing, and in a parallel
    test run the threads of several workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jdt(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _tdt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("use_weight", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_modulate_matches_jax(dtype, use_weight):
    b, t, d = 2, 16, 64
    x, w = rand((b, t, d), 0), 1.0 + 0.1 * rand((d,), 1)
    shift, scale, cot = rand((b, d), 2), 0.5 * rand((b, d), 3), rand((b, t, d), 4)
    jx, js, jc = (jnp.asarray(a, _jdt(dtype)) for a in (x, shift, scale))
    jw = jnp.asarray(w) if use_weight else None

    def jloss(x, w, s1, s2):
        out = jadaln.layernorm_modulate(x, w, s1, s2, 1e-6, True)  # interpret mode
        return jnp.sum(out.astype(jnp.float32) * cot), out

    argnums = (0, 1, 2, 3) if use_weight else (0, 2, 3)
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(jloss, argnums, has_aux=True))(
        jx, jw, js, jc)

    tx, ts, tc = (torch.from_numpy(a).to(_tdt(dtype)).requires_grad_() for a in (x, shift, scale))
    tw = torch.from_numpy(w).requires_grad_() if use_weight else None
    out_t = tadaln.layernorm_modulate(tx, tw, ts, tc)
    assert type(out_t.grad_fn).__name__ == "_LayerNormModulateBackward"
    assert out_t.dtype == _tdt(dtype)
    inputs = [tx, tw, ts, tc] if use_weight else [tx, ts, tc]
    grads_t = torch.autograd.grad((out_t.float() * torch.from_numpy(cot)).sum(), inputs)

    fwd_tol, grad_tol = TOL[dtype]
    assert _rel(out_t.float().detach(), out_j) <= fwd_tol
    for g_t, g_j in zip(grads_t, grads_j):
        assert g_t.dtype == next(i.dtype for i in inputs if i.shape == g_t.shape)
        assert _rel(g_t.float(), g_j) <= grad_tol


def test_reference_is_the_kernel_contract_not_the_unfused_layer():
    """The kernel's contract rounds once; the unfused LayerNorm rounds y to bf16
    before modulating. On bf16 inputs the two differ."""
    from micro_diffusion_tpu_torch.models.layers import LayerNorm, modulate

    x = torch.from_numpy(rand((2, 32, 64), 5)).bfloat16()
    shift, scale = (torch.from_numpy(rand((2, 64), s)).bfloat16() for s in (6, 7))
    ln = LayerNorm(64)
    ln._init_params(None)
    unfused = modulate(ln(x), shift, scale)
    fused = tadaln.layernorm_modulate_reference(x, ln.weight, shift, scale)
    exact = tadaln.layernorm_modulate_plain(x.float(), ln.weight, shift.float(), scale.float())
    assert not torch.equal(fused, unfused)
    # one rounding is closer to the fp32 result than two
    assert (fused.float() - exact).abs().mean() < (unfused.float() - exact).abs().mean()


def _micro_models(**kw):
    """The port's Micro DiT (seeded init, every parameter perturbed so the
    zero-init layers are live) and the JAX DiT with its weights, converted by the
    JAX package's interop; both wrapped in their LatentDiffusion."""
    tmodel = tdit.DiT(dtype=torch.float32, device="cpu", **SMALL, **kw)
    tmodel.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i, p in enumerate(tmodel.parameters()):
            p.add_(0.05 * torch.from_numpy(rand(tuple(p.shape), 100 + i)))
    params = {"params": jinterop.torch_state_dict_to_params(
        {k: v.numpy() for k, v in tmodel.state_dict().items()})}
    jmodel = jdit.DiT(dtype=jnp.float32, **SMALL, **kw)
    jld = jdiffusion.LatentDiffusion(dit=jmodel, latent_res=MICRO["input_size"],
                                     train_mask_ratio=0.75, latent_scale=1.0)
    tld = tdiffusion.LatentDiffusion(tmodel, latent_res=MICRO["input_size"],
                                     train_mask_ratio=0.75)
    return params, jmodel, jld, tld


def jax_mask(jmodel, params, rng_mask, batch, length, ratio):
    """The JAX DiT's token mask for ``rng_mask``: its make_rng('mask') at the root
    scope, without running the forward (the same key as DiT.__call__ draws)."""
    return jmodel.apply(params, method=lambda m: jmasking.make_token_mask(
        m.make_rng("mask"), batch, length, ratio).mask, rngs={"mask": rng_mask})


def test_dit_fused_adaln_and_dots_match_jax(monkeypatch):
    """The fused adaLN of the H100 overlays, fused_adaln=True with remat 'dots', against
    the JAX DiT with the same options: the edm_loss at mask 0.75 (the DiT forward
    through the fused adaLN sites) and every parameter gradient, fp32, Micro widths,
    JAX weights carried across. JAX's LayerNorm runs the Pallas kernel in interpret
    mode under MDT_ATTENTION_INTERPRET. Tolerances as tests/test_torch_train.py:
    1e-4 on the loss, 2e-3 on the gradients."""
    monkeypatch.setenv("MDT_ATTENTION_INTERPRET", "1")
    params, jmodel, jld, tld = _micro_models(fused_adaln=True, remat=True,
                                             remat_policy="dots")
    x = rand((2, 4, MICRO["input_size"], MICRO["input_size"]), 1)
    y = rand((2, 1) + MICRO_CAPTION, 2)
    rng = jax.random.PRNGKey(9)
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


class _CountProducts(TorchDispatchMode):
    """Counts aten.mm/addmm calls while ``active``."""

    def __init__(self, active=True):
        super().__init__()
        self.active, self.count = active, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.active and func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_dots_recomputes_no_products():
    """Under 'dots' the backward runs exactly the 2-D products of a backward
    without remat: none of the blocks' forward products is re-run. Under 'full' it
    runs those plus every aten.mm/addmm of the blocks' forward once more. The
    gradients agree in all three (fp32, exact up to 1e-6)."""
    kw = dict(input_size=16, caption_channels=32, device="cpu", dtype=torch.float32,
              fused_adaln=True)
    plain = tdit.MicroDiT_Micro_2(**kw).init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():  # make the adaLN-zero gates live
        for p in plain.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(3))
    x, y = torch.from_numpy(rand((2, 4, 16, 16), 3)), torch.from_numpy(rand((2, 8, 32), 4))

    # the 2-D products of the remat blocks' forward (mixer and backbone)
    in_blocks = _CountProducts(active=False)
    blocks = list(plain.patch_mixer) + list(plain.blocks)
    hooks = [h for b in blocks for h in (
        b.register_forward_pre_hook(lambda *_: setattr(in_blocks, "active", True)),
        b.register_forward_hook(lambda *_: setattr(in_blocks, "active", False)))]
    with torch.no_grad(), in_blocks:
        plain(x, torch.zeros(2), y, mask_ratio=0.5, generator=torch.Generator().manual_seed(5))
    for h in hooks:
        h.remove()
    assert in_blocks.count > 0

    grads, backward_products = {}, {}
    for policy in ("none", "full", "dots"):
        model = tdit.MicroDiT_Micro_2(remat=policy != "none",
                                      remat_policy="full" if policy == "none" else policy, **kw)
        model.load_state_dict(plain.state_dict())
        out = model(x, torch.zeros(2), y, mask_ratio=0.5,
                    generator=torch.Generator().manual_seed(5))["sample"]
        with _CountProducts() as counted:
            grads[policy] = torch.autograd.grad(out.square().mean(), list(model.parameters()))
        backward_products[policy] = counted.count
    assert backward_products["dots"] == backward_products["none"]
    assert backward_products["full"] == backward_products["none"] + in_blocks.count
    for policy in ("full", "dots"):
        for a, b in zip(grads["none"], grads[policy]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
