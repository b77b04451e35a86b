"""The port's tiled flash attention with the saved logsumexp (K5, 'flash_bthd')
against the JAX package's, on the same numpy inputs: on CPU tensors the port runs
the kernels' plain forward and backward, JAX the interpret-mode Pallas kernels, at
head dims 32 and 64, odd head counts, a key length that is no multiple of a tile
(77 caption tokens) and a query length JAX tiles in chunks (512); the Micro DiT
with attention_impl 'flash_bthd'; and the stage-2 H100 overlay with the override."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.ops import flash_attention as jfa
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.ops import attention as tattention
from micro_diffusion_tpu_torch.train import config as tconfig

tfa = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention")

OVERLAYS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "micro_diffusion_tpu_torch", "configs", "h100_1gpu")


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _inputs(b, tq, tk, h, d):
    return rand((b, tq, h, d), 0), rand((b, tk, h, d), 1), rand((b, tk, h, d), 2)


def _jax_flash(q, k, v):
    return jfa.flash_attention(q, k, v, None, True)  # interpret mode


# fp32: forward to 2e-5 and gradients to 2e-4, as tests/test_flash_attention.py
# holds the JAX kernel against XLA; the row logsumexp to 2e-5 as well.
@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 64, 77, 3, 32), (1, 512, 128, 2, 64)])
def test_flash_bthd_matches_jax(b, tq, tk, h, d):
    q, k, v = _inputs(b, tq, tk, h, d)
    ref = np.asarray(jax.jit(_jax_flash)(q, k, v))
    _, ref_lse = jax.jit(lambda q, k, v: jfa._forward_with_lse(q, k, v, d**-0.5, True))(q, k, v)
    loss = lambda q, k, v: jnp.sum(jnp.sin(_jax_flash(q, k, v)))
    ref_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)

    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*args)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5, atol=2e-5)
    _, lse = tfa.flash_attention_plain(*(a.detach() for a in args))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=2e-5, atol=2e-5)
    for name, a, r in zip("qkv", args, ref_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")
    got = tattention.dot_product_attention(*(a.detach() for a in args), impl="flash_bthd")
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_flash_bthd_bf16_roundings_match_jax():
    """bf16 inputs at D = 64, Tk = 77, odd H: the contract's bf16 casts of p (after
    the normalisation), ds and the outputs happen in both frameworks; 2e-2, the
    card's ATTN_TOL and BWD_TOL scale, gradients scaled by their largest entry."""
    b, tq, tk, h, d = 1, 64, 77, 3, 64
    q, k, v = _inputs(b, tq, tk, h, d)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(jax.jit(_jax_flash)(*jargs), np.float32)
    loss = lambda q, k, v: jnp.sum(jnp.sin(_jax_flash(q, k, v).astype(jnp.float32)))
    ref_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*jargs)

    args = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*args)
    torch.sin(out.float()).sum().backward()
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=2e-2, atol=2e-2)
    for name, a, r in zip("qkv", args, ref_g):
        r = np.asarray(r, np.float32)
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a.grad.float().numpy() / scale, r / scale, rtol=2e-2,
                                   atol=2e-2, err_msg=f"d{name}")


def test_flash_bthd_backward_is_the_plain_contract():
    """On CPU tensors the autograd Function runs the plain backward on the saved out
    and lse, which equals autograd through the plain forward (fp32, 1e-5), and
    never counts a launch; the tiling rule raises for a length JAX refuses."""
    q, k, v, do = (torch.from_numpy(rand(s, i)) for i, s in enumerate(
        [(2, 64, 3, 32), (2, 77, 3, 32), (2, 77, 3, 32), (2, 64, 3, 32)]))
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    direct = torch.autograd.grad(tfa.flash_attention(*leaves), leaves, do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(tfa.flash_attention_plain(*plain)[0], plain, do)
    for a, b_ in zip(direct, auto):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == before
    assert tfa.chunk(1024) == 256 and tfa.chunk(77) == 77
    q300 = torch.zeros(1, 300, 1, 16)
    with pytest.raises(ValueError, match="multiple of 128"):
        tattention.dot_product_attention(q300, q300, q300, impl="flash_bthd")


def test_dit_with_flash_bthd_matches_jax():
    """The Micro DiT (head_dim 16) with attention_impl 'flash_bthd': its forward
    against the JAX DiT with 'flash_bthd' (the interpret-mode Pallas kernels), and
    its forward and every gradient against the same DiT on the plain 'xla' path,
    the function tests/test_torch_dit.py holds against the JAX DiT; fp32, 2e-4 as
    that file holds the Micro config."""
    from micro_diffusion_tpu.models import dit as jdit
    from micro_diffusion_tpu.models import interop as jinterop
    from test_torch_dit import MICRO

    x, t, y = rand((2, 4, 16, 16), 3), np.asarray([0.3, 0.9], np.float32), rand((2, 1, 8, 32), 4)
    outs = {}
    for impl in ("flash_bthd", "xla"):
        model = tdit.DiT(dtype=torch.float32, device="cpu", attention_impl=impl, **MICRO)
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():  # the zero-init layers too, so every block is live
            for i, p in enumerate(model.parameters()):
                p.add_(torch.from_numpy(0.05 * rand(tuple(p.shape), 100 + i)))
        out = model(*map(torch.from_numpy, (x, t, y)))["sample"]
        grads = torch.autograd.grad(torch.sin(out).sum(), list(model.parameters()))
        outs[impl] = [out.detach()] + list(grads)
    for got, ref in zip(outs["flash_bthd"], outs["xla"]):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)

    params = {"params": jinterop.torch_state_dict_to_params(
        {k: v.numpy() for k, v in model.state_dict().items()})}
    jmodel = jdit.DiT(dtype=jnp.float32, attention_impl="flash_bthd", **MICRO)
    ref = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y)["sample"])(params, x, t, y)
    np.testing.assert_allclose(outs["flash_bthd"][0].numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_stage2_overlay_takes_flash_bthd():
    """The stage-2 H100 overlay with the command-line override resolves through the
    port's config loader and builds a DiT whose every block attention site (self and
    cross, mixer and backbone) is 'flash_bthd'; as the overlay stands, 'auto'. The
    caption block's self-attention is 'auto' either way, as in the JAX package
    (layers.py:759 builds it without an attn_impl)."""
    for args, want in (([], "auto"), (["model.attention_impl=flash_bthd"], "flash_bthd")):
        cfg = tconfig.load_config(OVERLAYS, "res_256_finetune", args)
        assert cfg["model"]["attention_impl"] == want
        assert cfg["model"]["train_mask_ratio"] == 0.0
        dit = tconfig.instantiate(cfg["model"], device="meta").dit
        blocks = list(dit.patch_mixer) + list(dit.blocks)
        impls = {blk.attn.attn_impl for blk in blocks} | {blk.cross_attn.attn_impl
                                                           for blk in blocks}
        assert impls == {want} and dit.y_emb_preprocess.attn.attn_impl == "auto"
