"""The port's whole-K flash attention (K4, 'flash_bh') against the JAX package's, on
the same numpy inputs: on CPU tensors the port runs the kernels' plain forward and
backward, JAX the interpret-mode Pallas kernels, at the head dims the lane kernel
does not take (16 for Micro, 32 for Tiny), odd head counts, and a key length that
is no multiple of a tile (77 caption tokens)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.ops import flash_attention_bh as jbh
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.ops import attention as tattention

tbh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _inputs(b, tq, tk, h, d):
    return rand((b, tq, h, d), 0), rand((b, tk, h, d), 1), rand((b, tk, h, d), 2)


# fp32: forward to 2e-5 and gradients to 2e-4, as tests/test_flash_attention.py
# holds the JAX bh kernel against XLA (test_bh_variant_*).
@pytest.mark.parametrize("b,tq,tk,h,d", [(2, 64, 64, 3, 16), (2, 128, 77, 5, 32),
                                         (1, 256, 256, 4, 32), (1, 96, 77, 1, 16)])
def test_flash_bh_matches_jax(b, tq, tk, h, d):
    q, k, v = _inputs(b, tq, tk, h, d)
    jfn = lambda q, k, v: jbh.flash_attention_bh(q, k, v, None, True)
    ref = np.asarray(jax.jit(jfn)(q, k, v))
    loss = lambda q, k, v: jnp.sum(jnp.sin(jfn(q, k, v)))
    ref_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)

    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tbh.flash_attention_bh(*args)
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-5, atol=2e-5)
    for name, a, r in zip("qkv", args, ref_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")
    # the dispatcher sends 'flash' off the lane shapes (head_dim != 64) and
    # 'flash_bh' itself to the same function
    for impl in ("flash", "flash_bh"):
        got = tattention.dot_product_attention(*(a.detach() for a in args), impl=impl)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5, err_msg=impl)


def test_flash_bh_bf16_roundings_match_jax():
    """bf16 inputs at D = 32, Tk = 77: the contract's bf16 casts of e, ds_u and the
    scaled q/do tiles happen in both frameworks; 2e-2, the card's ATTN_TOL and
    BWD_TOL scale (a few bf16 ulps of outputs of magnitude <~ 1), gradients scaled
    by their largest entry."""
    b, tq, tk, h, d = 1, 128, 77, 3, 32
    q, k, v = _inputs(b, tq, tk, h, d)
    jfn = lambda q, k, v: jbh.flash_attention_bh(q, k, v, None, True)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(jax.jit(jfn)(*jargs), np.float32)
    loss = lambda q, k, v: jnp.sum(jnp.sin(jfn(q, k, v).astype(jnp.float32)))
    ref_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*jargs)

    args = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = tbh.flash_attention_bh(*args)
    torch.sin(out.float()).sum().backward()
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=2e-2, atol=2e-2)
    for name, a, r in zip("qkv", args, ref_g):
        r = np.asarray(r, np.float32)
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a.grad.float().numpy() / scale, r / scale, rtol=2e-2,
                                   atol=2e-2, err_msg=f"d{name}")


def test_flash_bh_backward_is_the_plain_contract():
    """On CPU tensors the autograd Function runs flash_attention_bh_bwd_plain, which
    equals autograd through the plain forward (fp32, 1e-5), and never counts a
    launch."""
    q, k, v, do = (torch.from_numpy(rand(s, i)) for i, s in enumerate(
        [(2, 64, 3, 32), (2, 77, 3, 32), (2, 77, 3, 32), (2, 64, 3, 32)]))
    before = (tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    direct = torch.autograd.grad(tbh.flash_attention_bh(*leaves), leaves, do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(tbh.flash_attention_bh_plain(*plain), plain, do)
    for a, b_ in zip(direct, auto):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    assert (tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches) == before


def test_dit_with_flash_bh_runs_the_same_function():
    """The Micro DiT (head_dim 16) with attention_impl 'flash_bh': every block's
    self- and cross-attention through K4 (its plain versions on the CPU), forward
    and backward, against the same DiT with the plain 'xla' path; fp32, 2e-4 as
    tests/test_torch_dit.py holds the Micro config."""
    from test_torch_dit import MICRO

    x, t, y = rand((2, 4, 16, 16), 3), np.asarray([0.3, 0.9], np.float32), rand((2, 1, 8, 32), 4)
    outs = {}
    for impl in ("flash_bh", "xla"):
        model = tdit.DiT(dtype=torch.float32, device="cpu", attention_impl=impl, **MICRO)
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():  # the zero-init layers too, so every block is live
            for i, p in enumerate(model.parameters()):
                p.add_(torch.from_numpy(0.05 * rand(tuple(p.shape), 100 + i)))
        out = model(*map(torch.from_numpy, (x, t, y)))["sample"]
        grads = torch.autograd.grad(torch.sin(out).sum(), list(model.parameters()))
        outs[impl] = [out.detach()] + list(grads)
    for got, ref in zip(outs["flash_bh"], outs["xla"]):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
