"""The port's backward kernels' plain versions and token masking against the JAX
package, on the same numpy inputs: K1b (the lane attention backward) against
jax.grad of the interpret-mode Pallas kernel, K2b (the fused EC-MoE expert-FFN
backward) likewise on a shape where JAX takes its fused _dxdw_kernel and on one
where it takes the split _dx_kernel/_dw_kernel pair, and make_token_mask /
gather_tokens / scatter_tokens on injected indices. On CPU tensors the port runs
each kernel's plain version, forward and backward."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.ops import flash_attention_lane as jlane
from micro_diffusion_tpu.ops import masking as jmasking
from micro_diffusion_tpu.ops import moe_ffn as jmoe
from micro_diffusion_tpu_torch.ops import masking as tmasking

tlane = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
tmoe = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _torch_grads(fn, *arrays, dtype=torch.float32):
    """Gradients of sum(sin(fn(*args))) with respect to every argument."""
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    torch.sin(fn(*args).float()).sum().backward()
    return [a.grad.float().numpy() for a in args]


def _jax_grads(fn, *arrays, dtype=jnp.float32):
    loss = lambda *a: jnp.sum(jnp.sin(fn(*a).astype(jnp.float32)))
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a, dtype) for a in arrays])
    return [np.asarray(g, np.float32) for g in grads]


# The shapes of tests/test_flash_attention.py (batch 1 at T = 1024 to keep the
# interpret-mode reference quick), and the stage-1 backbone cross-attention
# (Tq 64 against 77 caption tokens).
@pytest.mark.parametrize("b,tq,tk,h", [(2, 64, 64, 4), (2, 256, 77, 12), (2, 128, 128, 4),
                                       (1, 1024, 1024, 16), (1, 1024, 77, 16),
                                       (2, 64, 77, 16)])
def test_attention_backward_matches_jax(b, tq, tk, h):
    """fp32; tolerance 2e-4, as tests/test_flash_attention.py holds the lane
    kernel's gradients against XLA's."""
    d = 64
    q, k, v = rand((b, tq, h, d), 0), rand((b, tk, h, d), 1), rand((b, tk, h, d), 2)
    ref = _jax_grads(lambda q, k, v: jlane.flash_attention_lane(q, k, v, None, True), q, k, v)
    got = _torch_grads(tlane.flash_attention_lane, q, k, v)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4, err_msg=f"d{name}")


def test_attention_backward_is_the_plain_contract():
    """On CPU tensors the backward entry point runs the kernels' plain version from
    the forward's out and row statistics, and that matches autograd through the
    plain forward (fp32, 1e-5)."""
    q, k, v, do = (torch.from_numpy(rand(s, i)) for i, s in enumerate(
        [(2, 64, 2, 64), (2, 77, 2, 64), (2, 77, 2, 64), (2, 64, 2, 64)]))
    out, stats = tlane.flash_attention_lane_stats_plain(q, k, v)
    direct = tlane.flash_attention_lane_bwd(q, k, v, out, stats, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tlane.flash_attention_lane_plain(*leaves)
    auto = torch.autograd.grad(out, leaves, do)
    for a, b_ in zip(direct, auto):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)


def _fused_in_jax(n, e, k, d, f):
    return jmoe._fused_ft(n * k, d, f) is not None


# (2, 4, 16, 128, 512): the whole row set fits JAX's VMEM budget, the fused
# _dxdw_kernel runs; (64, 2, 256, 128, 256): 16384 rows per expert do not, the
# split _dx_kernel + _dw_kernel pair runs.
@pytest.mark.parametrize("n,e,k,d,f,fused", [(2, 4, 16, 128, 512, True),
                                             (64, 2, 256, 128, 256, False)])
def test_moe_ffn_backward_matches_jax(n, e, k, d, f, fused):
    """bf16, tolerance 2e-2 (abs and rel), as tests/test_moe.py holds the split and
    fused Pallas backward kernels against each other: the bf16 roundings of a and
    da can flip by one ulp between summation orders."""
    assert _fused_in_jax(n, e, k, d, f) == fused and tmoe.supported(n, e, k, d, f)
    xg, w1, w2 = rand((n, e, k, d), 3), rand((e, d, f), 4) * 0.05, rand((e, f, d), 5) * 0.05
    ref = _jax_grads(lambda a, b, c: jmoe.moe_ffn(a, b, c, interpret=True), xg, w1, w2,
                     dtype=jnp.bfloat16)
    got = _torch_grads(tmoe.moe_ffn, xg, w1, w2, dtype=torch.bfloat16)
    for name, g, r in zip(("dx", "dw1", "dw2"), got, ref):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g / scale, r / scale, rtol=2e-2, atol=2e-2, err_msg=name)


def test_moe_backward_is_the_plain_contract():
    """The autograd Function's CPU backward is moe_ffn_bwd_plain, dtypes follow the
    inputs, and an unsupported shape keeps plain autograd (_moe_ffn_ref)."""
    xg = torch.from_numpy(rand((2, 2, 16, 128), 6)).bfloat16().requires_grad_()
    w1 = torch.from_numpy(rand((2, 128, 256), 7) * 0.05).bfloat16().requires_grad_()
    w2 = torch.from_numpy(rand((2, 256, 128), 8) * 0.05).bfloat16().requires_grad_()
    do = torch.from_numpy(rand((2, 2, 16, 128), 9)).bfloat16()
    grads = torch.autograd.grad(tmoe.moe_ffn(xg, w1, w2), (xg, w1, w2), do)
    for a, b_ in zip(grads, tmoe.moe_ffn_bwd_plain(xg, w1, w2, do)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b_)
    x8 = torch.from_numpy(rand((2, 2, 8, 64), 10)).requires_grad_()
    v1 = torch.from_numpy(rand((2, 64, 96), 11)).requires_grad_()
    v2 = torch.from_numpy(rand((2, 96, 64), 12)).requires_grad_()
    assert not tmoe.supported(2, 2, 8, 64, 96)
    assert tmoe.moe_ffn(x8, v1, v2).grad_fn.name() != "_ExpertFFNBackward"


def test_gather_scatter_match_jax():
    """Injected ids: gather and scatter agree with JAX exactly (fp32)."""
    b, t, keep, d = 3, 16, 4, 8
    rng = np.random.default_rng(13)
    ids_shuffle = np.stack([rng.permutation(t) for _ in range(b)]).astype(np.int32)
    ids_restore = np.argsort(ids_shuffle, axis=1).astype(np.int32)
    ids_keep = ids_shuffle[:, :keep]
    x, xk = rand((b, t, d), 14), rand((b, keep, d), 15)
    mask_token = np.zeros((1, 1, d), np.float32)
    ref_g = np.asarray(jmasking.gather_tokens(x, ids_keep))
    ref_s = np.asarray(jmasking.scatter_tokens(xk, ids_restore, mask_token))
    got_g = tmasking.gather_tokens(torch.from_numpy(x), torch.from_numpy(ids_keep).long())
    got_s = tmasking.scatter_tokens(torch.from_numpy(xk), torch.from_numpy(ids_restore).long(),
                                    torch.from_numpy(mask_token))
    np.testing.assert_array_equal(got_g.numpy(), ref_g)
    np.testing.assert_array_equal(got_s.numpy(), ref_s)


def test_token_mask_from_jax_keep_set():
    """The JAX keep-set injected in index order: the same mask, gather then scatter
    puts every kept token back where it was and zeros elsewhere; a drawn mask keeps
    int(T * (1 - ratio)) tokens per sample and is reproducible from its seed."""
    b, t, ratio = 4, 64, 0.75
    jm = jmasking.make_token_mask(jax.random.PRNGKey(3), b, t, ratio)
    keep = torch.from_numpy(np.asarray(jm.mask) == 0)
    tm = tmasking.token_mask_from_keep(keep)
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    assert tm.ids_keep.shape == (b, 16)
    assert bool((tm.ids_keep.diff(dim=1) > 0).all())  # index order
    x = torch.from_numpy(rand((b, t, 8), 16))
    back = tmasking.scatter_tokens(tmasking.gather_tokens(x, tm.ids_keep), tm.ids_restore,
                                   torch.zeros(1, 1, 8))
    torch.testing.assert_close(back, x * keep[..., None])

    draw = lambda seed: tmasking.make_token_mask(torch.Generator().manual_seed(seed), b, t, ratio)
    a, a2, c = draw(0), draw(0), draw(1)
    assert torch.equal(a.ids_keep, a2.ids_keep) and not torch.equal(a.ids_keep, c.ids_keep)
    assert a.ids_keep.shape == (b, int(t * (1 - ratio)))
    assert torch.equal(a.mask.sum(dim=1), torch.full((b,), float(t - 16)))
    with pytest.raises(ValueError):
        tmasking.token_mask_from_keep(torch.tensor([[True, False], [True, True]]))
