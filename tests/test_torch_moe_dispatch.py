"""The port's EC-MoE dispatches and the expert-major expert FFN (K3) against the JAX
package, on the same numpy inputs: K3's plain version against
``moe_ffn_expert_major(..., interpret=True)`` forward and backward, every
``moe_dispatch`` name of the port's FeedForwardECMoe against the JAX module of the
same name (forward and the gradients of x, gate, w1, w2), and the explicit
adjoints of ops/moe_dispatch.py. On CPU tensors the port runs each kernel's plain
version, forward and backward."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import layers as jlayers
from micro_diffusion_tpu.ops import moe_ffn as jmoe
from micro_diffusion_tpu_torch.models import layers as tlayers
from micro_diffusion_tpu_torch.ops import moe_dispatch as tdispatch

tmoe = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _torch_grads(fn, *arrays, dtype=torch.float32):
    """fn's output and the gradients of sum(sin(fn(*args))) for every argument."""
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*args)
    torch.sin(out.float()).sum().backward()
    return out.detach().float().numpy(), [a.grad.float().numpy() for a in args]


def _jax_grads(fn, *arrays, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in arrays]
    loss = lambda *a: jnp.sum(jnp.sin(fn(*a).astype(jnp.float32)))
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(arrays)))))(*args)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def test_expert_major_matches_jax_kernel():
    """K3 at a supported shape (e=2, m=32, d=128, f=256), bf16: the plain forward and
    backward against the interpret-mode Pallas kernels, with K2's tolerances
    (tests/test_torch_ops.py, tests/test_torch_grads.py): 2e-2 absolute and
    relative, gradients scaled by their largest entry, since the bf16 roundings of a
    and da can flip by one ulp between summation orders."""
    e, m, d, f = 2, 32, 128, 256
    assert tmoe.supported_expert_major(m, d, f)
    xg, w1, w2 = rand((e, m, d), 3), rand((e, d, f), 4) * 0.05, rand((e, f, d), 5) * 0.05
    ref_out, ref = _jax_grads(lambda a, b, c: jmoe.moe_ffn_expert_major(a, b, c, True),
                              xg, w1, w2, dtype=jnp.bfloat16)
    out, got = _torch_grads(tmoe.moe_ffn_expert_major, xg, w1, w2, dtype=torch.bfloat16)
    np.testing.assert_allclose(out, ref_out, rtol=2e-2, atol=2e-2)
    for name, g, r in zip(("dx", "dw1", "dw2"), got, ref):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g / scale, r / scale, rtol=2e-2, atol=2e-2, err_msg=name)


def test_expert_major_contract_and_reference_path():
    """On CPU tensors K3's autograd Function runs the plain backward, which is the
    sample-major contract at n = 1; off the JAX rule's grid (m % 16 != 0) the port,
    like JAX, takes the plain products (_moe_ffn_em_ref, fp32 to 1e-5)."""
    xg = torch.from_numpy(rand((2, 32, 128), 6)).bfloat16().requires_grad_()
    w1 = torch.from_numpy(rand((2, 128, 256), 7) * 0.05).bfloat16().requires_grad_()
    w2 = torch.from_numpy(rand((2, 256, 128), 8) * 0.05).bfloat16().requires_grad_()
    do = torch.from_numpy(rand((2, 32, 128), 9)).bfloat16()
    out = tmoe.moe_ffn_expert_major(xg, w1, w2)
    assert torch.equal(out, tmoe.moe_ffn_plain(xg[None], w1, w2)[0])
    grads = torch.autograd.grad(out, (xg, w1, w2), do)
    for a, b_ in zip(grads, tmoe.moe_ffn_expert_major_bwd_plain(xg, w1, w2, do)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b_)

    e, m, d, f = 2, 24, 64, 96
    assert not tmoe.supported_expert_major(m, d, f)
    xs, v1, v2 = rand((e, m, d), 10), rand((e, d, f), 11) * 0.1, rand((e, f, d), 12) * 0.1
    ref = np.asarray(jax.jit(jmoe.moe_ffn_expert_major)(xs, v1, v2))
    got = tmoe.moe_ffn_expert_major(*map(torch.from_numpy, (xs, v1, v2)))
    assert got.grad_fn is None or got.grad_fn.name() != "_ExpertFFNBackward"
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# The kernel-shaped MoE of tests/test_torch_dit.py's KERNEL config: d = 128, f = 512,
# 4 experts at capacity 2 over t = 64 tokens (k = 32, m = n*k = 64), so JAX's
# 'onehot'/'hybrid' reach the interpret-mode K2 and 'gather' K3, and the port the
# kernels' plain versions.
_N, _T, _D, _E, _HIDDEN = 2, 64, 128, 4, 512


def _jax_moe(dispatch):
    return jlayers.FeedForwardECMoe(num_experts=_E, expert_capacity=2.0, dim=_D,
                                    hidden_dim=_HIDDEN, multiple_of=256, dtype=jnp.float32,
                                    dispatch=dispatch)


@pytest.mark.parametrize("dispatch", tlayers.MOE_DISPATCH)
def test_dispatch_matches_jax_module(dispatch):
    """fp32. The output to 1e-3, as tests/test_torch_dit.py holds the kernel-shaped
    config (the kernel contract rounds a = x @ w1 to bf16, and a one-ulp flip of
    that rounding between summation orders is possible); each gradient, scaled by
    its largest entry, to 2e-3, as tests/test_torch_train.py holds the same
    config's gradients (the backward contract also rounds da to bf16)."""
    x = rand((_N, _T, _D), 0)
    gate, w1, w2 = rand((_D, _E), 1) * 0.3, rand((_E, _D, _HIDDEN), 2) * 0.1, \
        rand((_E, _HIDDEN, _D), 3) * 0.1
    jm = _jax_moe(dispatch)

    def jfn(x, gate, w1, w2):
        return jm.apply({"params": {"gate": {"kernel": gate}, "w1": w1, "w2": w2}}, x)

    ref_out, ref = _jax_grads(jfn, x, gate, w1, w2)

    tm = tlayers.FeedForwardECMoe(_E, 2.0, _D, _HIDDEN, 256, dispatch=dispatch,
                                  dtype=torch.float32, device="cpu")

    def tfn(x, gate, w1, w2):
        params = {"gate.weight": gate.t(), "w1": w1, "w2": w2}
        return torch.func.functional_call(tm, params, (x,))

    out, got = _torch_grads(tfn, x, gate, w1, w2)
    np.testing.assert_allclose(out, ref_out, rtol=1e-3, atol=1e-3)
    for name, g, r in zip(("dx", "dgate", "dw1", "dw2"), got, ref):
        scale = float(np.abs(r).max())
        assert scale > 0, name
        np.testing.assert_allclose(g / scale, r / scale, rtol=2e-3, atol=2e-3, err_msg=name)


def test_dispatch_adjoints_and_determinism():
    """The explicit adjoints are those of the plain gather and one-hot scatter (fp32,
    1e-6), and the flat combine adds each expert's rows once: two calls agree
    bitwise, forward and backward."""
    rng = np.random.default_rng(20)
    n, t, e, k, d = 3, 16, 4, 5, 8
    m = torch.from_numpy(np.stack([[rng.choice(t, k, replace=False) for _ in range(e)]
                                   for _ in range(n)]))  # (n, e, k) distinct per expert
    x = torch.from_numpy(rand((n, t, d), 21)).requires_grad_()
    idx = m.reshape(n, e * k)
    plain_x = x.detach().clone().requires_grad_()
    for fn, plain in (
        (lambda a: tdispatch.dispatch_rows(a, idx),
         lambda a: torch.gather(a, 1, idx[..., None].expand(-1, -1, d))),
        (lambda a: tdispatch.combine_rows(tdispatch.dispatch_rows(a, idx), idx, t),
         lambda a: torch.zeros_like(a).scatter_add(
             1, idx[..., None].expand(-1, -1, d),
             torch.gather(a, 1, idx[..., None].expand(-1, -1, d)))),
    ):
        co = torch.from_numpy(rand(tuple(fn(x).shape), 22))
        got = torch.autograd.grad(fn(x), x, co)[0]
        want = torch.autograd.grad(plain(plain_x), plain_x, co)[0]
        torch.testing.assert_close(fn(x), plain(plain_x), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    gidx = (m + (torch.arange(n) * t)[:, None, None]).transpose(0, 1).reshape(e, n * k)
    flat = x.reshape(n * t, d)

    def flat_round_trip():
        rows = tdispatch.gather_expert_rows(flat, gidx)
        out = tdispatch.combine_expert_rows(rows * 0.5, gidx, n * t)
        return out, torch.autograd.grad(out, x, torch.ones_like(out))[0]

    (o1, g1), (o2, g2) = flat_round_trip(), flat_round_trip()
    assert torch.equal(o1, o2) and torch.equal(g1, g2)
    picks = torch.zeros(n * t).index_add_(0, gidx.reshape(-1), torch.ones(e * n * k))
    torch.testing.assert_close(o1, 0.5 * picks[:, None] * flat, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g1.reshape(n * t, d), picks[:, None].expand(-1, d) * 0.5,
                               rtol=1e-6, atol=1e-6)
