"""The PyTorch port's attention and fused-MoE ops against the JAX package's, on the
same numpy inputs: on CPU tensors the port runs each kernel's plain version, JAX
runs XLA or the Pallas kernel in interpret mode."""

import importlib
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.ops import attention as jattention
from micro_diffusion_tpu.ops import flash_attention_lane as jlane
from micro_diffusion_tpu.ops import moe_ffn as jmoe
from micro_diffusion_tpu_torch.ops import _build
from micro_diffusion_tpu_torch.ops import attention as tattention

tlane = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
tmoe = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("tq,tk,h", [(256, 256, 4), (128, 77, 16), (64, 64, 2)])
def test_attention_matches_jax(tq, tk, h):
    """fp32, tolerance 2e-5 as tests/test_flash_attention.py holds the lane kernel."""
    b, d = 2, 64
    q, k, v = rand((b, tq, h, d), 0), rand((b, tk, h, d), 1), rand((b, tk, h, d), 2)
    ref_xla = np.asarray(jax.jit(
        lambda q, k, v: jattention._xla_attention(q, k, v, d**-0.5))(q, k, v))
    ref_lane = np.asarray(jax.jit(
        lambda q, k, v: jlane.flash_attention_lane(q, k, v, None, True))(q, k, v))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    outs = {
        "dispatch": tattention.dot_product_attention(qt, kt, vt).numpy(),
        "lane": tlane.flash_attention_lane(qt, kt, vt).numpy(),
        "lane_impl": tattention.dot_product_attention(qt, kt, vt, impl="flash").numpy(),
    }
    for name, out in outs.items():
        for ref in (ref_xla, ref_lane):
            np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5, err_msg=name)


def _moe_inputs(n, e, k, d, f, dtype):
    xg, w1, w2 = rand((n, e, k, d), 3), rand((e, d, f), 4) * 0.05, rand((e, f, d), 5) * 0.05
    jx = [jnp.asarray(a, dtype) for a in (xg, w1, w2)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(a).to(tdt) for a in (xg, w1, w2)]
    return jx, tx


@pytest.mark.parametrize("n,e,k,d,f", [(2, 8, 16, 128, 512), (8, 2, 256, 128, 1024)])
def test_moe_ffn_matches_jax_kernel(n, e, k, d, f):
    """bf16, tolerance 2e-2 as tests/test_moe.py holds the Pallas kernel."""
    (jx, jw1, jw2), (tx, tw1, tw2) = _moe_inputs(n, e, k, d, f, jnp.bfloat16)
    assert tmoe.supported(n, e, k, d, f)
    ref = jax.jit(lambda a, b, c: jmoe.moe_ffn(a, b, c, interpret=True))(jx, jw1, jw2)
    out = tmoe.moe_ffn(tx, tw1, tw2)
    assert out.dtype == torch.bfloat16 and out.shape == (n, e, k, d)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_moe_ffn_unsupported_shape_takes_reference_path():
    """k % 16 != 0: JAX takes its XLA path; so does the port (_moe_ffn_ref, not the
    kernel contract with its bf16 roundings), fp32 to 1e-5."""
    n, e, k, d, f = 2, 4, 8, 64, 96
    assert not tmoe.supported(n, e, k, d, f) and not jmoe.supported(n, e, k, d, f)
    (jx, jw1, jw2), (tx, tw1, tw2) = _moe_inputs(n, e, k, d, f, jnp.float32)
    ref = jax.jit(jmoe.moe_ffn)(jx, jw1, jw2)
    out = tmoe.moe_ffn(tx, tw1, tw2)
    assert torch.equal(out, tmoe._moe_ffn_ref(tx, tw1, tw2))
    assert not torch.equal(out, tmoe.moe_ffn_plain(tx, tw1, tw2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_supported_agrees_with_jax():
    for n, e, k, d, f in itertools.product((1, 2, 8), (4, 8), (8, 16, 32, 64, 77, 256),
                                           (64, 128, 768, 1000, 1024),
                                           (200, 256, 768, 3072, 3840)):
        assert tmoe.supported(n, e, k, d, f) == jmoe.supported(n, e, k, d, f)
    for h, d in itertools.product(range(1, 17), (16, 32, 64, 128)):
        assert tlane.supported(h, d) == jlane.supported(h, d)


def test_cpu_tensors_never_launch_kernels():
    counters = (tlane.flash_attention_lane, tlane.flash_attention_lane_bwd, tmoe.moe_ffn,
                tmoe.moe_ffn_bwd)
    before = [fn.launches for fn in counters]
    q = torch.from_numpy(rand((1, 64, 2, 64), 6)).requires_grad_()
    tlane.flash_attention_lane(q, q, q).sum().backward()
    tattention.dot_product_attention(q, q, q, impl="flash_lane")
    x = torch.from_numpy(rand((2, 2, 16, 128), 7)).bfloat16()
    w1 = torch.from_numpy(rand((2, 128, 256), 8)).bfloat16().requires_grad_()
    w2 = torch.from_numpy(rand((2, 256, 128), 9)).bfloat16()
    tmoe.moe_ffn(x, w1, w2).float().sum().backward()
    assert q.grad is not None and w1.grad is not None
    assert [fn.launches for fn in counters] == before


def test_unported_attention_impls_raise():
    """Every TPU attention kernel is ported, so no impl name raises for want of one:
    a name the JAX dispatch does not know raises ValueError; 'flash_bh', 'flash' off
    the lane shapes (head_dim 16: the bh kernel, K4) and 'flash_bthd' (K5) run, on a
    CPU tensor through their plain versions, which are the plain attention's
    function; K5 refuses a length its tiling does not take, as the JAX kernel does."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattention.dot_product_attention(q, q, q, impl="flash_nope")
    q16 = torch.from_numpy(rand((1, 8, 3, 16), 10))
    ref = tattention._xla_attention(q16, q16, q16, 16**-0.5)
    for impl in ("flash_bh", "flash", "flash_bthd"):
        out = tattention.dot_product_attention(q16, q16, q16, impl=impl)
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    q300 = torch.zeros(1, 300, 1, 16)
    with pytest.raises(ValueError, match="flash_attention"):
        tattention.dot_product_attention(q300, q300, q300, impl="flash_bthd")


def test_build_sources_are_the_csrc_files():
    """ops/_build.py builds every CUDA source under csrc/ and names no other."""
    on_disk = {f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu")}
    assert sorted(_build.SOURCES) == sorted(on_disk)
    assert len(set(_build.SOURCES)) == len(_build.SOURCES)
