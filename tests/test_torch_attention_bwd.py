"""The attention backward of K1b/K4b from the forward's saved row statistics, on the
CPU: the plain version of the kernels' function (``flash_attention_lane_bwd_saved_plain``,
delta from (do, out)) against the exact contract (``flash_attention_lane_bwd_plain``)
and against jax.grad of the JAX package's interpret-mode Pallas kernels
(``flash_attention_lane`` at D = 64, ``flash_attention_bh`` at D = 16 and 32), at a
ragged key length (77 caption tokens) and 64 query rows; the forward's statistics
against the row max and row sum computed on their own; the autograd Function
saving (out, stats) under every remat policy; and a plain mirror of the per-row
formulation that the backward kernels share between K1b/K4b (stats) and K5b (lse)
against both contracts."""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.ops import flash_attention_bh as jbh
from micro_diffusion_tpu.ops import flash_attention_lane as jlane
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.ops.remat_names import current_name

from test_torch_remat import _NamedOps

tlane = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
tbh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")
tfa = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention")

TQ, TK = 64, 77


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _inputs(d, h=3, b=2, dtype=torch.float32):
    return [torch.from_numpy(rand(s, i)).to(dtype) for i, s in enumerate(
        [(b, TQ, h, d), (b, TK, h, d), (b, TK, h, d), (b, TQ, h, d)])]


def _scaled_err(got, ref):
    """max |got - ref| over max |ref|, in fp32."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


# fp32: out is exact in fp32, so delta from (do, out) is the contract's up to fp32
# rounding (1e-5 of the largest entry). bf16: out is rounded to bf16, the one
# departure; 2e-2 of the largest entry, the scale at which the bf16 CPU tests hold
# the backward against JAX (a few bf16 ulps of the largest gradient entry).
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_saved_plain_matches_the_exact_contract(d, dtype, tol):
    q, k, v, do = _inputs(d, dtype=dtype)
    out, stats = tlane.flash_attention_lane_stats_plain(q, k, v)
    got = tlane.flash_attention_lane_bwd_saved_plain(q, k, v, out, stats, do)
    ref = tlane.flash_attention_lane_bwd_plain(q, k, v, do)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _scaled_err(g, r) <= tol, name
    # dv takes no delta: it is the contract's exactly
    assert torch.equal(got[2], ref[2])


def _jax_grads(jfn, arrays, dtype):
    loss = lambda q, k, v: jnp.sum(jnp.sin(jfn(q, k, v).astype(jnp.float32)))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*[jnp.asarray(a, dtype) for a in arrays])
    return [np.asarray(g, np.float32) for g in grads]


_JAX = {"lane": lambda q, k, v: jlane.flash_attention_lane(q, k, v, None, True),
        "bh": lambda q, k, v: jbh.flash_attention_bh(q, k, v, None, True)}
_TORCH = {"lane": lambda: tlane.flash_attention_lane, "bh": lambda: tbh.flash_attention_bh}


# fp32 to 2e-4, as tests/test_torch_grads.py holds K1b's plain version against JAX;
# bf16 to 2e-2 of the largest entry, as tests/test_torch_flash_bh.py holds K4's.
@pytest.mark.parametrize("impl,d,h", [("lane", 64, 2), ("bh", 16, 3), ("bh", 32, 5)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_autograd_backward_matches_jax(impl, d, h, dtype, tol):
    q, k, v, _ = _inputs(d, h=h)
    arrays = [x.numpy() for x in (q, k, v)]
    ref = _jax_grads(_JAX[impl], arrays, getattr(jnp, dtype))
    args = [x.to(getattr(torch, dtype)).requires_grad_() for x in (q, k, v)]
    torch.sin(_TORCH[impl]()(*args).float()).sum().backward()
    for name, a, r in zip("qkv", args, ref):
        g = a.grad.float().numpy()
        scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g / scale, r / scale, rtol=tol, atol=tol,
                                   err_msg=f"{impl} d{name}")


@pytest.mark.parametrize("d", [16, 32, 64])
def test_forward_stats_are_the_row_max_and_sum(d):
    """stats[0] is the row max of the unscaled q k^T, stats[1] 1 / rowsum(e), both
    recomputed here in float64. fp32 inputs: the max to 1e-6 (one fp32 rounding of
    a dot product), 1 / l to 1e-5 relative (an fp32 sum of 77 terms can be off by
    77 * 2^-24 ~ 4.6e-6)."""
    q, k, v, _ = _inputs(d)
    out, stats = tlane.flash_attention_lane_stats_plain(q, k, v)
    assert stats.shape == (2, 2, 3, TQ) and stats.dtype == torch.float32
    torch.testing.assert_close(out, tlane.flash_attention_lane_plain(q, k, v), rtol=0, atol=0)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    m = s.amax(dim=-1)
    l = torch.exp2((s - m[..., None]) * (d**-0.5 * np.log2(np.e))).sum(dim=-1)
    torch.testing.assert_close(stats[0].double(), m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[1].double(), 1.0 / l, rtol=1e-5, atol=0)


@pytest.mark.parametrize("policy", ["none", "full", "dots", "attn_moe", "dots_attn_moe"])
def test_function_saves_out_and_stats_under_remat(policy, monkeypatch):
    """The Micro DiT (head_dim 16) with attention_impl 'flash_bh': every block
    attention's backward receives the forward's out and stats; under the 'attn_moe'
    policies the backward re-runs no named attention operator (out and stats come
    from the cache), under 'full' it does; the gradients equal those without remat
    (fp32, 1e-6)."""
    kw = dict(input_size=16, caption_channels=32, device="cpu", dtype=torch.float32,
              attention_impl="flash_bh")
    plain = tdit.MicroDiT_Micro_2(**kw).init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():  # make the adaLN-zero gates live
        for p in plain.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(3))
    x, y = torch.from_numpy(rand((2, 4, 16, 16), 3)), torch.from_numpy(rand((2, 8, 32), 4))

    def grads(remat_policy):
        model = tdit.MicroDiT_Micro_2(remat=remat_policy != "none",
                                      remat_policy=remat_policy if remat_policy != "none"
                                      else "full", **kw)
        model.load_state_dict(plain.state_dict())
        out = model(x, torch.zeros(2), y, mask_ratio=0.5,
                    generator=torch.Generator().manual_seed(5))["sample"]
        with _NamedOps() as named:
            g = torch.autograd.grad(out.square().mean(), list(model.parameters()))
        return g, {name for name, _ in named.ops}

    ref, _ = grads("none")
    calls = []
    bwd = tbh.flash_attention_bh_bwd

    def recording(q, k, v, out, stats, do, scale=None):
        b, tq, h, _ = q.shape
        assert out.shape == q.shape and out.dtype == q.dtype
        assert stats.shape == (2, b, h, tq) and stats.dtype == torch.float32
        calls.append(current_name())
        return bwd(q, k, v, out, stats, do, scale)

    monkeypatch.setattr(tbh, "flash_attention_bh_bwd", recording)
    got, rerun = grads(policy)
    assert len(calls) > 0
    attn_rerun = rerun & {"attn_out", "xattn_out"}
    if policy in ("attn_moe", "dots_attn_moe", "none"):
        assert attn_rerun == set()
    else:
        assert attn_rerun == {"attn_out", "xattn_out"}
    for a, b_ in zip(ref, got):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)


def _shared_kernels_mirror(q, k, v, out, rowv, do, scale, lse_form):
    """The backward kernels' per-row formulation (csrc/flash_attention_lane_bwd.cu) in
    plain PyTorch. Per query row the dq kernel's prologue sets the exponent offset mc
    and the packed copies q_s, do_s; the products then apply one factor to ds before
    its rounding and one to dq's accumulator:

        form    mc                  q_s                      do_s             ds    dq
        stats   m * scale * log2 e  bf16(q * scale * inv_l)  bf16(do * inv_l) 1     scale * inv_l
        lse     lse * log2 e        q                        do               scale 1
    """
    dt = q.dtype
    c = scale * math.log2(math.e)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    qf = q.float().permute(0, 2, 1, 3)                          # (B, H, Tq, D)
    dof = do.float().permute(0, 2, 1, 3)
    if lse_form:
        mc = rowv[..., None] * math.log2(math.e)
        q_s, do_s, ds_f, dq_f = qf, dof, scale, 1.0
    else:
        m, inv_l = rowv[0][..., None], rowv[1][..., None]
        mc = m * c
        q_s = (qf * (scale * inv_l)).to(dt).float()
        do_s = (dof * inv_l).to(dt).float()
        ds_f, dq_f = 1.0, scale * inv_l
    e = torch.exp2(s * c - mc)
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bhqd,bkhd->bhqk", dof, v.float())
    ds = (e * (dp - delta) * ds_f).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bhqd", ds, k.float()) * dq_f
    dk = torch.einsum("bhqk,bhqd->bkhd", ds, q_s)
    dv = torch.einsum("bhqk,bhqd->bkhd", e.to(dt).float(), do_s)
    return dq.permute(0, 2, 1, 3).to(dt), dk.to(dt), dv.to(dt)


# Tolerances as test_saved_plain_matches_the_exact_contract: the mirror takes the
# exponent as one FFMA (s c - mc) where the plain versions subtract first, so fp32
# agrees to rounding (1e-5 of the largest entry) and bf16 to a few ulps of it.
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("form", ["stats", "lse"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_shared_backward_per_row_values_match_both_contracts(d, form, dtype, tol):
    """The stats form against K1b/K4b's plain version (flash_attention_lane_bwd_saved_plain),
    the lse form against K5b's contract (flash_attention_bwd_plain), from each
    forward's own out and saved row values."""
    q, k, v, do = _inputs(d, dtype=dtype)
    scale = d**-0.5
    if form == "lse":
        out, rowv = tfa.flash_attention_plain(q, k, v)
        ref = tfa.flash_attention_bwd_plain(q, k, v, out, rowv, do)
    else:
        out, rowv = tlane.flash_attention_lane_stats_plain(q, k, v)
        ref = tlane.flash_attention_lane_bwd_saved_plain(q, k, v, out, rowv, do)
    got = _shared_kernels_mirror(q, k, v, out, rowv, do, scale, form == "lse")
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert _scaled_err(g, r) <= tol, name
