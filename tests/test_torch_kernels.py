"""The port's hand-written CUDA kernels against their plain PyTorch versions at the
MicroDiT-XL sampling (forward) and stage-1 training (backward, fused adaLN) shapes,
the expert-major MoE kernels (K3) and the whole-K attention (K4) at the 512px ones,
in bf16 on the card. Marked `cuda`: each test skips
without a card (decided inside the test). Run on the card with

    python -m pytest tests/test_torch_kernels.py -q -m cuda
"""

import importlib

import pytest
import torch

tlane = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
tmoe = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")
tadaln = importlib.import_module("micro_diffusion_tpu_torch.ops.adaln")

# bf16 outputs of magnitude <~ 1: a few bf16 ulps (the kernel's online softmax and
# summation order differ from the plain version's)
TOL = 2e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,h", [(256, 256, 8), (256, 256, 16), (256, 77, 12),
                                     (77, 77, 16), (64, 64, 16), (1024, 1024, 16),
                                     (1024, 77, 16), (256, 120, 16)])
def test_flash_attention_kernel_matches_plain(tq, tk, h):
    gen = _card()
    b = 8
    q = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * 64, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0].view(b, tk, h, 64), kv[:, :, 1].view(b, tk, h, 64)  # strided
    before = tlane.flash_attention_lane.launches
    out = tlane.flash_attention_lane(q, k, v)
    torch.cuda.synchronize()
    assert tlane.flash_attention_lane.launches == before + 1
    ref = tlane.flash_attention_lane_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,f", [(64, 768, 3072), (64, 1024, 768), (64, 1024, 3840),
                                   (256, 1024, 3840), (16, 128, 256)])
def test_moe_ffn_kernel_matches_plain(k, d, f):
    gen = _card()
    n, e = 8, 8
    xg = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    w1 = (0.02 * torch.randn(e, d, f, generator=gen, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(e, f, d, generator=gen, device="cuda")).bfloat16()
    before = tmoe.moe_ffn.launches
    out = tmoe.moe_ffn(xg, w1, w2)
    torch.cuda.synchronize()
    assert tmoe.moe_ffn.launches == before + 1
    ref = tmoe.moe_ffn_plain(xg, w1, w2)
    assert (out.float() - ref.float()).abs().max().item() <= TOL


# Backward kernels: tolerance relative to the largest entry of each gradient. dk,
# dv and dw sum over many rows in fp32 and are stored in bf16, so one ulp there is
# 2^-8 of the entry; 1e-2 of the scale allows a couple of ulps of the largest.
BWD_TOL = 1e-2


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h", [(256, 77, 77, 16), (256, 256, 256, 12),
                                       (256, 256, 77, 12), (256, 64, 64, 8),
                                       (256, 64, 64, 16), (256, 64, 77, 16),
                                       (8, 1024, 1024, 16), (8, 1024, 77, 16)])
def test_flash_attention_bwd_kernel_matches_plain(b, tq, tk, h):
    """The stage-1 shapes at mb 256 (caption, mixer self/cross, backbone self/cross)
    and the 512px ones; k and v strided views, as the model hands them."""
    gen = _card()
    q = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * 64, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0].view(b, tk, h, 64), kv[:, :, 1].view(b, tk, h, 64)
    do = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    before = tlane.flash_attention_lane_bwd.launches
    got = tlane.flash_attention_lane_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert tlane.flash_attention_lane_bwd.launches == before + 1
    ref = tlane.flash_attention_lane_bwd_plain(q, k, v, do)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,f", [(64, 768, 3072), (16, 1024, 768), (16, 1024, 2304),
                                   (16, 1024, 3840), (256, 1024, 3840)])
def test_moe_ffn_bwd_kernel_matches_plain(k, d, f):
    """Stage-1 mixer and backbone widths (n = 64 of the 256 samples, to keep the
    plain version quick) and the 512px shape."""
    gen = _card()
    n, e = 64 if k < 256 else 8, 8
    xg = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    w1 = (0.02 * torch.randn(e, d, f, generator=gen, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(e, f, d, generator=gen, device="cuda")).bfloat16()
    do = torch.randn(n, e, k, d, generator=gen, device="cuda").bfloat16()
    before = tmoe.moe_ffn_bwd.launches
    got = tmoe.moe_ffn_bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    assert tmoe.moe_ffn_bwd.launches == before + 1
    for g, r in zip(got, tmoe.moe_ffn_bwd_plain(xg, w1, w2, do)):
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    """fp32 inputs raise; inputs that require grad now run the backward kernels
    through autograd (one forward and one backward launch each)."""
    gen = _card()
    q = torch.zeros(2, 64, 2, 64, device="cuda")  # fp32
    with pytest.raises(TypeError):
        tlane.flash_attention_lane(q, q, q)
    qb = torch.randn(2, 64, 2, 64, generator=gen, device="cuda").bfloat16().requires_grad_()
    before = tlane.flash_attention_lane.launches, tlane.flash_attention_lane_bwd.launches
    tlane.flash_attention_lane(qb, qb, qb).float().sum().backward()
    torch.cuda.synchronize()
    assert (tlane.flash_attention_lane.launches, tlane.flash_attention_lane_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(qb.grad.float()).all()
    xg = torch.zeros(2, 2, 16, 128, device="cuda", dtype=torch.bfloat16)
    w1 = torch.zeros(2, 128, 256, device="cuda", dtype=torch.bfloat16).requires_grad_()
    w2 = torch.zeros(2, 256, 128, device="cuda", dtype=torch.bfloat16)
    before = tmoe.moe_ffn.launches, tmoe.moe_ffn_bwd.launches
    tmoe.moe_ffn(xg, w1, w2).float().sum().backward()
    torch.cuda.synchronize()
    assert (tmoe.moe_ffn.launches, tmoe.moe_ffn_bwd.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        tmoe.moe_ffn(xg.float(), w1.float(), w2.float())


@pytest.mark.cuda
@pytest.mark.parametrize("use_weight", [True, False])
@pytest.mark.parametrize("b,t,d", [(256, 256, 768), (256, 64, 1024), (16, 256, 512),
                                   (32, 1024, 768), (3, 5, 8)])
def test_layernorm_modulate_kernel_matches_plain(b, t, d, use_weight):
    """K6 at the trainer path's shapes (and a ragged small one), shift and scale as
    strided chunks of one (B, 6D) projection, as the DiT block hands them over.
    Tolerance relative to the largest output entry: the output is rounded to bf16
    once (2^-8 of an entry); a backward through autograd launches once more."""
    gen = _card()
    x = torch.randn(b, t, d, generator=gen, device="cuda").bfloat16()
    mod = (0.5 * torch.randn(b, 6 * d, generator=gen, device="cuda")).bfloat16()
    shift, scale = mod.chunk(6, dim=1)[:2]
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")) if use_weight else None
    before = tadaln.layernorm_modulate.launches
    out = tadaln.layernorm_modulate(x, w, shift, scale)
    torch.cuda.synchronize()
    assert tadaln.layernorm_modulate.launches == before + 1
    ref = tadaln.layernorm_modulate_plain(x, w, shift, scale)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert _rel_err(out, ref) <= BWD_TOL
    xg = x.clone().requires_grad_()
    tadaln.layernorm_modulate(xg, w, shift, scale).float().square().sum().backward()
    torch.cuda.synchronize()
    assert tadaln.layernorm_modulate.launches == before + 2
    assert torch.isfinite(xg.grad.float()).all()


@pytest.mark.cuda
def test_layernorm_modulate_refuses_what_it_does_not_take():
    _card()
    x = torch.zeros(2, 4, 64, device="cuda")
    s = torch.zeros(2, 64, device="cuda")
    with pytest.raises(TypeError):
        tadaln.layernorm_modulate(x, None, s, s)  # fp32
    xb = torch.zeros(2, 4, 1032, device="cuda", dtype=torch.bfloat16)
    sb = torch.zeros(2, 1032, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tadaln.layernorm_modulate(xb, None, sb, sb)  # D above the register row


tbh = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_bh")


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,d,f", [(8, 2048, 1024, 3840), (8, 8192, 768, 3072),
                                     (8, 4096, 1024, 768), (8, 8192, 512, 2048),
                                     (2, 48, 128, 256)])
def test_moe_ffn_expert_major_kernels_match_plain(e, m, d, f):
    """K3 forward and backward at the 512px path's expert-major shapes (XL stage-3
    backbone and mixer, stage 4; Tiny's mixer) and a small one; m up to 8192 rows
    per expert."""
    gen = _card()
    xg = torch.randn(e, m, d, generator=gen, device="cuda").bfloat16()
    w1 = (0.02 * torch.randn(e, d, f, generator=gen, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(e, f, d, generator=gen, device="cuda")).bfloat16()
    do = torch.randn(e, m, d, generator=gen, device="cuda").bfloat16()
    before = tmoe.moe_ffn_expert_major.launches, tmoe.moe_ffn_expert_major_bwd.launches
    out = tmoe.moe_ffn_expert_major(xg, w1, w2)
    got = tmoe.moe_ffn_expert_major_bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    assert (tmoe.moe_ffn_expert_major.launches, tmoe.moe_ffn_expert_major_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = tmoe.moe_ffn_expert_major_plain(xg, w1, w2)
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    for g, r in zip(got, tmoe.moe_ffn_expert_major_bwd_plain(xg, w1, w2, do)):
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d", [(16, 1024, 1024, 16, 32), (16, 1024, 77, 16, 32),
                                         (16, 1024, 1024, 8, 32), (4, 1024, 1024, 3, 16),
                                         (4, 512, 77, 5, 16), (2, 300, 200, 3, 64),
                                         (2, 77, 77, 1, 32)])
def test_flash_attention_bh_kernels_match_plain(b, tq, tk, h, d):
    """K4 forward and backward at Tiny's 512px shapes (D = 32), Micro's D = 16, odd
    head counts and ragged lengths; k and v strided views of one packed tensor, as
    the cross-attention hands them over."""
    gen = _card()
    q = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * d, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0].view(b, tk, h, d), kv[:, :, 1].view(b, tk, h, d)
    do = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    before = tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches
    out = tbh.flash_attention_bh(q, k, v)
    got = tbh.flash_attention_bh_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert (tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = tbh.flash_attention_bh_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    for g, r in zip(got, tbh.flash_attention_bh_bwd_plain(q, k, v, do)):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
def test_k3_k4_refuse_what_they_do_not_take():
    """fp32 raises; a head_dim the K4 kernels are not built for raises on the card
    (never the plain version quietly); through autograd each launches once forward
    and once backward."""
    gen = _card()
    q = torch.zeros(2, 64, 3, 32, device="cuda")
    with pytest.raises(TypeError):
        tbh.flash_attention_bh(q, q, q)
    q48 = torch.zeros(2, 64, 3, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tbh.flash_attention_bh(q48, q48, q48)
    qb = torch.randn(2, 64, 3, 32, generator=gen, device="cuda").bfloat16().requires_grad_()
    before = tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches
    tbh.flash_attention_bh(qb, qb, qb).float().sum().backward()
    torch.cuda.synchronize()
    assert (tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    xg = torch.zeros(2, 32, 128, device="cuda", dtype=torch.bfloat16)
    w1 = torch.zeros(2, 128, 256, device="cuda", dtype=torch.bfloat16).requires_grad_()
    w2 = torch.zeros(2, 256, 128, device="cuda", dtype=torch.bfloat16)
    before = tmoe.moe_ffn_expert_major.launches, tmoe.moe_ffn_expert_major_bwd.launches
    tmoe.moe_ffn_expert_major(xg, w1, w2).float().sum().backward()
    torch.cuda.synchronize()
    assert (tmoe.moe_ffn_expert_major.launches, tmoe.moe_ffn_expert_major_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        tmoe.moe_ffn_expert_major(xg.float(), w1.float(), w2.float())
