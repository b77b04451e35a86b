"""The port's hand-written CUDA kernels against their plain PyTorch versions at the
MicroDiT-XL sampling (forward) and stage-1 training (backward, fused adaLN) shapes,
the expert-major MoE kernels (K3) and the whole-K attention (K4) at the 512px ones,
the tiled attention with the saved logsumexp (K5) at the stage-2 and 512px ones,
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
tfa = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention")

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


# the forward's row statistics: m is the max of the same fp32 scores summed in
# another order, 1 / rowsum(e) an fp32 sum taken online across key tiles
STATS_TOL = 1e-3


def _stats_err(stats, ref):
    """(max |m - m_ref|, max relative error of 1 / rowsum(e))."""
    return ((stats[0] - ref[0]).abs().max().item(),
            ((stats[1] - ref[1]).abs() / ref[1].abs()).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h", [(256, 77, 77, 16), (256, 256, 256, 12),
                                       (256, 256, 77, 12), (256, 64, 64, 8),
                                       (256, 64, 64, 16), (256, 64, 77, 16),
                                       (8, 1024, 1024, 16), (8, 1024, 77, 16)])
def test_flash_attention_bwd_kernel_matches_plain(b, tq, tk, h):
    """The stage-1 shapes at mb 256 (caption, mixer self/cross, backbone self/cross)
    and the 512px ones; k and v strided views, as the model hands them. The forward
    saves the row statistics (against the plain forward's), the backward kernels
    match their plain version from the same out and statistics, and two calls are
    bitwise equal."""
    gen = _card()
    q = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * 64, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0].view(b, tk, h, 64), kv[:, :, 1].view(b, tk, h, 64)
    do = torch.randn(b, tq, h, 64, generator=gen, device="cuda").bfloat16()
    out, stats = tlane._forward_stats(q, k, v, 0.125)
    before = tlane.flash_attention_lane_bwd.launches
    got = tlane.flash_attention_lane_bwd(q, k, v, out, stats, do)
    again = tlane.flash_attention_lane_bwd(q, k, v, out, stats, do)
    torch.cuda.synchronize()
    assert tlane.flash_attention_lane_bwd.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref_out, ref_stats = tlane.flash_attention_lane_stats_plain(q, k, v)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL
    assert max(_stats_err(stats, ref_stats)) <= STATS_TOL
    ref = tlane.flash_attention_lane_bwd_saved_plain(q, k, v, out, stats, do)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
def test_flash_attention_forward_writes_stats_only_for_a_gradient():
    """Without a gradient the forward is the out-only operator (one launch, no
    statistics); with one, the autograd Function keeps (out, stats) from one
    launch."""
    gen = _card()
    q = torch.randn(4, 256, 2, 64, generator=gen, device="cuda").bfloat16()
    before = tlane.flash_attention_lane.launches
    with torch.no_grad():
        out = tlane.flash_attention_lane(q, q, q)
    assert isinstance(out, torch.Tensor) and out.shape == q.shape
    qg = q.clone().requires_grad_()
    out_g = tlane.flash_attention_lane(qg, qg, qg)
    torch.cuda.synchronize()
    assert tlane.flash_attention_lane.launches == before + 2
    assert torch.equal(out, out_g.detach())
    saved = out_g.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (2, 4, 2, 256)
    assert saved[4].dtype == torch.float32


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
    again = tmoe.moe_ffn_bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    assert tmoe.moe_ffn_bwd.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
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
    again = tmoe.moe_ffn_expert_major_bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    assert (tmoe.moe_ffn_expert_major.launches, tmoe.moe_ffn_expert_major_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = tmoe.moe_ffn_expert_major_plain(xg, w1, w2)
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    for g, r in zip(got, tmoe.moe_ffn_expert_major_bwd_plain(xg, w1, w2, do)):
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("layout,n,e,k,d,f", [
    ("em", 1, 2, 48, 128, 768), ("em", 1, 3, 1040, 512, 768), ("em", 1, 2, 1040, 768, 512),
    ("em", 1, 2, 48, 1024, 768), ("em", 1, 1, 16, 256, 256),
    ("moe", 4, 2, 48, 1024, 768), ("moe", 3, 2, 48, 128, 256), ("moe", 5, 3, 16, 768, 768),
    ("moe", 2, 2, 32, 512, 1024), ("moe", 3, 2, 80, 384, 512), ("moe", 2, 2, 192, 640, 256),
])
def test_moe_kernels_at_ragged_and_odd_shapes(layout, n, e, k, d, f):
    """The expert FFN kernels off the 128-row grid: expert-major m = 48 and 1040
    (row tiles past the end, read as zeros and not stored), sample-major runs of k =
    48 and 80 (16-row boxes), 16 and 32 (boxes spanning runs) and 192 rows, d from 128
    to 1024 (128- and 256-wide output tiles), f from 256. Forward and backward against
    the plain versions, the backward twice and bitwise equal, one count per call."""
    gen = _card()
    shape = (e, k, d) if layout == "em" else (n, e, k, d)
    xg = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    w1 = (0.02 * torch.randn(e, d, f, generator=gen, device="cuda")).bfloat16()
    w2 = (0.02 * torch.randn(e, f, d, generator=gen, device="cuda")).bfloat16()
    do = torch.randn(*shape, generator=gen, device="cuda").bfloat16()
    if layout == "em":
        fwd, bwd = tmoe.moe_ffn_expert_major, tmoe.moe_ffn_expert_major_bwd
        fwd_plain, bwd_plain = tmoe.moe_ffn_expert_major_plain, tmoe.moe_ffn_expert_major_bwd_plain
    else:
        fwd, bwd = tmoe.moe_ffn, tmoe.moe_ffn_bwd
        fwd_plain, bwd_plain = tmoe.moe_ffn_plain, tmoe.moe_ffn_bwd_plain
    before = fwd.launches, bwd.launches
    out = fwd(xg, w1, w2)
    got = bwd(xg, w1, w2, do)
    again = bwd(xg, w1, w2, do)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 2)
    assert out.shape == xg.shape and out.dtype == torch.bfloat16
    assert (out.float() - fwd_plain(xg, w1, w2).float()).abs().max().item() <= TOL
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, r in zip(got, bwd_plain(xg, w1, w2, do)):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
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
    out, stats = tbh._forward_stats(q, k, v, d**-0.5)
    got = tbh.flash_attention_bh_bwd(q, k, v, out, stats, do)
    again = tbh.flash_attention_bh_bwd(q, k, v, out, stats, do)
    torch.cuda.synchronize()
    assert (tbh.flash_attention_bh.launches, tbh.flash_attention_bh_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref, ref_stats = tbh.flash_attention_bh_stats_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    assert max(_stats_err(stats, ref_stats)) <= STATS_TOL
    for g, r in zip(got, tbh.flash_attention_bh_bwd_saved_plain(q, k, v, out, stats, do)):
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d", [(64, 256, 256, 16, 64), (64, 256, 77, 12, 64),
                                         (64, 77, 77, 16, 64), (8, 1024, 1024, 16, 64),
                                         (8, 1024, 77, 16, 64), (4, 512, 77, 5, 32),
                                         (2, 200, 120, 3, 16), (2, 77, 77, 1, 32)])
def test_flash_attention_lse_kernels_match_plain(b, tq, tk, h, d):
    """K5 forward (out and the row logsumexp) and backward at XL stage-2 shapes
    (mb 64), the 512px ones, other head dims, odd head counts and ragged lengths;
    k and v strided views of one packed tensor. lse to 1e-3 absolute (fp32 sums of
    the same exponentials in another order). The backward runs K1b/K4b's kernels in
    their lse form; two calls are bitwise equal."""
    gen = _card()
    q = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(b, tk, 2, h * d, generator=gen, device="cuda").bfloat16()
    k, v = kv[:, :, 0].view(b, tk, h, d), kv[:, :, 1].view(b, tk, h, d)
    do = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
    before = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    out, lse = tfa._forward(q, k, v, d**-0.5)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref, ref_lse = tfa.flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL
    assert _rel_err(out, ref) <= TOL
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for g, r in zip(got, tfa.flash_attention_bwd_plain(q, k, v, out, lse, do)):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _rel_err(g, r) <= BWD_TOL


@pytest.mark.cuda
def test_flash_attention_lse_refuses_what_it_does_not_take():
    """fp32 raises; a head_dim the kernels are not built for raises on the card, as
    does a length the JAX tiling refuses; through autograd one forward and one
    backward launch."""
    gen = _card()
    q = torch.zeros(2, 64, 3, 32, device="cuda")
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)
    q48 = torch.zeros(2, 64, 3, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q48, q48, q48)
    q300 = torch.zeros(1, 300, 1, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q300, q300, q300)
    qb = torch.randn(2, 64, 3, 32, generator=gen, device="cuda").bfloat16().requires_grad_()
    before = tfa.flash_attention.launches, tfa.flash_attention_bwd.launches
    tfa.flash_attention(qb, qb, qb).float().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("tq", [1, 64, 65, 77, 128, 129, 1024])
def test_attention_forward_at_the_tiling_edges(tq, d):
    """The one forward kernel at each Tk of (1, 63, 64, 77, 128, 1024): through the
    lane wrapper (K1, D = 64) or the bh one (K4) with the row statistics, and through
    K5's with the logsumexp; k and v strided views of one packed tensor. out, stats
    and lse against the plain versions, each bitwise equal across two calls."""
    gen = _card()
    b, h = 2, 2
    mod = tlane if d == 64 else tbh
    for tk in (1, 63, 64, 77, 128, 1024):
        q = torch.randn(b, tq, h, d, generator=gen, device="cuda").bfloat16()
        kv = torch.randn(b, tk, 2, h * d, generator=gen, device="cuda").bfloat16()
        k, v = kv[:, :, 0].view(b, tk, h, d), kv[:, :, 1].view(b, tk, h, d)
        out, stats = mod._forward_stats(q, k, v, d**-0.5)
        out2, stats2 = mod._forward_stats(q, k, v, d**-0.5)
        o5, lse = tfa._forward(q, k, v, d**-0.5)
        o52, lse2 = tfa._forward(q, k, v, d**-0.5)
        torch.cuda.synchronize()
        what = f"tq {tq} tk {tk} d {d}"
        assert torch.equal(out, out2) and torch.equal(stats, stats2), what
        assert torch.equal(o5, o52) and torch.equal(lse, lse2), what
        ref, ref_stats = tlane.flash_attention_lane_stats_plain(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() <= TOL, what
        assert _rel_err(out, ref) <= TOL, what
        assert max(_stats_err(stats, ref_stats)) <= STATS_TOL, what
        ref5, ref_lse = tfa.flash_attention_plain(q, k, v)
        assert (o5.float() - ref5.float()).abs().max().item() <= TOL, what
        assert _rel_err(o5, ref5) <= TOL, what
        assert (lse - ref_lse).abs().max().item() <= 1e-3, what
