"""The port's hand-written CUDA kernels against their plain PyTorch versions at the
MicroDiT-XL sampling (forward) and stage-1 training (backward) shapes, in bf16 on
the card. Marked `cuda`: each test skips
without a card (decided inside the test). Run on the card with

    python -m pytest tests/test_torch_kernels.py -q -m cuda
"""

import importlib

import pytest
import torch

tlane = importlib.import_module("micro_diffusion_tpu_torch.ops.flash_attention_lane")
tmoe = importlib.import_module("micro_diffusion_tpu_torch.ops.moe_ffn")

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
