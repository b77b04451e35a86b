"""The frozen work counts against their shape formulas and against PyTorch's own
FLOP counter on the plain reference."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs
from benchmark.reference import edm
from benchmark.reference.dit import MicroDiT
from benchmark.work import flops

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def model_block(name, where=HERE):
    d = os.path.join(where, "configs") if where == HERE else where
    with open(os.path.join(d, name + ".json")) as f:
        return json.load(f)


def _reference(m, rows, mask_ratio, seed=0):
    torch.manual_seed(seed)
    model = MicroDiT(m)
    inputs.fill_weights(dict(model.named_parameters()), seed)
    t = (m["latent_res"] // m["patch_size"]) ** 2
    x = torch.randn(rows, m["in_channels"], m["latent_res"], m["latent_res"])
    y = torch.randn(rows, m["caption_len"], m["caption_channels"])
    mask = None
    if mask_ratio > 0:
        keep = int(t * (1 - mask_ratio))
        shuffle = torch.argsort(torch.rand(rows, t), dim=1)
        mask = (shuffle[:, :keep], torch.argsort(shuffle, dim=1))
    return model, x, y, mask


@pytest.mark.parametrize("mask_ratio", [0.0, 0.75])
def test_forward_flops_match_the_flop_counter(mask_ratio):
    m = model_block("micro-256")["model"]
    model, x, y, mask = _reference(m, 3, mask_ratio)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x, torch.rand(3), y, mask)
    assert counter.get_total_flops() == 3 * flops.model_flops(m, mask_ratio)


@pytest.mark.parametrize("mask_ratio", [0.0, 0.75])
def test_train_flops_match_the_flop_counter(mask_ratio):
    """Forward and backward as autograd runs them: every product's two gradients but
    the data's (recomputation is not counted: the reference keeps activations)."""
    m = model_block("micro-256")["model"]
    model, x, y, mask = _reference(m, 2, mask_ratio)
    counter = FlopCounterMode(display=False)
    with counter:
        edm.row_losses(model, x, y, torch.randn(2, 1, 1, 1), torch.randn_like(x), mask,
                       -0.6, 1.2, m["patch_size"]).mean().backward()
    assert counter.get_total_flops() == 2 * flops.model_flops(m, mask_ratio, train=True)


def test_xl_sizes():
    """The XL counts from the configurations against the port's XL model (built on
    the meta device): each block's qkv width, feed-forward width and kind; 28 + 6
    blocks, 16 of them EC-MoE, the expert rows twice the tokens (capacity 2)."""
    from micro_diffusion_tpu_torch.models import dit as port

    m = model_block("microdit-xl-512", CONFIGS)["model"]
    model = port.MicroDiT_XL_2(input_size=m["latent_res"], device="meta")
    blocks = flops.blocks(m)
    assert len(blocks) == 34 and sum(b["moe"] for b in blocks) == 16
    for blk, mod in zip(blocks, list(model.patch_mixer) + list(model.blocks)):
        assert blk["qkv"] == mod.attn.qkv.weight.shape[0] // 3
        if blk["moe"]:
            assert tuple(mod.mlp.w1.shape) == (m["num_experts"], blk["dim"],
                                                flops._rounded(blk["mlp"], m["multiple_of"]))
        else:
            assert mod.mlp.w1.weight.shape[0] == flops._ffn_hidden(blk["mlp"],
                                                                    m["multiple_of"])
    assert flops.tokens(m, 0.0) == (1024, 1024)
    calls = flops.expert_calls(m, 1, 0.0)
    assert all(n * e * k == 2 * 1024 for n, e, k, _, _ in calls)
    assert len(flops.attention_calls(m, 1, 0.0)) == 1 + 2 * 34
    m256 = model_block("microdit-xl-256", CONFIGS)["model"]
    assert flops.tokens(m256, 0.75) == (256, 64)


@pytest.mark.parametrize("b,tq,tk,h,d", [(16, 1024, 1024, 16, 64), (2, 77, 77, 16, 64),
                                         (8, 64, 77, 12, 32)])
def test_attention_counts_follow_the_shape_formula(b, tq, tk, h, d):
    fl, by = flops.attn_flops_bytes(b, tq, tk, h, d)
    assert fl == 2 * (2 * b * h * tq * tk * d)               # q k^T and p v
    assert by == 2 * b * h * d * (2 * tq + 2 * tk)           # q, out; k, v in bf16
    fl, by = flops.attn_bwd_flops_bytes(b, tq, tk, h, d)
    assert fl == 5 * (2 * b * h * tq * tk * d)
    assert by == 2 * b * h * d * (3 * tq + 4 * tk)


@pytest.mark.parametrize("n,e,k,d,f", [(16, 8, 256, 1024, 3840), (256, 8, 16, 768, 3072)])
def test_expert_counts_follow_the_shape_formula(n, e, k, d, f):
    rows = n * e * k
    fl, by = flops.moe_flops_bytes(n, e, k, d, f)
    assert fl == 2 * (2 * rows * d * f)
    assert by == 2 * (2 * rows * d + 2 * e * d * f)
    fl, by = flops.moe_bwd_flops_bytes(n, e, k, d, f)
    assert fl == 5 * (2 * rows * d * f)
    assert by == 2 * (3 * rows * d + 4 * e * d * f)


def test_function_work_sums_the_calls():
    m = model_block("microdit-xl-512", CONFIGS)["model"]
    w = flops.function_work(m, 16, 0.0, train=True)
    want = sum(flops.bound_s(*flops.attn_flops_bytes(*c))
               + flops.bound_s(*flops.attn_bwd_flops_bytes(*c))
               for c in flops.attention_calls(m, 16, 0.0))
    assert np.isclose(w["attention"][2], want)
    fwd = flops.function_work(m, 16, 0.0, train=False)
    assert fwd["moe"][0] == sum(flops.moe_flops_bytes(*c)[0]
                                for c in flops.expert_calls(m, 16, 0.0))
    assert flops.bound_s(flops.PEAK_BF16_FLOPS, 0) == 1.0
