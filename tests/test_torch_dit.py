"""The PyTorch port's DiT against the JAX DiT: same numpy inputs, JAX weights carried
across through the port's converter, full forward in fp32 at cfg 1 and 5; and the
XL/Tiny state-dict layout against the converter's output for the JAX init."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_diffusion_tpu.models import dit as jdit
from micro_diffusion_tpu.models import interop as jinterop
from micro_diffusion_tpu_torch.models import dit as tdit
from micro_diffusion_tpu_torch.models import interop as tinterop

_COMMON = dict(patch_size=2, in_channels=4, depth=4, qkv_multipliers=(0.5, 1.0),
               ffn_multipliers=(0.5, 4.0), use_patch_mixer=True, patch_mixer_depth=2,
               patch_mixer_qkv_ratio=1.0, patch_mixer_mlp_ratio=4.0, use_bias=False,
               num_experts=4, expert_capacity=2.0)
# Micro-sized: head_dim 16 and d = 48/64, so attention and MoE take the plain paths
# in both frameworks.
MICRO = dict(_COMMON, input_size=16, dim=64, head_dim=16, multiple_of=32,
             caption_channels=32, patch_mixer_dim=48)
MICRO_CAPTION = (8, 32)
# Kernel-shaped: head_dim 64 with even head counts, and MoE shapes (k=32, d=128,
# f=256/512) that JAX sends through the interpret-mode Pallas kernel and the port
# through the kernel's plain version.
KERNEL = dict(_COMMON, input_size=16, dim=128, head_dim=64, multiple_of=256,
              caption_channels=64, patch_mixer_dim=128)
KERNEL_CAPTION = (77, 64)
# fp32 tolerances: 2e-4 where both frameworks compute the same fp32 math; 1e-3 on
# the kernel-shaped config, where the kernel contract rounds a = x @ w1 to bf16 and
# a one-ulp flip of that rounding between the two summation orders is possible.
TOL = {"micro": 2e-4, "kernel": 1e-3}
CONFIGS = {"micro": (MICRO, MICRO_CAPTION), "kernel": (KERNEL, KERNEL_CAPTION)}


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def jax_model_and_params(name, batch=2):
    """JAX fp32 DiT, its init, and numpy inputs, with every param perturbed so the
    zero-init layers are informative (as tests/test_torch_parity.py does); built
    once per config."""
    cfg, (cap_len, cap_dim) = CONFIGS[name]
    model = jdit.DiT(dtype=jnp.float32, **cfg)
    res = cfg["input_size"]
    x = rand((batch, 4, res, res), 0)
    t = np.asarray([0.3, 0.9][:batch], np.float32)
    y = rand((batch, 1, cap_len, cap_dim), 1)
    rng = jax.random.PRNGKey(0)
    params = jax.jit(lambda: model.init({"params": rng, "mask": rng}, x, t, y))()
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf + 0.05 * jax.random.normal(
            jax.random.PRNGKey(zlib.crc32(str(path).encode()) % (2**31)), leaf.shape),
        params)
    return model, params, (x, t, y)


def torch_twin(name, params):
    cfg, _ = CONFIGS[name]
    model = tdit.DiT(dtype=torch.float32, device="cpu", **cfg).eval()
    return tinterop.load_jax_params(model, params)


@pytest.mark.parametrize("cfg_scale", [1.0, 5.0])
@pytest.mark.parametrize("name", ["micro", "kernel"])
def test_dit_forward_matches_jax(name, cfg_scale):
    jmodel, params, (x, t, y) = jax_model_and_params(name)
    out_j = jax.jit(lambda p, x, t, y: jmodel.apply(p, x, t, y, cfg=cfg_scale)["sample"])(
        params, x, t, y)
    tmodel = torch_twin(name, params)
    with torch.no_grad():
        out_t = tmodel(*map(torch.from_numpy, (x, t, y)), cfg=cfg_scale)["sample"]
    assert out_t.dtype == torch.float32 and out_t.shape == x.shape
    tol = TOL[name]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=tol, atol=tol)


@pytest.mark.parametrize("name,expected", [("MicroDiT_XL_2", 1_165_442_320),
                                           ("MicroDiT_Tiny_2", 200_692_752)])
def test_state_dict_layout_matches_converter(name, expected):
    """Keys and shapes of the port's state dict == the converter's output for the JAX
    init (abstract: eval_shape, zero-stride arrays), and the parameter count on the
    meta device."""
    jmodel = getattr(jdit, name)()
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, 4, 32, 32)), jnp.zeros((1,)), jnp.zeros((1, 1, 77, 1024))))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    converted = tinterop.params_to_torch_state_dict(tree)
    # the port's copy of the mapping agrees with the JAX package's
    original = jinterop.params_to_torch_state_dict(tree)
    assert {k: v.shape for k, v in converted.items()} == {
        k: v.shape for k, v in original.items()}

    tmodel = getattr(tdit, name)(device="meta")
    port = tmodel.state_dict()
    assert set(port) == set(converted)
    for key, value in port.items():
        assert tuple(value.shape) == tuple(converted[key].shape), key
    assert sum(p.numel() for p in tmodel.parameters()) == expected


def test_init_shapes_and_zero_layers():
    """The port's own init fills every parameter with the JAX initialisers' shapes;
    the adaLN and final-layer projections start at zero, as in JAX."""
    model = tdit.MicroDiT_Micro_2(input_size=16, caption_channels=32, dtype=torch.float32,
                                  device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert all(torch.isfinite(v).all() for v in sd.values())
    assert not sd["blocks.0.adaLN_modulation.1.weight"].any()
    assert not sd["final_layer.linear.weight"].any()
    assert sd["blocks.1.mlp.w1"].std() > 0.01
    assert torch.equal(sd["blocks.0.norm1.weight"], torch.ones(64))


def test_unported_modes_raise():
    """A remat policy name outside ``<base>[_lean|_xlean][_alean]`` raises (JAX runs
    an unknown base as 'full'); every lean name of bench.py's ladders builds, as do
    the modes ported with the training slices (remat 'full', 'dots', 'attn_moe',
    'dots_attn_moe', fused adaLN, mask_ratio > 0, every moe_dispatch, attention
    'flash_bh' and 'flash_bthd'), which run."""
    for policy in ("dot", "dots_lean_xlean", "dots_alean_lean", "dots_alean_alean",
                   "attn_moe_xlean_lean", "lean"):
        with pytest.raises(ValueError, match="unknown remat policy"):
            tdit.MicroDiT_Micro_2(input_size=16, caption_channels=32, device="meta",
                                  remat=True, remat_policy=policy)
    for policy in ("dots_attn_moe_lean", "dots_attn_moe_xlean", "dots_attn_moe_alean",
                   "dots_attn_moe_xlean_alean", "attn_moe_lean", "dots_lean", "full_alean"):
        tdit.MicroDiT_Micro_2(input_size=16, caption_channels=32, device="meta",
                              remat=True, remat_policy=policy)
    for kw in (dict(remat=True, remat_policy="dots"), dict(remat=True, remat_policy="attn_moe"),
               dict(remat=True, remat_policy="dots_attn_moe"), dict(fused_adaln=True),
               dict(moe_dispatch="gather"), dict(attention_impl="flash_bh"),
               dict(attention_impl="flash_bthd")):
        tdit.MicroDiT_Micro_2(input_size=16, caption_channels=32, device="meta", **kw)
    model = tdit.MicroDiT_Micro_2(input_size=16, caption_channels=32, device="cpu",
                                  remat=True, moe_dispatch="gather",
                                  attention_impl="flash_bh").init_weights(
                                      torch.Generator().manual_seed(0))
    x = torch.zeros(1, 4, 16, 16, requires_grad=True)
    out = model.forward_without_cfg(x, torch.zeros(1), torch.zeros(1, 8, 32), mask_ratio=0.5,
                                    generator=torch.Generator().manual_seed(1))
    assert out["sample"].shape == (1, 4, 16, 16) and out["mask"].sum() == 32
    out["sample"].sum().backward()
    assert x.grad is not None
    with pytest.raises(ValueError, match="generator"):
        model.forward_without_cfg(x, torch.zeros(1), torch.zeros(1, 8, 32), mask_ratio=0.5)


@pytest.mark.parametrize("mask_ratio", [0.0, 0.75])
def test_remat_changes_no_numbers(mask_ratio):
    """Per-block checkpointing ('full') gives the same loss gradients as no remat
    (fp32, exact up to 1e-6: the recomputed forward is the same arithmetic)."""
    kw = dict(input_size=16, caption_channels=32, device="cpu", dtype=torch.float32)
    plain = tdit.MicroDiT_Micro_2(**kw).init_weights(torch.Generator().manual_seed(2))
    remat = tdit.MicroDiT_Micro_2(remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    x, y = torch.from_numpy(rand((2, 4, 16, 16), 3)), torch.from_numpy(rand((2, 8, 32), 4))
    grads = []
    for model in (plain, remat):
        out = model(x, torch.zeros(2), y, mask_ratio=mask_ratio,
                    generator=torch.Generator().manual_seed(5))["sample"]
        grads.append(torch.autograd.grad(out.square().mean(), list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_load_torch_checkpoint_strict(tmp_path):
    """A Composer-style .pt (prefixed keys, pos_embed/mask_token buffers) loads into
    the port's DiT with strict=True; a non-zero mask_token is refused."""
    kw = dict(input_size=16, caption_channels=32, device="cpu")
    model = tdit.MicroDiT_Micro_2(**kw).init_weights(torch.Generator().manual_seed(1))
    sd = {f"dit.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["dit.pos_embed"] = model.pos_embed.clone()
    sd["dit.mask_token"] = torch.zeros(1, 1, 16)
    path = tmp_path / "ckpt.pt"
    torch.save({"state": {"model": sd}}, path)

    twin = tdit.MicroDiT_Micro_2(**kw)
    loaded = tinterop.load_torch_checkpoint(str(path), twin)
    assert "pos_embed" not in loaded and "mask_token" not in loaded
    for key, value in model.state_dict().items():
        assert torch.equal(twin.state_dict()[key], value), key

    sd["dit.mask_token"] = torch.ones(1, 1, 16)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="mask_token"):
        tinterop.load_torch_checkpoint(str(path))
