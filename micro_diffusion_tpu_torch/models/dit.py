"""MicroDiT backbone in PyTorch, counterpart of micro_diffusion_tpu/models/dit.py.

patchify -> pos-embed -> caption/timestep conditioning -> patch-mixer ->
width-laddered adaLN-zero DiT blocks (self-attn + cross-attn + dense-or-EC-MoE
FFN) -> final layer -> unpatchify, with deferred token masking (mask_ratio > 0:
the kept tokens are gathered after the patch mixer and scattered back after the
final layer) and per-block rematerialisation (``remat=True``: per-block
``torch.utils.checkpoint``; policy 'full' recomputes the whole block, 'dots'
keeps the 2-D products' outputs, 'attn_moe' the self-attention, cross-attention
and EC-MoE outputs, 'dots_attn_moe' both; the lean suffixes leave named products
out: ``remat_policy_fn``). ``pos_embed`` is a computed constant (a non-persistent
buffer), as in the JAX package, so converted weights and released checkpoints load
strictly.
"""

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.masking import TokenMask, gather_tokens, make_token_mask, scatter_tokens
from ..ops.remat_names import GROUP_SUM, current_name

from .layers import (
    XAVIER,
    ZEROS,
    AttentionBlockPromptEmbedding,
    CaptionProjection,
    CrossAttention,
    FeedForward,
    FeedForwardECMoe,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    SelfAttention,
    T2IFinalLayer,
    TimestepEmbedder,
    get_2d_sincos_pos_embed,
    normal,
)


def resolve_device(device) -> torch.device:
    """``device``, or the card when None; never drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return device


def qkv_hidden_dim(dim: int, qkv_ratio: float, head_dim: int) -> int:
    """Per-layer qkv width: dim*ratio rounded up to a multiple of 2*head_dim
    (reference dit.py:192-195)."""
    if qkv_ratio == 1:
        return dim
    unit = head_dim * 2
    return unit * ((int(dim * qkv_ratio) + unit - 1) // unit)


class NormLinear(nn.Sequential):
    """LayerNorm + Linear pair (patch_mixer_map_{xin,xout,y}.0/.1, dit.py:377-388)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool, norm_eps: float = 1e-6,
                 dtype=torch.bfloat16, device=None):
        super().__init__(
            LayerNorm(in_dim, eps=norm_eps, device=device),
            Linear(in_dim, out_dim, use_bias, init=XAVIER, dtype=dtype, device=device),
        )


class DiTBlock(nn.Module):
    """adaLN-zero DiT block: gated self-attn, ungated cross-attn, gated (dense|MoE)
    FFN (reference dit.py:151-246)."""

    def __init__(self, dim: int, head_dim: int, mlp_ratio: float, qkv_ratio: float,
                 multiple_of: int, pooled_emb_dim: int, norm_eps: float, depth_init: bool,
                 layer_id: int, num_layers: int, compress_xattn: bool, use_bias: bool,
                 moe_block: bool, num_experts: int, expert_capacity: float,
                 moe_dispatch: str = "onehot", attn_impl: str = "auto",
                 xattn_impl: str | None = None, fused_adaln: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        qkv_hidden = qkv_hidden_dim(dim, qkv_ratio, head_dim)
        mlp_hidden = int(dim * mlp_ratio)
        # depth-scaled init std for output projections (dit.py:227-230)
        init_std = (0.02 / (2 * (layer_id + 1)) ** 0.5 if depth_init
                    else 0.02 / (2 * num_layers) ** 0.5)
        xattn_hidden = qkv_hidden if compress_xattn else dim

        self.adaLN_modulation = nn.Sequential(
            nn.GELU(approximate="tanh"),
            Linear(pooled_emb_dim, 6 * dim, init=ZEROS, dtype=dtype, device=device),
        )
        self.norm1 = LayerNorm(dim, eps=norm_eps, fused_adaln=fused_adaln, device=device)
        self.attn = SelfAttention(dim, qkv_hidden // head_dim, qkv_bias=use_bias,
                                  norm_eps=norm_eps, hidden_dim=qkv_hidden,
                                  qkv_init=normal(0.02), proj_init=normal(init_std),
                                  attn_impl=attn_impl, dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, eps=norm_eps, device=device)
        self.cross_attn = CrossAttention(dim, xattn_hidden // head_dim, qkv_bias=use_bias,
                                         norm_eps=norm_eps, hidden_dim=xattn_hidden,
                                         qkv_init=normal(0.02), proj_init=normal(init_std),
                                         attn_impl=xattn_impl or attn_impl, dtype=dtype,
                                         device=device)
        self.norm3 = LayerNorm(dim, eps=norm_eps, fused_adaln=fused_adaln, device=device)
        if moe_block:
            self.mlp = FeedForwardECMoe(num_experts, expert_capacity, dim, mlp_hidden,
                                        multiple_of, w2_init=normal(init_std),
                                        dispatch=moe_dispatch, dtype=dtype, device=device)
        else:
            self.mlp = FeedForward(dim, mlp_hidden, multiple_of, use_bias,
                                   w1_init=normal(0.02), w2_init=normal(init_std),
                                   w3_init=normal(init_std), dtype=dtype, device=device)

    def forward(self, x, y, c):
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=1)
        h = self.attn(self.norm1(x, shift_msa, scale_msa))
        x = x + gate_msa[:, None, :] * h
        x = x + self.cross_attn(self.norm2(x), y)
        h = self.mlp(self.norm3(x, shift_mlp, scale_mlp))
        return x + gate_mlp[:, None, :] * h


def _moe_block_flags(depth: int, experts_every_n: int, *, skip_last: bool) -> list[bool]:
    """Every n-th block is MoE: backbone candidates range(0, depth-1), mixer
    candidates range(1, depth) (dit.py:410-414, 346-349)."""
    candidates = range(0, depth - 1) if skip_last else range(1, depth)
    moe_idx = {i for i in candidates if (i + 1) % experts_every_n == 0}
    return [i in moe_idx for i in range(depth)]


# JAX's dots_with_no_batch_dims_saveable: the Linears' products are the 2-D ones
# (a 3-D input is folded to rows); the batched bmm/einsum products, the hand
# kernels and the elementwise ops are recomputed. The unrolled dispatches' expert
# products are batched here but 2-D dots in JAX: 'dots' keeps them by name.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_DOTS_NAMES = ("expert_dots",)
# JAX's save_only_these_names (dit.py:350-382): the operators that produce the
# named outputs (ops/remat_names.py)
_NAMES_SAVED = ("attn_out", "xattn_out", "moe_out")
_BASES = ("full", "dots", "attn_moe", "dots_attn_moe")
# the products that each lean suffix leaves out (JAX dit.py:330-349): '_xlean' implies
# '_lean', '_alean' composes with either
_LEAN = {"_lean": ("expert_dots",), "_xlean": ("expert_dots", "ffn_hidden"),
         "_alean": ("attn_proj",)}


def parse_remat_policy(policy: str) -> tuple[str, frozenset]:
    """``<base>[_lean|_xlean][_alean]`` -> (base, the names its suffixes leave out).
    JAX treats an unknown base as 'full' (dit.py:378-379); the port raises."""
    name, lean = policy, set()
    for suffix in ("_alean", "_xlean", "_lean"):
        if name.endswith(suffix):
            name = name[:-len(suffix)]
            lean.update(_LEAN[suffix])
            if suffix != "_alean":
                break
    if name not in _BASES:
        raise ValueError(f"unknown remat policy {policy!r}: one of {_BASES}, each "
                         "optionally with '_lean' or '_xlean', then '_alean'")
    return name, frozenset(lean)


def remat_policy_fn(policy: str):
    """The selective-checkpoint policy of a remat policy name (None for 'full'): it
    recomputes every operator run under a name the lean suffixes leave out, keeps
    the outputs of the base's operators and names, and recomputes the rest. Under
    'dots_attn_moe', '_alean' also gives up the cross-attention output (JAX
    dit.py:367-372)."""
    base, lean = parse_remat_policy(policy)
    if base == "full":
        return None
    ops = _DOTS_SAVED if base.startswith("dots") else ()
    names = set(_DOTS_NAMES if base.startswith("dots") else ())
    if base.endswith("attn_moe"):
        names.update(_NAMES_SAVED)
        if base == "dots_attn_moe" and "attn_proj" in lean:
            names.discard("xattn_out")

    def fn(ctx, op, *args, **kwargs):
        name = current_name()
        if name in lean or name == GROUP_SUM or not (op in ops or name in names):
            return CheckpointPolicy.PREFER_RECOMPUTE
        return CheckpointPolicy.MUST_SAVE
    return fn


def _remat_context(policy: str):
    """The selective-checkpoint context of a block under ``policy`` ('full': None).
    The 'gather' combine adds into the tensor that its first operator made, so under
    the 'attn_moe' bases the kept entries of the 'moe_out' region change after they
    are cached (to the kept value)."""
    fn = remat_policy_fn(policy)
    if fn is None:
        return None
    return functools.partial(create_selective_checkpoint_contexts, fn,
                             allow_cache_entry_mutation="attn_moe" in policy)


class DiT(nn.Module):
    """Text-conditioned Diffusion Transformer (reference dit.py:249-627)."""

    def __init__(self, input_size: int = 32, patch_size: int = 2, in_channels: int = 4,
                 dim: int = 1152, depth: int = 28, head_dim: int = 64,
                 multiple_of: int = 256, caption_channels: int = 1024,
                 pos_interp_scale: float = 1.0, norm_eps: float = 1e-6,
                 depth_init: bool = True, qkv_multipliers: Sequence[float] = (1.0,),
                 ffn_multipliers: Sequence[float] = (4.0,), use_patch_mixer: bool = True,
                 patch_mixer_depth: int = 4, patch_mixer_dim: int = 512,
                 patch_mixer_qkv_ratio: float = 1.0, patch_mixer_mlp_ratio: float = 1.0,
                 use_bias: bool = True, num_experts: int = 8, expert_capacity: float = 1.0,
                 experts_every_n: int = 2, dtype=torch.bfloat16, remat: bool = False,
                 remat_policy: str = "full", moe_dispatch: str = "onehot",
                 attention_impl: str = "auto", xattn_attention_impl: str | None = None,
                 fused_adaln: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        if remat:
            parse_remat_policy(remat_policy)
        self.remat = remat
        self.remat_policy = remat_policy
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels
        self.dim = dim
        self.depth = depth
        self.caption_channels = caption_channels
        self.use_patch_mixer = use_patch_mixer
        self.dtype = dtype
        base_size = input_size // patch_size
        kw = dict(dtype=dtype, device=device)

        self.x_embedder = PatchEmbed(patch_size, in_channels, dim, use_bias=True, **kw)
        self.t_embedder = TimestepEmbedder(dim, **kw)
        self.y_embedder = CaptionProjection(caption_channels, dim, norm_eps=norm_eps, **kw)
        self.y_emb_preprocess = AttentionBlockPromptEmbedding(
            dim, head_dim, mlp_ratio=4.0, multiple_of=multiple_of, norm_eps=norm_eps,
            use_bias=use_bias, **kw)
        self.pooled_y_emb_process = Mlp(dim, dim, dim, use_norm=True, norm_eps=norm_eps,
                                        fc1_init=normal(0.02), fc2_init=normal(0.02), **kw)

        block_kw = dict(head_dim=head_dim, multiple_of=multiple_of, pooled_emb_dim=dim,
                        norm_eps=norm_eps, num_layers=depth, compress_xattn=False,
                        use_bias=use_bias, num_experts=num_experts,
                        expert_capacity=expert_capacity, moe_dispatch=moe_dispatch,
                        attn_impl=attention_impl, xattn_impl=xattn_attention_impl,
                        fused_adaln=fused_adaln, **kw)
        self.patch_mixer_map_xin = self.patch_mixer_map_xout = None
        self.patch_mixer_map_y = None
        if use_patch_mixer:
            mixer_moe = _moe_block_flags(patch_mixer_depth, experts_every_n,
                                         skip_last=False)
            self.patch_mixer = nn.ModuleList([
                DiTBlock(dim=patch_mixer_dim, mlp_ratio=patch_mixer_mlp_ratio,
                         qkv_ratio=patch_mixer_qkv_ratio, depth_init=False, layer_id=0,
                         moe_block=mixer_moe[i], **block_kw)
                for i in range(patch_mixer_depth)
            ])
            if patch_mixer_dim != dim:
                self.patch_mixer_map_xin = NormLinear(dim, patch_mixer_dim, use_bias,
                                                      norm_eps, **kw)
                self.patch_mixer_map_xout = NormLinear(patch_mixer_dim, dim, use_bias,
                                                       norm_eps, **kw)
                self.patch_mixer_map_y = NormLinear(dim, patch_mixer_dim, use_bias,
                                                    norm_eps, **kw)

        qkv_ratios, mlp_ratios = self._layer_ratios(depth, qkv_multipliers, ffn_multipliers)
        backbone_moe = _moe_block_flags(depth, experts_every_n, skip_last=True)
        self.blocks = nn.ModuleList([
            DiTBlock(dim=dim, mlp_ratio=mlp_ratios[i], qkv_ratio=qkv_ratios[i],
                     depth_init=depth_init, layer_id=i, moe_block=backbone_moe[i],
                     **block_kw)
            for i in range(depth)
        ])
        self.final_layer = T2IFinalLayer(dim, dim, patch_size, self.out_channels,
                                         norm_eps=norm_eps, fused_adaln=fused_adaln, **kw)

        num_patches = (input_size // patch_size) ** 2
        pos = get_2d_sincos_pos_embed(dim, int(num_patches**0.5),
                                      pos_interp_scale=pos_interp_scale, base_size=base_size)
        self.register_buffer("pos_embed",
                             torch.tensor(pos[None], dtype=torch.float32, device=device),
                             persistent=False)

    @staticmethod
    def _layer_ratios(depth, qkv_multipliers, ffn_multipliers):
        """Distribute qkv/ffn multipliers across depth (reference dit.py:394-408)."""
        qkv_m, ffn_m = list(qkv_multipliers), list(ffn_multipliers)
        assert len(qkv_m) == len(ffn_m)
        if len(ffn_m) == depth:
            return qkv_m, ffn_m
        assert depth % len(ffn_m) == 0, "number of blocks should be divisible by splits"
        per = depth // len(ffn_m)
        return ([m for m in qkv_m for _ in range(per)],
                [m for m in ffn_m for _ in range(per)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiT":
        """The JAX package's initialisers, drawn from ``generator``."""
        for mod in self.modules():
            if hasattr(mod, "_init_params"):
                mod._init_params(generator)
        return self

    def unpatchify(self, x):
        """(B, T, p*p*C) -> (B, C, H, W) (reference dit.py:566-575)."""
        c, p = self.out_channels, self.patch_size
        h = w = int(x.shape[1] ** 0.5)
        assert h * w == x.shape[1]
        x = x.reshape(x.shape[0], h, w, p, p, c)
        x = torch.einsum("nhwpqc->nchpwq", x)
        return x.reshape(x.shape[0], c, h * p, w * p)

    def _run_block(self, block, x, y, c):
        """One DiT block; with remat its activations are recomputed in the backward
        (the JAX package's nn.remat): all of them under 'full'; under the other
        policies a selective-checkpoint context keeps the 2-D products' outputs
        ('dots'), the named attention and MoE outputs ('attn_moe'), or both, less
        the products that the policy's lean suffixes name. The policy is read here,
        at each call."""
        if not (self.remat and torch.is_grad_enabled()):
            return block(x, y, c)
        context = _remat_context(self.remat_policy)
        if context is None:
            return checkpoint(block, x, y, c, use_reentrant=False)
        return checkpoint(block, x, y, c, use_reentrant=False, context_fn=context)

    def forward_without_cfg(self, x, t, y, mask_ratio: float = 0.0,
                            token_mask: TokenMask | None = None,
                            generator: torch.Generator | None = None) -> dict:
        """Unguided forward pass (reference dit.py:455-519).

        x: (B, C, H, W) noisy latents; t: () or (B,) EDM c_noise values;
        y: (B, 1, L, cap_dim) or (B, L, cap_dim) caption embeddings.
        mask_ratio > 0 keeps T * (1 - mask_ratio) tokens through the backbone: the
        keep-set is ``token_mask`` when given, else drawn from ``generator``.
        Returns {'sample': (B, C, H, W) fp32, 'mask': (B, T) or None}.
        """
        b = x.shape[0]
        x = self.x_embedder(x) + self.pos_embed.to(self.dtype)
        t = self.t_embedder(torch.broadcast_to(t.reshape(-1), (b,)))
        if y.dim() == 4:
            y = y.reshape(b, y.shape[-2], y.shape[-1])
        y = self.y_emb_preprocess(self.y_embedder(y))
        c = t + self.pooled_y_emb_process(y.mean(dim=-2))

        if self.use_patch_mixer:
            y_mixer = y
            if self.patch_mixer_map_xin is not None:
                x = self.patch_mixer_map_xin(x)
                y_mixer = self.patch_mixer_map_y(y)
            for block in self.patch_mixer:
                x = self._run_block(block, x, y_mixer, c)

        mask = None
        if mask_ratio > 0:
            if token_mask is None:
                if generator is None:
                    raise ValueError("mask_ratio > 0 needs a token_mask or a generator")
                token_mask = make_token_mask(generator, b, x.shape[1], mask_ratio)
            mask = token_mask.mask
            x = gather_tokens(x, token_mask.ids_keep)
        # back to the backbone width after masking, to save compute (dit.py:506-508)
        if self.use_patch_mixer and self.patch_mixer_map_xout is not None:
            x = self.patch_mixer_map_xout(x)

        for block in self.blocks:
            x = self._run_block(block, x, y, c)
        x = self.final_layer(x, c)
        if mask_ratio > 0:
            mask_token = torch.zeros(1, 1, x.shape[-1], device=x.device)
            x = scatter_tokens(x, token_mask.ids_restore, mask_token)
        return {"sample": self.unpatchify(x.float()), "mask": mask}

    def forward_with_cfg(self, x, t, y, cfg: float = 1.0, mask_ratio: float = 0.0) -> dict:
        """Classifier-free guidance by batch doubling (reference dit.py:521-550)."""
        x = torch.cat([x, x], dim=0)
        y = torch.cat([y, torch.zeros_like(y)], dim=0)
        t = torch.atleast_1d(t)
        if t.shape[0] != 1:
            t = torch.cat([t, t], dim=0)
        eps = self.forward_without_cfg(x, t, y, mask_ratio)["sample"]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        return {"sample": uncond_eps + cfg * (cond_eps - uncond_eps)}

    def forward(self, x, t, y, cfg: float = 1.0, mask_ratio: float = 0.0,
                token_mask: TokenMask | None = None,
                generator: torch.Generator | None = None) -> dict:
        """Routes on the cfg scale (reference dit.py:552-564); the mask arguments
        go to the unguided forward (masking is a training-time option)."""
        if cfg != 1.0:
            return self.forward_with_cfg(x, t, y, cfg, mask_ratio)
        return self.forward_without_cfg(x, t, y, mask_ratio, token_mask, generator)


def _zoo(depth, dim, head_dim, multiple_of, mixer_depth, mixer_dim, qkv_ratio, mlp_ratio,
         **kwargs) -> DiT:
    kwargs.setdefault("patch_size", 2)
    return DiT(
        dim=dim, depth=depth, head_dim=head_dim, multiple_of=multiple_of, norm_eps=1e-6,
        depth_init=True,
        qkv_multipliers=tuple(np.linspace(qkv_ratio[0], qkv_ratio[1], num=depth)),
        ffn_multipliers=tuple(np.linspace(mlp_ratio[0], mlp_ratio[1], num=depth)),
        use_patch_mixer=True, patch_mixer_depth=mixer_depth, patch_mixer_dim=mixer_dim,
        patch_mixer_qkv_ratio=1.0, patch_mixer_mlp_ratio=4.0, use_bias=False, **kwargs)


def MicroDiT_Tiny_2(caption_channels=1024, qkv_ratio=(0.5, 1.0), mlp_ratio=(0.5, 4.0),
                    pos_interp_scale=1.0, input_size=32, num_experts=8,
                    expert_capacity=2.0, experts_every_n=2, in_channels=4, **kwargs) -> DiT:
    """~201M-param MicroDiT (reference dit.py:630-668)."""
    return _zoo(16, 512, 32, 256, 4, 512, qkv_ratio, mlp_ratio,
                caption_channels=caption_channels, pos_interp_scale=pos_interp_scale,
                input_size=input_size, num_experts=num_experts,
                expert_capacity=expert_capacity, experts_every_n=experts_every_n,
                in_channels=in_channels, **kwargs)


def MicroDiT_XL_2(caption_channels=1024, qkv_ratio=(0.5, 1.0), mlp_ratio=(0.5, 4.0),
                  pos_interp_scale=1.0, input_size=32, num_experts=8, expert_capacity=2.0,
                  experts_every_n=2, in_channels=4, **kwargs) -> DiT:
    """~1.165B-param MicroDiT (reference dit.py:671-709)."""
    return _zoo(28, 1024, 64, 256, 6, 768, qkv_ratio, mlp_ratio,
                caption_channels=caption_channels, pos_interp_scale=pos_interp_scale,
                input_size=input_size, num_experts=num_experts,
                expert_capacity=expert_capacity, experts_every_n=experts_every_n,
                in_channels=in_channels, **kwargs)


def MicroDiT_Micro_2(caption_channels=1024, qkv_ratio=(0.5, 1.0), mlp_ratio=(0.5, 4.0),
                     pos_interp_scale=1.0, input_size=32, num_experts=4,
                     expert_capacity=2.0, experts_every_n=2, in_channels=4,
                     **kwargs) -> DiT:
    """Debug-scale model, structurally identical to Tiny/XL (not in the reference zoo)."""
    return _zoo(4, 64, 16, 32, 2, 48, qkv_ratio, mlp_ratio,
                caption_channels=caption_channels, pos_interp_scale=pos_interp_scale,
                input_size=input_size, num_experts=num_experts,
                expert_capacity=expert_capacity, experts_every_n=experts_every_n,
                in_channels=in_channels, **kwargs)
