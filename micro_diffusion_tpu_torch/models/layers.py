"""Layer library of the MicroDiT port, counterpart of micro_diffusion_tpu/models/layers.py.

Numerics follow the JAX package's dtype policy, written out: parameters are fp32;
each Linear casts its input, weight and bias to the compute dtype (bf16 by
default); LayerNorm statistics and the attention softmax are fp32, and LayerNorm
casts back to its input dtype before modulate (the fused adaLN kernel, behind
``fused_adaln``, rounds once after it). There is no autocast.

Parameter names are the reference's torch state-dict names (``blocks.3.attn.qkv``,
``t_embedder.mlp.0``, ``adaLN_modulation.1``, the 3-D MoE ``mlp.w1``/``mlp.w2``),
so weights converted from the JAX package and the released ``.pt`` checkpoints
load with ``strict=True``.

Every parameter-owning layer has ``_init_params(generator)``, the JAX package's
initialiser for that parameter (layers.py:32-60, dit.py); ``DiT.init_weights``
calls them all. Constructors leave parameters uninitialised.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.adaln import layernorm_modulate
from ..ops.attention import dot_product_attention
from ..ops.moe_dispatch import (combine_expert_rows, combine_rows, dispatch_rows,
                                gather_expert_rows)
from ..ops.moe_ffn import _moe_ffn_em_ref, _moe_ffn_ref, moe_ffn, moe_ffn_expert_major
from ..ops.remat_names import checkpoint_name
from ..parallel.sharding import copy_to_group, reduce_from_group

# ------------------------------------------------------------------ initialisers
# An init spec is ("xavier",), ("zeros",) or ("normal", std); trunc_normal in the
# reference truncates at +-2 absolute, i.e. ~100 sigma at std 0.02: a plain normal.

XAVIER = ("xavier",)
ZEROS = ("zeros",)


def normal(std: float) -> tuple:
    return ("normal", float(std))


@torch.no_grad()
def init_tensor(t: torch.Tensor, spec: tuple, gen: torch.Generator,
                fan_in: int | None = None, fan_out: int | None = None) -> None:
    """Fill ``t`` per ``spec``; xavier fans default to a (out, in) weight's."""
    kind = spec[0]
    if kind == "zeros":
        t.zero_()
    elif kind == "normal":
        t.normal_(0.0, spec[1], generator=gen)
    elif kind == "xavier":
        fan_in = t.shape[1] if fan_in is None else fan_in
        fan_out = t.shape[0] if fan_out is None else fan_out
        a = math.sqrt(6.0 / (fan_in + fan_out))
        t.uniform_(-a, a, generator=gen)
    else:
        raise ValueError(f"unknown init spec {spec}")


# ------------------------------------------------------------------ basic layers


class Linear(nn.Linear):
    """nn.Linear with fp32 parameters that computes in ``dtype``; bias inits to 0."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 init: tuple = XAVIER, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=torch.float32)
        self.init = init
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        """No-op: ``_init_params`` sets the weights (called by DiT.init_weights)."""

    def _init_params(self, gen: torch.Generator) -> None:
        init_tensor(self.weight, self.init, gen)
        if self.bias is not None:
            init_tensor(self.bias, ZEROS, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x * (1 + scale[:, None]) + shift[:, None] (reference utils.py:28-30)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, optional affine scale (no bias), output cast
    back to the input dtype; called with (shift, scale) it also modulates. With
    ``fused_adaln`` the modulated call is the fused kernel (ops/adaln.py), whose
    contract rounds once, after the modulate (JAX layers.py:106-114)."""

    def __init__(self, dim: int, eps: float = 1e-6, use_scale: bool = True,
                 fused_adaln: bool = False, device=None):
        super().__init__()
        self.fused_adaln = fused_adaln
        self.eps = eps
        if use_scale:
            self.weight = nn.Parameter(torch.empty(dim, device=device))
        else:
            self.register_parameter("weight", None)

    def _init_params(self, gen: torch.Generator) -> None:
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(1.0)

    def forward(self, x, shift=None, scale=None):
        if shift is not None and self.fused_adaln:
            return layernorm_modulate(x, self.weight, shift, scale, self.eps)
        # the JAX package's formula, op for op (F.layer_norm's Welford variance
        # rounds differently, enough to flip bf16 roundings downstream)
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight
        y = y.to(x.dtype)
        if shift is not None:
            y = modulate(y, shift, scale)
        return y


# ------------------------------------------------------------------------ MLPs


class Mlp(nn.Module):
    """timm-style MLP: fc1 -> tanh-GELU -> (norm) -> fc2 (reference utils.py:34-68)."""

    def __init__(self, in_features: int, hidden_features: int | None = None,
                 out_features: int | None = None, use_norm: bool = False,
                 use_bias: bool = True, norm_eps: float = 1e-6, fc1_init=XAVIER,
                 fc2_init=XAVIER, dtype=torch.bfloat16, device=None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = Linear(in_features, hidden, use_bias, init=fc1_init, dtype=dtype,
                          device=device)
        self.norm = LayerNorm(hidden, eps=norm_eps, device=device) if use_norm else None
        self.fc2 = Linear(hidden, out, use_bias, init=fc2_init, dtype=dtype, device=device)

    def forward(self, x):
        x = F.gelu(self.fc1(x), approximate="tanh")
        if self.norm is not None:
            x = self.norm(x)
        return self.fc2(x)


class FeedForward(nn.Module):
    """SwiGLU feed-forward: w3(silu(w1 x) * w2 x), hidden = 2/3 rounding (dit.py:63-94)."""

    def __init__(self, dim: int, hidden_dim: int, multiple_of: int, use_bias: bool,
                 w1_init=normal(0.02), w2_init=XAVIER, w3_init=XAVIER,
                 remat_hidden: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        if remat_hidden:
            raise NotImplementedError(
                "the lean remat policies are not ported (README.md, 'Not ported'; "
                "ROADMAP queue A)")
        hidden = self.rounded_hidden(hidden_dim, multiple_of)
        self.w1 = Linear(dim, hidden, use_bias, init=w1_init, dtype=dtype, device=device)
        self.w2 = Linear(dim, hidden, use_bias, init=w2_init, dtype=dtype, device=device)
        self.w3 = Linear(hidden, dim, use_bias, init=w3_init, dtype=dtype, device=device)

    @staticmethod
    def rounded_hidden(hidden_dim: int, multiple_of: int) -> int:
        hidden_dim = int(2 * hidden_dim / 3)
        return multiple_of * ((hidden_dim + multiple_of - 1) // multiple_of)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


MOE_DISPATCH = ("onehot", "onehot_dots", "hybrid", "gather", "unroll", "batched", "scan")


class FeedForwardECMoe(nn.Module):
    """Expert-choice MoE feed-forward with exact-GELU experts (dit.py:97-148): each
    expert picks its top-k tokens per sample (k = capacity * T / E). Every dispatch
    of the JAX module's table (layers.py:250-274) computes the same function and
    moves the data its own way:

      'onehot'      - per-sample one-hot matmuls gather sample-major (n, e, k, d)
                      rows for the fused expert kernel (K2, ops/moe_ffn.py) and
                      combine the gate-weighted outputs back (the default);
      'onehot_dots' - the same one-hot dispatch, the expert FFN as plain products;
      'hybrid'      - row gather / one-hot matmul with explicit adjoints
                      (ops/moe_dispatch.py) around K2, gate applied elementwise;
      'gather'      - flat expert-major gather into (e, n*k, d) rows, the fused
                      expert-major kernel (K3), gate weighting and a scatter-add
                      combine: no one-hot matmuls, whose FLOPs grow as t/f of the
                      experts' (~50% at T = 1024): the 512px stages' choice;
      'unroll', 'batched', 'scan' - the same flat gather and combine with the
                      expert FFN as plain batched products (TPU codegen variants
                      of one computation: here one torch.bmm path).

    The flat gather and combine add rows expert by expert (ops/moe_dispatch.py),
    so their sums on the card are bitwise repeatable. The gradient into the gate
    flows through topk's values and the gate weighting; the routing indices carry
    none (JAX's stop_gradient, layers.py:439). The combine runs under
    ``checkpoint_name("moe_out")``, JAX's tag (layers.py:303,307,390), for the
    'attn_moe' remat policies.

    Expert parallelism (``set_expert_parallel``, from parallel/sharding.py
    ``shard_params``): the module keeps experts [lo, lo + e_local) of ``w1`` / ``w2``.
    The gate, its softmax and the top-k stay replicated, with k from the global
    expert count; the rank runs its experts' slice of (g, m) through the same
    dispatch, combines them in fp32 and sums the partial outputs over the
    ``tensor`` group, rounding once to the compute dtype after the sum. The input
    passes an identity whose backward sums the gradient over the group; the gate's
    parameter gradient holds this rank's experts' share (parallel.sharding.Zero2
    sums it over ``tensor``)."""

    def __init__(self, num_experts: int, expert_capacity: float, dim: int,
                 hidden_dim: int, multiple_of: int, w2_init=XAVIER,
                 remat_experts: bool = False, dispatch: str = "onehot",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if dispatch not in MOE_DISPATCH:
            raise ValueError(f"unknown moe_dispatch {dispatch!r}; one of {MOE_DISPATCH}")
        if remat_experts:
            raise NotImplementedError(
                "the lean remat policies are not ported (README.md, 'Not ported'; "
                "ROADMAP queue A)")
        hidden = multiple_of * ((hidden_dim + multiple_of - 1) // multiple_of)
        self.num_experts = num_experts
        self.expert_capacity = expert_capacity
        self.dispatch = dispatch
        self.compute_dtype = dtype
        self.w2_init = w2_init
        self.gate = Linear(dim, num_experts, bias=False, init=normal(0.02), dtype=dtype,
                           device=device)
        self.w1 = nn.Parameter(torch.empty(num_experts, dim, hidden, device=device))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, dim, device=device))
        self.expert_parallel = None  # (group, first expert, local experts)

    def set_expert_parallel(self, group, index: int, size: int) -> None:
        """Keep experts [index * e / size, (index + 1) * e / size) and sum the
        partial outputs over ``group``."""
        count = self.num_experts // size
        lo = index * count
        with torch.no_grad():
            self.w1 = nn.Parameter(self.w1[lo:lo + count].clone())
            self.w2 = nn.Parameter(self.w2[lo:lo + count].clone())
        self.expert_parallel = (group, lo, count)

    def _init_params(self, gen: torch.Generator) -> None:
        e, d, f = self.w1.shape
        init_tensor(self.w1, normal(0.02), gen)
        # JAX's xavier over a 3-D (e, f, d) param: fan_in = e*f, fan_out = e*d
        init_tensor(self.w2, self.w2_init, gen, fan_in=e * f, fan_out=e * d)

    def forward(self, x):
        if self.expert_parallel is None:
            return self._experts(x, *self._route(x))
        group, lo, count = self.expert_parallel
        x = copy_to_group(x, group)
        g, m = self._route(x)
        out = self._experts(x, g[:, lo:lo + count], m[:, lo:lo + count], torch.float32)
        return reduce_from_group(out, group).to(self.compute_dtype)

    def _route(self, x):
        """Expert choice over all experts: (g, m), each (n, e, k)."""
        t, e = x.shape[1], self.num_experts
        k = int(self.expert_capacity * t / e)
        probs = torch.softmax(self.gate(x).float(), dim=-1)  # (n, t, e)
        g, m = torch.topk(probs.transpose(1, 2), k, dim=-1)
        return g.to(self.compute_dtype), m

    def _experts(self, x, g, m, combine_dtype=None):
        """The experts of ``self.w1`` / ``self.w2`` on their picks (g, m), each
        (n, e, k), combined in ``combine_dtype`` (default: the compute dtype)."""
        n, t, d = x.shape
        e, k = m.shape[1], m.shape[2]
        dt = self.compute_dtype
        cdt = combine_dtype or dt
        x = x.to(dt)
        w1, w2 = self.w1.to(dt), self.w2.to(dt)

        if self.dispatch == "hybrid":
            idx = m.reshape(n, e * k)
            xg = dispatch_rows(x, idx)  # (n, e*k, d)
            h = moe_ffn(xg.reshape(n, e, k, d), w1, w2).reshape(n, e * k, d)
            hg = (h * g.reshape(n, e * k, 1)).to(cdt)
            with checkpoint_name("moe_out"):
                return combine_rows(hg, idx, t)
        if self.dispatch in ("onehot", "onehot_dots"):
            iota = torch.arange(t, device=x.device)
            onehot = (m[..., None] == iota).to(dt).reshape(n, e * k, t)
            xg = torch.bmm(onehot, x).reshape(n, e, k, d)  # (sample, expert, slot) rows
            ffn = moe_ffn if self.dispatch == "onehot" else _moe_ffn_ref
            h = ffn(xg, w1, w2).reshape(n, e * k, d)
            weights_t = (onehot * g.reshape(n, e * k, 1)).transpose(1, 2)
            with checkpoint_name("moe_out"):
                return torch.bmm(weights_t.to(cdt), h.to(cdt))  # (n, t, d)

        # flat expert-major rows: expert i's picks of sample j at flat row j*t + m
        gidx = m + (torch.arange(n, device=x.device) * t)[:, None, None]  # (n, e, k)
        gidx = gidx.transpose(0, 1).reshape(e, n * k)
        xin = gather_expert_rows(x.reshape(n * t, d), gidx)  # (e, n*k, d)
        ffn = moe_ffn_expert_major if self.dispatch == "gather" else _moe_ffn_em_ref
        h = ffn(xin, w1, w2)
        out = (h * g.transpose(0, 1).reshape(e, n * k, 1)).to(cdt)
        with checkpoint_name("moe_out"):
            out = combine_expert_rows(out, gidx, n * t)
        return out.reshape(n, t, d)


# ------------------------------------------------------------------- attention


class SelfAttention(nn.Module):
    """Self-attention with fused qkv and non-affine QK-LayerNorm over the flattened
    head dims (reference utils.py:144-201)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 norm_eps: float = 1e-6, hidden_dim: int | None = None,
                 qkv_init=normal(0.02), proj_init=XAVIER, attn_impl: str = "auto",
                 remat_proj: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        if remat_proj:
            raise NotImplementedError(
                "the lean remat policies are not ported (README.md, 'Not ported'; "
                "ROADMAP queue A)")
        hidden = hidden_dim or dim
        assert hidden % num_heads == 0
        self.num_heads = num_heads
        self.hidden = hidden
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, hidden * 3, qkv_bias, init=qkv_init, dtype=dtype,
                          device=device)
        self.ln_q = LayerNorm(hidden, eps=norm_eps, use_scale=False)
        self.ln_k = LayerNorm(hidden, eps=norm_eps, use_scale=False)
        self.proj = Linear(hidden, dim, qkv_bias, init=proj_init, dtype=dtype,
                           device=device)

    def forward(self, x):
        b, n, _ = x.shape
        h, hd = self.num_heads, self.hidden // self.num_heads
        qkv = self.qkv(x).view(b, n, 3, self.hidden)
        q = self.ln_q(qkv[:, :, 0]).view(b, n, h, hd)
        k = self.ln_k(qkv[:, :, 1]).view(b, n, h, hd)
        v = qkv[:, :, 2].view(b, n, h, hd)  # strided view; the kernel reads strides
        out = dot_product_attention(q, k, v, impl=self.attn_impl)
        return self.proj(out.reshape(b, n, self.hidden))


class CrossAttention(nn.Module):
    """Cross-attention: q from image tokens, kv from caption tokens, QK-LayerNorm on
    the flattened hidden dims (reference utils.py:81-141)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 norm_eps: float = 1e-6, hidden_dim: int | None = None,
                 qkv_init=normal(0.02), proj_init=XAVIER, attn_impl: str = "auto",
                 remat_proj: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        if remat_proj:
            raise NotImplementedError(
                "the lean remat policies are not ported (README.md, 'Not ported'; "
                "ROADMAP queue A)")
        hidden = hidden_dim or dim
        assert hidden % num_heads == 0
        self.num_heads = num_heads
        self.hidden = hidden
        self.attn_impl = attn_impl
        self.q_linear = Linear(dim, hidden, qkv_bias, init=qkv_init, dtype=dtype,
                               device=device)
        self.kv_linear = Linear(dim, hidden * 2, qkv_bias, init=qkv_init, dtype=dtype,
                                device=device)
        self.ln_q = LayerNorm(hidden, eps=norm_eps, use_scale=False)
        self.ln_k = LayerNorm(hidden, eps=norm_eps, use_scale=False)
        self.proj = Linear(hidden, dim, qkv_bias, init=proj_init, dtype=dtype,
                           device=device)

    def forward(self, x, cond):
        b, n, _ = x.shape
        h, hd = self.num_heads, self.hidden // self.num_heads
        l = cond.shape[-2]
        cond = cond.reshape(b, l, cond.shape[-1])
        q = self.ln_q(self.q_linear(x)).view(b, n, h, hd)
        kv = self.kv_linear(cond).view(b, l, 2, self.hidden)
        k = self.ln_k(kv[:, :, 0]).view(b, l, h, hd)
        v = kv[:, :, 1].view(b, l, h, hd)
        out = dot_product_attention(q, k, v, impl=self.attn_impl, ckpt_name="xattn_out")
        return self.proj(out.reshape(b, n, self.hidden))


# ------------------------------------------------------- embedders / final layer


class _PatchProj(nn.Module):
    """Holds the patch-embedding conv's (D, C, p, p) weight and bias."""

    def __init__(self, in_channels: int, embed_dim: int, p: int, use_bias: bool, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed_dim, in_channels, p, p, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(embed_dim, device=device))
        else:
            self.register_parameter("bias", None)

    def _init_params(self, gen: torch.Generator) -> None:
        d, c, p, _ = self.weight.shape
        # xavier over the flattened (D, C*p*p) kernel; torch's conv bias default
        init_tensor(self.weight, XAVIER, gen, fan_in=c * p * p, fan_out=d)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(c * p * p)
            with torch.no_grad():
                self.bias.uniform_(-bound, bound, generator=gen)


class PatchEmbed(nn.Module):
    """Patchify + linear projection (a stride-p conv written as a matmul), NCHW in,
    (B, T, D) out with the (H/p, W/p) grid flattened row-major (dit.py:312-314)."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 use_bias: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.compute_dtype = dtype
        self.proj = _PatchProj(in_channels, embed_dim, patch_size, use_bias, device)

    def forward(self, x):
        b, c, h, w = x.shape
        p = self.patch_size
        x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, (h // p) * (w // p), c * p * p)
        dt = self.compute_dtype
        wt = self.proj.weight.reshape(self.embed_dim, c * p * p).to(dt)
        bias = None if self.proj.bias is None else self.proj.bias.to(dt)
        return F.linear(x.to(dt), wt, bias)


class TimestepEmbedder(nn.Module):
    """Cos-first sinusoidal timestep embedding + 2-layer MLP (utils.py:243-289)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 512,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.compute_dtype = dtype
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, init=normal(0.02), dtype=dtype,
                   device=device),
            nn.GELU(approximate="tanh"),
            Linear(hidden_size, hidden_size, init=normal(0.02), dtype=dtype, device=device),
        )

    @staticmethod
    def timestep_embedding(t, dim: int, max_period: int = 10000):
        half = dim // 2
        freqs = torch.exp(
            -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / half)
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t):
        t_freq = self.timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(t_freq.to(self.compute_dtype))


class CaptionProjection(nn.Module):
    """Caption embedding -> model dim MLP with inner LayerNorm (utils.py:292-318)."""

    def __init__(self, in_channels: int, hidden_size: int, norm_eps: float = 1e-6,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.y_proj = Mlp(in_channels, hidden_size, hidden_size, use_norm=True,
                          norm_eps=norm_eps, fc1_init=normal(0.02), fc2_init=normal(0.02),
                          dtype=dtype, device=device)

    def forward(self, caption):
        return self.y_proj(caption)


class T2IFinalLayer(nn.Module):
    """Final adaLN (shift/scale) + linear to p*p*C; both linears zero-init
    (utils.py:204-240, dit.py:626-627)."""

    def __init__(self, hidden_size: int, time_emb_dim: int, patch_size: int,
                 out_channels: int, norm_eps: float = 1e-6, fused_adaln: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(
            nn.GELU(approximate="tanh"),
            Linear(time_emb_dim, 2 * hidden_size, init=ZEROS, dtype=dtype, device=device),
        )
        self.norm_final = LayerNorm(hidden_size, eps=norm_eps, fused_adaln=fused_adaln,
                                    device=device)
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels,
                             init=ZEROS, dtype=dtype, device=device)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(self.norm_final(x, shift, scale))


class AttentionBlockPromptEmbedding(nn.Module):
    """Pre-LN self-attention + SwiGLU block over caption tokens; output projections
    zero-init so the block starts as identity (dit.py:12-60, 621-623)."""

    def __init__(self, dim: int, head_dim: int, mlp_ratio: float, multiple_of: int,
                 norm_eps: float, use_bias: bool, dtype=torch.bfloat16, device=None):
        super().__init__()
        assert dim % head_dim == 0
        self.norm1 = LayerNorm(dim, eps=norm_eps, device=device)
        self.attn = SelfAttention(dim, dim // head_dim, qkv_bias=use_bias, norm_eps=norm_eps,
                                  qkv_init=normal(0.02), proj_init=ZEROS, dtype=dtype,
                                  device=device)
        self.norm2 = LayerNorm(dim, eps=norm_eps, device=device)
        self.mlp = FeedForward(dim, int(dim * mlp_ratio), multiple_of, use_bias,
                               w1_init=normal(0.02), w2_init=normal(0.02), w3_init=ZEROS,
                               dtype=dtype, device=device)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


# -------------------------------- 2D sin-cos positional embedding (host numpy)
# Own copy of micro_diffusion_tpu/models/layers.py:789-819 (reference
# utils.py:330-379).


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, pos_interp_scale: float = 1.0,
                            base_size: int = 16) -> np.ndarray:
    """2D sin-cos positional embedding with resolution-transfer interpolation:
    grid coords divided by (grid/base)/interp_scale."""
    grid_h = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size) / pos_interp_scale
    grid_w = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size) / pos_interp_scale
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0)
    grid = grid.reshape([2, 1, grid_size, grid_size])
    return get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
