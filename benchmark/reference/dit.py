"""A plain float32 MicroDiT: the benchmark's reference of the port's DiT.

Written from the published model (arXiv 2407.15811; the reference code's dit.py and
utils.py) with plain torch operations: no kernel, no remat, no bf16 casts. Parameter
names are the reference's state-dict names, so that the benchmark's seeded weights
fill the port's model and this one alike. Departures from the published model:

  * attention is an explicit softmax(q k^T / sqrt(d)) v in float32 (the published
    code calls a fused kernel, which computes the same function);
  * the expert-choice MoE gathers each expert's top-k tokens by index and adds the
    gate-weighted outputs back with ``index_add_`` (the published code does the same
    through one-hot products);
  * every product's operands and output, and the residual stream after each
    update, go through ``Operands`` (precision.py): the identity in float32; the
    control rounds them to fp8 where the program rounds them to bf16.

Tokens are (B, T, D); the patch grid is flattened row-major.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import Operands


def _p(*shape):
    return nn.Parameter(torch.empty(*shape))


class Linear(nn.Module):
    def __init__(self, q: Operands, din: int, dout: int, bias: bool):
        super().__init__()
        self.q = q
        self.weight = _p(dout, din)
        self.bias = _p(dout) if bias else None

    def forward(self, x):
        return self.q(F.linear(self.q(x), self.q(self.weight), self.bias))


class LayerNorm(nn.Module):
    """LayerNorm without bias, optional scale, eps 1e-6."""

    def __init__(self, dim: int, scale: bool = True, eps: float = 1e-6):
        super().__init__()
        self.weight = _p(dim) if scale else None
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight if self.weight is not None else y


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def attention(q_ops: Operands, q, k, v):
    """Softmax attention over (B, T, H, D) heads, scale 1/sqrt(D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_ops(q), q_ops(k)) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return q_ops(torch.einsum("bhqk,bkhd->bqhd", q_ops(p), q_ops(v)))


class SelfAttention(nn.Module):
    """Fused qkv, non-affine LayerNorm on q and k over the flattened heads."""

    def __init__(self, q: Operands, dim: int, hidden: int, head_dim: int):
        super().__init__()
        self.q, self.hidden, self.heads = q, hidden, hidden // head_dim
        self.qkv = Linear(q, dim, 3 * hidden, False)
        self.ln_q = LayerNorm(hidden, scale=False)
        self.ln_k = LayerNorm(hidden, scale=False)
        self.proj = Linear(q, hidden, dim, False)

    def forward(self, x):
        b, t, _ = x.shape
        qq, kk, vv = self.qkv(x).split(self.hidden, dim=-1)
        shape = (b, t, self.heads, self.hidden // self.heads)
        out = attention(self.q, self.ln_q(qq).reshape(shape), self.ln_k(kk).reshape(shape),
                        vv.reshape(shape))
        return self.proj(out.reshape(b, t, self.hidden))


class CrossAttention(nn.Module):
    def __init__(self, q: Operands, dim: int, head_dim: int):
        super().__init__()
        self.q, self.dim, self.heads = q, dim, dim // head_dim
        self.q_linear = Linear(q, dim, dim, False)
        self.kv_linear = Linear(q, dim, 2 * dim, False)
        self.ln_q = LayerNorm(dim, scale=False)
        self.ln_k = LayerNorm(dim, scale=False)
        self.proj = Linear(q, dim, dim, False)

    def forward(self, x, y):
        b, t, _ = x.shape
        hd = self.dim // self.heads
        qq = self.ln_q(self.q_linear(x)).reshape(b, t, self.heads, hd)
        kk, vv = self.kv_linear(y).split(self.dim, dim=-1)
        kk = self.ln_k(kk).reshape(b, y.shape[1], self.heads, hd)
        out = attention(self.q, qq, kk, vv.reshape(b, y.shape[1], self.heads, hd))
        return self.proj(out.reshape(b, t, self.dim))


class SwiGLU(nn.Module):
    def __init__(self, q: Operands, dim: int, hidden: int):
        super().__init__()
        self.w1 = Linear(q, dim, hidden, False)
        self.w2 = Linear(q, dim, hidden, False)
        self.w3 = Linear(q, hidden, dim, False)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


class ExpertChoiceMoE(nn.Module):
    """Each of E experts takes the k = capacity * T / E tokens of each image that its
    softmax gate weighs most, runs gelu(x w1) w2 on them, and adds the outputs back
    weighted by the gate."""

    def __init__(self, q: Operands, dim: int, hidden: int, experts: int, capacity: float):
        super().__init__()
        self.q, self.experts, self.capacity = q, experts, capacity
        self.gate = Linear(q, dim, experts, False)
        self.w1 = _p(experts, dim, hidden)
        self.w2 = _p(experts, hidden, dim)

    def forward(self, x):
        n, t, d = x.shape
        e = self.experts
        k = int(self.capacity * t / e)
        probs = torch.softmax(self.gate(x), dim=-1)            # (n, t, e)
        g, idx = torch.topk(probs.transpose(1, 2), k, dim=-1)  # (n, e, k)
        rows = (idx + t * torch.arange(n, device=x.device)[:, None, None])
        rows = rows.transpose(0, 1).reshape(e, n * k)          # flat token rows per expert
        xin = x.reshape(n * t, d)[rows]                        # (e, n*k, d)
        h = F.gelu(torch.bmm(self.q(xin), self.q(self.w1)))
        out = torch.bmm(self.q(h), self.q(self.w2))
        out = out * g.transpose(0, 1).reshape(e, n * k, 1)
        y = torch.zeros(n * t, d, device=x.device, dtype=out.dtype)
        y = y.index_add(0, rows.reshape(-1), out.reshape(e * n * k, d))
        return self.q(y.reshape(n, t, d))


class Mlp(nn.Module):
    """fc1 -> tanh-GELU -> LayerNorm -> fc2, with biases."""

    def __init__(self, q: Operands, din: int, dim: int):
        super().__init__()
        self.fc1 = Linear(q, din, dim, True)
        self.norm = LayerNorm(dim)
        self.fc2 = Linear(q, dim, dim, True)

    def forward(self, x):
        return self.fc2(self.norm(F.gelu(self.fc1(x), approximate="tanh")))


class AdaLN(nn.Module):
    """adaLN_modulation: tanh-GELU then a Linear to ``chunks`` x dim ('.1')."""

    def __init__(self, q: Operands, cdim: int, dim: int, chunks: int):
        super().__init__()
        self.add_module("1", Linear(q, cdim, chunks * dim, True))
        self.chunks = chunks

    def forward(self, c):
        return getattr(self, "1")(F.gelu(c, approximate="tanh")).chunk(self.chunks, dim=1)


class Block(nn.Module):
    """adaLN-zero block: gated self-attention, cross-attention, gated dense SwiGLU or
    expert-choice MoE feed-forward."""

    def __init__(self, q: Operands, m: dict, dim: int, qkv: int, mlp: int, moe: bool):
        super().__init__()
        hd = m["head_dim"]
        self.q = q
        self.adaLN_modulation = AdaLN(q, m["dim"], dim, 6)
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(q, dim, qkv, hd)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = CrossAttention(q, dim, hd)
        self.norm3 = LayerNorm(dim)
        mult = m["multiple_of"]
        if moe:
            f = mult * ((mlp + mult - 1) // mult)
            self.mlp = ExpertChoiceMoE(q, dim, f, m["num_experts"], m["expert_capacity"])
        else:
            f = mult * ((int(2 * mlp / 3) + mult - 1) // mult)
            self.mlp = SwiGLU(q, dim, f)

    def forward(self, x, y, c):
        q = self.q
        s1, sc1, g1, s2, sc2, g2 = self.adaLN_modulation(c)
        x = q(x + g1[:, None] * self.attn(modulate(self.norm1(x), s1, sc1)))
        x = q(x + self.cross_attn(self.norm2(x), y))
        return q(x + g2[:, None] * self.mlp(modulate(self.norm3(x), s2, sc2)))


class CaptionBlock(nn.Module):
    """Pre-LN self-attention and SwiGLU over the caption tokens."""

    def __init__(self, q: Operands, dim: int, head_dim: int, multiple_of: int):
        super().__init__()
        self.q = q
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(q, dim, dim, head_dim)
        self.norm2 = LayerNorm(dim)
        h = multiple_of * ((int(2 * 4 * dim / 3) + multiple_of - 1) // multiple_of)
        self.mlp = SwiGLU(q, dim, h)

    def forward(self, x):
        x = self.q(x + self.attn(self.norm1(x)))
        return self.q(x + self.mlp(self.norm2(x)))


def sincos_pos_embed(dim: int, grid: int, interp: float) -> np.ndarray:
    """2-D sin-cos positions (reference utils.py:330-379) on a grid whose base size is
    the grid itself, coordinates divided by ``interp``; (grid * grid, dim), float64."""
    coords = np.arange(grid, dtype=np.float32) / interp
    ww, hh = np.meshgrid(coords, coords)

    def one(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one(dim // 2, ww), one(dim // 2, hh)], axis=1)


def _ratios(lo, hi, n):
    return [float(r) for r in np.linspace(lo, hi, num=n)]


def _qkv(dim, ratio, head_dim):
    if ratio == 1:
        return dim
    unit = 2 * head_dim
    return unit * ((int(dim * ratio) + unit - 1) // unit)


class MicroDiT(nn.Module):
    """patchify -> + positions -> timestep and caption conditioning -> patch mixer
    (on every token) -> [keep the unmasked tokens] -> backbone -> final adaLN layer ->
    [zeros at the masked tokens] -> unpatchify. ``m`` is a configuration's ``model``
    block (benchmark/configs)."""

    def __init__(self, m: dict, precision: str = "fp32"):
        super().__init__()
        q = self.q = Operands(precision)
        d, hd, p = m["dim"], m["head_dim"], m["patch_size"]
        self.m = m
        self.x_embedder = nn.Module()
        self.x_embedder.proj = nn.Module()
        self.x_embedder.proj.weight = _p(d, m["in_channels"], p, p)
        self.x_embedder.proj.bias = _p(d)
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.ModuleDict({"0": Linear(q, m["freq_dim"], d, True),
                                             "2": Linear(q, d, d, True)})
        self.y_embedder = nn.Module()
        self.y_embedder.y_proj = Mlp(q, m["caption_channels"], d)
        self.y_emb_preprocess = CaptionBlock(q, d, hd, m["multiple_of"])
        self.pooled_y_emb_process = Mlp(q, d, d)
        dm = m["mixer_dim"]
        every = m["experts_every_n"]
        mixer_moe = [i in range(1, m["mixer_depth"]) and (i + 1) % every == 0
                     for i in range(m["mixer_depth"])]
        self.patch_mixer = nn.ModuleList(
            Block(q, m, dm, dm, int(dm * m["mixer_mlp_ratio"]), mixer_moe[i])
            for i in range(m["mixer_depth"]))
        self.maps = dm != d
        if self.maps:
            def norm_linear(a, b):
                return nn.ModuleDict({"0": LayerNorm(a), "1": Linear(q, a, b, False)})
            self.patch_mixer_map_xin = norm_linear(d, dm)
            self.patch_mixer_map_xout = norm_linear(dm, d)
            self.patch_mixer_map_y = norm_linear(d, dm)
        depth = m["depth"]
        qkv_r, mlp_r = _ratios(*m["qkv_ratio"], depth), _ratios(*m["mlp_ratio"], depth)
        moe = [i in range(0, depth - 1) and (i + 1) % every == 0 for i in range(depth)]
        self.blocks = nn.ModuleList(
            Block(q, m, d, _qkv(d, qkv_r[i], hd), int(d * mlp_r[i]), moe[i])
            for i in range(depth))
        self.final_layer = nn.Module()
        self.final_layer.adaLN_modulation = AdaLN(q, d, d, 2)
        self.final_layer.norm_final = LayerNorm(d)
        self.final_layer.linear = Linear(q, d, p * p * m["in_channels"], True)
        grid = m["latent_res"] // p
        pos = sincos_pos_embed(d, grid, m["pos_interp_scale"])
        self.register_buffer("pos_embed", torch.tensor(pos[None], dtype=torch.float32),
                             persistent=False)

    def timestep_embedding(self, t):
        half = self.m["freq_dim"] // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, device=t.device) / half)
        args = t[:, None].float() * freqs[None]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    @staticmethod
    def _norm_linear(nl, x):
        return nl["1"](nl["0"](x))

    def forward(self, x, t, y, token_mask=None):
        """x (B, C, H, W) noisy latents scaled by c_in; t (B,) c_noise; y (B, L, Dc)
        caption latents; token_mask (ids_keep, ids_restore) or None. Returns (B, C,
        H, W)."""
        b, c, h, w = x.shape
        p = self.m["patch_size"]
        patches = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(b, (h // p) * (w // p), c * p * p)
        proj = self.x_embedder.proj
        x = self.q(F.linear(self.q(patches),
                            self.q(proj.weight.reshape(proj.weight.shape[0], -1)), proj.bias)
                   + self.pos_embed)
        temb = self.t_embedder.mlp["2"](
            F.gelu(self.t_embedder.mlp["0"](self.timestep_embedding(t)), approximate="tanh"))
        y = self.y_emb_preprocess(self.y_embedder.y_proj(y))
        cond = temb + self.pooled_y_emb_process(y.mean(dim=1))
        ym = y
        if self.maps:
            x = self._norm_linear(self.patch_mixer_map_xin, x)
            ym = self._norm_linear(self.patch_mixer_map_y, y)
        for blk in self.patch_mixer:
            x = blk(x, ym, cond)
        if token_mask is not None:
            ids_keep, _ = token_mask
            x = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, x.shape[-1]))
        if self.maps:
            x = self._norm_linear(self.patch_mixer_map_xout, x)
        for blk in self.blocks:
            x = blk(x, y, cond)
        fl = self.final_layer
        shift, scale = fl.adaLN_modulation(cond)
        x = fl.linear(modulate(fl.norm_final(x), shift, scale))
        if token_mask is not None:
            _, ids_restore = token_mask
            full = torch.cat([x, x.new_zeros(b, ids_restore.shape[1] - x.shape[1],
                                              x.shape[2])], dim=1)
            x = torch.gather(full, 1, ids_restore[:, :, None].expand(-1, -1, x.shape[-1]))
        x = x.reshape(b, h // p, w // p, p, p, c)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(b, c, h, w)
