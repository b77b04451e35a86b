"""The frozen encoders of the sampling path, plain and in float32: the CLIP text
tower (OpenCLIP's layout) and the SD/SDXL KL autoencoder (diffusers' layout, its
products' operands through ``Operands`` for the control), under
the public checkpoints' state-dict names, so that the benchmark's seeded weights fill
the port's modules and these alike.

CLIP text: token and positional embedding, a causal pre-LN transformer (LayerNorm
eps 1e-5, fused in-projection, GELU or quick-GELU MLP of width 4w), ``ln_final``;
every token's embedding is returned. The VAE's decoder: post-quant 1x1 conv, conv_in,
a mid block (two resnets around a single-head attention over the positions), up
blocks of ``layers + 1`` resnets each followed, but in the last, by a 2x nearest
resize and a conv, GroupNorm(32, eps 1e-6) + SiLU, conv_out. The encoder is built too
(its leaves are part of the VAE's weights) but never run.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import Operands

FP32 = Operands("fp32")


def _p(*shape):
    return nn.Parameter(torch.empty(*shape))


class _LN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight, self.bias = _p(dim), _p(dim)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class _Linear(nn.Module):
    def __init__(self, din, dout, q=FP32):
        super().__init__()
        self.weight, self.bias = _p(dout, din), _p(dout)
        self.q = q

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class _CLIPAttention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.in_proj_weight, self.in_proj_bias = _p(3 * width, width), _p(3 * width)
        self.out_proj = _Linear(width, width)
        self.heads = heads

    def forward(self, x, mask):
        b, l, w = x.shape
        hd = w // self.heads
        q, k, v = (t.reshape(b, l, self.heads, hd) for t in
                   F.linear(x, self.in_proj_weight, self.in_proj_bias).split(w, -1))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5 + mask
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.out_proj(out.reshape(b, l, w))


class _CLIPBlock(nn.Module):
    def __init__(self, width, heads, quick_gelu):
        super().__init__()
        self.ln_1, self.ln_2 = _LN(width), _LN(width)
        self.attn = _CLIPAttention(width, heads)
        self.mlp = nn.Module()
        self.mlp.c_fc, self.mlp.c_proj = _Linear(width, 4 * width), _Linear(4 * width, width)
        self.quick_gelu = quick_gelu

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp.c_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return x + self.mlp.c_proj(h)


class CLIPText(nn.Module):
    """``t`` is a configuration's text encoder block: vocab, width, layers, heads,
    context, quick_gelu."""

    def __init__(self, t: dict):
        super().__init__()
        self.token_embedding = nn.Embedding(t["vocab"], t["width"],
                                            _weight=torch.empty(t["vocab"], t["width"]))
        self.positional_embedding = _p(t["context"], t["width"])
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            _CLIPBlock(t["width"], t["heads"], t["quick_gelu"]) for _ in range(t["layers"]))
        self.ln_final = _LN(t["width"])

    def forward(self, ids):
        l = ids.shape[1]
        x = self.token_embedding(ids) + self.positional_embedding[:l]
        mask = torch.full((l, l), float("-inf"), device=x.device).triu(1)
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        return self.ln_final(x)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, pad=None, q=FP32):
        super().__init__()
        self.weight, self.bias = _p(cout, cin, k, k), _p(cout)
        self.stride, self.pad = stride, k // 2 if pad is None else pad
        self.q = q

    def forward(self, x):
        return F.conv2d(self.q(x), self.q(self.weight), self.bias, self.stride, self.pad)


class _GN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight, self.bias = _p(c), _p(c)

    def forward(self, x):
        return F.group_norm(x, 32, self.weight, self.bias, 1e-6)


class _Resnet(nn.Module):
    def __init__(self, cin, cout, q):
        super().__init__()
        self.norm1, self.conv1 = _GN(cin), _Conv(cin, cout, q=q)
        self.norm2, self.conv2 = _GN(cout), _Conv(cout, cout, q=q)
        if cin != cout:
            self.conv_shortcut = _Conv(cin, cout, 1, q=q)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class _Attn(nn.Module):
    def __init__(self, c, q):
        super().__init__()
        self.group_norm = _GN(c)
        self.to_q, self.to_k, self.to_v = _Linear(c, c, q), _Linear(c, c, q), _Linear(c, c, q)
        self.to_out = nn.ModuleList([_Linear(c, c, q)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        a = torch.softmax(self.to_q(y) @ self.to_k(y).transpose(1, 2) * c ** -0.5, dim=-1)
        y = self.to_out[0](a @ self.to_v(y))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Resample(nn.Module):
    def __init__(self, c, down, q):
        super().__init__()
        self.down = down
        self.conv = _Conv(c, c, 3, 2 if down else 1, 0 if down else 1, q)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    def __init__(self, cin, c, n, resample, q):
        super().__init__()
        self.resnets = nn.ModuleList(_Resnet(cin if j == 0 else c, c, q) for j in range(n))
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Resample(c, True, q)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Resample(c, False, q)])

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        for s in getattr(self, "upsamplers", ()):
            h = s(h)
        return h


class _Mid(nn.Module):
    def __init__(self, c, q):
        super().__init__()
        self.resnets = nn.ModuleList([_Resnet(c, c, q), _Resnet(c, c, q)])
        self.attentions = nn.ModuleList([_Attn(c, q)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class VAE(nn.Module):
    """``v`` is a configuration's VAE block: channels, layers, latent_channels,
    scaling_factor; the products' operands in ``precision`` (precision.py)."""

    def __init__(self, v: dict, precision: str = "fp32"):
        super().__init__()
        ch, n, lat = list(v["channels"]), v["layers"], v["latent_channels"]
        q = Operands(precision)
        self.scaling_factor = v["scaling_factor"]
        self.encoder = nn.Module()
        self.encoder.conv_in = _Conv(3, ch[0], q=q)
        self.encoder.down_blocks = nn.ModuleList(
            _Level(ch[max(i - 1, 0)], c, n, "down" if i < len(ch) - 1 else None, q)
            for i, c in enumerate(ch))
        self.encoder.mid_block = _Mid(ch[-1], q)
        self.encoder.conv_norm_out = _GN(ch[-1])
        self.encoder.conv_out = _Conv(ch[-1], 2 * lat, q=q)
        rc = list(reversed(ch))
        self.decoder = nn.Module()
        self.decoder.conv_in = _Conv(lat, rc[0], q=q)
        self.decoder.mid_block = _Mid(rc[0], q)
        self.decoder.up_blocks = nn.ModuleList(
            _Level(rc[max(i - 1, 0)], c, n + 1, "up" if i < len(rc) - 1 else None, q)
            for i, c in enumerate(rc))
        self.decoder.conv_norm_out = _GN(rc[-1])
        self.decoder.conv_out = _Conv(rc[-1], 3, q=q)
        self.quant_conv = _Conv(2 * lat, 2 * lat, 1, q=q)
        self.post_quant_conv = _Conv(lat, lat, 1, q=q)

    def decode_images(self, latents):
        """Sampled latents -> images in [0, 1]."""
        d = self.decoder
        h = d.mid_block(d.conv_in(self.post_quant_conv(latents / self.scaling_factor)))
        for blk in d.up_blocks:
            h = blk(h)
        x = d.conv_out(F.silu(d.conv_norm_out(h)))
        return (x / 2 + 0.5).clamp(0, 1)
