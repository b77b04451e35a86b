"""AutoencoderKL (the SD/SDXL VAE) in PyTorch, counterpart of micro_diffusion_tpu/models/vae.py.

A frozen f8 KL autoencoder: conv encoder -> diagonal Gaussian latents, conv decoder
for ``generate()``. 4-level encoder/decoder (``block_out_channels``,
``layers_per_block`` resnets), GroupNorm(32, eps 1e-6), SiLU, one single-head
attention block in each mid block; the 4-channel SDXL VAE and the 16-channel
ostris/vae-kl-f8-d16 through ``latent_channels``. NCHW throughout, as diffusers.

Numerics follow the JAX module: parameters fp32; convolutions and products in
``compute_dtype`` (bf16 as the reference loads the VAE, or fp32); GroupNorm
statistics fp32 in either; the attention softmax fp32 (4096-token rows at 512px);
the encoder's ``conv_out``, ``quant_conv`` and ``post_quant_conv`` and the decoder's
``conv_out`` in fp32, so moments and pixels come out fp32. The layout traps between
flax NHWC and torch NCHW: the downsample pads (0, 1, 0, 1) before a stride-2, pad-0
conv; the upsample is a 2x nearest resize then a conv.

State-dict names are diffusers AutoencoderKL's (``encoder.down_blocks.N.resnets.M``,
``mid_block.attentions.0.to_q``, ``downsamplers.0.conv``, ...), so a snapshot loads
with ``strict=True`` (``from_pretrained``). Random weights come from a generator
(``init_weights``) at PyTorch's default scales.
"""

import json
import os
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dit import resolve_device
from .layers import Linear, init_tensor, normal

GROUPS = 32


class Conv2d(nn.Conv2d):
    """nn.Conv2d with fp32 parameters that computes in ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(cin, cout, kernel, stride,
                         kernel // 2 if padding is None else padding, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        """No-op: ``_init_params`` sets the weights (called by init_weights)."""

    def _init_params(self, gen: torch.Generator) -> None:
        # the variance of PyTorch's default uniform(+-1/sqrt(fan_in))
        std = (3 * self.weight[0].numel()) ** -0.5
        init_tensor(self.weight, normal(std), gen)
        init_tensor(self.bias, normal(std), gen)

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNorm(nn.Module):
    """GroupNorm(32, eps 1e-6) with fp32 statistics; output in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.compute_dtype = dtype

    def _init_params(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.group_norm(x.float(), GROUPS, self.weight, self.bias,
                            1e-6).to(self.compute_dtype)


def _dense(c: int, dtype, device):
    return Linear(c, c, init=normal((3 * c) ** -0.5), dtype=dtype, device=device)


class ResnetBlock(nn.Module):
    """norm -> SiLU -> conv, twice, plus a 1x1 shortcut where the width changes
    (JAX vae.py:35)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.norm1 = GroupNorm(cin, dtype, device)
        self.conv1 = Conv2d(cin, cout, dtype=dtype, device=device)
        self.norm2 = GroupNorm(cout, dtype, device)
        self.conv2 = Conv2d(cout, cout, dtype=dtype, device=device)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1, dtype=dtype, device=device)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions (JAX vae.py:61): logits in
    the compute dtype, softmax in fp32."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.group_norm = GroupNorm(channels, dtype, device)
        self.to_q = _dense(channels, dtype, device)
        self.to_k = _dense(channels, dtype, device)
        self.to_v = _dense(channels, dtype, device)
        self.to_out = nn.ModuleList([_dense(channels, dtype, device)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.bmm(q, k.transpose(1, 2)) * c**-0.5
        attn = torch.softmax(logits.float(), dim=-1).to(y.dtype)
        y = self.to_out[0](torch.bmm(attn, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class _Resample(nn.Module):
    """diffusers' Downsample2D / Upsample2D: the ``conv`` and the resize around it."""

    def __init__(self, ch: int, down: bool, dtype, device):
        super().__init__()
        self.down = down
        self.conv = Conv2d(ch, ch, 3, 2 if down else 1, 0 if down else 1, dtype=dtype,
                           device=device)

    def forward(self, x):
        if self.down:  # asymmetric (0, 1) padding of H and W, then stride 2, pad 0
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down or up block: ``resnets`` then, but in the last, one resample."""

    def __init__(self, cin: int, ch: int, n: int, resample: Optional[str], dtype, device):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else ch, ch, dtype, device) for j in range(n))
        if resample == "down":
            self.downsamplers = nn.ModuleList([_Resample(ch, True, dtype, device)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([_Resample(ch, False, dtype, device)])

    def forward(self, h):
        for r in self.resnets:
            h = r(h)
        for s in getattr(self, "downsamplers", getattr(self, "upsamplers", ())):
            h = s(h)
        return h


class _MidBlock(nn.Module):
    def __init__(self, ch: int, dtype, device):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(ch, ch, dtype, device) for _ in range(2))
        self.attentions = nn.ModuleList([AttnBlock(ch, dtype, device)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class Encoder(nn.Module):
    """Image (B, 3, H, W) -> moments (B, 2 * latent, H/8, W/8) in fp32 (JAX vae.py:88)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        chans = list(block_out_channels)
        self.conv_in = Conv2d(3, chans[0], dtype=dtype, device=device)
        self.down_blocks = nn.ModuleList(
            _Block(chans[max(i - 1, 0)], ch, layers_per_block,
                   "down" if i < len(chans) - 1 else None, dtype, device)
            for i, ch in enumerate(chans))
        self.mid_block = _MidBlock(chans[-1], dtype, device)
        self.conv_norm_out = GroupNorm(chans[-1], dtype, device)
        # moments in fp32: the latent distribution feeds training targets
        self.conv_out = Conv2d(chans[-1], 2 * latent_channels, device=device)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = F.silu(self.conv_norm_out(self.mid_block(h)))
        return self.conv_out(h.float())


class Decoder(nn.Module):
    """Latents (B, latent, h, w) -> image (B, 3, 8h, 8w) in fp32 (JAX vae.py:119)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 out_channels: int = 3, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        chans = list(reversed(block_out_channels))
        self.conv_in = Conv2d(latent_channels, chans[0], dtype=dtype, device=device)
        self.mid_block = _MidBlock(chans[0], dtype, device)
        self.up_blocks = nn.ModuleList(
            _Block(chans[max(i - 1, 0)], ch, layers_per_block + 1,
                   "up" if i < len(chans) - 1 else None, dtype, device)
            for i, ch in enumerate(chans))
        self.conv_norm_out = GroupNorm(chans[-1], dtype, device)
        # pixels in fp32
        self.conv_out = Conv2d(chans[-1], out_channels, device=device)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)).float())


class AutoencoderKL(nn.Module):
    """The frozen VAE with the reference's call surface (NCHW, JAX vae.py:184):

        vae.encode(images, generator)  -> sampled latents (the caller scales them)
        vae.encode_mode(images)        -> the distribution's mean
        vae.decode(latents)            -> images in [-1, 1], fp32
        vae.scaling_factor

    ``device`` None means the card (raises without one). Parameters are left
    uninitialised: ``init_weights(generator)`` or a loaded state dict sets them.
    """

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 scaling_factor: float = 0.13025,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.block_out_channels = tuple(block_out_channels)
        self.layers_per_block = layers_per_block
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        self.compute_dtype = compute_dtype
        self.encoder = Encoder(block_out_channels, layers_per_block, latent_channels,
                               compute_dtype, device)
        self.decoder = Decoder(block_out_channels, layers_per_block, latent_channels, 3,
                               compute_dtype, device)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1, device=device)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1, device=device)
        self.requires_grad_(False)

    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        for mod in self.modules():
            if hasattr(mod, "_init_params"):
                mod._init_params(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.quant_conv.weight.device

    @torch.no_grad()
    def encode_moments(self, images):
        """(mean, logvar) of the latent distribution, logvar clipped to [-30, 20]."""
        x = torch.as_tensor(images, device=self.device).float()
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    @torch.no_grad()
    def encode(self, images, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """Sampled latents (diffusers' ``latent_dist.sample()``); ``noise`` (the
        latents' shape) is drawn from ``generator`` when not given."""
        mean, logvar = self.encode_moments(images)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.device).float()

    def encode_mode(self, images):
        return self.encode_moments(images)[0]

    @torch.no_grad()
    def decode(self, latents):
        z = torch.as_tensor(latents, device=self.device).float()
        return self.decoder(self.post_quant_conv(z))

    @classmethod
    def from_pretrained(cls, name: str, weights_dir: Optional[str] = None,
                        subfolder: str = "vae", compute_dtype: torch.dtype = torch.float32,
                        device=None) -> "AutoencoderKL":
        """Load a local HF snapshot (config.json + weights, JAX vae.py:251):
        ``weights_dir`` is the model root; the SDXL repo keeps the VAE under 'vae',
        ostris/vae-kl-f8-d16 at the root."""
        from .text_encoders import load_state_dict_from_dir

        if weights_dir is None:
            raise FileNotFoundError(
                f"no local weights for VAE '{name}': pass weights_dir with a local HF "
                "snapshot")
        root = weights_dir
        if name != "ostris/vae-kl-f8-d16" and os.path.isdir(os.path.join(root, subfolder)):
            root = os.path.join(root, subfolder)
        with open(os.path.join(root, "config.json")) as f:
            cfg = json.load(f)
        vae = cls(block_out_channels=cfg.get("block_out_channels", (128, 256, 512, 512)),
                  layers_per_block=cfg.get("layers_per_block", 2),
                  latent_channels=cfg.get("latent_channels", 4),
                  scaling_factor=cfg.get("scaling_factor", 0.13025),
                  compute_dtype=compute_dtype, device=device)
        vae.load_state_dict(load_state_dict_from_dir(root), strict=True)
        return vae
