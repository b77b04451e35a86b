"""EDM latent diffusion in PyTorch, counterpart of
micro_diffusion_tpu/models/diffusion.py: the training loss, the sampler and the
prompt -> image path.

``LatentDiffusion`` holds the DiT as a submodule, and optionally the frozen VAE
(models/vae.py), text encoder and tokenizer (models/text_encoders.py).
``forward(batch)`` is the training loss (``edm_loss``: log-normal sigma, the EDM
weight, the masked patch-pooled loss, the caption drop) on precomputed latents, or on
raw images and token ids through the VAE and the text encoder; its draws (the VAE's
latent noise, the sigma normal, the noise, the token mask) come from a
``torch.Generator`` or are injected. ``generate(prompt=... | tokenized_prompts=... |
text_embeddings=...)`` tokenizes and encodes, runs the EDM Heun sampler (with
classifier-free guidance) as a Python loop over steps, with the Heun correction on
every step but the last, then decodes with the VAE into images in [0, 1]. The sigma
schedule is host float64 numpy (bit-identical to the JAX package); the per-step
scalars are rounded to float32 on the host as the JAX loop carries them, and x is
carried in float32.
"""

import dataclasses
import json
import math
import os

import numpy as np
import torch
import torch.nn as nn

from ..ops.masking import make_token_mask
from . import dit as model_zoo
from .dit import resolve_device


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """EDM (Karras et al.) parameters (reference model.py:74-86)."""

    sigma_min: float = 0.002
    sigma_max: float = 80.0
    P_mean: float = -0.6
    P_std: float = 1.2
    sigma_data: float = 0.9
    num_steps: int = 18
    rho: float = 7.0
    S_churn: float = 0.0
    S_min: float = 0.0
    S_max: float = float("inf")
    S_noise: float = 1.0


def text_encoder_embedding_format(enc: str) -> tuple[int, int]:
    """(sequence length, embedding dim) per text encoder (reference utils.py:501-513)."""
    if enc in (
        "stabilityai/stable-diffusion-2-base",
        "runwayml/stable-diffusion-v1-5",
        "CompVis/stable-diffusion-v1-4",
        "openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378",
    ):
        return 77, 1024
    if enc == "DeepFloyd/t5-v1_1-xxl":
        return 120, 4096
    # a local HF CLIPTextModel snapshot directory
    cfg_path = os.path.join(enc, "config.json")
    if os.path.isdir(enc) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        return int(cfg.get("max_position_embeddings", 77)), int(cfg["hidden_size"])
    raise ValueError(f"Please specify the sequence and embedding size of {enc} encoder")


# Latent scaling factors of the supported VAEs (diffusers config.scaling_factor).
VAE_SCALING_FACTORS = {
    "stabilityai/stable-diffusion-xl-base-1.0": 0.13025,
    "ostris/vae-kl-f8-d16": 1.0,
}

class LatentDiffusion(nn.Module):
    """DiT denoiser with the EDM preconditioning and Heun sampler, and the frozen
    ``vae``, ``text_encoder`` and ``tokenizer`` handles (None when not attached:
    then the paths that need them raise)."""

    def __init__(self, dit: model_zoo.DiT, vae=None, text_encoder=None, tokenizer=None,
                 latent_res: int = 32, p_mean: float = -0.6, p_std: float = 1.2,
                 train_mask_ratio: float = 0.0, latent_scale: float | None = None,
                 precomputed_latents: bool = True):
        super().__init__()
        self.dit = dit
        self.vae = vae
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.latent_res = latent_res
        self.edm_config = EDMConfig(P_mean=p_mean, P_std=p_std)
        self.train_mask_ratio = train_mask_ratio
        self.eval_mask_ratio = 0.0  # no masking during sampling/eval (model.py:88)
        self.precomputed_latents = precomputed_latents
        if latent_scale is None:
            latent_scale = float(getattr(vae, "scaling_factor", 1.0))
        self.latent_scale = latent_scale

    def model_forward_wrapper(self, x, sigma, y, cfg: float = 1.0,
                              mask_ratio: float = 0.0, **mask_kw) -> dict:
        """EDM preconditioning around the DiT call (reference model.py:144-179);
        cfg != 1 runs the guided (batch-doubled) forward. ``mask_kw`` (token_mask,
        generator) goes to the DiT's masked forward."""
        ec = self.edm_config
        sd2 = ec.sigma_data**2
        sigma = sigma.float().reshape(-1, 1, 1, 1)
        c_skip = torch.full_like(sigma, sd2) / (sigma**2 + sd2)
        c_out = sigma * ec.sigma_data / torch.sqrt(sigma**2 + sd2)
        c_in = 1.0 / torch.sqrt(sd2 + sigma**2)
        c_noise = torch.log(sigma) / 4.0
        out = self.dit((c_in * x).to(x.dtype), c_noise.reshape(-1), y, cfg=cfg,
                       mask_ratio=mask_ratio, **mask_kw)
        out = dict(out)
        out["sample"] = c_skip * x + c_out * out["sample"].float()
        return out

    def edm_loss(self, x, y, mask_ratio: float = 0.0, *,
                 generator: torch.Generator | None = None, rnd_normal=None, noise=None,
                 token_mask=None):
        """Log-normal-sigma EDM loss with mask-aware patch pooling (model.py:181-210).

        ``rnd_normal`` (N, 1, 1, 1), ``noise`` (N, C, H, W) and ``token_mask``: the
        ones not given are ``train_draws``'s from ``generator``.
        """
        ec = self.edm_config
        x = x.float()
        y = y.float()
        if rnd_normal is None or noise is None or (mask_ratio > 0 and token_mask is None):
            drawn = self.train_draws(x.shape, mask_ratio, generator, x.device)
            rnd_normal = drawn["rnd_normal"] if rnd_normal is None else rnd_normal
            noise = drawn["noise"] if noise is None else noise
            token_mask = drawn.get("token_mask") if token_mask is None else token_mask
        sigma = torch.exp(rnd_normal.float() * ec.P_std + ec.P_mean)
        weight = (sigma**2 + ec.sigma_data**2) / (sigma * ec.sigma_data) ** 2
        n = noise.float() * sigma
        out = self.model_forward_wrapper(x + n, sigma, y, mask_ratio=mask_ratio,
                                         token_mask=token_mask)
        loss = weight * (out["sample"] - x) ** 2  # (N, C, H, W)
        if mask_ratio > 0:
            # per-patch pooled loss over the kept patches only (model.py:201-209)
            p = self.dit.patch_size
            loss = loss.mean(dim=1)  # (N, H, W)
            n_, h, w = loss.shape
            loss = loss.reshape(n_, h // p, p, w // p, p).mean(dim=(2, 4)).reshape(n_, -1)
            unmask = 1.0 - out["mask"]
            loss = (loss * unmask).sum(dim=1) / unmask.sum(dim=1)
        return loss.mean()

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                train: bool = True, **draws):
        """Training/eval loss (model.py:104-142, JAX diffusion.py:229-250).

        batch: 'image_latents' (N, C, H, W) or raw 'image' (N, 3, H, W) in [-1, 1]
        (VAE-encoded, times ``latent_scale``); 'caption_latents' (N, 1, L, D) or
        (N, L, D), or token ids 'captions' (N, L) (text-encoded); optional
        'drop_caption_mask' (N,) (0 drops the caption). ``draws``: ``latent_noise``
        for the VAE's sample, and rnd_normal, noise, token_mask for ``edm_loss``.
        Returns (loss, latents, conditioning) as the reference does.
        """
        latent_noise = draws.pop("latent_noise", None)
        if self.precomputed_latents and "image_latents" in batch:
            latents = batch["image_latents"]
        else:
            latents = self._require("vae", "training on raw images").encode(
                batch["image"], generator=generator, noise=latent_noise) * self.latent_scale
        if self.precomputed_latents and "caption_latents" in batch:
            conditioning = batch["caption_latents"]
        else:
            conditioning = self._require("text_encoder", "training on captions").encode(
                batch["captions"])[0]
        if "drop_caption_mask" in batch:  # zero out dropped captions (model.py:131-135)
            keep = batch["drop_caption_mask"].reshape((-1,) + (1,) * (conditioning.dim() - 1))
            conditioning = conditioning * keep
        loss = self.edm_loss(latents.float(), conditioning.float(),
                             mask_ratio=self.train_mask_ratio if train else self.eval_mask_ratio,
                             generator=generator, **draws)
        return loss, latents, conditioning

    def train_draws(self, shape, mask_ratio: float,
                    generator: torch.Generator | None = None, device=None) -> dict:
        """The random draws of one microbatch of latents shaped ``shape`` (N, C, H, W),
        in the one order that ``edm_loss`` and ``skip_train_draws`` share: rnd_normal
        (N, 1, 1, 1), noise (N, C, H, W), then, with mask_ratio > 0, the token mask
        of the DiT's (H / p) * (W / p) tokens. On ``generator``'s device, else on
        ``device`` from the global generator."""
        n, _, h, w = shape
        device = generator.device if generator is not None else device
        draws = {"rnd_normal": torch.randn((n, 1, 1, 1), generator=generator, device=device),
                 "noise": torch.randn(tuple(shape), generator=generator, device=device)}
        if mask_ratio > 0:
            if generator is None:
                raise ValueError("mask_ratio > 0 needs a token_mask or a generator")
            p = self.dit.patch_size
            draws["token_mask"] = make_token_mask(generator, n, (h // p) * (w // p), mask_ratio)
        return draws

    def skip_train_draws(self, generator: torch.Generator, batch: dict, count: int) -> None:
        """Advance ``generator`` past the draws that ``forward`` makes for ``count``
        training microbatches shaped like ``batch`` (``train_draws``). A rank whose
        rows come after other ranks' in the global batch then draws what one
        process would have drawn for its rows."""
        if not (self.precomputed_latents and "image_latents" in batch):
            raise ValueError("skip_train_draws: only for precomputed latents")
        for _ in range(count):
            self.train_draws(batch["image_latents"].shape, self.train_mask_ratio, generator)

    def _require(self, name: str, what: str):
        handle = getattr(self, name)
        if handle is None:
            raise RuntimeError(f"{what} needs a {name.replace('_', ' ')}, and none is "
                               "attached (create_latent_diffusion(load_encoders=True) or "
                               f"LatentDiffusion({name}=...))")
        return handle

    def _sigma_schedule(self, num_steps: int) -> np.ndarray:
        """rho-spaced sigma schedule, float64 on the host (reference model.py:246-254)."""
        ec = self.edm_config
        i = np.arange(num_steps, dtype=np.float64)
        t = (
            ec.sigma_max ** (1 / ec.rho)
            + i / (num_steps - 1)
            * (ec.sigma_min ** (1 / ec.rho) - ec.sigma_max ** (1 / ec.rho))
        ) ** ec.rho
        return np.concatenate([t, np.zeros(1)])

    @torch.no_grad()
    def edm_sampler_loop(self, x, y, steps: int | None = None, cfg: float = 1.0,
                         generator: torch.Generator | None = None):
        """EDM Heun (2nd-order) sampling loop (reference model.py:231-297).

        ``generator`` draws the churn noise, used only on steps with gamma > 0
        (S_churn = 0 in every recipe, so none is drawn there).
        """
        ec = self.edm_config
        num_steps = ec.num_steps if steps is None else steps
        t_np = self._sigma_schedule(num_steps)
        gammas = np.array([
            min(ec.S_churn / num_steps, math.sqrt(2) - 1) if ec.S_min <= tc <= ec.S_max
            else 0.0
            for tc in t_np[:-1]
        ])
        t_cur_all = t_np[:-1].astype(np.float32)
        t_next_all = t_np[1:].astype(np.float32)
        gammas = gammas.astype(np.float32)
        guide = cfg if cfg > 1.0 else 1.0

        def denoise(x_in, sigma):
            s = torch.full((1,), float(sigma), dtype=torch.float32, device=x_in.device)
            return self.model_forward_wrapper(x_in, s, y, cfg=guide)["sample"]

        x_cur = x.float() * float(np.float32(t_np[0]))
        for i in range(num_steps):
            t_cur, t_next, gamma = t_cur_all[i], t_next_all[i], gammas[i]
            t_hat = np.float32(t_cur + gamma * t_cur)
            x_hat = x_cur
            if gamma > 0:
                noise = torch.randn(x_cur.shape, generator=generator, dtype=torch.float32,
                                    device=x_cur.device)
                amp = np.float32(np.sqrt(np.maximum(t_hat**2 - t_cur**2, np.float32(0))))
                x_hat = x_cur + float(amp * np.float32(ec.S_noise)) * noise
            dt = float(np.float32(t_next - t_hat))
            d_cur = (x_hat - denoise(x_hat, t_hat)) / float(t_hat)
            x_euler = x_hat + dt * d_cur
            if i < num_steps - 1:
                d_prime = (x_euler - denoise(x_euler, t_next)) / float(t_next)
                x_cur = x_hat + dt * (0.5 * d_cur + 0.5 * d_prime)
            else:
                x_cur = x_euler
        return x_cur

    @torch.no_grad()
    def encode_prompts(self, prompt=None, tokenized_prompts=None, attention_mask=None):
        """Captions, or their token ids, -> text embeddings (JAX diffusion.py:373-380)."""
        if tokenized_prompts is None:
            out = self._require("tokenizer", "generate(prompt=...)").tokenize(list(prompt))
            tokenized_prompts = out["input_ids"]
            attention_mask = out.get("attention_mask")
        return self._require("text_encoder", "generate(prompt=...)").encode(
            tokenized_prompts, attention_mask=attention_mask)[0]

    @torch.no_grad()
    def decode_latents(self, latents):
        """Latents -> fp32 images in [0, 1] (JAX diffusion.py:406-414)."""
        image = self._require("vae", "decoding latents").decode(latents / self.latent_scale)
        return (image / 2.0 + 0.5).clamp(0.0, 1.0).float()

    @torch.no_grad()
    def generate(self, prompt=None, tokenized_prompts=None, attention_mask=None,
                 text_embeddings=None, guidance_scale: float = 5.0,
                 num_inference_steps: int = 30, seed: int | None = None,
                 return_only_latents: bool = False):
        """Text -> image (reference model.py:299-353, JAX diffusion.py:351-414).

        Takes raw prompts (needs the tokenizer and text encoder), token ids (the text
        encoder), or ``text_embeddings`` (B, L, cap_dim) / (B, 1, L, cap_dim). The
        latents and any sampler noise come from a torch.Generator seeded with
        ``seed`` (0 if None). Returns fp32 images (B, 3, 8 latent_res, 8 latent_res)
        in [0, 1], or with ``return_only_latents`` the sampled latents.
        """
        if prompt is None and tokenized_prompts is None and text_embeddings is None:
            raise ValueError("Must provide either prompt or tokenized prompts")
        if text_embeddings is None:
            text_embeddings = self.encode_prompts(prompt, tokenized_prompts, attention_mask)
        device = self.dit.pos_embed.device
        gen = torch.Generator(device=device).manual_seed(seed if seed else 0)
        y = torch.as_tensor(text_embeddings, device=device)
        shape = (y.shape[0], self.dit.in_channels, self.latent_res, self.latent_res)
        latents = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        latents = self.edm_sampler_loop(latents, y, steps=num_inference_steps,
                                        cfg=guidance_scale, generator=gen)
        if return_only_latents:
            return latents
        return self.decode_latents(latents)


def create_latent_diffusion(
    vae_name: str = "stabilityai/stable-diffusion-xl-base-1.0",
    text_encoder_name: str = "openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378",
    dit_arch: str = "MicroDiT_XL_2",
    latent_res: int = 32,
    in_channels: int = 4,
    pos_interp_scale: float = 1.0,
    dtype: str = "bfloat16",
    precomputed_latents: bool = True,
    p_mean: float = -0.6,
    p_std: float = 1.2,
    train_mask_ratio: float = 0.0,
    load_encoders: bool = False,
    weights_dir: str | None = None,
    text_encoder_weights_dir: str | None = None,
    tokenizer_dir: str | None = None,
    remat: bool = False,
    remat_policy: str = "full",
    moe_dispatch: str = "onehot",
    attention_impl: str = "auto",
    fused_adaln: bool = False,
    device=None,
    seed: int = 0,
) -> LatentDiffusion:
    """Model factory with the reference signature (model.py:356-405, JAX
    diffusion.py:417-508); takes every key of a recipe's model block
    (configs/base.yaml) as it is written.

    Builds the DiT on ``device`` (the card when None; raises if there is none) and
    initialises it with the JAX package's initialisers from a generator seeded
    with ``seed``. Load trained weights afterwards (models/interop.py).
    ``load_encoders=True`` attaches the frozen VAE, text encoder and tokenizer from
    local snapshots: ``weights_dir`` holds the VAE (FileNotFoundError without it),
    ``text_encoder_weights_dir`` / ``tokenizer_dir`` the encoder and tokenizer (the
    encoder's defaulting to ``weights_dir``). The VAE computes in bf16 unless
    ``dtype`` is float32, as the reference's ``torch_dtype``. Encoders with random
    weights are built directly (``AutoencoderKL(...).init_weights``,
    ``UniversalTextEncoder(..., pretrained=False)``) and passed to LatentDiffusion.
    """
    device = resolve_device(device)
    _, cap_dim = text_encoder_embedding_format(text_encoder_name)
    dit = getattr(model_zoo, dit_arch)(
        input_size=latent_res, caption_channels=cap_dim, pos_interp_scale=pos_interp_scale,
        in_channels=in_channels,
        dtype={"bfloat16": torch.bfloat16, "float32": torch.float32,
               "float16": torch.float16}[dtype],
        remat=remat, remat_policy=remat_policy, moe_dispatch=moe_dispatch,
        attention_impl=attention_impl, fused_adaln=fused_adaln, device=device,
    )
    if device.type != "meta":
        dit.init_weights(torch.Generator(device=device).manual_seed(seed))
    vae = text_encoder = tokenizer = None
    if load_encoders:
        from .text_encoders import UniversalTextEncoder, UniversalTokenizer
        from .vae import AutoencoderKL

        vae = AutoencoderKL.from_pretrained(
            vae_name, weights_dir=weights_dir, device=device,
            compute_dtype=torch.float32 if dtype == "float32" else torch.bfloat16)
        text_encoder = UniversalTextEncoder(
            text_encoder_name, dtype=dtype,
            weights_dir=text_encoder_weights_dir or weights_dir, device=device)
        tokenizer = UniversalTokenizer(text_encoder_name, tokenizer_dir=tokenizer_dir)
    return LatentDiffusion(dit, vae=vae, text_encoder=text_encoder, tokenizer=tokenizer,
                           latent_res=latent_res, p_mean=p_mean, p_std=p_std,
                           train_mask_ratio=train_mask_ratio,
                           latent_scale=VAE_SCALING_FACTORS.get(vae_name),
                           precomputed_latents=precomputed_latents)
