"""CLIP zero-shot classification (the vision tower and the similarity head) in PyTorch,
the port's counterpart of micro_diffusion_tpu/models/clip_zero_shot.py.

Upstream GenEval (Ghosh et al. 2023) judges the colour of each detected object by
CLIP zero-shot classification of the detection crop; eval/geneval.py's
``make_clip_color_fn`` runs it through ``CLIPZeroShot``.

``CLIPVisionTransformer`` carries HF ``CLIPVisionModel``'s names (those of its
``vision_model``): ``embeddings.{patch_embedding, class_embedding,
position_embedding}``, ``pre_layrnorm`` (HF's spelling), ``encoder.layers.N.{
layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2, mlp.fc1, mlp.fc2}``,
``post_layernorm``. ``CLIPZeroShot`` reads a local HF ``CLIPModel`` snapshot
(config.json and the weights, through ``load_state_dict_from_dir``); its text tower
is models/text_encoders.py's ``CLIPTextTransformer`` with the HF names mapped on
load. Everything computes in fp32; the attention is plain matmul + softmax, as in
the JAX module, and never reaches the DiT's kernels.
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .dit import resolve_device
from .text_encoders import (CLIPTextTransformer, UniversalTokenizer, _attention, _LayerNorm,
                            load_state_dict_from_dir, load_text_encoder_state_dict)

# CLIP preprocessing constants (OpenAI CLIP / HF CLIPImageProcessor defaults)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class _Embeddings(nn.Module):
    def __init__(self, width: int, patch: int, tokens: int):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.position_embedding = nn.Embedding(tokens, width)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(width, width) for _ in range(4))
        self.heads = heads

    def forward(self, x):
        b, l, w = x.shape
        hd = w // self.heads
        q, k, v = (m(x).reshape(b, l, self.heads, hd) for m in (self.q_proj, self.k_proj,
                                                                self.v_proj))
        return self.out_proj(_attention(q, k, v, 0.0, x.dtype, hd**-0.5).reshape(b, l, w))


class _Mlp(nn.Module):
    def __init__(self, width: int, quick_gelu: bool):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)
        self.quick_gelu = quick_gelu

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return self.fc2(h)


class _EncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, quick_gelu: bool):
        super().__init__()
        self.layer_norm1 = _LayerNorm(width, torch.float32)
        self.self_attn = _Attention(width, heads)
        self.layer_norm2 = _LayerNorm(width, torch.float32)
        self.mlp = _Mlp(width, quick_gelu)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class CLIPVisionTransformer(nn.Module):
    """HF ``CLIPVisionModel`` semantics (JAX clip_zero_shot.py:36): conv patchify
    without bias, CLS token and learned position embedding, ``pre_layrnorm``, pre-LN
    blocks (quick-GELU or exact GELU), the post-LN CLS embedding. Pixels (B, 3, H, W)
    normalized -> pooled (B, width)."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, use_quick_gelu: bool = True):
        super().__init__()
        self.image_size = image_size
        self.embeddings = _Embeddings(width, patch_size, (image_size // patch_size) ** 2 + 1)
        self.pre_layrnorm = _LayerNorm(width, torch.float32)
        self.encoder = _Encoder(_EncoderLayer(width, heads, use_quick_gelu)
                                for _ in range(layers))
        self.post_layernorm = _LayerNorm(width, torch.float32)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        patches = emb.patch_embedding(pixels).flatten(2).transpose(1, 2)  # (B, T, W)
        cls = emb.class_embedding.expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None]
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


def _bicubic_resize(img: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(np.asarray(img, np.uint8))
    return np.asarray(pil.resize((size, size), Image.BICUBIC), np.float32)


def preprocess_images(images: Sequence, image_size: int) -> np.ndarray:
    """uint8 HWC crops (any sizes) -> (B, S, S, 3) CLIP-normalized float32."""
    out = np.stack([_bicubic_resize(im, image_size) for im in images]) / 255.0
    return ((out - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)).astype(np.float32)


class CLIPZeroShot:
    """Zero-shot classifier over a list of candidate texts, from a local HF CLIPModel
    snapshot (config.json and the weights; the tokenizer's vocab.json / merges.txt in
    the same directory or ``tokenizer_dir``), on ``device`` (the card when None)."""

    def __init__(self, snapshot_dir: str, tokenizer_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(snapshot_dir, "config.json")) as f:
            cfg = json.load(f)
        vc, tc = cfg["vision_config"], cfg["text_config"]
        with self.device:  # built where it runs; every tensor is loaded below
            self.vision = CLIPVisionTransformer(
                image_size=vc.get("image_size", 224), patch_size=vc.get("patch_size", 14),
                width=vc["hidden_size"], layers=vc["num_hidden_layers"],
                heads=vc["num_attention_heads"],
                use_quick_gelu=vc.get("hidden_act", "quick_gelu") == "quick_gelu")
            self.text = CLIPTextTransformer(
                vocab_size=tc["vocab_size"], width=tc["hidden_size"],
                layers=tc["num_hidden_layers"], heads=tc["num_attention_heads"],
                context_length=tc.get("max_position_embeddings", 77),
                use_quick_gelu=tc.get("hidden_act", "quick_gelu") == "quick_gelu")
        sd = load_state_dict_from_dir(snapshot_dir)
        pre = "vision_model."
        self.vision.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                                     if k.startswith(pre) and not k.endswith("position_ids")},
                                    strict=True)
        load_text_encoder_state_dict(
            self.text, {k: v for k, v in sd.items() if k.startswith("text_model.")})
        for m in (self.vision, self.text):
            m.eval().requires_grad_(False)
        # (width, proj)
        self.visual_projection = sd["visual_projection.weight"].float().T.to(self.device)
        self.text_projection = sd["text_projection.weight"].float().T.to(self.device)
        self.tokenizer = UniversalTokenizer("CompVis/stable-diffusion-v1-4",  # CLIP's BPE
                                            tokenizer_dir=tokenizer_dir or snapshot_dir)
        self._text_cache: Dict[tuple, np.ndarray] = {}

    @torch.no_grad()
    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """L2-normalized text embeddings (pooled at the eot token, the argmax id),
        cached per candidate list."""
        key = tuple(texts)
        if key not in self._text_cache:
            ids = torch.as_tensor(self.tokenizer.tokenize(list(texts))["input_ids"],
                                  device=self.device).long()
            feats = self.text(ids).float()
            pooled = feats[torch.arange(len(texts), device=self.device), ids.argmax(-1)]
            emb = (pooled @ self.text_projection).cpu().numpy()
            self._text_cache[key] = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        return self._text_cache[key]

    @torch.no_grad()
    def encode_images(self, images: Sequence) -> np.ndarray:
        """L2-normalized image embeddings of uint8 HWC crops."""
        pixels = preprocess_images(images, self.vision.image_size)
        x = torch.from_numpy(pixels).permute(0, 3, 1, 2).to(self.device)
        emb = (self.vision(x) @ self.visual_projection).cpu().numpy()
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    def classify(self, images: Sequence, candidate_texts: Sequence[str]) -> List[int]:
        """Argmax cosine-similarity candidate index per image."""
        sims = self.encode_images(images) @ self.encode_texts(candidate_texts).T
        return [int(i) for i in sims.argmax(-1)]
