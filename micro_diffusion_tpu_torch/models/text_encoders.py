"""Frozen text encoders in PyTorch, counterparts of micro_diffusion_tpu/models/text_encoders.py.

  * ``CLIPTextTransformer`` - the CLIP text tower: token and positional embedding, a
    causal pre-LN transformer, ``ln_final``; it returns ALL token embeddings (not
    pooled), which ``UniversalTextEncoder.encode`` shapes (B, 1, 77, width);
  * ``T5Encoder`` - the T5 v1.1 encoder stack (relative-position buckets, RMSNorm,
    no 1/sqrt(d_kv) scale, gated tanh-GELU feed-forward), (B, 1, 120, 4096) for
    DeepFloyd/t5-v1_1-xxl;
  * ``UniversalTextEncoder`` / ``UniversalTokenizer`` - the reference's wrappers
    (utils.py:429-582): ``encode(ids, attention_mask) -> (emb, None)`` and
    ``tokenize(captions)``, over the port's own tokenizers (utils/clip_bpe.py,
    utils/spm.py).

Numerics follow the JAX modules, written out: parameters are fp32 and the compute
follows ``dtype`` (each product casts its input, weight and bias to it), LayerNorm
and RMSNorm statistics are fp32, the attention logits are fp32 (the product of the
compute-dtype q and k, summed in fp32) and the probabilities are cast to the compute
dtype before the product with v. These attentions are plain matmul + softmax: they
never reach the DiT's attention kernels.

State-dict names are the public checkpoints': OpenCLIP's text tower
(``token_embedding.weight``, ``positional_embedding``,
``transformer.resblocks.N.{ln_1, attn.in_proj_*, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}``, ``ln_final``) and HF ``T5EncoderModel``'s. ``load_text_encoder_state_dict``
maps HF CLIP names onto OpenCLIP's (q/k/v concatenated into ``in_proj``, as
``clip_torch_to_params`` does) and loads with ``strict=True``. Weights come from a local
snapshot directory (``load_state_dict_from_dir``: ``.safetensors`` through a first-party
reader, ``.bin`` / ``.pt`` through ``torch.load(weights_only=True)``), or, with
``pretrained=False``, are drawn from a generator at OpenCLIP's and HF T5's init scales.
"""

import json
import math
import mmap
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .dit import resolve_device
from .layers import Linear, init_tensor, normal

T5_NAME = "DeepFloyd/t5-v1_1-xxl"

# name -> (vocab, width, layers, heads, quick_gelu) (JAX text_encoders.py:335)
_CLIP_CONFIGS = {
    "openclip:hf-hub:apple/DFN5B-CLIP-ViT-H-14-378": (49408, 1024, 24, 16, False),
    "stabilityai/stable-diffusion-2-base": (49408, 1024, 23, 16, False),
    "runwayml/stable-diffusion-v1-5": (49408, 768, 12, 12, True),
    "CompVis/stable-diffusion-v1-4": (49408, 768, 12, 12, True),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _attention(q, k, v, bias, dtype, scale: float = 1.0):
    """softmax(scale q k^T + bias) v over (B, L, H, D) heads: fp32 logits (the
    compute-dtype q and k multiplied and summed in fp32) and softmax, probabilities
    cast to ``dtype`` before the product with v."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale + bias
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class _LayerNorm(nn.Module):
    """LayerNorm with scale and bias, fp32 statistics (E[x^2] - E[x]^2, as flax
    computes them), output in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))
        self.eps, self.compute_dtype = eps, dtype

    def _init_params(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.compute_dtype)


# ======================================================================= CLIP


class _CLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameter names (in_proj_weight/bias, out_proj)."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype, std: float,
                 out_std: float, device=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, device=device))
        self.out_proj = Linear(width, width, init=normal(out_std), dtype=dtype, device=device)
        self.heads, self.std, self.compute_dtype = heads, std, dtype

    def _init_params(self, gen: torch.Generator) -> None:
        init_tensor(self.in_proj_weight, normal(self.std), gen)
        init_tensor(self.in_proj_bias, ("zeros",), gen)

    def forward(self, x, mask):
        b, l, w = x.shape
        dt = self.compute_dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        hd = w // self.heads
        q, k, v = (t.reshape(b, l, self.heads, hd) for t in qkv.split(w, -1))
        return self.out_proj(_attention(q, k, v, mask, dt, hd**-0.5).reshape(b, l, w))


class _CLIPMlp(nn.Module):
    def __init__(self, width: int, quick_gelu: bool, dtype: torch.dtype, fc_std: float,
                 proj_std: float, device=None):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, init=normal(fc_std), dtype=dtype, device=device)
        self.c_proj = Linear(4 * width, width, init=normal(proj_std), dtype=dtype,
                             device=device)
        self.quick_gelu = quick_gelu

    def forward(self, x):
        h = self.c_fc(x)
        h = h * torch.sigmoid(1.702 * h) if self.quick_gelu else F.gelu(h)
        return self.c_proj(h)


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, quick_gelu, dtype, stds, device=None):
        super().__init__()
        attn_std, proj_std, fc_std = stds
        self.ln_1 = _LayerNorm(width, dtype, device=device)
        self.attn = _CLIPAttention(width, heads, dtype, attn_std, proj_std, device=device)
        self.ln_2 = _LayerNorm(width, dtype, device=device)
        self.mlp = _CLIPMlp(width, quick_gelu, dtype, fc_std, proj_std, device=device)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.resblocks = nn.ModuleList(blocks)


class CLIPTextTransformer(nn.Module):
    """CLIP text tower: token + positional embedding -> causal pre-LN transformer ->
    ln_final; (B, L, width), every token (JAX text_encoders.py:33)."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, layers: int = 24,
                 heads: int = 16, context_length: int = 77, use_quick_gelu: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.width, self.layers, self.compute_dtype = width, layers, dtype
        self.token_embedding = nn.Embedding(
            vocab_size, width, _weight=torch.empty(vocab_size, width, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width, device=device))
        # OpenCLIP's TextTransformer.init_parameters scales
        stds = (width**-0.5, width**-0.5 * (2 * layers) ** -0.5, (2 * width) ** -0.5)
        self.transformer = _Transformer(
            _ResidualAttentionBlock(width, heads, use_quick_gelu, dtype, stds, device=device)
            for _ in range(layers))
        self.ln_final = _LayerNorm(width, dtype, device=device)

    def init_weights(self, generator: torch.Generator) -> "CLIPTextTransformer":
        """OpenCLIP's initialisers, drawn from ``generator``."""
        init_tensor(self.token_embedding.weight, normal(0.02), generator)
        init_tensor(self.positional_embedding, normal(0.01), generator)
        for mod in self.modules():
            if hasattr(mod, "_init_params"):
                mod._init_params(generator)
        return self

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        l = input_ids.shape[1]
        dt = self.compute_dtype
        x = self.token_embedding(input_ids).to(dt) + self.positional_embedding[:l].to(dt)
        mask = torch.full((l, l), float("-inf"), device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        return self.ln_final(x)


# ======================================================================= T5


class _RMSNorm(nn.Module):
    """T5's layer norm: x * rsqrt(mean(x^2) + eps) in fp32, rounded to the compute
    dtype, times the fp32 weight (so the output is fp32, as in the JAX module)."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.eps, self.compute_dtype = eps, dtype

    def _init_params(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)).to(self.compute_dtype) * self.weight


class _T5Attention(nn.Module):
    def __init__(self, d_model, heads, d_kv, dtype, buckets=None, device=None):
        super().__init__()
        inner = heads * d_kv
        mk = lambda i, o, std: Linear(i, o, False, init=normal(std), dtype=dtype,
                                      device=device)
        # HF T5PreTrainedModel._init_weights scales (factor 1.0)
        self.q = mk(d_model, inner, (d_model * d_kv) ** -0.5)
        self.k = mk(d_model, inner, d_model**-0.5)
        self.v = mk(d_model, inner, d_model**-0.5)
        self.o = mk(inner, d_model, inner**-0.5)
        if buckets is not None:  # the first block's table, shared by every block
            self.relative_attention_bias = nn.Embedding(
                buckets, heads, _weight=torch.empty(buckets, heads, device=device))
        self.heads, self.d_kv, self.compute_dtype = heads, d_kv, dtype
        self.bias_std = d_model**-0.5

    def _init_params(self, gen: torch.Generator) -> None:
        if hasattr(self, "relative_attention_bias"):
            init_tensor(self.relative_attention_bias.weight, normal(self.bias_std), gen)

    def forward(self, x, bias):
        b, l, _ = x.shape
        q, k, v = (m(x).reshape(b, l, self.heads, self.d_kv) for m in (self.q, self.k, self.v))
        # T5 does not scale the logits by 1/sqrt(d_kv)
        out = _attention(q, k, v, bias, self.compute_dtype)
        return self.o(out.reshape(b, l, self.heads * self.d_kv))


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, d_model, heads, d_kv, dtype, eps, buckets=None, device=None):
        super().__init__()
        self.SelfAttention = _T5Attention(d_model, heads, d_kv, dtype, buckets, device)
        self.layer_norm = _RMSNorm(d_model, dtype, eps, device)


class _T5DenseGatedActDense(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device=None):
        super().__init__()
        mk = lambda i, o, std: Linear(i, o, False, init=normal(std), dtype=dtype,
                                      device=device)
        self.wi_0 = mk(d_model, d_ff, d_model**-0.5)
        self.wi_1 = mk(d_model, d_ff, d_model**-0.5)
        self.wo = mk(d_ff, d_model, d_ff**-0.5)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _T5LayerFF(nn.Module):
    def __init__(self, d_model, d_ff, dtype, eps, device=None):
        super().__init__()
        self.DenseReluDense = _T5DenseGatedActDense(d_model, d_ff, dtype, device)
        self.layer_norm = _RMSNorm(d_model, dtype, eps, device)


class _T5Block(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)

    def forward(self, x, bias):
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _T5Stack(nn.Module):
    def __init__(self, embed_tokens, blocks, final_layer_norm):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList(blocks)
        self.final_layer_norm = final_layer_norm


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional (encoder) T5 bucketing of ``memory - context`` offsets (JAX
    text_encoders.py:218, HF T5Attention._relative_position_bucket)."""
    num_buckets //= 2
    ret = (rel_pos > 0).long() * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(n.clamp_min(1).float() / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


class T5Encoder(nn.Module):
    """T5 v1.1 encoder stack (JAX text_encoders.py:201): relative-position-bias
    attention without the 1/sqrt(d_kv) scale, gated tanh-GELU feed-forward, RMSNorm,
    padding masked as -1e9; defaults are DeepFloyd/t5-v1_1-xxl's (d_model 4096, 24
    layers, 64 heads, d_kv 64, d_ff 10240). Names are HF T5EncoderModel's, the token
    table tied under ``shared`` and ``encoder.embed_tokens``."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 4096, num_layers: int = 24,
                 num_heads: int = 64, d_kv: int = 64, d_ff: int = 10240,
                 rel_buckets: int = 32, rel_max_distance: int = 128, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_layers, self.compute_dtype = num_layers, dtype
        self.rel_buckets, self.rel_max_distance = rel_buckets, rel_max_distance
        self.shared = nn.Embedding(vocab_size, d_model,
                                   _weight=torch.empty(vocab_size, d_model, device=device))
        blocks = [_T5Block([
            _T5LayerSelfAttention(d_model, num_heads, d_kv, dtype, eps,
                                  rel_buckets if i == 0 else None, device),
            _T5LayerFF(d_model, d_ff, dtype, eps, device)]) for i in range(num_layers)]
        self.encoder = _T5Stack(self.shared, blocks, _RMSNorm(d_model, dtype, eps, device))

    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """HF T5's initialisers (factor 1.0), drawn from ``generator``."""
        init_tensor(self.shared.weight, normal(1.0), generator)
        for mod in self.modules():
            if hasattr(mod, "_init_params"):
                mod._init_params(generator)
        return self

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l = input_ids.shape
        x = self.shared(input_ids).to(self.compute_dtype)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        pos = torch.arange(l, device=x.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.rel_buckets,
                                           self.rel_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = table[buckets].permute(2, 0, 1)[None]  # (1, H, L, L), fp32
        bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


# ============================================================ weights on disk

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
              "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors: an 8-byte little-endian header length,
    a JSON header {name: {dtype, shape, data_offsets}}, then the raw buffer."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as buf:
        n = int.from_bytes(buf[:8], "little")
        header = json.loads(buf[8:8 + n])
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            count = math.prod(info["shape"])
            if end - begin != count * dtype.itemsize or base + end > len(buf):
                raise ValueError(f"{path}: tensor {name} has {end - begin} bytes for "
                                 f"shape {info['shape']} {info['dtype']}")
            view = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin)
                    if count else torch.empty(0, dtype=dtype))
            out[name] = view.reshape(info["shape"]).clone()
            del view  # no view of the map may outlive it
    return out


def load_state_dict_from_dir(weights_dir: str) -> Dict[str, torch.Tensor]:
    """Every ``.safetensors`` file of a local snapshot directory, or else every
    ``.bin`` / ``.pt`` / ``.pth`` file (JAX text_encoders.py:421)."""
    files = sorted(os.listdir(weights_dir))
    sd: Dict[str, torch.Tensor] = {}
    st = [f for f in files if f.endswith(".safetensors")]
    for f in st:
        sd.update(read_safetensors(os.path.join(weights_dir, f)))
    if not st:
        for f in files:
            if f.endswith((".bin", ".pt", ".pth")):
                sd.update(torch.load(os.path.join(weights_dir, f), map_location="cpu",
                                     weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no weight files in {weights_dir}")
    return sd


_CLIP_TOWER = ("token_embedding.", "positional_embedding", "transformer.", "ln_final.")
_HF_CLIP_NAMES = {"layer_norm1": "ln_1", "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
                  "mlp.fc2": "mlp.c_proj", "self_attn.out_proj": "attn.out_proj"}


def clip_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The text tower's entries under OpenCLIP's names, from an OpenCLIP checkpoint
    (the visual tower, projection and logit scale dropped) or an HF CLIPTextModel /
    CLIPModel one (JAX clip_torch_to_params, :119)."""
    if "token_embedding.weight" in sd:
        return {k: v for k, v in sd.items() if k.startswith(_CLIP_TOWER)}
    pre = "text_model."
    out = {"token_embedding.weight": sd[f"{pre}embeddings.token_embedding.weight"],
           "positional_embedding": sd[f"{pre}embeddings.position_embedding.weight"],
           "ln_final.weight": sd[f"{pre}final_layer_norm.weight"],
           "ln_final.bias": sd[f"{pre}final_layer_norm.bias"]}
    layers = {int(k.split(".")[3]) for k in sd if k.startswith(f"{pre}encoder.layers.")}
    for i in sorted(layers):
        src, dst = f"{pre}encoder.layers.{i}.", f"transformer.resblocks.{i}."
        for p in ("weight", "bias"):
            out[f"{dst}attn.in_proj_{p}"] = torch.cat(
                [sd[f"{src}self_attn.{x}_proj.{p}"] for x in "qkv"], dim=0)
            for hf, oc in _HF_CLIP_NAMES.items():
                out[f"{dst}{oc}.{p}"] = sd[f"{src}{hf}.{p}"]
    return out


def t5_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF T5EncoderModel's entries: a full T5's decoder dropped, the tied token table
    under both of its names."""
    out = {k: v for k, v in sd.items() if k == "shared.weight" or k.startswith("encoder.")}
    table = out.get("shared.weight", out.get("encoder.embed_tokens.weight"))
    if table is not None:
        out["shared.weight"] = out["encoder.embed_tokens.weight"] = table
    return out


def load_text_encoder_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a checkpoint's state dict into a CLIPTextTransformer or T5Encoder,
    names mapped as above, ``strict=True``."""
    sd = t5_state_dict(sd) if isinstance(module, T5Encoder) else clip_state_dict(sd)
    module.load_state_dict(sd, strict=True)
    return module


# ============================================================ universal wrappers


class UniversalTextEncoder(nn.Module):
    """Reference-parity universal encoder (utils.py:429-469): ``encode(ids, mask)``
    -> (embeddings, None), CLIP (B, 1, 77, width) or T5 (B, 1, 120, 4096).

    ``pretrained=True`` loads ``weights_dir`` (a local snapshot; FileNotFoundError
    without one); ``pretrained=False`` draws random weights from ``generator`` (seed
    0 when None). Frozen: no parameter requires a gradient. ``device`` None means
    the card (raises without one).
    """

    def __init__(self, name: str, dtype: str = "bfloat16", pretrained: bool = True,
                 weights_dir: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.name = name
        self.is_t5 = name == T5_NAME
        tdtype = _DTYPES[dtype]
        if self.is_t5:
            self.model = T5Encoder(dtype=tdtype, device=device)
        else:
            if name in _CLIP_CONFIGS:
                vocab, width, layers, heads, qg = _CLIP_CONFIGS[name]
                ctx = 77
            else:  # a local HF CLIPTextModel snapshot: the architecture from config.json
                cfg_dir = name if os.path.isdir(name) else (weights_dir or "")
                cfg_path = os.path.join(cfg_dir, "config.json")
                if not os.path.exists(cfg_path):
                    raise KeyError(f"unknown text encoder '{name}' and no local config.json")
                with open(cfg_path) as f:
                    cfg = json.load(f)
                vocab, width = int(cfg["vocab_size"]), int(cfg["hidden_size"])
                layers, heads = int(cfg["num_hidden_layers"]), int(cfg["num_attention_heads"])
                qg = cfg.get("hidden_act", "quick_gelu") == "quick_gelu"
                ctx = int(cfg.get("max_position_embeddings", 77))
                if os.path.isdir(name) and weights_dir is None:
                    weights_dir = name
            self.model = CLIPTextTransformer(vocab, width, layers, heads, ctx, qg, tdtype,
                                             device=device)
        if pretrained:
            if weights_dir is None:
                raise FileNotFoundError(
                    f"no local weights for text encoder '{name}': pass weights_dir "
                    "pointing at a local HF snapshot")
            load_text_encoder_state_dict(self.model, load_state_dict_from_dir(weights_dir))
        else:
            gen = generator or torch.Generator(device=device).manual_seed(0)
            self.model.init_weights(gen)
        self.requires_grad_(False)

    @torch.no_grad()
    def encode(self, tokenized_caption, attention_mask=None) -> Tuple[torch.Tensor, None]:
        device = next(self.model.parameters()).device
        ids = torch.as_tensor(tokenized_caption, device=device).long()
        if self.is_t5:
            mask = (None if attention_mask is None
                    else torch.as_tensor(attention_mask, device=device))
            out = self.model(ids, mask)
        else:
            out = self.model(ids)
        return out[:, None], None  # (B, 1, L, D)


class UniversalTokenizer:
    """Reference-parity tokenizer wrapper (utils.py:537-582) over a local tokenizer
    directory: CLIP ids padded to 77 (``vocab.json`` / ``merges.txt``, no mask); T5
    ids and mask padded to 120 (``spiece.model``). FileNotFoundError when there is
    no directory or it lacks those files."""

    def __init__(self, name: str, tokenizer_dir: Optional[str] = None):
        from .diffusion import text_encoder_embedding_format

        self.name = name
        self.model_max_length, _ = text_encoder_embedding_format(name)
        self._tokenizer_dir = tokenizer_dir
        self._tok = None

    def _ensure(self):
        if self._tok is not None:
            return
        d = self._tokenizer_dir
        if d is None:
            raise FileNotFoundError(
                f"tokenizer for '{self.name}' requires a local vocab: pass tokenizer_dir "
                "with an HF tokenizer snapshot")
        if self.name == T5_NAME:
            from ..utils.spm import T5SpmTokenizer

            path = os.path.join(d, "spiece.model")
            if not os.path.exists(path):
                raise FileNotFoundError(f"no spiece.model in {d}")
            self._tok = T5SpmTokenizer(path)
        else:
            from ..utils.clip_bpe import CLIPBPETokenizer

            for f in ("vocab.json", "merges.txt"):
                if not os.path.exists(os.path.join(d, f)):
                    raise FileNotFoundError(f"no {f} in {d}")
            self._tok = CLIPBPETokenizer(d)

    def tokenize(self, captions) -> Dict[str, np.ndarray]:
        self._ensure()
        out = self._tok(captions, max_length=self.model_max_length)
        if self.name == T5_NAME:
            return {"input_ids": out["input_ids"], "attention_mask": out["attention_mask"]}
        return {"input_ids": out["input_ids"]}
