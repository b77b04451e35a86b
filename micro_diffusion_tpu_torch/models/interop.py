"""Weights into the port's DiT: from a JAX (flax) params tree, a reference .pt file or
a checkpoint of the port's trainer (``load_any_checkpoint``).

Own copy of the name/layout mapping of micro_diffusion_tpu/models/interop.py
(params_to_torch_state_dict, :104; load_torch_checkpoint, :166), working on
numpy arrays:

    blocks_3/*                 -> blocks.3.*
    patch_mixer_2/*            -> patch_mixer.2.*
    t_embedder/mlp_0, mlp_2    -> t_embedder.mlp.0, .2
    adaLN_modulation_1         -> adaLN_modulation.1
    patch_mixer_map_xin/norm, linear -> patch_mixer_map_xin.0, .1
    <dense>/kernel (in, out)   -> <linear>.weight (out, in)
    x_embedder/proj/kernel (p, p, C, D) -> x_embedder.proj.weight (D, C, p, p)
    mlp/w1, mlp/w2 (MoE, 3-D)  -> as they are

``pos_embed`` and ``mask_token`` are computed constants in the DiT, so they are
neither produced nor loaded.
"""

import os
from typing import Any, Dict

import numpy as np
import torch

SKIPPED_BUFFERS = ("pos_embed", "mask_token")


def params_to_torch_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a flax params tree into a torch-layout state dict of numpy arrays."""
    flat: Dict[str, np.ndarray] = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + [k])
            return
        arr = np.asarray(node)
        toks = list(path)
        if toks[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            toks[-1] = "weight"
        torch_toks = []
        for tok in toks:
            if tok.startswith("blocks_") and tok[7:].isdigit():
                torch_toks += ["blocks", tok[7:]]
            elif tok.startswith("patch_mixer_") and tok[12:].isdigit():
                torch_toks += ["patch_mixer", tok[12:]]
            elif tok.startswith("mlp_") and tok[4:].isdigit():
                torch_toks += ["mlp", tok[4:]]
            elif tok.startswith("adaLN_modulation_"):
                torch_toks += ["adaLN_modulation", tok.split("_")[-1]]
            elif tok == "norm" and toks[0].startswith("patch_mixer_map"):
                torch_toks += ["0"]
            elif tok == "linear" and toks[0].startswith("patch_mixer_map"):
                torch_toks += ["1"]
            else:
                torch_toks.append(tok)
        flat[".".join(torch_toks)] = arr

    visit(params.get("params", params), [])
    return flat


def load_numpy_state_dict(module: torch.nn.Module, state_dict: Dict[str, Any],
                          strict: bool = True) -> torch.nn.Module:
    """load_state_dict after turning numpy arrays into tensors (copy_ moves them to
    the module's device and dtype); the converters below give such dicts."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32)) if isinstance(v, np.ndarray) else v
          for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=strict)
    return module


def load_jax_params(module: torch.nn.Module, params: Dict[str, Any]) -> torch.nn.Module:
    """Load a JAX DiT params tree into the port's DiT ``module`` (strict)."""
    return load_numpy_state_dict(module, params_to_torch_state_dict(params))


def _strip_prefixes(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip Composer-style nesting ('state/model') and 'model.'/'dit.' prefixes."""
    sd = state_dict
    if "state" in sd and isinstance(sd["state"], dict):
        sd = sd["state"].get("model", sd["state"])
    out = {}
    for k, v in sd.items():
        for prefix in ("model.dit.", "module.dit.", "dit."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out


def load_torch_checkpoint(path: str, module: torch.nn.Module | None = None,
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """Read a reference .pt checkpoint (plain DiT state dict or Composer trainer
    state) as a state dict for the port's DiT, without the computed buffers;
    loaded into ``module`` too when one is given."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"unexpected checkpoint object: {type(sd)}")
    out = {}
    for key, value in _strip_prefixes(sd).items():
        if key.split(".")[0] in SKIPPED_BUFFERS:
            if key.startswith("mask_token") and torch.any(value != 0):
                raise ValueError("checkpoint has a non-zero mask_token; the DiT folds it "
                                 "out as a constant zero")
            continue
        out[key] = value
    if module is not None:
        load_numpy_state_dict(module, out, strict)
    return out


def load_any_checkpoint(path: str, module: torch.nn.Module | None = None,
                        strict: bool = True) -> Dict[str, torch.Tensor]:
    """DiT weights from a reference ``.pt`` file (``load_torch_checkpoint``) or from a
    checkpoint of the port's trainer (its ``checkpoint.pt``, a step directory or a
    folder of them, the latest step): ``ema_params`` when the checkpoint has them,
    else ``params``, as the JAX package prefers its trainer's EMA for eval. Loaded
    into ``module`` too when one is given. An orbax (JAX) checkpoint directory
    raises: convert it to a reference ``.pt`` with the JAX package first."""
    if os.path.isdir(path):
        from ..train.trainer import find_checkpoint  # the trainer imports this module

        try:
            path = find_checkpoint(path)
        except ValueError as err:
            raise ValueError(
                f"{err}. Restore it with the JAX package and write a reference .pt "
                "through micro_diffusion_tpu/models/interop.py params_to_torch_state_dict "
                "(the orbax converter of ROADMAP queue A item 2)") from err
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and "step" in ckpt and isinstance(ckpt.get("params"), dict)):
        return load_torch_checkpoint(path, module, strict)
    out = ckpt.get("ema_params") or ckpt["params"]
    if module is not None:
        load_numpy_state_dict(module, out, strict)
    return out


# ------------------------------------------ frozen encoders (CLIP, T5, VAE, CLIP vision)
# Inverses of the JAX package's clip_torch_to_params (text_encoders.py:119),
# t5_torch_to_params (:284), vae_torch_to_params (vae.py:339) and
# clip_vision_torch_to_params (clip_zero_shot.py:132), on numpy arrays: flax trees ->
# the checkpoints' names, which the port's modules carry.


def _leaf(name: str, arr: np.ndarray) -> tuple:
    """A flax leaf -> (torch leaf name, array): kernels transposed to (out, in[, kh,
    kw]), LayerNorm/GroupNorm scales and embedding tables named 'weight'."""
    if name == "kernel":
        return "weight", arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return {"scale": "weight", "embedding": "weight"}.get(name, name), arr


def clip_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CLIPTextTransformer params -> OpenCLIP text-tower names."""
    p = params.get("params", params)
    out = {"token_embedding.weight": np.asarray(p["token_embedding"]["embedding"]),
           "positional_embedding": np.asarray(p["positional_embedding"])}
    for mod, leaves in p.items():
        if not mod.startswith("resblocks_") and mod != "ln_final":
            continue
        if mod == "ln_final":
            dst = "ln_final"
        else:  # resblocks_{i}_{ln_1 | ln_2 | attn_in_proj | attn_out_proj | mlp_c_fc | ...}
            _, i, rest = mod.split("_", 2)
            sub = {"attn_out_proj": "attn.out_proj", "mlp_c_fc": "mlp.c_fc",
                   "mlp_c_proj": "mlp.c_proj"}.get(rest, rest)
            dst = f"transformer.resblocks.{i}.{sub}"
        for leaf, arr in leaves.items():
            name, arr = _leaf(leaf, np.asarray(arr))
            if dst.endswith("attn_in_proj"):  # nn.MultiheadAttention's fused q/k/v
                out[f"{dst[:-len('attn_in_proj')]}attn.in_proj_{name}"] = arr
            else:
                out[f"{dst}.{name}"] = arr
    return out


def t5_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX T5Encoder params -> HF T5EncoderModel names (the token table under both
    of its tied names)."""
    p = params.get("params", params)
    table = np.asarray(p["shared"]["embedding"])
    out = {"shared.weight": table, "encoder.embed_tokens.weight": table,
           "encoder.final_layer_norm.weight": np.asarray(p["final_layer_norm"]),
           "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
               np.asarray(p["relative_attention_bias"])}
    where = {"q": "0.SelfAttention.q", "k": "0.SelfAttention.k", "v": "0.SelfAttention.v",
             "o": "0.SelfAttention.o", "ln_0": "0.layer_norm", "ln_1": "1.layer_norm",
             "wi_0": "1.DenseReluDense.wi_0", "wi_1": "1.DenseReluDense.wi_1",
             "wo": "1.DenseReluDense.wo"}
    for mod, leaf in p.items():
        if not mod.startswith("layers_"):
            continue
        _, i, rest = mod.split("_", 2)
        arr = np.asarray(leaf["kernel"]).T if isinstance(leaf, dict) else np.asarray(leaf)
        out[f"encoder.block.{i}.layer.{where[rest]}.weight"] = arr
    return out


def _vae_module_name(tok: str) -> str:
    parts = tok.split("_")
    if tok.startswith(("down_", "up_")) and parts[2] == "resnet":
        return f"{parts[0]}_blocks.{parts[1]}.resnets.{parts[3]}"
    if tok.startswith("down_"):  # down_{i}_downsample
        return f"down_blocks.{parts[1]}.downsamplers.0.conv"
    if tok.startswith("up_"):  # up_{i}_upsample
        return f"up_blocks.{parts[1]}.upsamplers.0.conv"
    if tok.startswith("mid_resnet_"):
        return f"mid_block.resnets.{parts[2]}"
    return {"mid_attn": "mid_block.attentions.0", "to_out_0": "to_out.0"}.get(tok, tok)


def vae_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX AutoencoderKL params -> diffusers AutoencoderKL names."""
    out: Dict[str, np.ndarray] = {}

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + [k])
            return
        name, arr = _leaf(path[-1], np.asarray(node))
        out[".".join([_vae_module_name(t) for t in path[:-1]] + [name])] = arr

    visit(params.get("params", params), [])
    return out


def clip_vision_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX CLIPVisionTransformer params -> HF ``CLIPVisionModel`` names (those of its
    ``vision_model``): the patch conv (kh, kw, in, out) -> (out, in, kh, kw), the
    fused in_proj split into q/k/v, HF's own spelling ``pre_layrnorm``."""
    p = params.get("params", params)
    out = {"embeddings.patch_embedding.weight":
               np.asarray(p["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1),
           "embeddings.class_embedding": np.asarray(p["class_embedding"]),
           "embeddings.position_embedding.weight": np.asarray(p["position_embedding"])}
    sub = {"ln_1": "layer_norm1", "ln_2": "layer_norm2", "attn_out_proj": "self_attn.out_proj",
           "mlp_c_fc": "mlp.fc1", "mlp_c_proj": "mlp.fc2"}
    for mod, leaves in p.items():
        if mod in ("pre_layernorm", "post_layernorm"):
            dst = "pre_layrnorm" if mod == "pre_layernorm" else mod
        elif mod.startswith("resblocks_"):
            _, i, rest = mod.split("_", 2)
            dst = f"encoder.layers.{i}.{sub.get(rest, rest)}"
        else:
            continue
        for leaf, arr in leaves.items():
            name, arr = _leaf(leaf, np.asarray(arr))
            if dst.endswith("attn_in_proj"):  # (3W[, W]) -> q, k, v
                for x, part in zip("qkv", np.split(arr, 3, axis=0)):
                    out[f"{dst[:-len('attn_in_proj')]}self_attn.{x}_proj.{name}"] = part
            else:
                out[f"{dst}.{name}"] = arr
    return out
