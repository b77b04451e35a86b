"""Recipe configs: yaml with ``defaults`` inheritance, ``${...}`` interpolation,
dotted CLI overrides and ``_target_`` instantiation. The port's own copy of
micro_diffusion_tpu/train/config.py (``apply_overrides`` :79, ``load_config``
:103, ``instantiate`` :144).

``_target_`` strings resolve to the port only. The reference's targets, the
JAX package's (``micro_diffusion_tpu.X`` becomes ``micro_diffusion_tpu_torch.X``)
and the symbolic optimizer, scheduler and EMA names of the recipes are
re-pointed to the port's callables; the port's own dotted paths resolve as
written. Any other target raises, so a recipe can never import the JAX package.
"""

import copy
import importlib
import os
import re
from typing import Any, Callable, Dict, List, Optional

import yaml

_PORT = "micro_diffusion_tpu_torch"
_JAX_PKG = "micro_diffusion_tpu"

# a target named in the reference's or the JAX package's recipes -> the port's callable
TARGET_REGISTRY: Dict[str, str] = {
    "micro_diffusion.models.model.create_latent_diffusion":
        f"{_PORT}.models.diffusion.create_latent_diffusion",
    "micro_diffusion.datasets.latents_loader.build_streaming_latents_dataloader":
        f"{_PORT}.datasets.latents_loader.build_streaming_latents_dataloader",
    "micro_diffusion.models.callbacks.LogDiffusionImages":
        f"{_PORT}.train.callbacks.LogDiffusionImages",
    "micro_diffusion.models.callbacks.NaNCatcher": f"{_PORT}.train.callbacks.NaNCatcher",
    "composer.callbacks.speed_monitor.SpeedMonitor": f"{_PORT}.train.callbacks.SpeedMonitor",
    "composer.callbacks.lr_monitor.LRMonitor": f"{_PORT}.train.callbacks.LRMonitor",
    "composer.callbacks.runtime_estimator.RuntimeEstimator":
        f"{_PORT}.train.callbacks.RuntimeEstimator",
    "composer.callbacks.OptimizerMonitor": f"{_PORT}.train.callbacks.OptimizerMonitor",
    "composer.loggers.TensorboardLogger": f"{_PORT}.train.callbacks.TensorboardLogger",
    # wandb is not available: its metrics go to the Tensorboard/JSONL logger
    "composer.loggers.wandb_logger.WandBLogger": f"{_PORT}.train.callbacks.TensorboardLogger",
    "composer.Trainer": f"{_PORT}.train.trainer.Trainer",
    # symbolic blocks the trainer reads by key; their callables in the port
    "torch.optim.AdamW": f"{_PORT}.train.optim.build_optimizer",
    "composer.optim.CosineAnnealingWithWarmupScheduler": f"{_PORT}.train.optim.cosine_with_warmup",
    "composer.optim.ConstantScheduler": f"{_PORT}.train.optim.constant_schedule",
    "composer.optim.ConstantWithWarmupScheduler": f"{_PORT}.train.optim.constant_with_warmup",
    "diffusion.algorithms.ema.EMA": f"{_PORT}.train.optim.ema_update",
}

_INTERP = re.compile(r"\$\{([^}]+)\}")


def _resolve_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def resolve_interpolations(cfg: dict) -> dict:
    """Resolve ${dotted.path} interpolations against the config root."""

    def resolve(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.fullmatch(node)
            if m:
                return _resolve_path(cfg, m.group(1))
            return _INTERP.sub(lambda mm: str(_resolve_path(cfg, mm.group(1))), node)
        return node

    return resolve(cfg)


def _parse_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def apply_overrides(cfg: dict, overrides: List[str]) -> dict:
    """Apply hydra-style dotted CLI overrides: a.b.c=value."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, raw = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return cfg


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(config_path: str, config_name: str, overrides: Optional[List[str]] = None,
                _resolve: bool = True) -> dict:
    """Load a recipe yaml (and its ``defaults`` bases), apply overrides, resolve
    interpolations.

    Interpolations resolve only at the top-level call, after the whole defaults
    merge: a base may reference keys its children define (base.yaml's
    ``${exp_name}``). A base's path is relative to the file naming it and may
    cross directories (``../../../configs/res_256_pretrain`` from an overlay).
    """
    if not config_name.endswith((".yaml", ".yml")):
        config_name += ".yaml"
    path = os.path.join(config_path, config_name)
    with open(path) as f:
        cfg = yaml.safe_load(f)

    bases = cfg.pop("defaults", [])
    merged: dict = {}
    for base in bases if isinstance(bases, list) else [bases]:
        merged = _deep_merge(merged, load_config(os.path.dirname(path), str(base),
                                                 _resolve=False))
    cfg = _deep_merge(merged, cfg)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve_interpolations(cfg) if _resolve else cfg


def resolve_target(target: str) -> Callable:
    """The port's callable for ``target`` (see the module docstring); raises
    ValueError for a target the port cannot serve."""
    name = TARGET_REGISTRY.get(target, target)
    if name.startswith(_JAX_PKG + "."):
        name = _PORT + name[len(_JAX_PKG):]
    if not name.startswith(_PORT + "."):
        raise ValueError(f"_target_ {target!r} has no counterpart in {_PORT}")
    module, _, attr = name.rpartition(".")
    try:
        return getattr(importlib.import_module(module), attr)
    except (ImportError, AttributeError) as err:
        raise ValueError(f"_target_ {target!r} has no counterpart in {_PORT} "
                         f"({name}: {err}; README.md, 'Not ported')") from err


def instantiate(block: dict, **extra: Any) -> Any:
    """hydra.utils.instantiate's counterpart: call block['_target_'] with the other
    keys and ``extra``."""
    if "_target_" not in block:
        raise ValueError(f"config block has no _target_: {block}")
    kwargs = {k: v for k, v in block.items() if k != "_target_"}
    kwargs.update(extra)
    return resolve_target(block["_target_"])(**kwargs)
