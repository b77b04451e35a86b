"""Training entry point of the port: a yaml recipe -> model, loaders, callbacks and
``Trainer`` -> ``fit()``. Counterpart of the repository's ``train.py`` (:24-127):

    python -m micro_diffusion_tpu_torch.train \\
        --config-path micro_diffusion_tpu_torch/configs/h100_1gpu \\
        --config-name res_256_pretrain [key=value ...]

The recipes' ``_target_`` strings resolve to the port (train/config.py). The
model is built on ``trainer.device``: ``cuda`` unless the recipe or an override
says ``cpu`` (the H100 overlays say ``cuda``; without a card that raises).

One process per GPU (train.py:110-123's ``jax.distributed`` path):

    torchrun --nproc_per_node 8 -m micro_diffusion_tpu_torch.train --multihost \
        --config-path micro_diffusion_tpu_torch/configs/h100_1gpu \
        --config-name res_256_pretrain dataset.train_batch_size=2048

``--multihost``, or a set ``WORLD_SIZE``, joins the process group (NCCL on
``cuda``, gloo on ``cpu``); the model goes to ``cuda:LOCAL_RANK``.
``dataset.train_batch_size`` and ``eval_batch_size`` are global: each rank loads
its part of every batch (train.py:31-46); ``device_train_microbatch_size`` is per
rank; ``misc.mesh_shape`` lays the ranks out (parallel/mesh.py).
"""

import argparse
import os
from typing import List, Optional, Sequence

import torch.distributed as dist

from ..models.diffusion import text_encoder_embedding_format
from ..parallel import init_distributed
from ..parallel.mesh import DEFAULT_TIMEOUT_S
from ..utils.profiling import span
from .callbacks import Callback
from .config import instantiate, load_config, resolve_target
from .trainer import Trainer

_DEVICES = ("cuda", "cpu")


def _device(name: str) -> str:
    if name.split(":")[0] not in _DEVICES:
        raise ValueError(f"trainer.device {name!r}: the port runs on 'cuda' or 'cpu' "
                         "(the H100 overlays set 'cuda')")
    return name


def build_from_config(cfg: dict, callbacks: Sequence[Callback] = ()) -> Trainer:
    """The trainer a recipe describes; ``callbacks`` are added after the
    recipe's own."""
    if not cfg["model"].get("precomputed_latents", True):
        raise ValueError("for microbudget training the latents are precomputed, as in "
                         "the JAX package's train.py (no raw-image dataset loader)")
    trainer_cfg = dict(cfg["trainer"])
    device = _device(str(trainer_cfg.pop("device", "cuda")))
    mesh_shape = (cfg.get("misc") or {}).get("mesh_shape") or {}
    rank, parts = 0, 1
    if dist.is_initialized():
        rank = dist.get_rank()
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
        # the batch splits over data x fsdp; the tensor ranks of a cell share rows
        tensor = int(mesh_shape.get("tensor") or 1)
        parts = dist.get_world_size() // tensor
        rank //= tensor
    seed = int(trainer_cfg.get("seed", cfg.get("seed", 18)))
    model = instantiate(cfg["model"], device=device, seed=seed)

    cap_seq, cap_dim = text_encoder_embedding_format(cfg["model"]["text_encoder_name"])
    ds = cfg["dataset"]
    loader_kw = dict(image_size=ds["image_size"], cap_seq_size=cap_seq, cap_emb_dim=cap_dim,
                     seed=cfg.get("seed", 18), process_index=rank, process_count=parts)

    def per_rank(key):
        total = int(ds[key])
        if total % parts:
            raise ValueError(f"dataset.{key} {total} does not split over {parts} ranks")
        return total // parts

    train_loader = instantiate(ds["train"], batch_size=per_rank("train_batch_size"),
                               cap_drop_prob=ds.get("cap_drop_prob", 0.0), **loader_kw)
    print(f"Found {len(train_loader.dataset)} images in the training dataset", flush=True)
    eval_loader = None
    if "eval" in ds:
        try:
            eval_loader = instantiate(ds["eval"], batch_size=per_rank("eval_batch_size"),
                                      **loader_kw)
            print(f"Found {len(eval_loader.dataset)} images in the eval dataset", flush=True)
        except FileNotFoundError:
            print("eval dataset not found; online eval disabled", flush=True)

    loggers = []
    if not dist.is_initialized() or dist.get_rank() == 0:  # rank 0 logs
        loggers = [instantiate(c) for c in (cfg.get("logger") or {}).values()
                   if isinstance(c, dict) and "_target_" in c]
    cbs = [instantiate(c) for c in (cfg.get("callbacks") or {}).values()
           if isinstance(c, dict) and "_target_" in c]
    algorithms = cfg.get("algorithms") or {}
    ema_cfg = None
    if "ema" in algorithms:
        ema_cfg = {k: v for k, v in algorithms["ema"].items() if k != "_target_"}
    trainer_cls = resolve_target(trainer_cfg.pop("_target_", "composer.Trainer"))
    return trainer_cls(
        model=model,
        optimizer={k: v for k, v in cfg["optimizer"].items() if k != "_target_"},
        schedulers=cfg["scheduler"],
        train_dataloader=train_loader,
        eval_dataloader=eval_loader,
        loggers=loggers,
        callbacks=cbs + list(callbacks),
        algorithms=algorithms,
        ema=ema_cfg,
        mesh_shape=mesh_shape,
        device=device,
        **trainer_cfg,
    )


def main(argv: Optional[List[str]] = None, callbacks: Sequence[Callback] = ()) -> Trainer:
    """Parse the command line, train, and return the trainer."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-path", default="configs")
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group torchrun describes (one process "
                             "per GPU; also when WORLD_SIZE is set)")
    parser.add_argument("--dist-timeout", type=float, default=DEFAULT_TIMEOUT_S,
                        help="seconds a collective may wait before the run fails")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    with span("entry.build"):  # the recipe to the built trainer
        cfg = load_config(args.config_path, args.config_name, args.overrides)
        if args.multihost or "WORLD_SIZE" in os.environ:
            init_distributed(_device(str(cfg["trainer"].get("device", "cuda"))),
                             timeout=args.dist_timeout)
        trainer = build_from_config(cfg, callbacks)
    try:
        trainer.fit()
    finally:
        trainer.close()
    return trainer
