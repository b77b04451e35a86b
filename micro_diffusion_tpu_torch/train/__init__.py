"""Training step, AdamW, schedules and EMA of the port (counterpart of
micro_diffusion_tpu/train/: optim.py and train_step.py)."""

from .optim import (AdamW, build_optimizer, build_schedule, constant_schedule,
                    constant_with_warmup, cosine_with_warmup, ema_update)
from .train_step import TrainState, create_train_state, make_eval_step, make_train_step

__all__ = [
    "AdamW",
    "build_optimizer",
    "build_schedule",
    "constant_schedule",
    "constant_with_warmup",
    "cosine_with_warmup",
    "ema_update",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
]
