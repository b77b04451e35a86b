"""Training step, AdamW, schedules and EMA of the port (counterpart of
micro_diffusion_tpu/train/: optim.py and train_step.py, whose host-EMA classes are
train/host_ema.py here)."""

from .host_ema import AsyncHostEMA, HostComputeEMA, HostEMA, StagedEMAUpdate, pinned_empty
from .optim import (AdamW, build_optimizer, build_schedule, constant_schedule,
                    constant_with_warmup, cosine_with_warmup, ema_update)
from .train_step import (TrainState, create_train_state, make_apply_step, make_ema_step,
                         make_eval_step, make_grad_step, make_train_step,
                         zero_grad_accumulator)

__all__ = [
    "AdamW",
    "AsyncHostEMA",
    "HostComputeEMA",
    "HostEMA",
    "StagedEMAUpdate",
    "build_optimizer",
    "build_schedule",
    "constant_schedule",
    "constant_with_warmup",
    "cosine_with_warmup",
    "ema_update",
    "pinned_empty",
    "TrainState",
    "create_train_state",
    "make_apply_step",
    "make_ema_step",
    "make_eval_step",
    "make_grad_step",
    "make_train_step",
    "zero_grad_accumulator",
]
