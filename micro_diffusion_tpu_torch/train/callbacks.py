"""Loggers and callbacks of the port's trainer, its own copy of
micro_diffusion_tpu/train/callbacks.py: SpeedMonitor, LRMonitor,
OptimizerMonitor and RuntimeEstimator (the reference recipe's Composer
callbacks), NaNCatcher and LogDiffusionImages (the reference's own), and the
Tensorboard logger with its JSONL fallback.

Callbacks see host floats, once per metric window: the trainer keeps each step's
metrics on the device and fetches them only every ``metric_window`` steps.
"""

import json
import math
import os
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence

import numpy as np


class Logger:
    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONLLogger(Logger):
    """One JSON object per call: {"step": n, <name>: value, ...}."""

    def __init__(self, path: str = "./metrics.jsonl", **_: Any):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log_scalars(self, scalars, step):
        self._f.write(json.dumps({"step": step, **scalars}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardLogger(Logger):
    """Tensorboard event files under ``log_dir``; ``metrics.jsonl`` there when
    tensorboard is not installed."""

    def __init__(self, log_dir: Optional[str] = None, **_: Any):
        self.log_dir = log_dir or "./runs"
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._writer = None
            self._jsonl = JSONLLogger(os.path.join(self.log_dir, "metrics.jsonl"))
        else:
            self._writer = SummaryWriter(log_dir=self.log_dir)

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self._writer is None:
            self._jsonl.log_scalars(scalars, step)
            return
        for k, v in scalars.items():
            self._writer.add_scalar(k, v, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()


# ----------------------------------------------------------------------- callbacks


class Callback:
    def fit_start(self, trainer) -> None:
        pass

    def step_end(self, trainer, metrics: Dict[str, float]) -> None:
        """Called with host metric values every metric window (not every step)."""

    def eval_end(self, trainer, eval_loss: float) -> None:
        pass

    def fit_end(self, trainer) -> None:
        pass


class SpeedMonitor(Callback):
    """Images/s over the last ``window_size`` metric windows (Composer SpeedMonitor)."""

    def __init__(self, window_size: int = 3, **_: Any):
        self.window_size = window_size
        self._times: deque = deque(maxlen=window_size + 1)
        self._steps: deque = deque(maxlen=window_size + 1)

    def step_end(self, trainer, metrics) -> None:
        self._times.append(time.perf_counter())
        self._steps.append(int(trainer.global_step))
        if len(self._times) < 2:
            return
        dt = self._times[-1] - self._times[0]
        dsteps = self._steps[-1] - self._steps[0]
        if dt > 0 and dsteps > 0:
            sps = dsteps / dt
            ips = sps * trainer.global_batch_size
            trainer.log({"throughput/steps_per_sec": sps,
                         "throughput/images_per_sec": ips,
                         "throughput/images_per_sec_per_chip": ips / max(trainer.num_chips, 1)})


class LRMonitor(Callback):
    def __init__(self, **_: Any):
        pass

    def step_end(self, trainer, metrics) -> None:
        if "lr" in metrics:
            trainer.log({"lr-AdamW/group0": float(metrics["lr"])})


class OptimizerMonitor(Callback):
    """The global gradient norm before clipping (Composer OptimizerMonitor)."""

    def __init__(self, **_: Any):
        pass

    def step_end(self, trainer, metrics) -> None:
        if "grad_norm" in metrics:
            trainer.log({"l2_norm/grad/global": float(metrics["grad_norm"])})


class RuntimeEstimator(Callback):
    def __init__(self, **_: Any):
        self._start: Optional[float] = None
        self._start_step = 0

    def fit_start(self, trainer) -> None:
        self._start = time.perf_counter()
        self._start_step = int(trainer.global_step)

    def step_end(self, trainer, metrics) -> None:
        done = int(trainer.global_step) - self._start_step
        if done <= 0 or self._start is None:
            return
        rate = (time.perf_counter() - self._start) / done
        remaining = (trainer.max_steps - int(trainer.global_step)) * rate
        trainer.log({"time/remaining_estimate_hours": remaining / 3600.0})


class NaNCatcher(Callback):
    """Raise on a non-finite train loss (reference callbacks.py:47-64), checked at
    the metric window: a NaN persists, so the windowed check still halts."""

    def __init__(self, **_: Any):
        pass

    def step_end(self, trainer, metrics) -> None:
        loss = metrics.get("loss")
        if loss is not None and not math.isfinite(loss):
            raise RuntimeError(f"Train loss contains a NaN (step {trainer.global_step}).")


class LogDiffusionImages(Callback):
    """Sample the fixed prompts at each eval (reference callbacks.py:9-44).

    It samples from precomputed prompt embeddings, not through an attached text
    encoder and VAE as the JAX callback can (ROADMAP queue A item 4),
    ``prompt_latents_path`` (an .npy of shape
    (P, 1, L, D) or (P, L, D)), with the eval weights (the EMA when there is one),
    and logs the latents' standard deviation. Without that file it warns once and
    logs nothing.
    """

    def __init__(self, prompts: Optional[Sequence[str]] = None,
                 prompts_file: Optional[str] = None, sampling_steps: int = 30,
                 guidance_scale: float = 5.0, seed: Optional[int] = 1138,
                 prompt_latents_path: Optional[str] = None, **_: Any):
        if prompts is None and prompts_file:
            import yaml

            with open(prompts_file) as f:
                prompts = yaml.safe_load(f)["prompts"]
        self.prompts = list(prompts or [])
        self.sampling_steps = sampling_steps
        self.guidance_scale = guidance_scale
        self.seed = seed
        self.prompt_latents_path = prompt_latents_path
        self._warned = False

    def eval_end(self, trainer, eval_loss) -> None:
        if not (self.prompt_latents_path and os.path.exists(self.prompt_latents_path)):
            if not self._warned:
                trainer.print("LogDiffusionImages: no prompt_latents_path; skipping "
                              "image logging")
                self._warned = True
            return
        emb = np.load(self.prompt_latents_path)
        with trainer.eval_weights():
            latents = trainer.model.generate(
                text_embeddings=emb, guidance_scale=self.guidance_scale,
                num_inference_steps=self.sampling_steps, seed=self.seed,
                return_only_latents=True)
        trainer.log({"images/latent_std": float(latents.float().std())})
