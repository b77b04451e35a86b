"""Optimizer, learning-rate schedules and EMA, counterpart of
micro_diffusion_tpu/train/optim.py.

AdamW is written as plain tensor functions (``torch._foreach_*``) that reproduce
the JAX package's optax chain step for step, with fp32 update math:

  * ``clip_by_global_norm``: when ||g|| >= max_norm, g <- (g / ||g||) * max_norm
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
  * Adam moments ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
    corrected by ``1 - b^count`` at the incremented count, update
    ``mu_hat / (sqrt(nu_hat) + eps)``;
  * decoupled weight decay on the old parameter, ``u + wd * p``;
  * the learning rate evaluated at the pre-increment count, ``p <- p - lr * u``.

Parameters are a ``{name: tensor}`` dict (the module's own parameters, or under
ZeRO-2 this rank's shard of each: parallel/sharding.py ``Zero2.param_shards``,
views into them), updated in place under ``no_grad``; the moments take the shape
of what ``init`` is given. The MoE lr group matches ``moe_matcher`` against the
parameter names, as the reference matches it against torch names: with the
default 'moe' it matches nothing (the modules are named ``mlp``), so every
parameter gets the base lr, but the machinery is live.
"""

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# ----------------------------------------------------------------------- schedules
# Each schedule maps a step count to the learning rate, computed in float32 as the
# JAX package computes it on the device.


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_with_warmup(base_lr: float, t_warmup: int, t_max: int,
                       alpha_f: float = 0.0) -> Callable:
    """Composer CosineAnnealingWithWarmupScheduler: linear warmup then cosine to
    alpha_f * base_lr at t_max."""

    def schedule(step):
        step = _f32(step)
        warm = step / max(t_warmup, 1)
        tau = torch.clamp((step - t_warmup) / max(t_max - t_warmup, 1), 0.0, 1.0)
        cos = alpha_f + (1.0 - alpha_f) * 0.5 * (1.0 + torch.cos(math.pi * tau))
        return base_lr * torch.where(step < t_warmup, warm, cos)

    return schedule


def constant_schedule(base_lr: float, alpha: float = 1.0) -> Callable:
    def schedule(step):
        return _f32(base_lr * alpha)

    return schedule


def constant_with_warmup(base_lr: float, t_warmup: int, alpha: float = 1.0) -> Callable:
    def schedule(step):
        warm = _f32(step) / max(t_warmup, 1)
        return base_lr * alpha * torch.clamp(warm, max=1.0)

    return schedule


def build_schedule(cfg: dict, base_lr: float, t_max: int) -> Callable:
    """A schedule from a reference-style scheduler config block (the reference
    ``_target_`` names, composer.optim.*, or short names)."""
    target = cfg.get("_target_", cfg.get("name", "constant"))
    name = target.split(".")[-1].lower()

    def parse_t(v):  # '2500ba' -> 2500
        if isinstance(v, str):
            if not v.endswith("ba"):
                raise ValueError(f"only 'ba' units supported, got {v}")
            return int(v[:-2])
        return int(v)

    if "cosineannealingwithwarmup" in name:
        return cosine_with_warmup(base_lr, parse_t(cfg["t_warmup"]), t_max,
                                  float(cfg.get("alpha_f", 0.0)))
    if "constantwithwarmup" in name:
        return constant_with_warmup(base_lr, parse_t(cfg["t_warmup"]),
                                    float(cfg.get("alpha", 1.0)))
    if "constant" in name:
        return constant_schedule(base_lr, float(cfg.get("alpha", 1.0)))
    raise ValueError(f"unknown scheduler {target}")


# ----------------------------------------------------------------------- optimizer


def global_norm(tensors, group=None, device=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32. With a process
    ``group``, the squares are summed over its ranks first: each rank passes the
    shards it counts (parallel.sharding.Zero2.norm_names), so that every element
    of the reduced gradient is counted once; ``device`` for a rank that counts
    none."""
    tensors = [t.float() for t in tensors]
    if tensors:
        squares = torch.stack(torch._foreach_norm(tensors)).square().sum()
    else:
        squares = torch.zeros((), device=device)
    if group is not None:
        dist.all_reduce(squares, group=group)
    return squares.sqrt()


def _label_params(names, moe_matcher: str = "moe") -> dict:
    """Label each parameter 'moe' or 'rest' by name substring (train.py:29-30)."""
    return {n: "moe" if moe_matcher in n.lower() else "rest" for n in names}


# parameters per foreach pass: bounds the fp32 temporaries of one pass (256 MB each)
_CHUNK_NUMEL = 1 << 26


@dataclasses.dataclass
class AdamState:
    """The Adam moments per parameter name and the update count (shared by the
    lr groups, which always step together)."""

    count: int
    mu: dict
    nu: dict


class AdamW:
    """AdamW (+ global-norm clip) with a reduced-lr group for the parameters
    labelled 'moe'. ``init`` makes the state; ``step`` clips the gradients and
    updates the parameters in place, returning the new state."""

    def __init__(self, labels: dict, lr_schedule: Callable, weight_decay: float = 0.1,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                 clip_norm: Optional[float] = None, moe_lr_factor: float = 0.5,
                 mu_dtype: Optional[torch.dtype] = None,
                 low_precision_moments: bool = False):
        self.labels = labels
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.clip_norm = clip_norm
        has_moe = any(l == "moe" for l in labels.values())
        self.factors = {"rest": 1.0, "moe": moe_lr_factor if has_moe else 1.0}
        self.low_precision_moments = low_precision_moments
        self.mu_dtype = torch.bfloat16 if low_precision_moments else mu_dtype
        self.nu_dtype = torch.bfloat16 if low_precision_moments else None

    def init(self, params: dict) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=self.nu_dtype or p.dtype) for k, p in params.items()},
        )

    def _chunks(self, names, params):
        chunk, size = [], 0
        for n in names:
            chunk.append(n)
            size += params[n].numel()
            if size >= _CHUNK_NUMEL:
                yield chunk
                chunk, size = [], 0
        if chunk:
            yield chunk

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: AdamState,
             grad_norm: Optional[torch.Tensor] = None) -> AdamState:
        """One update; ``grads`` (fp32) are clipped in place, the parameters and the
        moments updated in place. Returns the state with the incremented count."""
        names = list(params)
        if self.clip_norm is not None:
            norm = global_norm(grads[n] for n in names) if grad_norm is None else grad_norm
            # optax's select(norm < max_norm, g, g / norm * max_norm) on the device,
            # with no host sync: below the threshold g is divided and multiplied by 1
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            gl = [grads[n] for n in names]
            torch._foreach_div_(gl, torch.where(keep, one, norm))
            torch._foreach_mul_(gl, torch.where(keep, one, torch.full_like(norm, self.clip_norm)))
        count_inc = state.count + 1
        b1, b2 = self.b1, self.b2
        c32 = np.float32(count_inc)
        bc1 = float(np.float32(1) - np.float32(b1) ** c32)
        bc2 = float(np.float32(1) - np.float32(b2) ** c32)
        lr = float(self.lr_schedule(state.count))
        for label, factor in self.factors.items():
            group = [n for n in names if self.labels[n] == label]
            neg_lr = -float(np.float32(lr) * np.float32(factor))
            for chunk in self._chunks(group, params):
                self._update(chunk, params, grads, state, bc1, bc2, neg_lr)
        return AdamState(count=count_inc, mu=state.mu, nu=state.nu)

    def _update(self, names, params, grads, state, bc1, bc2, neg_lr):
        b1, b2, eps = self.b1, self.b2, self.eps
        p = [params[n] for n in names]
        g = [grads[n].float() for n in names]
        g2 = torch._foreach_mul(g, g)

        def moment(old, new, b):
            # scale_by_adam_low_precision: b * m + (1 - b) * g, all in fp32
            old32 = [m.float() for m in old]
            if self.low_precision_moments:
                out = torch._foreach_mul(old32, b)
                torch._foreach_add_(out, torch._foreach_mul(new, 1 - b))
                return out
            # optax: (1 - b) * g + b * m, where JAX rounds the Python scalar b to the
            # dtype of a bf16-stored m (0.9 -> 0.8984375) and multiplies in fp32
            b_m = torch.tensor(b, dtype=old[0].dtype).item()
            out = torch._foreach_mul(new, 1 - b)
            torch._foreach_add_(out, torch._foreach_mul(old32, b_m))
            return out

        mu = moment([state.mu[n] for n in names], g, b1)
        nu = moment([state.nu[n] for n in names], g2, b2)
        del g2
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, eps)
        torch._foreach_div_(u, den)
        del den
        # decoupled weight decay on the old parameter, then -lr, then apply
        torch._foreach_add_(u, torch._foreach_mul([x.float() for x in p], self.weight_decay))
        torch._foreach_mul_(u, neg_lr)
        for n, x, du, m, v in zip(names, p, u, mu, nu):
            x.add_(du.to(x.dtype))
            state.mu[n].copy_(m)
            state.nu[n].copy_(v)


def build_optimizer(params: dict, lr_schedule: Callable, weight_decay: float = 0.1,
                    betas: tuple = (0.9, 0.999), eps: float = 1e-8,
                    clip_norm: Optional[float] = None, moe_lr_factor: float = 0.5,
                    moe_matcher: str = "moe", mu_dtype: Optional[torch.dtype] = None,
                    low_precision_moments: bool = False) -> AdamW:
    """AdamW (+ global-norm clip) with an optional reduced-lr group for MoE params.

    ``params``: {name: tensor}, e.g. ``dict(model.named_parameters())``.
    ``mu_dtype`` can be torch.bfloat16 to halve first-moment memory;
    ``low_precision_moments`` stores both moments in bf16 (fp32 math).
    """
    return AdamW(_label_params(params, moe_matcher), lr_schedule, weight_decay, betas,
                 eps, clip_norm, moe_lr_factor, mu_dtype, low_precision_moments)


# ----------------------------------------------------------------------- EMA


@torch.no_grad()
def ema_update(ema_params: dict, params: dict, step: int, smoothing: float,
               ema_start: int, update_interval: int = 1) -> dict:
    """EMA with start gating, in place on ``ema_params``: mirror the params before
    ``ema_start``, decay after it, every ``update_interval``-th step (the mirror
    runs every step). fp32 decay math whatever the EMA storage dtype."""
    step = int(step)
    if not (step < ema_start or step % max(1, update_interval) == 0):
        return ema_params
    decay = np.float32(smoothing if step >= ema_start else 0.0)
    keep, take = float(decay), float(np.float32(1.0) - decay)
    for name, e in ema_params.items():
        e.copy_(e.float() * keep + params[name].float() * take)
    return ema_params
