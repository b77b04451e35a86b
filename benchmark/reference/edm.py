"""EDM training and sampling around the plain MicroDiT, and AdamW, in float32.

Karras et al. 2022 (arXiv 2206.00364) with the published MicroDiT settings:
sigma_data 0.9, log-normal training sigma (P_mean, P_std of the stage), the EDM loss
weight, the masked patch-pooled loss at mask ratio > 0 (the loss of each kept
2 x 2 patch, averaged over the kept patches of the image), the Heun sampler with
classifier-free guidance by batch doubling (sigma_min 0.002, sigma_max 80, rho 7,
no churn; each sigma and step rounded to float32 as the sampler carries them).
AdamW with a global-norm clip (no epsilon), bias correction, weight decay
on the old parameter and the learning rate at the step before the update; the EMA
mirrors the parameters before ``ema_start`` and decays after it.
"""

import math

import numpy as np
import torch

SIGMA_DATA = 0.9


def denoise(model, x, sigma, y, token_mask=None):
    """The preconditioned denoiser D(x; sigma) of x (B, C, H, W), sigma (B,)."""
    s = sigma.reshape(-1, 1, 1, 1)
    sd2 = SIGMA_DATA ** 2
    c_skip = sd2 / (s ** 2 + sd2)
    c_out = s * SIGMA_DATA / torch.sqrt(s ** 2 + sd2)
    c_in = 1 / torch.sqrt(sd2 + s ** 2)
    out = model(c_in * x, torch.log(sigma) / 4, y, token_mask)
    return c_skip * x + c_out * out


def row_losses(model, x, y, rnd, noise, token_mask, p_mean, p_std, patch):
    """The EDM loss of each image (B,)."""
    sigma = torch.exp(rnd.reshape(-1) * p_std + p_mean)
    weight = (sigma ** 2 + SIGMA_DATA ** 2) / (sigma * SIGMA_DATA) ** 2
    d = denoise(model, x + noise * sigma.reshape(-1, 1, 1, 1), sigma, y, token_mask)
    loss = weight.reshape(-1, 1, 1, 1) * (d - x) ** 2
    if token_mask is None:
        return loss.mean(dim=(1, 2, 3))
    b, _, h, w = loss.shape
    pooled = loss.mean(dim=1).reshape(b, h // patch, patch, w // patch, patch)
    pooled = pooled.mean(dim=(2, 4)).reshape(b, -1)
    ids_keep, _ = token_mask
    return torch.gather(pooled, 1, ids_keep).mean(dim=1)


def sigma_schedule(steps: int, sigma_min=0.002, sigma_max=80.0, rho=7.0) -> np.ndarray:
    i = np.arange(steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho) + i / (steps - 1)
         * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([t, [0.0]])


def sampler_steps(steps: int):
    """(t0, [(sigma, next sigma, step) of each Heun step]): the schedule in float64,
    each sigma and each step rounded to float32, as the sampler carries them."""
    t = sigma_schedule(steps)
    cur, nxt = t[:-1].astype(np.float32), t[1:].astype(np.float32)
    return float(np.float32(t[0])), [(float(c), float(n), float(np.float32(n - c)))
                                      for c, n in zip(cur, nxt)]


def guided(model, x, sigma: float, y2, cfg: float):
    """The guided denoiser at (x, sigma): D of the doubled batch, conditional half
    captions ``y2[:n]``, unconditional half zeros, mixed at ``cfg``."""
    s = torch.full((2 * x.shape[0],), sigma, device=x.device)
    cond, uncond = denoise(model, torch.cat([x, x]), s, y2).chunk(2)
    return uncond + cfg * (cond - uncond)


@torch.no_grad()
def heun_sample(model, noise, y, steps: int, cfg: float, record=None, weight: float = 0.5):
    """EDM's deterministic Heun sampler from ``noise`` (B, C, H, W) with guidance
    ``cfg``, the last step Euler; ``record`` (a list) takes each denoiser call's
    (input, output). ``weight``: the second slope's share of a step (Heun's 0.5;
    calibrate.py plants a wrong one)."""
    t0, plan = sampler_steps(steps)
    y2 = torch.cat([y, torch.zeros_like(y)])

    def den(x, sigma):
        d = guided(model, x, sigma, y2, cfg)
        if record is not None:
            record.append((x, d))
        return d

    x = noise * t0
    for i, (tc, tn, dt) in enumerate(plan):
        d_cur = (x - den(x, tc)) / tc
        x_euler = x + dt * d_cur
        if i < steps - 1:
            d_prime = (x_euler - den(x_euler, tn)) / tn
            x = x + dt * ((1 - weight) * d_cur + weight * d_prime)
        else:
            x = x_euler
    return x


def relative_gap(got, want) -> float:
    """The widest gap of ``got`` from ``want`` over ``want``'s largest magnitude."""
    return float((got - want).abs().max() / want.abs().max())


def heun_replay(xs, ds, steps: int):
    """The Heun arithmetic again, in float64, over a recorded run of the sampler:
    ``xs`` / ``ds``, the inputs and outputs of its 2 * steps - 1 denoiser calls.
    Returns (the widest gap between a recorded input and the one the update gives
    from the calls before it, relative to the recorded input's largest magnitude: the
    sampler's own float32 rounding and nothing else in a sound run; the final latents,
    in float32)."""
    _, plan = sampler_steps(steps)
    xs, ds = [x.double() for x in xs], [d.double() for d in ds]
    gap = 0.0
    for i, (tc, tn, dt) in enumerate(plan):
        x = xs[2 * i]
        d_cur = (x - ds[2 * i]) / tc
        x_euler = x + dt * d_cur
        if i == steps - 1:
            return gap, x_euler.float()
        gap = max(gap, relative_gap(x_euler, xs[2 * i + 1]))
        d_prime = (xs[2 * i + 1] - ds[2 * i + 1]) / tn
        gap = max(gap, relative_gap(x + dt * (0.5 * d_cur + 0.5 * d_prime), xs[2 * i + 2]))


def cosine_warmup_lr(base: float, warmup: int, total: int, alpha_f: float, step: int):
    if step < warmup:
        return base * step / max(warmup, 1)
    tau = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * (alpha_f + (1 - alpha_f) * 0.5 * (1 + math.cos(math.pi * tau)))


def learning_rate(sched: dict, step: int) -> float:
    """The stage's schedule at ``step``: {'kind': 'constant', 'lr'} or {'kind':
    'cosine_warmup', 'lr', 'warmup', 'total', 'alpha_f'}."""
    if sched["kind"] == "constant":
        return sched["lr"]
    return cosine_warmup_lr(sched["lr"], sched["warmup"], sched["total"], sched["alpha_f"],
                            step)


class AdamW:
    """AdamW on a {name: float32 tensor} dict, updated in place."""

    def __init__(self, params: dict, sched: dict, weight_decay: float, betas, eps: float,
                 clip_norm):
        self.params, self.sched = params, sched
        self.wd, (self.b1, self.b2), self.eps, self.clip = weight_decay, betas, eps, clip_norm
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Clip, update; returns the clipped gradients (what the moments took)."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if self.clip is not None and norm >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        lr = learning_rate(self.sched, self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.sub_(lr * (u + self.wd * p))
        return grads


@torch.no_grad()
def ema_update(ema: dict, params: dict, step: int, smoothing: float, start: int,
               interval: int = 1) -> None:
    if step < start:
        for k, e in ema.items():
            e.copy_(params[k])
    elif step % interval == 0:
        for k, e in ema.items():
            e.mul_(smoothing).add_(params[k], alpha=1 - smoothing)
