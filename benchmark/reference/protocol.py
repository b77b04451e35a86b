"""The draws that a training run makes from its seed, worked out again.

The program's training run is deterministic given its seed (the recipes' top-level
``seed``): which samples make up each batch, which captions are dropped, and the
sigma, noise and token-mask draws of each microbatch. The reference needs the same
draws to follow the same steps, so this module derives them independently from the
documented protocol of the latents loader and the trainer:

  * epoch order: ``numpy.random.default_rng((seed, epoch))``, 'block' shuffle (the
    block order permuted, then each block's samples), or 'full' (one permutation);
  * caption drop of sample ``i`` in ``epoch``: ``default_rng((seed, epoch, i))
    .random() < p``;
  * step ``s`` draws from a ``torch.Generator`` on the run's device seeded with
    SeedSequence([seed, s]).generate_state(1, uint64) >> 1; each microbatch of n
    latents (C, H, W) draws, in order, a normal (n, 1, 1, 1) for log-sigma, a normal
    (n, C, H, W) noise, and with a mask ratio r a uniform (n, T) whose argsort keeps
    the first int(T * (1 - r)) tokens.
"""

import numpy as np
import torch


def step_seed(seed: int, step: int) -> int:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def epoch_order(n: int, seed: int, epoch: int, algo: str = "block",
                block: int = 1 << 18) -> np.ndarray:
    rng = np.random.default_rng((seed, epoch))
    if algo == "full":
        return rng.permutation(n)
    out = []
    starts = np.arange(0, n, block)
    for b in rng.permutation(len(starts)):
        lo = int(starts[b])
        hi = min(n, lo + block)
        out.append(lo + rng.permutation(hi - lo))
    return np.concatenate(out)


def caption_kept(seed: int, epoch: int, index: int, p: float) -> float:
    """1.0 where the caption of sample ``index`` is kept in ``epoch``, 0.0 where the
    loader drops it."""
    if p <= 0:
        return 1.0
    return 0.0 if np.random.default_rng((seed, epoch, int(index))).random() < p else 1.0


def batch_indices(n: int, batch: int, seed: int, step: int, algo: str = "block"):
    """(epoch, sample indices) of global step ``step``, drop_last batches of
    ``batch`` samples, the epochs one after the other."""
    per_epoch = n // batch
    epoch, k = divmod(step, per_epoch)
    order = epoch_order(n, seed, epoch, algo)
    return epoch, order[k * batch:(k + 1) * batch]


def microbatch_draws(gen: torch.Generator, shape, mask_ratio: float, patch: int):
    """One microbatch's draws from ``gen``, in the program's order: (rnd_normal (n, 1,
    1, 1), noise (n, C, H, W), (ids_keep, ids_restore) or None)."""
    n, _, h, w = shape
    dev = gen.device
    rnd = torch.randn((n, 1, 1, 1), generator=gen, device=dev)
    noise = torch.randn(tuple(shape), generator=gen, device=dev)
    mask = None
    if mask_ratio > 0:
        t = (h // patch) * (w // patch)
        keep = int(t * (1 - mask_ratio))
        shuffle = torch.argsort(torch.rand(n, t, generator=gen, device=dev), dim=1)
        mask = (shuffle[:, :keep], torch.argsort(shuffle, dim=1))
    return rnd, noise, mask


def step_draws(seed: int, step: int, batch_shape, microbatch: int, mask_ratio: float,
               patch: int, device):
    """The draws of every microbatch of step ``step``, in order."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    n = batch_shape[0]
    return [microbatch_draws(gen, (min(microbatch, n - i),) + tuple(batch_shape[1:]),
                             mask_ratio, patch) for i in range(0, n, microbatch)]
