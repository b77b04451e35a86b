"""The inputs a run makes from its seed: weights, latents, captions (plain torch
and numpy: the reference takes its weights from here too).

Both sides get the same inputs: the program's modules and the plain reference are
filled by ``fill_weights`` from the same seed, so that no weight the program made
reaches the reference. Weights are drawn on the targets' device, in chunks of whole
leaves (one normal draw per chunk), in sorted name order, and scaled per leaf:

  * a matrix, expert bank or convolution: std 1 / sqrt(fan in), the fan in being
    every dimension after the first (dimension 1 alone for a 3-D expert bank
    (experts, in, out));
  * a vector named ``*weight`` (a norm's scale): 1 + 0.1 * normal;
  * any other vector (a bias): 0.02 * normal.

Unlike the recipe's adaLN-zero init no gate starts at zero, so every layer moves from
the first step on, as in a stage that starts from the previous stage's weights.
"""

import numpy as np
import torch

CHUNK = 1 << 27  # elements drawn per call (512 MB of float32)


def sub_seed(seed: int, *tags: int) -> int:
    """A seed for one use of the run's seed (a torch.Generator takes < 2**64)."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _scale(name: str, shape):
    if len(shape) >= 2:
        fan_in = shape[1] if len(shape) == 3 else int(np.prod(shape[1:]))
        return 1 / fan_in ** 0.5, 0.0
    return (0.1, 1.0) if name.endswith("weight") else (0.02, 0.0)


@torch.no_grad()
def fill_weights(targets: dict, seed: int) -> None:
    """Fill ``targets`` ({name: tensor}, all on one device) in place from ``seed``."""
    names = sorted(targets)
    device = targets[names[0]].device
    gen = torch.Generator(device=device).manual_seed(seed)
    i = 0
    while i < len(names):
        chunk, size = [], 0
        while i < len(names) and (not chunk or size + targets[names[i]].numel() <= CHUNK):
            chunk.append(names[i])
            size += targets[names[i]].numel()
            i += 1
        flat = torch.randn(size, generator=gen, device=device)
        off = 0
        for name in chunk:
            t = targets[name]
            std, base = _scale(name, tuple(t.shape))
            t.copy_(flat[off:off + t.numel()].view(t.shape).mul_(std).add_(base))
            off += t.numel()
        del flat


def latents(seed: int, n: int, latent_res: int, cap_len: int, cap_dim: int, device):
    """n samples of fp16 caption latents (n, 1, L, D) and image latents (n, 4, r, r),
    as numpy arrays, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    caps = torch.randn((n, 1, cap_len, cap_dim), generator=gen, device=device)
    lats = 0.8 * torch.randn((n, 4, latent_res, latent_res), generator=gen, device=device)
    return caps.half().cpu().numpy(), lats.half().cpu().numpy()


def captions(path: str) -> list:
    with open(path) as f:
        return [line.strip() for line in f if line.strip() and not line.startswith("#")]


def draw_prompts(seed: int, call: int, pool: list, k: int) -> list:
    """The ``k`` captions of generate call ``call``, drawn from ``pool``."""
    rng = np.random.default_rng((int(seed), 7, call))
    return [pool[i] for i in rng.choice(len(pool), size=k, replace=False)]
