"""Deferred patch masking, counterpart of ``micro_diffusion_tpu/ops/masking.py``.

Per-sample random keep-set via argsort of uniform noise (reference
utils.py:382-426): the kept tokens are gathered out so the backbone sees only
``T * (1 - mask_ratio)`` of them, and after the final layer they are scattered
back with a zero mask token. The noise comes from an explicit
``torch.Generator``; a caller that needs a given keep-set builds the
:class:`TokenMask` itself (``token_mask_from_keep``).
"""

from typing import NamedTuple

import torch


class TokenMask(NamedTuple):
    mask: torch.Tensor         # (B, T) float, 0 = keep, 1 = removed
    ids_keep: torch.Tensor     # (B, len_keep) int64
    ids_restore: torch.Tensor  # (B, T) int64


def _from_shuffle(ids_shuffle: torch.Tensor, len_keep: int) -> TokenMask:
    """The mask for a per-sample permutation whose first ``len_keep`` entries are kept."""
    batch, length = ids_shuffle.shape
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    mask = torch.ones(batch, length, device=ids_shuffle.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return TokenMask(mask=mask, ids_keep=ids_shuffle[:, :len_keep], ids_restore=ids_restore)


def make_token_mask(generator: torch.Generator, batch: int, length: int,
                    mask_ratio: float) -> TokenMask:
    """Per-sample random token keep-set (reference utils.py:382-403).

    ``len_keep = int(length * (1 - mask_ratio))``. The uniform noise is drawn from
    ``generator``, on its device.
    """
    len_keep = int(length * (1 - mask_ratio))
    noise = torch.rand(batch, length, generator=generator, device=generator.device)
    return _from_shuffle(torch.argsort(noise, dim=1), len_keep)


def token_mask_from_keep(keep: torch.Tensor) -> TokenMask:
    """The TokenMask whose kept tokens are ``keep`` (B, T) bool, in index order.

    Every sample must keep the same number of tokens. Used to inject a keep-set
    drawn elsewhere (for example by the JAX package in the parity tests).
    """
    counts = keep.sum(dim=1)
    if not bool((counts == counts[0]).all()):
        raise ValueError("every sample must keep the same number of tokens")
    # stable sort on "removed": kept indices first, each group in index order
    ids_shuffle = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return _from_shuffle(ids_shuffle, int(counts[0]))


def gather_tokens(x: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
    """Gather kept tokens: (B, T, D) -> (B, len_keep, D) (reference utils.py:406-414)."""
    return torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, x.shape[-1]))


def scatter_tokens(x: torch.Tensor, ids_restore: torch.Tensor,
                   mask_token: torch.Tensor) -> torch.Tensor:
    """Scatter kept tokens back into the full sequence (reference utils.py:417-426).

    Missing positions are filled with ``mask_token`` (broadcastable to (1, 1, D)).
    """
    b, len_keep, d = x.shape
    t = ids_restore.shape[1]
    fill = mask_token.to(x.dtype).expand(b, t - len_keep, d)
    x_full = torch.cat([x, fill], dim=1)
    return torch.gather(x_full, 1, ids_restore[:, :, None].expand(-1, -1, d))
