"""Attention dispatch, layout (batch, seq, heads, head_dim) everywhere.

Counterpart of ``micro_diffusion_tpu/ops/attention.py``. The dispatch rules are
the JAX package's, with "on the accelerator" read as "on a CUDA tensor":

  'auto'       - on the card, the flash kernel (``flash_attention_lane``, K1) where
                 it applies (head_dim 64, even H); otherwise the ``flash_bh``
                 kernel (K4) at Tq >= 512 and the plain path below.
  'xla'        - the plain path (:func:`_xla_attention`).
  'flash'      - the lane kernel where it applies, else ``flash_bh``.
  'flash_lane' - force the lane kernel (its plain version on a CPU tensor).
  'flash_bh'   - force the whole-K kernel (``flash_attention_bh``, K4).
  'flash_bthd' - a TPU kernel not ported yet (K5): it raises.

On a CPU tensor 'auto' takes the plain path, as the JAX package does off the TPU.
"""

import torch

from .flash_attention_bh import flash_attention_bh
from .flash_attention_lane import flash_attention_lane, supported as lane_supported


def _xla_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v with fp32 scores and softmax; probabilities are
    cast to q.dtype before the product with v. (B, Tq, H, D) in and out."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


_UNPORTED = {"flash_bthd": "flash_attention (ROADMAP queue B, K5)"}


def _dispatch(q, k, v, *, scale: float, impl: str):
    on_card = q.is_cuda
    lane_ok = lane_supported(q.shape[2], q.shape[3])
    if impl == "auto":
        if on_card and lane_ok:
            impl = "flash_lane"
        else:
            impl = "flash" if (on_card and q.shape[1] >= 512) else "xla"
    elif impl == "pallas":  # legacy alias
        impl = "flash"
    if impl == "flash":
        impl = "flash_lane" if lane_ok else "flash_bh"
    if impl == "flash_lane":
        return flash_attention_lane(q, k, v, scale)
    if impl == "flash_bh":
        return flash_attention_bh(q, k, v, scale)
    if impl in _UNPORTED:
        raise NotImplementedError(
            f"attention impl {impl!r} needs the unported kernel {_UNPORTED[impl]}")
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _xla_attention(q, k, v, scale)


def dot_product_attention(q, k, v, *, scale: float | None = None,
                          impl: str | None = None):
    """Non-causal multi-head attention, layout (B, T, H, D), default scale
    1/sqrt(head_dim)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _dispatch(q, k, v, scale=scale, impl=impl or "auto")
