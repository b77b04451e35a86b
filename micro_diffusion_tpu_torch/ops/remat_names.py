"""Names for values that a remat policy may keep: the port's ``checkpoint_name``.

The JAX package tags the self-attention, cross-attention and EC-MoE outputs with
``jax.ad_checkpoint.checkpoint_name`` ("attn_out", "xattn_out", "moe_out";
``micro_diffusion_tpu/ops/attention.py:83``, ``models/layers.py:303,307,390,601``)
so that the 'attn_moe' policies save them by name. A PyTorch selective-checkpoint
policy sees operators, not values, so the port names the operator that produces
each value instead: the producer runs inside ``with checkpoint_name(name):``, and
a policy reads :func:`current_name` when it is asked about an operator. The kernel
forwards are single operators (``torch.library`` custom ops) for this reason: kept,
their outputs come back from the cache in the backward's recompute, and the
kernel is not launched again.
"""

import contextlib
import threading

_state = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str | None):
    """Run the block's operators under ``name`` (None: no name)."""
    prev = getattr(_state, "name", None)
    _state.name = name
    try:
        yield
    finally:
        _state.name = prev


def current_name() -> str | None:
    """The name of the innermost ``checkpoint_name`` block running, or None."""
    return getattr(_state, "name", None)
