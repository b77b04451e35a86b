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

The lean remat policies (``<base>[_lean|_xlean][_alean]``, JAX ``models/dit.py:330-379``)
use names too. JAX makes a product lean by giving its dot a size-1 batch dimension,
which ``dots_with_no_batch_dims_saveable`` leaves out; the port runs each product
that a lean suffix concerns under a name of its own, and the policy tests that name
before its operator test (models/dit.py ``remat_policy_fn``):

  * ``ffn_hidden``  - the dense SwiGLU ``w1`` / ``w2`` products (``_xlean``);
  * ``attn_proj``   - self-attention ``qkv`` / ``proj``, cross-attention ``q_linear`` /
    ``kv_linear`` / ``proj`` (``_alean``);
  * ``expert_dots`` - the expert products of the unrolled dispatches ('unroll',
    'scan', 'onehot_dots'), which 'dots' keeps as JAX keeps their 2-D dots, and
    ``_lean`` / ``_xlean`` do not.

One name is never kept:

  * ``group_sum``   - the expert-parallel sum of the partial EC-MoE outputs over the
    ``tensor`` group (parallel/sharding.py ``_ReduceFromGroup``), an all-reduce in
    place on a copy; the recompute runs both again.

Names rather than JAX's batch-1 product, because a lean product then runs the very
operator that a kept one runs, so a lean policy changes no value, bit for bit (a
batch-1 ``bmm`` is another GEMM than ``addmm`` on the card); and because the policy
alone decides, when the block runs, what a name's products are: the layers carry no
flag, and a model follows ``remat_policy`` whenever it is changed.
"""

import contextlib
import threading

GROUP_SUM = "group_sum"

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
