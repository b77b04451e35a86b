"""Whole-K flash attention ('flash_bh') for head_dim 16, 32 and 64, any head count,
on the natural (B, T, H, D) layout.

Counterpart of ``micro_diffusion_tpu/ops/flash_attention_bh.py`` (K4), forward and
backward: the attention of the models whose head_dim the lane kernel does not take
(MicroDiT-Tiny, D = 32; Micro, D = 16) at Tq >= 512 under 'auto'.
:func:`flash_attention_bh` is a ``torch.autograd.Function`` that saves q, k, v (the
JAX rule saves their (B*H, T, D) transposes; the port reads strides and makes no
copy) and recomputes the softmax in the backward. On CUDA tensors the forward
and the backward launch the lane kernels' sources, ``csrc/flash_attention_lane.cu``
and ``csrc/flash_attention_lane_bwd.cu``, which are templated on the head dim (one
function, one layout), through the same helpers; the counts here are K4's own. On
CPU tensors both run their plain versions.

Forward contract (the TPU ``_fwd_kernel``): m is the row max of the unscaled
s = q k^T (fp32), e = exp2((s - m) * scale * log2(e)), l = rowsum(e),
out = (bf16(e) @ v, fp32 accumulation) / l.
Backward contract (the TPU ``_bwd_kernel``), inv_l = 1 / l:

    dv = bf16(e)^T @ bf16(do * inv_l)
    dp = do @ v^T (fp32),  delta = rowsum(e * dp) * inv_l
    ds_u = bf16(e * (dp - delta))
    dq = (ds_u @ k) * scale * inv_l,  dk = ds_u^T @ bf16(q * scale * inv_l)

These are the lane kernel's (K1, K1b) roundings too: the two TPU kernels compute
one function in two layouts, so the plain versions and the CUDA kernels are shared
with ``ops/flash_attention_lane.py``, written for any head count.
"""

from .flash_attention_lane import (_LaneAttention, _check, _default_scale, _needs_grad,
                                   _on_card, flash_attention_lane_bwd_plain,
                                   flash_attention_lane_plain, launch_bwd, launch_fwd)

HEAD_DIMS = (16, 32, 64)  # the kernels' template instances

flash_attention_bh_plain = flash_attention_lane_plain
flash_attention_bh_bwd_plain = flash_attention_lane_bwd_plain


def _check_bh(q, k, v):
    _on_card(q)
    _check("flash_attention_bh", q, k, v)
    if q.shape[3] not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention_bh kernel is built for head_dim in "
                                  f"{HEAD_DIMS}, got {q.shape[3]}")


def _forward(q, k, v, scale):
    """Forward on q's device: the plain version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_bh_plain(q, k, v, scale)
    _check_bh(q, k, v)
    return launch_fwd(flash_attention_bh, q, k, v, scale)


def flash_attention_bh_bwd(q, k, v, do, scale=None):
    """(dq, dk, dv) of the attention at (q, k, v) for the output cotangent ``do``:
    the plain version on CPU tensors, the backward kernels on the card (one count
    per call)."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bh_bwd_plain(q, k, v, do, scale)
    _check_bh(q, k, v)
    return launch_bwd(flash_attention_bh_bwd, q, k, v, do, scale)


def flash_attention_bh(q, k, v, scale=None):
    """Non-causal MHA, (B, T, H, D) in and out, D in (16, 32, 64) on the card;
    differentiable. On CUDA tensors forward and backward run the kernels (or raise)."""
    scale = _default_scale(q, scale)
    if _needs_grad(q, k, v):
        return _LaneAttention.apply(q, k, v, scale, _forward, flash_attention_bh_bwd)
    return _forward(q, k, v, scale)


def flash_attention_bh_reference(q, k, v, scale=None):
    """The plain forward and the plain backward as one differentiable function, on
    any device: what the card's path is held against (chip_smoke.py)."""
    scale = _default_scale(q, scale)
    if _needs_grad(q, k, v):
        return _LaneAttention.apply(q, k, v, scale, flash_attention_bh_plain,
                                    flash_attention_bh_bwd_plain)
    return flash_attention_bh_plain(q, k, v, scale)


flash_attention_bh.launches = 0
flash_attention_bh_bwd.launches = 0
