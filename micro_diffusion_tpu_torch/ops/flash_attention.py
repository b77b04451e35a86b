"""Tiled flash attention with the saved row logsumexp ('flash_bthd', K5), head_dim
16, 32 or 64, any head count, on the natural (B, T, H, D) layout.

Counterpart of ``micro_diffusion_tpu/ops/flash_attention.py`` (forward
``_fwd_kernel`` :76, backward ``_dq_kernel`` :140 and ``_dkv_kernel`` :172 under
the ``custom_vjp`` :215/:315). :func:`flash_attention` is a
``torch.autograd.Function`` that saves (q, k, v, out, lse), as the JAX rule does.
On CUDA tensors the forward launches the attention forward kernel of
``csrc/flash_attention_lane.cu`` with its logsumexp output, and the backward the
dq and dk/dv kernels of ``csrc/flash_attention_lane_bwd.cu`` (K1b/K4b's) in their
lse form; on CPU tensors both run their plain versions. The JAX kernels write
(B, H, T, D) and transpose back, a TPU store-layout workaround; the port reads and
writes (B, T, H, D) through strides. Forward contract (``_fwd_kernel``), per (batch, head):

    s = (q k^T in fp32) * scale,  m = rowmax(s),  e = exp(s - m),  l = rowsum(e)
    p = bf16(e / l)                 (normalised before the cast, unlike K1)
    out = bf16(p @ v),  fp32 accumulation;   lse = m + log(l)  (fp32, (B, H, Tq))

Backward contract (``_bwd_rule``), from the saved bf16 out and fp32 lse:

    delta = rowsum(fp32(do) * fp32(out))
    p = exp(s - lse),  dp = fp32(do) @ fp32(v)^T,  ds = bf16(p * (dp - delta) * scale)
    dq = ds @ k,  dk = ds^T @ q,  dv = bf16(p)^T @ do   (fp32 sums, input dtypes)

Sequence lengths follow the JAX kernels' tiling rule (``_chunk`` :49): a length
over 256 needs a divisor <= 256 that is a multiple of 128, else ValueError, on
every device, so both packages accept the same configurations.
"""

import torch

from .flash_attention_lane import (_check, _default_scale, _needs_grad, _on_card, launch_bwd,
                                   launch_fwd)

HEAD_DIMS = (16, 32, 64)  # the kernels' template instances


def chunk(t: int, target: int = 256) -> int:
    """The JAX kernels' sequence tile: t itself up to ``target``, else its largest
    divisor <= target, which must be a multiple of 128."""
    if t <= target:
        return t
    c = target
    while t % c:
        c -= 1
    if c % 128:
        raise ValueError(
            f"flash_attention: sequence length {t} has no chunk <= {target} that is a "
            f"multiple of 128 (best divisor: {c}); the tiled kernels do not take this "
            "shape - use another attention_impl ('xla')")
    return c


def flash_attention_plain(q, k, v, scale=None):
    """The forward kernel's contract in plain PyTorch (any device, any float dtype):
    (out (B, Tq, H, D) in q's dtype, lse (B, H, Tq) fp32)."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = (e / l).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, out, lse, do, scale=None):
    """The backward kernels' contract in plain PyTorch, op for op as the TPU's
    ``_bwd_rule``: (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = _default_scale(q, scale)
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, H, Tq, 1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_lengths(q, k):
    chunk(q.shape[1])
    chunk(k.shape[1])


def _check_card(q, k, v):
    _on_card(q)
    _check("flash_attention", q, k, v)
    if q.shape[3] not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernels are built for head_dim in "
                                  f"{HEAD_DIMS}, got {q.shape[3]}")


@torch.library.custom_op("micro_diffusion_tpu_torch::flash_attention_fwd", mutates_args=())
def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) on q's device: the plain version on the CPU, the kernel on the card.
    One operator, so that a selective-checkpoint policy can keep its outputs."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check_card(q, k, v)
    b, tq, h, _ = q.shape
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    return launch_fwd(flash_attention, q, k, v, scale, lse), lse


def flash_attention_bwd(q, k, v, out, lse, do, scale=None):
    """(dq, dk, dv) of the attention at (q, k, v) with the forward's ``out`` and
    ``lse``, for the output cotangent ``do``: the plain version on CPU tensors, the
    kernels on the card (one count per call)."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, scale)
    _check_card(q, k, v)
    return launch_bwd(flash_attention_bwd, q, k, v, out, lse, do, scale, lse=True)


class _LseAttention(torch.autograd.Function):
    """Saves (q, k, v, out, lse); the backward recomputes p from the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fwd, bwd):
        out, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.bwd = scale, bwd
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, scale=None):
    """Non-causal MHA, (B, T, H, D) in and out, D in (16, 32, 64) on the card;
    differentiable. On CUDA tensors forward and backward run the kernels (or raise)."""
    scale = _default_scale(q, scale)
    _check_lengths(q, k)
    if _needs_grad(q, k, v):
        return _LseAttention.apply(q, k, v, scale, _forward, flash_attention_bwd)
    return _forward(q, k, v, scale)[0]


def flash_attention_reference(q, k, v, scale=None):
    """The plain forward and the plain backward as one differentiable function, on
    any device: what the card's path is held against (chip_smoke.py)."""
    scale = _default_scale(q, scale)
    _check_lengths(q, k)
    if _needs_grad(q, k, v):
        return _LseAttention.apply(q, k, v, scale, flash_attention_plain,
                                   flash_attention_bwd_plain)
    return flash_attention_plain(q, k, v, scale)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
