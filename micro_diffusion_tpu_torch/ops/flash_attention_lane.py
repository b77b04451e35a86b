"""Flash attention for head_dim 64 on the natural (B, T, H, D) layout.

Counterpart of ``micro_diffusion_tpu/ops/flash_attention_lane.py``, forward and
backward. :func:`flash_attention_lane` is a ``torch.autograd.Function`` that
saves q, k, v (as the JAX rule does) and recomputes the softmax in the backward.
On CUDA tensors the forward launches the hand-written Hopper kernel in
``csrc/flash_attention_lane.cu`` and the backward the one in
``csrc/flash_attention_lane_bwd.cu``; on CPU tensors both run their plain
PyTorch versions. The kernels are templated on the head dim: the whole-K
attention of ``ops/flash_attention_bh.py`` (K4, D = 16 or 32) computes the same
function and launches them through the same helpers here. Forward contract:

    e = exp2((s - rowmax(s)) * scale * log2(e)),  s = q k^T in fp32
    out = (bf16(e) @ v, fp32 accumulation) / rowsum(e)

Backward contract (the TPU kernel's ``_bwd_kernel``), with inv_l = 1 / rowsum(e):

    dv = bf16(e)^T @ bf16(do * inv_l)
    dp = do @ v^T (fp32),  delta = rowsum(e * dp) * inv_l
    ds_u = bf16(e * (dp - delta))
    dq = (ds_u @ k) * scale * inv_l,  dk = ds_u^T @ bf16(q * scale * inv_l)
"""

import ctypes
import math

import torch

from . import _build

_LOG2E = math.log2(math.e)
_SRC = "flash_attention_lane"
_SRC_BWD = "flash_attention_lane_bwd"


def supported(h: int, d: int) -> bool:
    """The JAX dispatch rule: head_dim 64 and an even head count."""
    return d == 64 and h % 2 == 0


def _default_scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_attention_lane_plain(q, k, v, scale=None):
    """The forward kernel's contract in plain PyTorch (any device, any float dtype)."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2((s - m) * (scale * _LOG2E))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float()) / l
    return o.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_lane_bwd_plain(q, k, v, do, scale=None):
    """The backward kernel's contract in plain PyTorch, op for op as the TPU
    kernel's ``_bwd_kernel``: (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2((s - m) * (scale * _LOG2E))
    inv_l = 1.0 / e.sum(dim=-1, keepdim=True)                   # (B, H, Tq, 1)
    dof = do.float().permute(0, 2, 1, 3)                        # (B, H, Tq, D)
    dv = torch.einsum("bhqk,bhqd->bkhd", e.to(do.dtype).float(),
                      (dof * inv_l).to(do.dtype).float())
    dp = torch.einsum("bhqd,bkhd->bhqk", dof, v.float())
    delta = (e * dp).sum(dim=-1, keepdim=True) * inv_l
    ds_u = (e * (dp - delta)).to(q.dtype).float()
    cb = scale * inv_l
    dq = torch.einsum("bhqk,bkhd->bhqd", ds_u, k.float()) * cb
    qm = (q.float().permute(0, 2, 1, 3) * cb).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bkhd", ds_u, qm)
    return dq.permute(0, 2, 1, 3).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_rows(name, x):
    # rows are copied 16 bytes at a time: the head dim must be contiguous and
    # every row start 16-byte aligned
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{name} must have a contiguous head dim and 16-byte "
                         f"aligned rows, got strides {x.stride()}")
    if max(x.stride()[:3]) >= 2**31:
        raise ValueError(f"{name} strides overflow int32")


def _check(name, q, k, v):
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, H, D)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(arg, x)


def _on_card(q):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")


def launch_fwd(counter, q, k, v, scale):
    """Run ``csrc/flash_attention_lane.cu`` on q's card (head_dim 16, 32 or 64, the
    caller has checked it) and add one to ``counter.launches``; returns out."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = _build.function(_SRC, "flash_attention_fwd",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, tq, tk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{counter.__name__} kernel launch failed: CUDA error {err}")
    counter.launches += 1
    return o


def launch_bwd(counter, q, k, v, do, scale):
    """Run both passes of ``csrc/flash_attention_lane_bwd.cu`` on q's card and add
    one to ``counter.launches``; returns (dq, dk, dv)."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q")
    if do.stride(3) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()  # the cotangent comes in whatever strides autograd made
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # per (batch, head, query row): the row max, 1/rowsum(e) and delta
    stats = torch.empty((3, b, h, tq), dtype=torch.float32, device=q.device)
    fn = _build.function(_SRC_BWD, "flash_attention_bwd",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 26 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, tq, tk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                 *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{counter.__name__} backward kernel launch failed: "
                           f"CUDA error {err}")
    counter.launches += 1
    return dq, dk, dv


def _check_lane(q, k, v):
    _on_card(q)
    _check("flash_attention_lane", q, k, v)
    if not supported(q.shape[2], q.shape[3]):
        raise ValueError(f"kernel needs head_dim 64 and even H, got H={q.shape[2]} "
                         f"D={q.shape[3]}")


def _forward(q, k, v, scale):
    """Forward on q's device: the plain version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_lane_plain(q, k, v, scale)
    _check_lane(q, k, v)
    return launch_fwd(flash_attention_lane, q, k, v, scale)


def flash_attention_lane_bwd(q, k, v, do, scale=None):
    """(dq, dk, dv) of the attention at (q, k, v) for the output cotangent ``do``:
    the plain version on CPU tensors, the backward kernel on the card."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_lane_bwd_plain(q, k, v, do, scale)
    _check_lane(q, k, v)
    return launch_bwd(flash_attention_lane_bwd, q, k, v, do, scale)


class _LaneAttention(torch.autograd.Function):
    """Saves q, k, v; the backward recomputes the softmax (no saved logsumexp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fwd, bwd):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.bwd = scale, bwd
        return fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, do, ctx.scale)
        return dq, dk, dv, None, None, None


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_lane(q, k, v, scale=None):
    """Non-causal MHA, (B, T, H, 64) in and out, H even; differentiable. On CUDA
    tensors forward and backward run the kernels (or raise)."""
    scale = _default_scale(q, scale)
    if _needs_grad(q, k, v):
        return _LaneAttention.apply(q, k, v, scale, _forward, flash_attention_lane_bwd)
    return _forward(q, k, v, scale)


def flash_attention_lane_reference(q, k, v, scale=None):
    """The plain forward and the plain backward as one differentiable function, on
    any device: what the card's path is held against (chip_smoke.py)."""
    scale = _default_scale(q, scale)
    if _needs_grad(q, k, v):
        return _LaneAttention.apply(q, k, v, scale, flash_attention_lane_plain,
                                    flash_attention_lane_bwd_plain)
    return flash_attention_lane_plain(q, k, v, scale)


flash_attention_lane.launches = 0
flash_attention_lane_bwd.launches = 0
