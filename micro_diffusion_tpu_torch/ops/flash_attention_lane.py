"""Flash attention for head_dim 64 on the natural (B, T, H, D) layout.

Counterpart of ``micro_diffusion_tpu/ops/flash_attention_lane.py``, forward and
backward. :func:`flash_attention_lane` is a ``torch.autograd.Function``. On CUDA
tensors the forward launches the hand-written Hopper kernel in
``csrc/flash_attention_lane.cu`` and the backward the two in
``csrc/flash_attention_lane_bwd.cu``; on CPU tensors both run their plain
PyTorch versions. The kernels are templated on the head dim: the whole-K
attention of ``ops/flash_attention_bh.py`` (K4, D = 16 or 32) computes the same
function and launches them through the same helpers here. Forward contract:

    e = exp2((s - m) * scale * log2(e)),  s = q k^T in fp32,  m = rowmax(s)
    out = (bf16(e) @ v, fp32 accumulation) / rowsum(e)

Backward contract (the TPU kernel's ``_bwd_kernel``), with inv_l = 1 / rowsum(e):

    dv = bf16(e)^T @ bf16(do * inv_l)
    dp = do @ v^T (fp32),  delta = rowsum(e * dp) * inv_l
    ds_u = bf16(e * (dp - delta))
    dq = (ds_u @ k) * scale * inv_l,  dk = ds_u^T @ bf16(q * scale * inv_l)

The JAX rule saves q, k, v and recomputes the row statistics in the backward. The
port's Function also saves the forward's out and its row statistics ``stats`` (m
and inv_l, fp32 (2, B, H, Tq)), so that each backward kernel sweeps the other
sequence once. It then takes delta = rowsum(fp32(do) * fp32(out)), equal to the
contract's up to out's bf16 roundings: the one departure from the contract
(:func:`flash_attention_lane_bwd_saved_plain`; the exact contract stays
:func:`flash_attention_lane_bwd_plain`).
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


def flash_attention_lane_stats_plain(q, k, v, scale=None):
    """The forward kernel's contract in plain PyTorch (any device, any float dtype),
    with the row statistics it saves for the backward: (out, stats), stats fp32
    (2, B, H, Tq) holding the row max m of the unscaled s and 1 / rowsum(e)."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2((s - m) * (scale * _LOG2E))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float()) / l
    return o.permute(0, 2, 1, 3).to(q.dtype), torch.stack([m[..., 0], 1.0 / l[..., 0]])


def flash_attention_lane_plain(q, k, v, scale=None):
    """The forward kernel's contract in plain PyTorch (any device, any float dtype)."""
    return flash_attention_lane_stats_plain(q, k, v, scale)[0]


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


def flash_attention_lane_bwd_saved_plain(q, k, v, out, stats, do, scale=None):
    """The backward kernels' function in plain PyTorch: the contract above from the
    forward's ``out`` and ``stats`` (m, inv_l), with delta = rowsum(fp32(do) *
    fp32(out)); (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m, inv_l = stats[0][..., None], stats[1][..., None]         # (B, H, Tq, 1)
    e = torch.exp2((s - m) * (scale * _LOG2E))
    dof = do.float().permute(0, 2, 1, 3)                        # (B, H, Tq, D)
    dv = torch.einsum("bhqk,bhqd->bkhd", e.to(do.dtype).float(),
                      (dof * inv_l).to(do.dtype).float())
    dp = torch.einsum("bhqd,bkhd->bhqk", dof, v.float())
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1)[..., None]
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


def launch_fwd(counter, q, k, v, scale, lse=None, stats=None):
    """Run ``csrc/flash_attention_lane.cu`` on q's card (head_dim 16, 32 or 64, the
    caller has checked it) and add one to ``counter.launches``; returns out. Given
    ``lse`` (fp32, (B, H, Tq) contiguous), the kernel also writes the row logsumexp
    of the scaled scores there (K5's forward); given ``stats`` (fp32, (2, B, H, Tq)
    contiguous), the row max of the unscaled scores and 1 / rowsum(e) (what the
    backward of :func:`launch_bwd` reads)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = _build.function(_SRC, "flash_attention_fwd",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_float] +
             [ctypes.c_void_p] * 3)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, tq, tk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 float(scale), None if lse is None else lse.data_ptr(),
                 None if stats is None else stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{counter.__name__} kernel launch failed: CUDA error {err}")
    counter.launches += 1
    return o


def launch_fwd_stats(counter, q, k, v, scale):
    """:func:`launch_fwd` writing the row statistics too: (out, stats)."""
    b, tq, h, _ = q.shape
    stats = torch.empty((2, b, h, tq), dtype=torch.float32, device=q.device)
    return launch_fwd(counter, q, k, v, scale, stats=stats), stats


def launch_bwd(counter, q, k, v, out, stats, do, scale, lse=False):
    """Run both kernels of ``csrc/flash_attention_lane_bwd.cu`` on q's card from the
    forward's ``out`` and ``stats`` and add one to ``counter.launches``; returns
    (dq, dk, dv). With ``lse``, ``stats`` is the forward's row logsumexp (fp32,
    (B, H, Tq)) and the kernels compute K5's backward contract
    (``ops/flash_attention.py``) instead."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q")
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match q")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    want = (b, h, tq) if lse else (2, b, h, tq)
    if stats.shape != want or stats.dtype != torch.float32:
        raise ValueError(f"{'lse' if lse else 'stats'} {tuple(stats.shape)} {stats.dtype} is "
                         f"not the forward's {want} float32")
    if do.stride(3) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()  # the cotangent comes in whatever strides autograd made
    _check_rows("out", out)
    stats = stats.contiguous()
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # what the dq kernel hands the dk/dv kernel: per 64-row query tile the scaled
    # copies of q and do (not written in the lse form) and two fp32 values per row,
    # 256 d + 512 bytes a tile
    packed = torch.empty(b * h * -(-tq // 64) * (256 * d + 512), dtype=torch.uint8,
                         device=q.device)
    strides = (ctypes.c_int * 24)(*(s for x in (q, k, v, out, do, dq, dk, dv)
                                    for s in x.stride()[:3]))
    fn = _build.function(_SRC_BWD, "flash_attention_bwd",
                         [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 +
                         [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                 stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 packed.data_ptr(), b, tq, tk, h, d, strides,
                 float(scale), int(lse), stream)
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


@torch.library.custom_op("micro_diffusion_tpu_torch::flash_attention_lane_fwd",
                         mutates_args=())
def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Forward on q's device without the row statistics (no gradient): the plain
    version on the CPU, the kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_lane_plain(q, k, v, scale)
    _check_lane(q, k, v)
    return launch_fwd(flash_attention_lane, q, k, v, scale)


@torch.library.custom_op("micro_diffusion_tpu_torch::flash_attention_lane_fwd_stats",
                         mutates_args=())
def _forward_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, stats) on q's device, for the backward. One operator, so that a
    selective-checkpoint policy keeps both outputs (ops/remat_names.py)."""
    if q.device.type == "cpu":
        return flash_attention_lane_stats_plain(q, k, v, scale)
    _check_lane(q, k, v)
    return launch_fwd_stats(flash_attention_lane, q, k, v, scale)


def flash_attention_lane_bwd(q, k, v, out, stats, do, scale=None):
    """(dq, dk, dv) of the attention at (q, k, v) for the output cotangent ``do``,
    from the forward's ``out`` and ``stats``: the plain version on CPU tensors, the
    backward kernels on the card (one count per call)."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_lane_bwd_saved_plain(q, k, v, out, stats, do, scale)
    _check_lane(q, k, v)
    return launch_bwd(flash_attention_lane_bwd, q, k, v, out, stats, do, scale)


class _LaneAttention(torch.autograd.Function):
    """Saves q, k, v, out and the forward's row statistics; the backward computes
    e from them (the row max and 1 / rowsum(e) are not recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fwd, bwd):
        out, stats = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.scale, ctx.bwd = scale, bwd
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, stats, do, ctx.scale)
        return dq, dk, dv, None, None, None


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_lane(q, k, v, scale=None):
    """Non-causal MHA, (B, T, H, 64) in and out, H even; differentiable. On CUDA
    tensors forward and backward run the kernels (or raise)."""
    scale = _default_scale(q, scale)
    if _needs_grad(q, k, v):
        return _LaneAttention.apply(q, k, v, scale, _forward_stats, flash_attention_lane_bwd)
    return _forward(q, k, v, scale)


def flash_attention_lane_reference(q, k, v, scale=None):
    """The plain forward and the plain backward of the kernels' function as one
    differentiable function, on any device: what the card's path is held against
    (chip_smoke.py)."""
    scale = _default_scale(q, scale)
    if _needs_grad(q, k, v):
        return _LaneAttention.apply(q, k, v, scale, flash_attention_lane_stats_plain,
                                    flash_attention_lane_bwd_saved_plain)
    return flash_attention_lane_plain(q, k, v, scale)


flash_attention_lane.launches = 0
flash_attention_lane_bwd.launches = 0
