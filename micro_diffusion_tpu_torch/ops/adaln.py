"""Fused LayerNorm + adaLN modulate: modulate(LN(x), shift, scale) in one pass.

Counterpart of ``micro_diffusion_tpu/ops/adaln.py`` ``layernorm_modulate`` (K6),
behind ``model.fused_adaln``: every DiT block's ``norm1`` and ``norm3`` and the
final layer's ``norm_final`` call it with the block's (shift, scale). Forward
contract (the TPU kernel's, adaln.py:22-33), all in fp32 with one rounding:

    mean = mean(x),  var = mean((x - mean)^2)
    y = (x - mean) * rsqrt(var + eps)
    y = y * weight                       (when a weight is given)
    out = x.dtype(y * (1 + scale) + shift)

This is not the unfused ``LayerNorm`` of models/layers.py, which rounds ``y`` to
the input dtype before the modulate and rounds again after it.

On CUDA tensors the forward launches ``csrc/adaln.cu`` (bf16 x, shift and scale;
an fp32 weight or none) or raises; on CPU tensors it runs the plain version. The
backward is the JAX rule ``_bwd`` (adaln.py:84): the autograd of the plain
composition, recomputed from the saved (x, weight, shift, scale). The TPU kernel
has no backward kernel, so neither has the port.
"""

import ctypes

import torch

from . import _build

_SRC = "adaln"
_KERNEL_MAX_D = 1024  # the kernel holds a row in one warp's registers


def layernorm_modulate_plain(x, weight, shift, scale, eps: float = 1e-6):
    """The kernel's contract in plain PyTorch (JAX ``_reference``, adaln.py:57)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    y = y * (1.0 + scale[:, None, :].float()) + shift[:, None, :].float()
    return y.to(x.dtype)


def _rows_ok(t):
    """shift/scale rows the kernel reads in place: unit inner stride, 16-byte
    aligned rows."""
    return t.stride(1) == 1 and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0


def _check(x, weight, shift, scale):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got {tuple(x.shape)}")
    b, _, d = x.shape
    if not (x.dtype == shift.dtype == scale.dtype == torch.bfloat16):
        raise TypeError(f"layernorm_modulate kernel takes bf16 x/shift/scale, got "
                        f"{x.dtype}/{shift.dtype}/{scale.dtype}")
    if tuple(shift.shape) != (b, d) or tuple(scale.shape) != (b, d):
        raise ValueError(f"shift {tuple(shift.shape)} / scale {tuple(scale.shape)} "
                         f"must be ({b}, {d})")
    tensors = [x, shift, scale] + ([] if weight is None else [weight])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, weight, shift, scale must be on one device")
    if weight is not None and (weight.dtype != torch.float32 or tuple(weight.shape) != (d,)):
        raise TypeError(f"weight must be fp32 ({d},), got {weight.dtype} "
                        f"{tuple(weight.shape)}")
    if d % 8 or d > _KERNEL_MAX_D:
        raise NotImplementedError(
            f"layernorm_modulate kernel takes D a multiple of 8 up to {_KERNEL_MAX_D}; "
            f"got D={d}")


def _forward(x, weight, shift, scale, eps):
    """Forward on x's device: the plain version on the CPU, the kernel on the card."""
    if x.device.type == "cpu":
        return layernorm_modulate_plain(x, weight, shift, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, weight, shift, scale)
    x = x.contiguous()
    shift = shift if _rows_ok(shift) else shift.contiguous()
    scale = scale if _rows_ok(scale) else scale.contiguous()
    if weight is not None:
        weight = weight.contiguous()
    b, t, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.function(_SRC, "layernorm_modulate_fwd",
                         [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_longlong, ctypes.c_longlong,
                                                  ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), None if weight is None else weight.data_ptr(),
                 shift.data_ptr(), scale.data_ptr(), out.data_ptr(), b * t, t, d,
                 shift.stride(0), scale.stride(0), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"layernorm_modulate kernel launch failed: CUDA error {err}")
    layernorm_modulate.launches += 1
    return out


class _LayerNormModulate(torch.autograd.Function):
    """Saves (x, weight, shift, scale); the backward is the autograd of the plain
    composition, recomputed from them."""

    @staticmethod
    def forward(ctx, x, weight, shift, scale, eps, fwd):
        ctx.save_for_backward(x, weight, shift, scale)
        ctx.eps = eps
        return fwd(x, weight, shift, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, shift, scale = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip((x, weight, shift, scale), ctx.needs_input_grad)]
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need]
        with torch.enable_grad():
            y = layernorm_modulate_plain(*inputs, ctx.eps)
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if need else None for need in ctx.needs_input_grad[:4]),
                None, None)


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs)


def layernorm_modulate(x, weight, shift, scale, eps: float = 1e-6):
    """Fused modulate(LN(x), shift, scale); differentiable. x: (B, T, D); shift and
    scale: (B, D); weight: (D,) or None (a non-affine LayerNorm). A weight in another
    dtype (a bf16 ``param_flow_dtype`` copy) enters in fp32, as JAX's kernel reads it,
    and its gradient returns in its own dtype."""
    if weight is not None and weight.dtype != torch.float32:
        weight = weight.float()
    if _needs_grad(x, weight, shift, scale):
        return _LayerNormModulate.apply(x, weight, shift, scale, eps, _forward)
    return _forward(x, weight, shift, scale, eps)


def layernorm_modulate_reference(x, weight, shift, scale, eps: float = 1e-6):
    """The plain forward with the same backward, on any device: what the card's
    path is held against (chip_smoke.py)."""
    if _needs_grad(x, weight, shift, scale):
        return _LayerNormModulate.apply(x, weight, shift, scale, eps,
                                        layernorm_modulate_plain)
    return layernorm_modulate_plain(x, weight, shift, scale, eps)


layernorm_modulate.launches = 0
