"""Fused EC-MoE expert feed-forward: gelu(x @ w1[e]) @ w2[e] per expert.

Counterpart of ``micro_diffusion_tpu/ops/moe_ffn.py`` ``moe_ffn`` (sample-major
(n, e, k, d) rows, K2/K2b) and ``moe_ffn_expert_major`` (expert-major (e, m, d)
rows, the ``gather`` dispatch's K3), forward and backward. Dispatch follows the JAX rules: a
shape that :func:`supported` rejects goes to :func:`_moe_ffn_ref`, the
counterpart of the JAX XLA path, with plain autograd. A supported shape goes
through a ``torch.autograd.Function`` that saves xg, w1, w2 (as the JAX rule
does): on CUDA tensors the forward launches ``csrc/moe_ffn.cu`` and the backward
``csrc/moe_ffn_bwd.cu``; on CPU tensors both run their plain PyTorch versions.
Forward contract, including both bf16 roundings:

    a = bf16(x @ w1[e])          fp32 accumulation, then rounded
    h = bf16(gelu_exact(a))      GELU in fp32
    out = h @ w2[e]              fp32 accumulation, stored in xg's dtype

Backward contract (the TPU kernels ``_dxdw_kernel`` / ``_dx_kernel`` +
``_dw_kernel``, which compute one function):

    dh = do @ w2[e]^T (fp32),  da = bf16(gelu'(a) * dh)
    dx = bf16(da @ w1[e]^T),  dw1 = x^T @ da,  dw2 = h^T @ do
    (dw1, dw2 summed in fp32 over all of the expert's rows, stored in w's dtype)

K3 (:func:`moe_ffn_expert_major`) is the same function on (e, m, d) rows: the
TPU runs it through the same kernel bodies with expert-major blocks, and so does
the port. Expert-major rows are sample-major rows with n = 1 and k = m, so its
kernels are the K2/K2b sources driven through their own entry points
(``moe_ffn_em_fwd``, ``moe_ffn_em_bwd``) with that layout; its wrappers keep their
own launch counters.

On the card both directions are wgmma GEMMs fed by TMA rings (``csrc/moe_gemm.cuh``):
the forward is two launches with the (e, rows, f) bf16 hidden between them, the
backward four (a; dh with da and h in its epilogue; dx; dw1 and dw2), with a, da and
h in an (e, rows, f) scratch. The wrappers allocate those buffers; each call counts
once.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .remat_names import checkpoint_name

_SRC = "moe_ffn"
_SRC_BWD = "moe_ffn_bwd"
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def supported(n: int, e: int, k: int, d: int, f: int) -> bool:
    """The JAX rule: shapes the kernel tiles cleanly (every MicroDiT shape passes)."""
    return k % 16 == 0 and d % 128 == 0 and f % 256 == 0


def _hidden_pre(xg, w1):
    """a = bf16(x @ w1[e]) as fp32 (n, e, k, f)."""
    a = torch.einsum("nekd,edf->nekf", xg.float(), w1.float())
    return a.to(torch.bfloat16).float()


def moe_ffn_plain(xg, w1, w2):
    """The forward kernel's contract in plain PyTorch on (n, e, k, d) rows."""
    h = F.gelu(_hidden_pre(xg, w1)).to(torch.bfloat16)
    return torch.einsum("nekf,efd->nekd", h.float(), w2.float()).to(xg.dtype)


def gelu_grad(a):
    """d/da of exact GELU: Phi(a) + a * phi(a)."""
    return 0.5 * (1.0 + torch.erf(a * _SQRT_HALF)) + a * torch.exp(-0.5 * a * a) * _INV_SQRT_2PI


def moe_ffn_bwd_plain(xg, w1, w2, dout):
    """The backward kernels' contract in plain PyTorch: (dx, dw1, dw2)."""
    a = _hidden_pre(xg, w1)
    dh = torch.einsum("nekd,efd->nekf", dout.float(), w2.float())
    da = (gelu_grad(a) * dh).to(torch.bfloat16).float()
    h = F.gelu(a).to(torch.bfloat16).float()
    dx = torch.einsum("nekf,edf->nekd", da, w1.float()).to(xg.dtype)
    dw1 = torch.einsum("nekd,nekf->edf", xg.float(), da).to(w1.dtype)
    dw2 = torch.einsum("nekf,nekd->efd", h, dout.float()).to(w2.dtype)
    return dx, dw1, dw2


def _moe_ffn_ref(xg, w1, w2):
    """Counterpart of the JAX XLA path for shapes the kernel does not take: the
    products come out in the input dtype, GELU runs in fp32."""
    a = torch.einsum("nekd,edf->nekf", xg, w1)
    h = F.gelu(a.float()).to(a.dtype)
    return torch.einsum("nekf,efd->nekd", h, w2)


def _check(xg, w1, w2):
    if not (xg.dtype == w1.dtype == w2.dtype == torch.bfloat16):
        raise TypeError(f"moe_ffn kernel takes bf16, got {xg.dtype}/{w1.dtype}/{w2.dtype}")
    n, e, k, d = xg.shape
    f = w1.shape[-1]
    if tuple(w1.shape) != (e, d, f) or tuple(w2.shape) != (e, f, d):
        raise ValueError(f"shape mismatch xg {tuple(xg.shape)} w1 {tuple(w1.shape)} "
                         f"w2 {tuple(w2.shape)}")
    if not (xg.device == w1.device == w2.device):
        raise ValueError("xg, w1, w2 must be on one device")
    for name, x in (("xg", xg), ("w1", w1), ("w2", w2)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _on_card(x):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _forward(xg, w1, w2):
    """Forward on xg's device: the plain version on the CPU, the kernel on the card."""
    if xg.device.type == "cpu":
        return moe_ffn_plain(xg, w1, w2)
    _on_card(xg)
    _check(xg, w1, w2)
    n, e, k, d = xg.shape
    f = w1.shape[-1]
    out = torch.empty_like(xg)
    if out.numel() == 0 or f == 0:
        return out.zero_()
    hidden = torch.empty((e, n * k, f), dtype=torch.bfloat16, device=xg.device)
    fn = _build.function(_SRC, "moe_ffn_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), hidden.data_ptr(),
                 n, e, k, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn kernel launch failed: CUDA error {err}")
    moe_ffn.launches += 1
    return out


def moe_ffn_bwd(xg, w1, w2, dout):
    """(dx, dw1, dw2) for the output cotangent ``dout``: the plain version on CPU
    tensors, the backward kernels on the card (one count per call)."""
    if xg.device.type == "cpu":
        return moe_ffn_bwd_plain(xg, w1, w2, dout)
    _on_card(xg)
    _check(xg, w1, w2)
    if dout.shape != xg.shape or dout.dtype != xg.dtype or dout.device != xg.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match xg")
    dout = dout.contiguous()  # autograd may hand the cotangent in other strides
    n, e, k, d = xg.shape
    f = w1.shape[-1]
    dx = torch.empty_like(xg)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    if dx.numel() == 0 or f == 0:
        return dx.zero_(), dw1.zero_(), dw2.zero_()
    # da and h (a before it), (e, n*k, f) bf16 each: written by the first GEMMs, read by
    # the others
    scratch = torch.empty((2, e, n * k, f), dtype=torch.bfloat16, device=xg.device)
    fn = _build.function(_SRC_BWD, "moe_ffn_bwd",
             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w1.data_ptr(), w2.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                 dw1.data_ptr(), dw2.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                 n, e, k, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn backward kernel launch failed: CUDA error {err}")
    moe_ffn_bwd.launches += 1
    return dx, dw1, dw2


class _ExpertFFN(torch.autograd.Function):
    """Saves xg, w1, w2; the backward recomputes a = x @ w1 and gelu'(a)."""

    @staticmethod
    def forward(ctx, xg, w1, w2, fwd, bwd):
        ctx.save_for_backward(xg, w1, w2)
        ctx.bwd = bwd
        return fwd(xg, w1, w2)

    @staticmethod
    def backward(ctx, dout):
        xg, w1, w2 = ctx.saved_tensors
        return (*ctx.bwd(xg, w1, w2, dout), None, None)


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def moe_ffn(xg, w1, w2):
    """Per-expert gelu(x @ w1) @ w2 on (n, e, k, d) dispatched tokens; differentiable.

    w1: (e, d, f), w2: (e, f, d), in the compute dtype (cast by the caller).
    Returns (n, e, k, d) in xg.dtype.
    """
    n, e, k, d = xg.shape
    f = w1.shape[-1]
    if not supported(n, e, k, d, f):
        return _moe_ffn_ref(xg, w1, w2)
    if _needs_grad(xg, w1, w2):
        return _ExpertFFN.apply(xg, w1, w2, _forward, moe_ffn_bwd)
    return _forward(xg, w1, w2)


def moe_ffn_reference(xg, w1, w2):
    """The plain forward and the plain backward as one differentiable function, on
    any device: what the card's path is held against (chip_smoke.py)."""
    n, e, k, d = xg.shape
    if not supported(n, e, k, d, w1.shape[-1]):
        return _moe_ffn_ref(xg, w1, w2)
    if _needs_grad(xg, w1, w2):
        return _ExpertFFN.apply(xg, w1, w2, moe_ffn_plain, moe_ffn_bwd_plain)
    return moe_ffn_plain(xg, w1, w2)


moe_ffn.launches = 0
moe_ffn_bwd.launches = 0


# ------------------------------------------------- expert-major (gather) layout


def supported_expert_major(m: int, d: int, f: int) -> bool:
    """The JAX rule of ``moe_ffn_expert_major`` (moe_ffn.py:574)."""
    return m % 16 == 0 and d % 128 == 0 and f % 256 == 0


def _moe_ffn_em_ref(xg, w1, w2, ckpt_name=None):
    """Counterpart of the JAX ``_moe_ffn_em_ref`` for shapes K3 does not take: the
    products come out in the input dtype, GELU runs in fp32. With ``ckpt_name``
    each product runs under that name (ops/remat_names.py)."""
    with checkpoint_name(ckpt_name):
        a = torch.bmm(xg, w1)
    h = F.gelu(a.float()).to(a.dtype)
    with checkpoint_name(ckpt_name):
        return torch.bmm(h, w2)


def moe_ffn_expert_major_plain(xg, w1, w2):
    """K3's forward contract in plain PyTorch on (e, m, d) rows."""
    return moe_ffn_plain(xg[None], w1, w2)[0]


def moe_ffn_expert_major_bwd_plain(xg, w1, w2, dout):
    """K3's backward contract in plain PyTorch: (dx, dw1, dw2)."""
    dx, dw1, dw2 = moe_ffn_bwd_plain(xg[None], w1, w2, dout[None])
    return dx[0], dw1, dw2


def _check_em(xg, w1, w2):
    if xg.dim() != 3:
        raise ValueError(f"expert-major rows are (e, m, d), got {tuple(xg.shape)}")
    _check(xg[None], w1, w2)


def _forward_em(xg, w1, w2):
    """K3's forward on xg's device: the plain version on the CPU, the kernel on the card."""
    if xg.device.type == "cpu":
        return moe_ffn_expert_major_plain(xg, w1, w2)
    _on_card(xg)
    _check_em(xg, w1, w2)
    e, m, d = xg.shape
    f = w1.shape[-1]
    out = torch.empty_like(xg)
    if out.numel() == 0 or f == 0:
        return out.zero_()
    hidden = torch.empty((e, m, f), dtype=torch.bfloat16, device=xg.device)
    fn = _build.function(_SRC, "moe_ffn_em_fwd",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), hidden.data_ptr(),
                 e, m, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn_expert_major kernel launch failed: CUDA error {err}")
    moe_ffn_expert_major.launches += 1
    return out


def moe_ffn_expert_major_bwd(xg, w1, w2, dout):
    """K3's (dx, dw1, dw2) for the output cotangent ``dout``: the plain version on
    CPU tensors, the backward kernels on the card (one count per call)."""
    if xg.device.type == "cpu":
        return moe_ffn_expert_major_bwd_plain(xg, w1, w2, dout)
    _on_card(xg)
    _check_em(xg, w1, w2)
    if dout.shape != xg.shape or dout.dtype != xg.dtype or dout.device != xg.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not match xg")
    dout = dout.contiguous()
    e, m, d = xg.shape
    f = w1.shape[-1]
    dx = torch.empty_like(xg)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    if dx.numel() == 0 or f == 0:
        return dx.zero_(), dw1.zero_(), dw2.zero_()
    # da and h (a before it), (e, m, f) bf16 each: written by the first GEMMs, read by
    # the others
    scratch = torch.empty((2, e, m, f), dtype=torch.bfloat16, device=xg.device)
    fn = _build.function(_SRC_BWD, "moe_ffn_em_bwd",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w1.data_ptr(), w2.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                 dw1.data_ptr(), dw2.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                 e, m, d, f, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn_expert_major backward kernel launch failed: "
                           f"CUDA error {err}")
    moe_ffn_expert_major_bwd.launches += 1
    return dx, dw1, dw2


def moe_ffn_expert_major(xg, w1, w2):
    """Per-expert gelu(x @ w1) @ w2 on (e, m, d) gathered token rows (K3, the
    ``gather`` dispatch's layout); differentiable. Off the JAX rule's grid it is
    :func:`_moe_ffn_em_ref` with plain autograd, as in JAX."""
    e, m, d = xg.shape
    if not supported_expert_major(m, d, w1.shape[-1]):
        return _moe_ffn_em_ref(xg, w1, w2)
    if _needs_grad(xg, w1, w2):
        return _ExpertFFN.apply(xg, w1, w2, _forward_em, moe_ffn_expert_major_bwd)
    return _forward_em(xg, w1, w2)


def moe_ffn_expert_major_reference(xg, w1, w2):
    """K3's plain forward and plain backward as one differentiable function, on any
    device (chip_smoke.py's plain path)."""
    e, m, d = xg.shape
    if not supported_expert_major(m, d, w1.shape[-1]):
        return _moe_ffn_em_ref(xg, w1, w2)
    if _needs_grad(xg, w1, w2):
        return _ExpertFFN.apply(xg, w1, w2, moe_ffn_expert_major_plain,
                                moe_ffn_expert_major_bwd_plain)
    return moe_ffn_expert_major_plain(xg, w1, w2)


moe_ffn_expert_major.launches = 0
moe_ffn_expert_major_bwd.launches = 0
