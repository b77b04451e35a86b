"""The operand precision of the plain reference's products.

The reference computes in float32 with TF32 off. Its control computes the same
function with its products' operands and outputs and the DiT's residual stream
rounded to a lower precision, where the program holds them in the configurations'
bf16: ``fp8`` rounds to float8 e4m3 under a per-tensor scale (the largest magnitude
maps to 448, e4m3's largest finite value), the step below bf16. Gradients pass the
rounding unchanged.
"""

import contextlib

import torch

E4M3_MAX = 448.0


class Operands:
    """``q(t)``: ``t`` as a product operand, rounded to ``precision`` and back to
    float32 (the identity for 'fp32')."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: 'fp32' or 'fp8'")
        self.precision = precision

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        # straight-through: the rounding is a constant offset for autograd
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (rounded - t.detach())


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
