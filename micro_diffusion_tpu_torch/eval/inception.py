"""InceptionV3 pool3 feature extractor in PyTorch (for FID), the port's counterpart of
micro_diffusion_tpu/eval/inception.py.

The reference computes its headline FID-30K with the canonical pt_inception weights
(pt_inception-2015-12-05, the TF-ported network pytorch-fid uses). This module is
that graph up to pool3:

  * the state-dict names are pt_inception's (``Conv2d_1a_3x3.conv.weight``,
    ``Mixed_5b.branch1x1.bn.running_mean``, ...), so ``synthetic_params()`` and a
    real ``.pth`` load into ``InceptionPool3`` with ``strict=True`` over the pool3
    keys (``load_params`` drops the aux-logits and fc heads);
  * the FID variants of the blocks: InceptionA/C and Mixed_7b (FIDInceptionE_1)
    pool with ``avg_pool2d(count_include_pad=False)``, Mixed_7c (FIDInceptionE_2)
    with a MAX pool in its pool branch;
  * every BasicConv2d is conv (no bias) -> BN with eps 1e-3 folded into a scale
    and a bias -> ReLU, as the JAX ``_conv_bn``;
  * the input convention is pytorch-fid's: float images in [0, 1], NCHW, a bilinear
    resize to 299x299 with half-pixel centres and no antialias (JAX's
    ``jax.image.resize(..., "bilinear", antialias=False)``), then scaled to [-1, 1].

Convolutions are cuDNN calls on the card. ``make_feature_fn`` computes in fp32 with
cuDNN's TF32 off around its forward, so FID does not depend on a process-wide flag.
"""

import contextlib
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.dit import resolve_device

BN_EPS = 1e-3
FEATURE_DIM = 2048
INPUT_SIZE = 299


# ------------------------------------------------------------------ modules (NCHW)


class _BatchNorm(nn.Module):
    """pt_inception's BN tensors (weight, bias, running_mean, running_var), applied
    in inference form: no ``num_batches_tracked``, nothing updated."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


class BasicConv2d(nn.Module):
    """conv (no bias) -> BN (eps 1e-3, folded into a scale and a bias) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x):
        x = self.conv(x)
        scale = self.bn.weight * torch.rsqrt(self.bn.running_var + BN_EPS)
        bias = self.bn.bias - self.bn.running_mean * scale
        return F.relu(x * scale[None, :, None, None] + bias[None, :, None, None])


def _avg_pool(x):
    """avg_pool2d(count_include_pad=False): the FID blocks' pool."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool(x)),
        ], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2),
        ], 1)


class InceptionC(nn.Module):
    def __init__(self, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(768, 192, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(768, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool`` 'avg' is FIDInceptionE_1 (Mixed_7b); 'max' is FIDInceptionE_2
    (Mixed_7c), pytorch-fid's TF-parity patch."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)
        self.pool = pool

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "avg":
            bp = _avg_pool(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionPool3(nn.Module):
    """(B, 3, 299, 299) in [-1, 1] -> (B, 2048) pool3 activations, in the dtype of
    its parameters (fp32 for FID)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(128)
        self.Mixed_6c = InceptionC(160)
        self.Mixed_6d = InceptionC(160)
        self.Mixed_6e = InceptionC(192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1x1


def preprocess(x: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """[0, 1] images (B, 3, H, W) -> the network's input: a bilinear resize to 299
    (half-pixel centres, no antialias) unless already 299, then 2x - 1."""
    if resize and tuple(x.shape[2:]) != (INPUT_SIZE, INPUT_SIZE):
        x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                          align_corners=False, antialias=False)
    return 2.0 * x - 1.0


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN's TF32 convolutions on or off inside the block, every other cuDNN flag
    as it was."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic,
                 allow_tf32=allow):
        yield


# ----------------------------------------------------- parameter table / loading


def parameter_shapes() -> Dict[str, tuple]:
    """The full pt_inception pool3 parameter table (name -> shape) in the network's
    order, read off ``InceptionPool3`` on the meta device; ``synthetic_params`` draws
    in this order."""
    with torch.device("meta"):
        net = InceptionPool3()
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def synthetic_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights with the exact pt_inception shapes (for tests and the card's
    smoke run); the same numbers as the JAX package's ``synthetic_params(seed)``.
    Conv weights are fan-in scaled so activations stay O(1) through all 17 stages."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in parameter_shapes().items():
        if name.endswith("running_var") or name.endswith("bn.weight"):
            out[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name.endswith("conv.weight"):
            fan_in = int(np.prod(shape[1:]))
            out[name] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return out


def load_params(weights_path: str) -> Dict[str, np.ndarray]:
    """Load the pt_inception-2015-12-05 torch checkpoint from a local path: the pool3
    subgraph's keys and shapes validated, the aux-logits / fc heads (and any BN
    ``num_batches_tracked``) ignored."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):  # torchvision-style wrapper
        sd = sd.state_dict()
    out, missing = {}, []
    for name, shape in parameter_shapes().items():
        if name not in sd:
            missing.append(name)
            continue
        arr = sd[name].detach().to(torch.float32).numpy()
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape} != expected {shape}")
        out[name] = arr
    if missing:
        raise ValueError(f"weights missing pool3 keys, e.g. {missing[:5]}")
    return out


def build_inception(params: Dict[str, np.ndarray], device=None,
                    dtype: torch.dtype = torch.float32) -> InceptionPool3:
    """``InceptionPool3`` on ``device`` (the card when None) in ``dtype``, loaded
    from a pool3 parameter dict with ``strict=True``."""
    device = resolve_device(device)
    net = InceptionPool3()
    net.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                         for k, v in params.items()}, strict=True)
    return net.to(device=device, dtype=dtype).eval().requires_grad_(False)


def make_feature_fn(params: Dict[str, np.ndarray], resize: bool = True,
                    device=None) -> Callable[[np.ndarray], np.ndarray]:
    """feature_fn(images) -> (B, 2048) numpy for eval.fid.FIDStats, on ``device``.

    ``images``: a float array or tensor (B, 3, H, W) in [0, 1] (pytorch-fid's input
    convention), resized to 299 and scaled to [-1, 1] on the device; fp32 with
    cuDNN's TF32 off.
    """
    net = build_inception(params, device)
    device = next(net.parameters()).device

    @torch.no_grad()
    def fn(images):
        x = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        with cudnn_tf32(False):
            feats = net(preprocess(x, resize))
        return feats.cpu().numpy()

    return fn
