"""flax-faithful convolution, BatchNorm, pooling and Dense layers shared
by the vision models (``models/lenet.py``, ``models/resnet.py``).

Activations are NCHW tensors (a permute of the NHWC input, so in
``torch.channels_last`` memory); parameters are f32 and cast to the
compute dtype at use, as flax casts them. Where PyTorch's own layers
compute something else, these follow flax:

  - ``SAME`` padding is XLA's rule: the output has ceil(size / stride)
    positions and the padding total max((out - 1) * stride + k - size, 0)
    is split with the smaller half BEFORE. At stride 2 it is asymmetric:
    a 3x3 conv on 32x32 pads (0, 1), a 7x7 stride-2 conv on 64x64 pads
    (2, 3). ``nn.Conv2d(padding=1)`` pads (1, 1) and gives other numbers,
    so the layers pad explicitly and convolve unpadded. A ``SAME``
    max-pool pads with -inf.
  - BatchNorm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
    batch statistics in f32 over every row (no sample mask), the variance
    biased and taken as E[x^2] - E[x]^2 clipped at 0 (flax's
    ``use_fast_variance``), the running update ``ra = 0.9 ra + 0.1 batch``
    (``nn.BatchNorm2d`` updates the running variance with the unbiased
    estimate), the output ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in f32 cast to the compute dtype; eval mode normalises with the
    running statistics. Its running statistics are registered buffers
    named ``running_mean``/``running_var``: the flax ``batch_stats``
    leaves ``mean``/``var`` (``convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial axis under XLA's ``SAME``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: Tuple[int, int], stride: Tuple[int, int],
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor's H and W to XLA's ``SAME`` rule."""
    top, bottom = same_pads(x.shape[2], k[0], stride[0])
    left, right = same_pads(x.shape[3], k[1], stride[1])
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` over NCHW activations: weight [out, in, kh, kw]
    (the flax kernel [kh, kw, in, out] transposed), ``SAME`` or ``VALID``
    padding applied explicitly, operands cast to ``dtype``, the bias added
    after the product as flax adds it."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0,
                         bias=bias, device=device)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.same = padding == "SAME"
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        stride = self.stride
        if self.kernel_size == (1, 1) and stride != (1, 1):
            # a strided 1x1 conv (which SAME never pads) is the 1x1 conv
            # of the subsampled input, the same sums; oneDNN's CPU
            # backward of the strided channels_last form crashes
            x, stride = x[:, :, ::stride[0], ::stride[1]], 1
        elif self.same:
            x = pad_same(x, self.kernel_size, stride)
        y = F.conv2d(x, self.weight.to(self.dtype), None, stride)
        # flax adds the bias to the rounded product, in the compute dtype
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of NCHW activations
    (see the module docstring): ``weight``/``bias`` are flax's
    ``scale``/``bias``, the buffers its ``batch_stats``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale     # flax scale_init=zeros
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf.square().mean(dim=(0, 2, 3))
                   - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense``: weight [out, in] (the kernel [in, out]
    transposed), operands cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__(in_features, out_features, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax adds the bias to the rounded product, in the compute dtype
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) \
            + self.bias.to(self.dtype)


def max_pool(x: torch.Tensor, k: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool`` over NCHW; ``SAME`` pads with -inf."""
    if padding == "SAME":
        x = pad_same(x, (k, k), (stride, stride), value=float("-inf"))
    return F.max_pool2d(x, k, stride)
