"""ResNet family, CIFAR and ImageNet stems (twin of
kubeml_tpu/models/resnet.py): ``resnet18``, ``resnet34``, ``resnet32``
(width 16) and ``resnet50`` (bottleneck blocks, the 7x7 stride-2 stem
and a max-pool).

Inputs arrive NHWC as in the JAX package; the forward permutes them to
NCHW, which leaves the memory in ``torch.channels_last`` order (a view,
no copy), and the module keeps its conv weights in that order too.
Compute is bf16 with f32 parameters, f32 batch statistics and f32 logits;
the layers follow flax's numerics (``models/layers.py``: XLA ``SAME``
padding, flax BatchNorm). Submodules carry the flax module names
(``stem``, ``stem_norm``, ``BasicBlock_<i>`` with ``Conv_<j>``,
``BatchNorm_<j>``, ``proj``, ``proj_norm``, and ``Dense_0``), so a state
dict name is its flax path (``convert.py``).

The recipe is the JAX package's: SGD with momentum 0.9 and weight decay
5e-4 (``optax.chain(add_decayed_weights(5e-4), sgd(lr, momentum=0.9))``
computes what ``torch.optim.SGD(momentum=0.9, weight_decay=5e-4)``
does), the learning rate stepped by 0.1 at epochs 15 and 25.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import vision_params_from_flax, \
    vision_params_to_flax
from kubeml_tpu_torch.models.base import ClassifierModel, register_model
from kubeml_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                            max_pool)


class BasicBlock(nn.Module):
    """Two 3x3 convs; the second norm's scale starts at zero; a 1x1
    ``proj`` + ``proj_norm`` shortcut when the shape changes."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, dtype,
                 device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.Conv_0 = Conv(in_ch, filters, 3, stride, **kw)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device=device)
        self.Conv_1 = Conv(filters, filters, 3, 1, **kw)
        self.BatchNorm_1 = BatchNorm(filters, dtype, zero_scale=True,
                                     device=device)
        if stride != 1 or in_ch != filters:
            self.proj = Conv(in_ch, filters, 1, stride, **kw)
            self.proj_norm = BatchNorm(filters, dtype, device=device)

    def forward(self, x, train: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "proj"):
            x = self.proj_norm(self.proj(x), train)
        return torch.relu(y + x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at 4x width; the last norm's scale
    starts at zero; a ``proj`` shortcut when the shape changes."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, dtype,
                 device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, 1, **kw)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device=device)
        self.Conv_2 = Conv(filters, out, 1, 1, **kw)
        self.BatchNorm_2 = BatchNorm(out, dtype, zero_scale=True,
                                     device=device)
        if stride != 1 or in_ch != out:
            self.proj = Conv(in_ch, out, 1, stride, **kw)
            self.proj_norm = BatchNorm(out, dtype, device=device)

    def forward(self, x, train: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if hasattr(self, "proj"):
            x = self.proj_norm(self.proj(x), train)
        return torch.relu(y + x)


BLOCKS = {"BasicBlock": BasicBlock, "BottleneckBlock": BottleneckBlock}


class ResNetModule(nn.Module):
    """Stage-configurable ResNet over NHWC inputs [B, H, W, C]."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "BasicBlock",
                 num_classes: int = 10, width: int = 64,
                 cifar_stem: bool = True, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.cifar_stem = cifar_stem
        self.stem = Conv(in_channels, width, 3 if cifar_stem else 7,
                         1 if cifar_stem else 2, bias=False, dtype=dtype,
                         device=dev)
        self.stem_norm = BatchNorm(width, dtype, device=dev)
        cls = BLOCKS[block]
        ch, i = width, 0
        self.blocks = []
        for stage, n_blocks in enumerate(stage_sizes):
            filters = width * 2 ** stage
            for j in range(n_blocks):
                stride = 2 if stage > 0 and j == 0 else 1
                blk = cls(ch, filters, stride, dtype, device=dev)
                self.add_module(f"{block}_{i}", blk)
                self.blocks.append(blk)
                ch, i = filters * cls.expansion, i + 1
        self.Dense_0 = Dense(ch, num_classes, dtype=dtype, device=dev)
        self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.stem.weight.device

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)     # NHWC -> NCHW view
        x = torch.relu(self.stem_norm(self.stem(x), train))
        if not self.cifar_stem:
            x = max_pool(x, 3, 2, "SAME")
        for blk in self.blocks:
            x = blk(x, train)
        # jnp.mean of bf16 sums in f32 and rounds the mean once
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.Dense_0(x).float()


class _ResNetBase(ClassifierModel):
    """The JAX package's ResNet recipe: SGD + momentum 0.9 + weight decay
    5e-4, lr x 0.1 at epochs 15 and 25 (the factor in f32, as there)."""

    stage_sizes: Sequence[int] = ()
    block = "BasicBlock"
    width = 64
    cifar_stem = True
    num_classes = 10
    lr_decay_epochs = (15, 25)
    lr_decay_factor = 0.1
    weight_decay = 5e-4
    collections = ("batch_stats", "params")

    in_channels = 3        # CIFAR's; init_module reads it from the data

    def build(self, dtype: torch.dtype = torch.bfloat16,
              device: DeviceLike = None) -> ResNetModule:
        return ResNetModule(self.stage_sizes, self.block, self.num_classes,
                            self.width, self.cifar_stem, self.in_channels,
                            dtype=dtype, device=device)

    def init_module(self, sample_batch, generator, device=None):
        self.in_channels = int(np.shape(sample_batch["x"])[-1])
        return super().init_module(sample_batch, generator, device)

    def lr_at(self, lr: float, epoch: int) -> float:
        factor = np.float32(1.0)
        for boundary in self.lr_decay_epochs:
            if epoch >= boundary:
                factor = factor * np.float32(self.lr_decay_factor)
        return float(np.float32(lr) * factor)

    def configure_optimizers(self, lr, epoch):
        rate = self.lr_at(lr, epoch)
        return lambda params: torch.optim.SGD(
            params, lr=rate, momentum=0.9, weight_decay=self.weight_decay)

    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        return vision_params_to_flax(state)

    def params_from_flax(self, variables: dict) -> Dict[str, torch.Tensor]:
        return vision_params_from_flax(variables)


@register_model("resnet18")
class ResNet18(_ResNetBase):
    name = "resnet18"
    stage_sizes = (2, 2, 2, 2)


@register_model("resnet34")
class ResNet34(_ResNetBase):
    name = "resnet34"
    stage_sizes = (3, 4, 6, 3)


@register_model("resnet50")
class ResNet50(_ResNetBase):
    name = "resnet50"
    stage_sizes = (3, 4, 6, 3)
    block = "BottleneckBlock"
    cifar_stem = False


@register_model("resnet32")
class ResNet32(_ResNetBase):
    """CIFAR ResNet-32: 3 stages of 5 blocks, 16/32/64 channels."""

    name = "resnet32"
    stage_sizes = (5, 5, 5)
    width = 16
