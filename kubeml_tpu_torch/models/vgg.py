"""VGG-11 for CIFAR-100 (twin of kubeml_tpu/models/vgg.py): eight 3x3
``SAME`` convolutions with relus and five 2x2 ``VALID`` max-pools (the
"A" configuration), then Dense(hidden) -> relu -> dropout -> Dense(hidden)
-> relu -> dropout -> Dense(classes); bf16 compute over f32 parameters,
f32 logits, SGD with momentum 0.9.

The layers are ``models/layers.py``'s flax-faithful ones. The flax module
flattens the NHWC feature map, so ``Dense_0``'s input rows run in (h, w,
c) order; the port flattens in that order too. At 32x32 the map is 1 x 1
x 512 and the order cannot show; at 64x64 it is 2 x 2 x 512. ``Dense_0``
is sized from the feature map, so the model reads the input's size and
channels from a sample batch (``init_module``) or from a checkpoint
(``module_from_flax``). Dropout draws from the engine's per-step
generator. Submodules carry the flax names (``Conv_0``..``Conv_7``,
``Dense_0``..``Dense_2``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import vision_params_from_flax, \
    vision_params_to_flax
from kubeml_tpu_torch.models.base import ClassifierModel, register_model
from kubeml_tpu_torch.models.layers import Conv, Dense, _dropout, max_pool

# VGG-11 ("A"): conv widths, "M" a max-pool
VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


def feature_size(height: int, width: int) -> int:
    """Elements of the flattened feature map of an H x W input: five
    VALID 2x2 pools halve each side, rounding down, over 512 channels."""
    for v in VGG11_CFG:
        if v == "M":
            height, width = height // 2, width // 2
    return height * width * VGG11_CFG[-2]


class VGGModule(nn.Module):
    """VGG-11 over NHWC inputs [B, H, W, C]; ``features`` is the
    flattened feature map's size (512 at 32x32)."""

    def __init__(self, num_classes: int = 100, hidden: int = 4096,
                 dropout: float = 0.5, in_channels: int = 3,
                 features: int = 512, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype, self.dropout = dtype, float(dropout)
        self.convs = []
        ch = in_channels
        for v in VGG11_CFG:
            if v != "M":
                conv = Conv(ch, v, 3, padding="SAME", dtype=dtype,
                            device=dev)
                self.add_module(f"Conv_{len(self.convs)}", conv)
                self.convs.append(conv)
                ch = v
        self.Dense_0 = Dense(features, hidden, dtype=dtype, device=dev)
        self.Dense_1 = Dense(hidden, hidden, dtype=dtype, device=dev)
        self.Dense_2 = Dense(hidden, num_classes, dtype=dtype, device=dev)
        self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.Conv_0.weight.device

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """[B, H, W, C] -> [B, classes] f32 logits; with ``train`` the
        two dropouts draw from ``generator``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)     # NHWC -> NCHW view
        convs = iter(self.convs)
        for v in VGG11_CFG:
            if v == "M":
                x = max_pool(x, 2, 2)
            else:
                x = torch.relu(next(convs)(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        rate = self.dropout if train else 0.0
        x = _dropout(torch.relu(self.Dense_0(x)), rate, generator)
        x = _dropout(torch.relu(self.Dense_1(x)), rate, generator)
        return self.Dense_2(x).float()


@register_model("vgg11")
class VGG11(ClassifierModel):
    """VGG-11 on CIFAR-100: 100 classes, SGD with momentum 0.9 (the
    reference's ``optax.sgd(lr, momentum=0.9)``: no weight decay, a
    constant rate)."""

    name = "vgg11"
    num_classes = 100
    in_channels = 3        # CIFAR's; init_module reads it from the data
    features = 512         # 32x32 inputs; init_module reads the size

    def build(self, dtype: torch.dtype = torch.bfloat16,
              device: DeviceLike = None) -> VGGModule:
        return VGGModule(num_classes=self.num_classes,
                         in_channels=self.in_channels,
                         features=self.features, dtype=dtype, device=device)

    def init_module(self, sample_batch, generator, device=None):
        _, h, w, c = np.shape(sample_batch["x"])
        self.in_channels, self.features = int(c), feature_size(h, w)
        return super().init_module(sample_batch, generator, device)

    def module_from_flax(self, variables, device=None):
        params = variables["params"]
        self.in_channels = int(np.shape(params["Conv_0"]["kernel"])[2])
        self.features = int(np.shape(params["Dense_0"]["kernel"])[0])
        return super().module_from_flax(variables, device)

    def _logits(self, module, batch, train, generator=None):
        return module(batch["x"].to(module.device), train=train,
                      generator=generator)

    def configure_optimizers(self, lr, epoch):
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)

    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        return vision_params_to_flax(state)["params"]

    def params_from_flax(self, params: dict) -> Dict[str, torch.Tensor]:
        return vision_params_from_flax({"params": params})
