"""LeNet-5 for MNIST (twin of kubeml_tpu/models/lenet.py): conv 6 (5x5
``SAME``) -> relu -> 2x2 max-pool -> conv 16 (5x5 ``VALID``) -> relu ->
2x2 max-pool -> Dense 120 -> 84 -> classes, bf16 compute with f32
parameters and f32 logits, plain SGD.

The flax module flattens NHWC activations, so ``Dense_0``'s input rows
run in (h, w, c) order; the port flattens in that order too, not in
NCHW's (c, h, w). Submodules carry the flax names (``Conv_0``,
``Conv_1``, ``Dense_0``..``Dense_2``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import vision_params_from_flax, \
    vision_params_to_flax
from kubeml_tpu_torch.models.base import ClassifierModel, register_model
from kubeml_tpu_torch.models.layers import Conv, Dense, max_pool


class LeNetModule(nn.Module):
    """LeNet over [B, 28, 28] or NHWC [B, 28, 28, 1] inputs."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.Conv_0 = Conv(1, 6, 5, padding="SAME", dtype=dtype, device=dev)
        self.Conv_1 = Conv(6, 16, 5, padding="VALID", dtype=dtype,
                           device=dev)
        self.Dense_0 = Dense(16 * 5 * 5, 120, dtype=dtype, device=dev)
        self.Dense_1 = Dense(120, 84, dtype=dtype, device=dev)
        self.Dense_2 = Dense(84, num_classes, dtype=dtype, device=dev)

    @property
    def device(self) -> torch.device:
        return self.Conv_0.weight.device

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if x.ndim == 3:
            x = x[..., None]                         # [B, 28, 28] -> NHWC
        x = x.permute(0, 3, 1, 2)                    # NCHW view
        x = max_pool(torch.relu(self.Conv_0(x)), 2, 2)
        x = max_pool(torch.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x).float()


@register_model("lenet")
class LeNet(ClassifierModel):
    name = "lenet"

    def __init__(self, num_classes: int = 10):
        self.num_classes = num_classes

    def build(self, dtype: torch.dtype = torch.bfloat16,
              device: DeviceLike = None) -> LeNetModule:
        return LeNetModule(self.num_classes, dtype=dtype, device=device)

    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        return vision_params_to_flax(state)["params"]

    def params_from_flax(self, params: dict) -> Dict[str, torch.Tensor]:
        return vision_params_from_flax({"params": params})
