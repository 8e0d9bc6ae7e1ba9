"""Small MLP classifier (twin of kubeml_tpu/models/mlp.py): the JAX
package's job-test workhorse and the simplest model template."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.convert import mlp_params_from_flax, mlp_params_to_flax
from kubeml_tpu_torch.models.base import ClassifierModel, register_model


class MLPModule(nn.Module):
    """flatten -> Linear(in, hidden) -> relu -> Linear(hidden, classes),
    f32 logits (the flax module's Dense_0 / Dense_1 as fc0 / fc1)."""

    def __init__(self, in_features: int, hidden: int = 32,
                 num_classes: int = 10, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.fc0 = nn.Linear(in_features, hidden, device=dev)
        self.fc1 = nn.Linear(hidden, num_classes, device=dev)

    @property
    def device(self) -> torch.device:
        return self.fc0.weight.device

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        return self.fc1(F.relu(self.fc0(x)))


@register_model("mlp")
class MLP(ClassifierModel):
    name = "mlp"

    def __init__(self, hidden: int = 32, num_classes: int = 10):
        self.hidden = hidden
        self.num_classes = num_classes
        self.in_features = None  # the flattened width of x, from the data

    def build(self, dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> MLPModule:
        if self.in_features is None:
            raise ValueError("mlp takes its input width from a sample "
                             "batch: build it through init_module")
        return MLPModule(self.in_features, self.hidden, self.num_classes,
                         device=device)

    def init_module(self, sample_batch, generator, device=None):
        x = np.asarray(sample_batch["x"])
        self.in_features = int(math.prod(x.shape[1:]))
        return super().init_module(sample_batch, generator, device)

    def module_from_flax(self, variables, device=None):
        params = variables["params"]
        self.in_features, self.hidden = params["Dense_0"]["kernel"].shape
        self.num_classes = params["Dense_1"]["kernel"].shape[1]
        return super().module_from_flax(variables, device)

    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        return mlp_params_to_flax(state)

    def params_from_flax(self, params: dict) -> Dict[str, torch.Tensor]:
        return mlp_params_from_flax(params)
