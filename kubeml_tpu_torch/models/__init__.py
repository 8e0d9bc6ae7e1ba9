"""Built-in models of the port (twin of kubeml_tpu/models): the GPT
family, ``gpt-mini`` and ``gpt-nano``, the ``mlp`` classifier, ``lenet``
and the ResNets (``resnet18``, ``resnet34``, ``resnet32``, ``resnet50``).
``get_builtin`` gives a GPT module builder (serving), ``get_model`` the
registered model class (training), ``model_names`` their names."""

from __future__ import annotations

import functools
from typing import Callable, Optional

from kubeml_tpu_torch.models.base import MODELS, KubeModel
from kubeml_tpu_torch.models.gpt import (GPT_CONFIGS, GPT_DROPOUT, GPTMini,
                                         GPTModule, GPTNano)
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.models.mlp import MLP
from kubeml_tpu_torch.models.resnet import (ResNet18, ResNet32, ResNet34,
                                            ResNet50)


def get_builtin(name: str) -> Optional[Callable[..., GPTModule]]:
    """A builder for the named built-in model, or None when unknown.
    The builder takes GPTModule's keyword arguments (``device=None``
    means CUDA; ``dtype`` defaults to bf16), e.g.
    ``get_builtin("gpt-mini")(device="cpu")``."""
    cfg = GPT_CONFIGS.get(name)
    return None if cfg is None else functools.partial(
        GPTModule, **cfg, dropout=GPT_DROPOUT[name])


def get_model(name: str) -> Optional[type]:
    """The registered KubeModel class of that name, or None."""
    return MODELS.get(name)


def builtin_names() -> list:
    return sorted(GPT_CONFIGS)


def model_names() -> list:
    """Names of the registered KubeModel classes (the trainable
    built-ins)."""
    return sorted(MODELS)


__all__ = ["GPTMini", "GPTModule", "GPTNano", "KubeModel", "LeNet", "MLP",
           "ResNet18", "ResNet32", "ResNet34", "ResNet50", "get_builtin",
           "get_model", "builtin_names", "model_names"]
