"""The model contract (twin of kubeml_tpu/models/base.py): what a model
gives the training engine, and the pieces the serving slice shares.

The reference's flax contract maps onto PyTorch as:

    KubeModel.build          -> the nn.Module (parameters + forward)
    KubeModel.loss           -> loss(module, batch, generator, sample_mask)
                                -> per-example loss [B]; differentiable, the
                                engine takes the masked mean and steps
    KubeModel.metrics        -> metrics(module, batch) -> {name: [B]}
                                (must include 'loss' and 'accuracy'); the
                                engine takes the datapoint-weighted mean
    configure_optimizers     -> configure_optimizers(lr, epoch) -> a factory
                                params -> torch.optim.Optimizer, called for
                                every worker of every round (the reference
                                resets optimizer state each round, so a
                                fresh optimizer per round is exact)

Random numbers come from the explicit ``torch.Generator`` the engine
hands to ``loss`` (seeded from the round's per-step key data), never from
torch's global generator. Only what the GPT family needs is ported here;
the classifier base and the vision pieces come with the vision slice.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, Iterable

import torch

PAD_ID = 0  # token id 0 is padding in every text model of the package

# params -> optimizer, as configure_optimizers returns it
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]

MODELS: Dict[str, type] = {}


def register_model(name: str):
    """Class decorator: register a KubeModel under ``name``."""
    def deco(cls):
        MODELS[name] = cls
        return cls
    return deco


class InferenceInputError(ValueError):
    """A model rejected the caller-supplied inference payload (bad shape,
    overlong prompt, ...). Serving layers translate exactly this type to
    a 4xx error; any other exception stays a server fault (5xx)."""


class KubeModel(abc.ABC):
    """Base class of a trainable model."""

    #: name under which the model registers
    name: str = ""

    @abc.abstractmethod
    def build(self, dtype: torch.dtype = torch.bfloat16,
              device=None) -> torch.nn.Module:
        """The nn.Module with f32 parameters; ``dtype`` is the compute
        dtype and ``device=None`` means CUDA."""

    @abc.abstractmethod
    def loss(self, module: torch.nn.Module, batch: Dict[str, torch.Tensor],
             generator: torch.Generator,
             sample_mask: torch.Tensor) -> torch.Tensor:
        """Per-example training loss [B] (dropout on, drawn from
        ``generator``). sample_mask [B] marks padded examples (0.0)."""

    @abc.abstractmethod
    def metrics(self, module: torch.nn.Module,
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-example metric values, each [B]; includes 'loss' and
        'accuracy'."""

    @abc.abstractmethod
    def configure_optimizers(self, lr: float, epoch: int) -> OptimizerFactory:
        """A fresh optimizer factory for one worker's round."""
