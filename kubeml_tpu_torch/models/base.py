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

    init_variables           -> init_module(sample_batch, generator, device):
                                the module sized for the batch, its
                                parameters drawn from flax's default
                                initializers (``flax_default_init_``)
    the checkpoint's flax     -> params_to_flax / params_from_flax: each
    variable tree               model names its own mapping between its
                                state dict and the flax ``params`` tree, so
                                checkpoints are written in the JAX
                                package's layout and each package loads the
                                other's (train/checkpoint.py). A model with
                                running statistics (``collections`` names
                                ``batch_stats``) maps the whole variable
                                tree {"params", "batch_stats"} instead
    the flax variables        -> ``module_state(module)``: the parameters
    {"params", "batch_stats"}   and the registered buffers (a BatchNorm's
                                running statistics) by name; the engine
                                loads, carries and merges all of them

Random numbers come from the explicit ``torch.Generator`` the engine
hands to ``loss`` (seeded from the round's per-step key data), never from
torch's global generator. ``ClassifierModel`` (cross-entropy over
{'x', 'y'} batches) and ``KubeDataset`` (the dataset's host transforms)
are the JAX package's, with the dataset's optional device transform
(``transform_train_device``) for the on-device dataset cache.
"""

from __future__ import annotations

import abc
import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kubeml_tpu_torch.models.layers import BatchNorm

PAD_ID = 0  # token id 0 is padding in every text model of the package

# params -> optimizer, as configure_optimizers returns it
OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]

MODELS: Dict[str, type] = {}


def module_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's variables by name: its parameters, then its registered
    buffers (the flax ``batch_stats``, e.g. a BatchNorm's running mean and
    variance). The tensors are the module's own, not copies."""
    return {**dict(module.named_parameters()),
            **dict(module.named_buffers())}


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

    #: the flax variable collections the model's state fills; a model
    #: with running statistics has ("batch_stats", "params"), and its
    #: params_to_flax/params_from_flax map the whole variable tree
    collections = ("params",)

    #: sequence-parallel batch layout: {batch key: dim index within the
    #: per-example shape carrying the sequence}, e.g. {"x": 0} for
    #: [B, T] token ids. None = no sequence-parallel support.
    seq_batch_dims = None

    #: the grid axis and implementation the modules build with
    #: (``enable_seq_parallel``); None = the dense execution
    seq_axis: Optional[str] = None
    seq_impl: str = "ring"

    def enable_seq_parallel(self, impl: str = "ring") -> None:
        """Build the model's modules for sequence-parallel execution over
        the rank grid's ``seq`` axis (the job calls it for
        ``--seq-parallel`` > 1). Models without ``seq_batch_dims`` refuse
        with the reference's message."""
        from kubeml_tpu_torch.parallel.distributed import SEQ_AXIS

        if self.seq_batch_dims is None:
            raise ValueError(
                f"function {self.name or type(self).__name__!r} does not "
                "support sequence parallelism")
        if impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq-parallel impl {impl!r}; "
                             "expected 'ring' or 'ulysses'")
        self.seq_axis, self.seq_impl = SEQ_AXIS, impl

    #: the GSPMD route's Megatron rule table (``parallel/tp.py``) over
    #: the flax paths of ``params_to_flax``; None = the model publishes
    #: no tensor-parallel sharding rules, and its modules take no
    #: ``tp_axis``
    tp_rules = None

    #: the grid axis and per-block plan the modules build with
    #: (``enable_tensor_parallel``); None = the dense execution
    tp_axis: Optional[str] = None
    tp_plan: Optional[dict] = None

    def enable_tensor_parallel(self, plan: Optional[dict] = None) -> None:
        """Build the model's modules tensor-parallel over the rank grid's
        ``model`` axis (the job calls it for ``--tensor-parallel`` > 1;
        it composes with ``enable_seq_parallel``'s ring). ``plan``: the
        GSPMD route's ``parallel/tp.shard_plan`` (a pair that does not
        divide runs whole); None is the manual route (every pair
        splits). A model without ``tp_rules`` (its modules take no
        ``tp_axis``) refuses with the reference's message. The modules'
        parameters stay whole (init, checkpoints and the merge see the
        dense model)."""
        from kubeml_tpu_torch.parallel.distributed import MODEL_AXIS

        if self.tp_rules is None:
            raise ValueError(
                f"function {self.name or type(self).__name__!r} does not "
                "support manual tensor parallelism")
        self.tp_axis, self.tp_plan = MODEL_AXIS, plan

    #: the model's trunk is a uniform stack of blocks that pipelines
    #: over the rank grid's stage axis (the transformer families)
    pipeline_trunk = False

    #: microbatches a step of the pipelined loss (enable_pipeline_parallel);
    #: 0 = the dense loss
    _pp_microbatches = 0

    def enable_pipeline_parallel(self, n_stage: int,
                                 microbatches: int = 0) -> None:
        """Train through a GPipe pipeline of the model's blocks over the
        rank grid's ``stage`` axis (the job calls it for
        ``--pipeline-parallel`` > 1; it composes with
        ``enable_expert_parallel``): the loss runs ``microbatches``
        microbatches (0: 2 x ``n_stage``) through stages of L / n_stage
        consecutive blocks, the modules and their parameters unchanged.
        The reference's refusals, in its order: a model without a
        pipelineable trunk; a seq or model axis; layers that do not split
        over the stages."""
        if not self.pipeline_trunk:
            raise ValueError(
                f"function {self.name or type(self).__name__!r} does not "
                "support pipeline parallelism (requires a uniform "
                "pipelineable trunk — the transformer families: GPT, "
                "BERT)")
        if self.seq_axis is not None or self.tp_axis is not None:
            raise ValueError(
                "pipeline parallelism composes with expert parallelism "
                "only (not --seq-parallel/--tensor-parallel)")
        layers = self.build(device="meta").layers
        if layers % n_stage:
            raise ValueError(
                f"{layers} layers do not split over a {n_stage}-stage axis")
        self._pp_microbatches = int(microbatches) or 2 * int(n_stage)

    def enable_expert_parallel(self) -> None:
        """Build the model's modules with their experts split over the
        rank grid's ``expert`` axis (the job calls it for
        ``--expert-parallel`` > 1). Only a mixture of experts has experts
        to shard (``GPTMoEMini`` overrides this); every other model
        refuses with the reference's message."""
        raise ValueError(
            f"function {self.name or type(self).__name__!r} has no "
            "experts to shard (expert parallelism applies to MoE "
            "families like gpt-moe-mini)")

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

    def init_module(self, sample_batch: Dict[str, np.ndarray],
                    generator: torch.Generator, device=None) -> nn.Module:
        """The module for batches like ``sample_batch`` (host numpy, one
        transformed training batch), with parameters drawn from flax's
        default initializers through ``generator``: the JAX package's
        ``init_variables`` in distribution, not in bits (jax.random's
        stream cannot be reproduced). Models whose widths follow the data
        override this."""
        module = self.build(device=device)
        flax_default_init_(module, generator)
        return module

    def module_from_flax(self, variables: dict, device=None) -> nn.Module:
        """A module holding a checkpoint's variable tree (the flax
        ``{"params"[, "batch_stats"]}`` tree load_checkpoint gives): what
        inference on a trained model runs. Models whose widths follow the
        data take them from the tree instead of a sample batch."""
        module = self.build(device=device)
        state = self.params_from_flax(
            variables["params"] if tuple(self.collections) == ("params",)
            else variables)
        with torch.no_grad():
            for name, t in module_state(module).items():
                t.copy_(state[name])
        return module

    @abc.abstractmethod
    def params_to_flax(self, state: Dict[str, torch.Tensor]) -> dict:
        """State dict (by parameter name) -> the JAX package's flax
        ``params`` tree of float32 numpy arrays."""

    @abc.abstractmethod
    def params_from_flax(self, params: dict) -> Dict[str, torch.Tensor]:
        """The inverse: a flax ``params`` tree -> CPU float32 state dict."""


def flax_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Draw ``module``'s parameters, in place and in named order, from the
    distributions flax gives the matching layers by default: a Linear's
    weight [out, in] and a Conv2d's [out, in, kh, kw] from lecun_normal (a
    normal truncated to +-2 standard deviations, scaled to variance
    1/fan_in, fan_in = in or in * kh * kw), an Embedding [V, E] from a
    normal of variance 1/E, LayerNorm scales 1; every bias and offset 0.
    A layer with its own ``reset_parameters`` and no weight to draw (the
    vision BatchNorm: scale 1, or 0 where flax zero-initialises it, bias
    0, running mean 0 and variance 1) resets itself; one with its own
    initializers (the MoE FFN's ``flax_init_``) draws them from
    ``generator``."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Linear, nn.Conv2d)):
                fan_in = sub.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = torch.empty(sub.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                sub.weight.copy_(w * std)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.Embedding):
                w = torch.randn(sub.weight.shape, generator=generator)
                sub.weight.copy_(w / math.sqrt(sub.embedding_dim))
            elif isinstance(sub, nn.LayerNorm):
                sub.weight.fill_(1.0)
                sub.bias.zero_()
            elif isinstance(sub, BatchNorm):
                sub.reset_parameters()
            elif hasattr(sub, "flax_init_"):
                sub.flax_init_(generator)


class ClassifierModel(KubeModel):
    """Softmax classifiers over {'x', 'y'} batches (twin of the JAX
    package's ClassifierModel): per-example cross-entropy of the module's
    f32 logits as the loss, loss and argmax accuracy as the metrics, plain
    SGD (the JAX package's default optimizer, ``optax.sgd(lr)``)."""

    def _logits(self, module, batch, train: bool,
                generator: Optional[torch.Generator] = None):
        """The module's f32 logits of the batch; a model whose module
        draws dropout passes ``generator`` (the engine's per-step one) on
        to it, a model without dropout leaves it unused."""
        return module(batch["x"].to(module.device), train=train)

    def loss(self, module, batch, generator, sample_mask):
        logits = self._logits(module, batch, train=True, generator=generator)
        return F.cross_entropy(logits, batch["y"].to(logits.device).long(),
                               reduction="none")

    def metrics(self, module, batch):
        with torch.no_grad():
            logits = self._logits(module, batch, train=False)
        y = batch["y"].to(logits.device).long()
        return {"loss": F.cross_entropy(logits, y, reduction="none"),
                "accuracy": (logits.argmax(-1) == y).float()}

    def configure_optimizers(self, lr, epoch):
        return lambda params: torch.optim.SGD(params, lr=lr)

    @torch.no_grad()
    def infer(self, module, data: np.ndarray) -> np.ndarray:
        """Argmax classes of the logits for a host batch."""
        x = torch.as_tensor(np.asarray(data), device=module.device)
        return module(x, train=False).argmax(-1).cpu().numpy()


class KubeDataset(abc.ABC):
    """Dataset-side user hooks (twin of the JAX package's KubeDataset):
    the transforms run on host numpy arrays, once per round chunk, and
    return the batch dict the model's loss reads — any keys (a language
    model's has no 'y')."""

    #: registry dataset name this model trains on
    dataset: str = ""

    #: optional device twin of transform_train for the index-fed cached
    #: path (data/device_cache.py): ``f(x, y) -> {key: torch.Tensor}``
    #: applied to the raw gathered leaves on the device (e.g. u8 -> f32
    #: normalize). A dataset whose host transform_train is not the
    #: identity must provide this for the device cache to be eligible,
    #: and the two must compute the same values, or cached and
    #: host-staged rounds diverge.
    transform_train_device = None

    def __init__(self, dataset_name: Optional[str] = None):
        if dataset_name:
            self.dataset = dataset_name

    def transform_train(self, data: np.ndarray,
                        labels: np.ndarray) -> Dict[str, np.ndarray]:
        return {"x": data, "y": labels}

    def transform_test(self, data: np.ndarray,
                       labels: np.ndarray) -> Dict[str, np.ndarray]:
        return {"x": data, "y": labels}
