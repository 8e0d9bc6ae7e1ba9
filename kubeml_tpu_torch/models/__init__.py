"""Built-in models of the port (twin of kubeml_tpu/models). This slice
serves the GPT family: ``gpt-mini`` and ``gpt-nano``."""

from __future__ import annotations

import functools
from typing import Callable, Optional

from kubeml_tpu_torch.models.gpt import GPT_CONFIGS, GPTModule


def get_builtin(name: str) -> Optional[Callable[..., GPTModule]]:
    """A builder for the named built-in model, or None when unknown.
    The builder takes GPTModule's keyword arguments (``device=None``
    means CUDA; ``dtype`` defaults to bf16), e.g.
    ``get_builtin("gpt-mini")(device="cpu")``."""
    cfg = GPT_CONFIGS.get(name)
    return None if cfg is None else functools.partial(GPTModule, **cfg)


def builtin_names() -> list:
    return sorted(GPT_CONFIGS)


__all__ = ["GPTModule", "get_builtin", "builtin_names"]
