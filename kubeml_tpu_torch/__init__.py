"""PyTorch + CUDA port of kubeml_tpu, beside the JAX package it mirrors.

Each subpackage keeps the name of its twin in ``kubeml_tpu`` (``models``,
``ops``, ``serve``, ``api``, ``control``, ``metrics``, ...) so a ported
module is found where its reference lives. The port imports ``torch``
and never JAX or anything of ``kubeml_tpu``: what it needs from a
numpy-only reference module it keeps as its own copy.

Every kernel the JAX package wrote in Pallas for the TPU is a kernel
written by hand for Hopper here (``ops/csrc``), built with ``nvcc`` at
first use. Entry points run on the card unless the caller asks for the
CPU (``device="cpu"``), where each kernel's plain PyTorch version runs.
"""

__all__ = ["require_cuda", "resolve_device"]


def __getattr__(name):
    """The two device helpers, imported at first use: importing the
    package (the CLI's client verbs do) does not import torch."""
    if name in __all__:
        from kubeml_tpu_torch import _device
        return getattr(_device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
