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

from kubeml_tpu_torch._device import require_cuda, resolve_device

__all__ = ["require_cuda", "resolve_device"]
