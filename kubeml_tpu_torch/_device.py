"""The port's device rule: entry points run on the card by default.

``device=None`` means CUDA. Asking for CUDA (explicitly or by default)
on a machine without a CUDA device raises instead of quietly running on
the CPU, so a measurement can never be a CPU number by accident. The CPU
is reachable only by asking for it (``device="cpu"``), which is what the
tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def require_cuda() -> None:
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; kubeml_tpu_torch entry points "
            "run on the GPU unless called with device='cpu'")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Map an entry point's ``device`` argument to a torch.device:
    None -> cuda (raising without a CUDA device), anything else as given
    (a CUDA device is checked the same way)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            # pin the index so devices compare equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
