"""Multi-head attention primitives (twin of kubeml_tpu/ops/attention.py).

One numerically pinned attention chain, the same as the reference's:
f32-accumulated scores, ``scores * (1/sqrt(d))``, an additive f32 bias
(0 = attend, NEG_INF = masked), an f32 softmax, and the weights cast to
``q.dtype`` before the PV product. The paged-attention kernel
(ops/csrc/paged_attention.cu) computes the same chain; ``masked_attention``
is the training path's entry to the flash kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e9  # large-negative instead of -inf: keeps softmax NaN-free
               # for rows that are fully masked (all-pad sequences)


def padding_bias(pad_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] 1/0 keep-mask -> [B, 1, 1, T] additive f32 attention bias."""
    return ((1.0 - pad_mask.float()) * NEG_INF)[:, None, None, :]


def composed_bias(pad_mask: torch.Tensor, causal: bool,
                  T: int) -> torch.Tensor:
    """Additive [B, 1, Tq, Tk]-broadcastable bias for a [B, T] keep-mask
    plus optional causality — the reference's mask semantics."""
    bias = padding_bias(pad_mask)
    if causal:
        idx = torch.arange(T, device=pad_mask.device)
        tri = torch.where(idx[:, None] >= idx[None, :],
                          torch.zeros((), device=pad_mask.device),
                          torch.full((), NEG_INF, device=pad_mask.device))
        bias = bias + tri[None, None]
    return bias


def score_scale(d: int) -> float:
    """The reference's ``1 / sqrt(float32(d))``, rounded as f32 does it
    (sqrt rounded to f32, then the reciprocal rounded to f32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, T, H, D] tensors.

    bias: additive logits bias broadcastable to [B, H, Tq, Tk].
    Returns [B, Tq, H, D] in q.dtype. Scores and softmax run in f32.
    """
    d = q.shape[-1]
    # products of bf16 values are exact in f32, so upcasting first gives
    # the reference's f32-accumulated (preferred_element_type) scores
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * score_scale(d)
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pad_mask: torch.Tensor,
                     causal: bool = False) -> torch.Tensor:
    """Self-attention over [B, T, H, D] with a [B, T] keep-mask —
    differentiable; the training forward's attention.

    Always flash attention (ops/flash_attention.py): a CUDA tensor
    launches the hand-written kernels, a CPU tensor runs their plain
    versions. The reference's ``impl``/``interpret`` knobs and its
    ``_flash_tiles`` gate exist to fit a TPU's tiling and are not ported:
    the CUDA kernels mask their own ragged edge, so any T >= 1 works.
    """
    from kubeml_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, pad_mask, causal)
