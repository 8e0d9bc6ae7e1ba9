"""Ulysses all-to-all sequence parallelism over the seq group of the rank
grid (twin of kubeml_tpu/parallel/ulysses.py).

The second of the two sequence-parallel strategies beside the ring
(``parallel/ring_attention.py``): one all-to-all re-shards the
activations from sequence-split [B, T/n, H, D] to head-split
[B, T, H/n, D], each rank runs ordinary full attention over the global
sequence for its head group (``masked_attention``: the flash kernels
#2-#4 on CUDA tensors, their plain versions on CPU tensors), and a second
all-to-all restores the sequence split. Requires H % n == 0. The
all-to-alls are ``distributed.all_to_all`` over the seq group; the
backward of each is the inverse re-shard (``_SeqToHeads``).
"""

from __future__ import annotations

import torch

from kubeml_tpu_torch.ops.attention import masked_attention
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel.distributed import SEQ_AXIS
from kubeml_tpu_torch.parallel.ring_attention import _seq_block, gather_seq

__all__ = ["ulysses_attention", "ulysses_self_attention"]


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, T/n, H, D] -> [B, T, H/n, D]: rank i keeps head group i and
    receives every rank's sequence block of it, in seq order."""
    B, Tl, H, D = x.shape
    parts = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = dist_lib.all_to_all(parts.contiguous(), group)  # [n, B, Tl, ..]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, T, H/n, D] -> [B, T/n, H, D]: the inverse of _seq_to_heads."""
    B, T, Hn, D = x.shape
    parts = x.reshape(B, n, T // n, Hn, D).permute(1, 0, 2, 3, 4)
    got = dist_lib.all_to_all(parts.contiguous(), group)  # [n, B, Tl, ..]
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hn, D)


class _SeqToHeads(torch.autograd.Function):
    """The re-shard as an autograd op: the VJP of an all-to-all is the
    all-to-all back."""

    @staticmethod
    def forward(ctx, x, n, group, to_heads):
        ctx.n, ctx.group, ctx.to_heads = n, group, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, n, group)

    @staticmethod
    def backward(ctx, g):
        back = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return back(g.contiguous(), ctx.n, ctx.group), None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: torch.Tensor, causal: bool = False,
                      axis_name: str = SEQ_AXIS) -> torch.Tensor:
    """Sequence-parallel attention body: q/k/v [B, T_local, H, D] this
    rank's blocks, kv_mask [B, T_local] (1 = real token) -> this rank's
    block of full attention over the global sequence, [B, T_local, H, D];
    differentiable in q, k and v. H must divide by the axis size.

    The reference's ``impl``/``interpret`` knobs pick its TPU kernel and
    are not ported: ``masked_attention`` is always the flash path."""
    n = dist_lib.axis_size(axis_name)
    H = q.shape[2]
    if H % n:
        raise ValueError(
            f"ulysses needs heads % seq-axis == 0, got H={H}, n={n}")
    if n == 1:
        return masked_attention(q, k, v, kv_mask, causal=causal)
    group = dist_lib.axis_group(axis_name)
    qg, kg, vg = (_SeqToHeads.apply(t, n, group, True) for t in (q, k, v))
    # the full-sequence keep-mask is tiny ([B, T]): gather it outright
    mask_g = dist_lib.all_gather_cat(
        kv_mask.float().t().contiguous(), group).t()
    out = masked_attention(qg, kg, vg, mask_g.contiguous(), causal=causal)
    return _SeqToHeads.apply(out, n, group, False)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pad_mask: torch.Tensor,
                           grid=None, causal: bool = False) -> torch.Tensor:
    """Host-callable wrapper: every rank of the seq group holds the whole
    [B, T, H, D] tensors; each runs ``ulysses_attention`` on its block
    and the blocks are gathered. T and H must divide by n."""
    grid = dist_lib.current_grid() if grid is None else grid
    n, sid = grid.n_seq, grid.seq_index
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by seq={n}")
    if H % n:
        raise ValueError(f"head count {H} not divisible by seq={n}")
    out = ulysses_attention(
        _seq_block(q, n, sid), _seq_block(k, n, sid), _seq_block(v, n, sid),
        _seq_block(pad_mask.float(), n, sid), causal=causal)
    return gather_seq(out, grid)
