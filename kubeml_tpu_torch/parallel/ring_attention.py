"""Ring attention: sequence parallelism over the seq group of the rank
grid (twin of kubeml_tpu/parallel/ring_attention.py).

The sequence is split over the ``seq`` axis of the rank grid
(``parallel/distributed.py`` ``make_grid``): each rank holds a Q block and
a KV block of T / n tokens. The KV blocks travel around the ring (one
``distributed.ring_shift`` per step: seq index i sends to i + 1) while
each rank folds its Q block's attention into a running online softmax
(max m, normalizer l, numerator acc), so no rank holds the [T, T] scores.
Padding and causality ride as per-token metadata (positions and the
keep-mask travel with their block), so the result equals full attention
under the composed bias.

Two block paths, as in the reference:

  - the dense ring (``use_flash=False``): ``_block_attn`` over the block's
    additive bias, any position layout; differentiable through
    ``ring_shift``, whose backward sends the gradient back the other way;
  - the flash ring (``use_flash=True``, what the models run): one call of
    the flash forward (#2) per visiting block, the partials merged by
    ``_merge_partials``, and a backward ring (``_RingFlash``) that feeds
    the GLOBAL row statistics (m and l merged over the whole ring) to the
    flash backward kernels (#3 dK/dV, #4 dQ) per block: with global
    statistics each block's probabilities exp(s - m) / l are the global
    ones, so the per-block gradients are the global gradient's parts and
    simply add. dK/dV accumulators travel with their block and one last
    hop brings them home; dQ accumulates in place. On CUDA tensors the
    kernels launch (n per layer per direction, fully masked blocks
    included); on CPU tensors their plain versions run.

Causality on the flash ring assumes the contiguous layout (seq index s
holds positions [s T/n, (s+1) T/n)): the local block takes the kernel's
aligned causal mask, a visiting block is wholly visible or wholly dropped
(``_causal_step_mask``). ``ring_self_attention`` raises RingLayoutError at
the host for another layout; the raw body ``ring_attention`` poisons its
output with NaN instead.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeml_tpu_torch.ops.attention import NEG_INF, score_scale
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel.distributed import SEQ_AXIS

__all__ = ["ring_attention", "ring_self_attention", "RingLayoutError",
           "gather_seq"]


class RingLayoutError(ValueError):
    """A causal flash ring call's positions violate the contiguous shard
    layout (shard s must hold global positions [s*T/n, (s+1)*T/n)).
    Raised at the host by ``ring_self_attention``, whose positions are
    known before the call; the raw body ``ring_attention`` poisons its
    output with NaN instead."""


def _block_attn(q, k, v, bias):
    """One Q-block x KV-block step of the online softmax: q [B, Tq, H, D],
    k/v [B, Tk, H, D], bias [B, H, Tq, Tk]-broadcastable additive ->
    (numerator [B, Tq, H, D] f32, row max [B, H, Tq] f32, row denominator
    [B, H, Tq] f32) for this block only."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * score_scale(q.shape[-1]) + bias
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return acc.float(), m, l


def _block_attn_flash(q, k, v, kv_mask, causal: bool):
    """The same partials from the flash forward (#2): the kernel's saved
    row statistics give back the unnormalised numerator, out * l.
    ``causal`` is the kernel's aligned diagonal mask (the local block
    only; visiting blocks express causality through ``kv_mask``)."""
    from kubeml_tpu_torch.ops.flash_attention import _fa_forward

    B, T, H, _ = q.shape
    out, m_rows, l_rows = _fa_forward(q, k, v, kv_mask, causal)
    m = m_rows.reshape(B, H, T)
    l = l_rows.reshape(B, H, T)
    return out.float() * l.transpose(1, 2)[..., None], m, l


def _merge_partials(acc, m, l, a_blk, m_blk, l_blk):
    """Fold one block's (numerator, max, denominator) into the running
    state: the merge rule the dense and flash rings share."""
    new_m = torch.maximum(m, m_blk)
    old_scale = torch.exp(m - new_m)             # [B, H, Tq]
    blk_scale = torch.exp(m_blk - new_m)
    l = l * old_scale + l_blk * blk_scale
    acc = acc * old_scale.transpose(1, 2)[..., None] \
        + a_blk * blk_scale.transpose(1, 2)[..., None]
    return acc, new_m, l


def _causal_step_mask(maskb, causal: bool, sid: int, s: int, n: int):
    """Visibility of the visiting block at ring step s, the rule the
    forward and backward rings share: after s hops this rank holds shard
    (sid - s)'s block, wholly visible iff it sits before this rank's
    shard; a dropped block's all-masked partials carry m = NEG_INF and
    merge (and backpropagate) with weight zero."""
    if not causal:
        return maskb
    return maskb * float((sid - s) % n < sid)


def _hop(t: torch.Tensor, axis_name: str) -> torch.Tensor:
    """One ring step of a tensor that carries no gradient."""
    return dist_lib.ring_shift(t.detach(), axis_name)


def _ring_flash_core(q, k, v, kv_mask, causal: bool, axis_name: str):
    """The flash forward ring: (normalised out f32 [B, T, H, D], m, l),
    m and l the GLOBAL row statistics [B, H, T] the backward needs."""
    n = dist_lib.axis_size(axis_name)
    sid = dist_lib.axis_index(axis_name)
    acc, m, l = _block_attn_flash(q, k, v, kv_mask, causal)
    kv, maskb = torch.stack([k, v]), kv_mask
    for s in range(1, n):
        kv, maskb = _hop(kv, axis_name), _hop(maskb, axis_name)
        eff = _causal_step_mask(maskb, causal, sid, s, n).contiguous()
        a_blk, m_blk, l_blk = _block_attn_flash(q, kv[0], kv[1], eff, False)
        acc, m, l = _merge_partials(acc, m, l, a_blk, m_blk, l_blk)
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out, m, l


def _ring_flash_bwd(q, k, v, kv_mask, out, m, l, g, causal: bool,
                    axis_name: str):
    """The backward ring: the flash backward kernels per (local q,
    visiting kv) pair, fed the merged global statistics in the kernels'
    [B*H, 1, T] layout (delta from the globally normalised ``out``)."""
    from kubeml_tpu_torch.ops.flash_attention import _fa_backward

    n = dist_lib.axis_size(axis_name)
    sid = dist_lib.axis_index(axis_name)
    B, T, H, _ = q.shape
    m_rows = m.reshape(B * H, 1, T).contiguous()
    l_rows = l.reshape(B * H, 1, T).contiguous()

    def block_bwd(kb, vb, maskb, blk_causal):
        return _fa_backward(q, kb, vb, maskb, out, m_rows, l_rows, g,
                            blk_causal)

    dq, dk, dv = block_bwd(k, v, kv_mask, causal)      # the local block
    dq = dq.float()
    kv, maskb = torch.stack([k, v]), kv_mask
    dkv = torch.stack([dk, dv]).float()
    for s in range(1, n):
        # the dK/dV accumulators travel with their block
        kv, maskb, dkv = (_hop(t, axis_name) for t in (kv, maskb, dkv))
        eff = _causal_step_mask(maskb, causal, sid, s, n).contiguous()
        dq_c, dk_c, dv_c = block_bwd(kv[0], kv[1], eff, False)
        dq = dq + dq_c.float()
        dkv = dkv + torch.stack([dk_c, dv_c]).float()
    # after n - 1 hops each accumulator sits one hop short of home
    dkv = _hop(dkv, axis_name)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` custom_vjp: the forward saves the
    global statistics, the backward ring consumes them."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, axis_name):
        out, m, l = _ring_flash_core(q, k, v, kv_mask, causal, axis_name)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        ctx.causal, ctx.axis_name = causal, axis_name
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(q, k, v, kv_mask, out, m, l,
                                     g.contiguous(), ctx.causal,
                                     ctx.axis_name)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   kv_mask: torch.Tensor, causal: bool = False,
                   axis_name: str = SEQ_AXIS,
                   use_flash: bool = False) -> torch.Tensor:
    """Sequence-parallel attention body: q/k/v [B, T_local, H, D] this
    rank's blocks, q_pos/kv_pos [T_local] their global positions,
    kv_mask [B, T_local] (1 = real token) -> this rank's block of full
    attention over the global sequence, [B, T_local, H, D].

    ``use_flash`` runs every block through the flash kernels, forward and
    backward (``_RingFlash``); positions are not consulted there, so a
    causal call whose positions break the contiguous layout gets NaN.
    The dense ring consults positions and takes any layout. Both are
    differentiable in q, k and v."""
    kv_mask = kv_mask.float().contiguous()
    if use_flash:
        if causal:
            sid = dist_lib.axis_index(axis_name)
            T = q.shape[1]
            expected = sid * T + torch.arange(T, device=q.device)
            layout_ok = (q_pos.to(q.device) == expected).all() \
                & (kv_pos.to(q.device) == expected).all()
        else:
            layout_ok = torch.ones((), dtype=torch.bool, device=q.device)
        out = _RingFlash.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), kv_mask, causal, axis_name)
        return torch.where(layout_ok, out,
                           torch.full((), float("nan"), dtype=out.dtype,
                                      device=out.device))
    n = dist_lib.axis_size(axis_name)
    q_pos = q_pos.to(q.device)

    def bias_for(pos_blk, mask_blk):
        bias = ((1.0 - mask_blk) * NEG_INF)[:, None, None, :]
        if causal:
            allowed = q_pos[:, None] >= pos_blk.to(q.device)[None, :]
            bias = bias + torch.where(
                allowed, torch.zeros((), device=q.device),
                torch.full((), NEG_INF, device=q.device))[None, None]
        return bias

    acc, m, l = _block_attn(q, k, v, bias_for(kv_pos, kv_mask))
    kb, vb, posb, maskb = k, v, kv_pos.to(q.device), kv_mask
    for _ in range(1, n):
        kb = dist_lib.ring_shift(kb, axis_name)
        vb = dist_lib.ring_shift(vb, axis_name)
        posb, maskb = _hop(posb, axis_name), _hop(maskb, axis_name)
        acc, m, l = _merge_partials(acc, m, l,
                                    *_block_attn(q, kb, vb,
                                                 bias_for(posb, maskb)))
    # a fully masked row keeps m = NEG_INF with l summed from exp(0)
    # terms, so the division is finite; the clamp is a guard
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _seq_block(t: torch.Tensor, n: int, i: int, dim: int = 1):
    T = t.shape[dim]
    return t.narrow(dim, i * (T // n), T // n)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_mask: torch.Tensor, grid=None,
                        causal: bool = False, use_flash: bool = False,
                        positions=None) -> torch.Tensor:
    """Host-callable wrapper: every rank of the seq group holds the whole
    [B, T, H, D] q/k/v and [B, T] keep-mask; each runs ``ring_attention``
    on its block and the blocks are gathered, so every rank returns the
    full [B, T, H, D] output. ``grid`` is the rank grid
    (``distributed.make_grid``; None: the current one, n = 1 without a
    group). T must divide by n.

    positions: optional [T] global position ids (default arange(T)),
    sliced with the tensors. A causal flash call needs the contiguous
    layout (positions arange(T)); any other raises RingLayoutError here,
    at the host."""
    grid = dist_lib.current_grid() if grid is None else grid
    n, sid = grid.n_seq, grid.seq_index
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by seq={n}")
    if positions is None:
        host_pos = np.arange(T)
    else:
        host_pos = np.asarray(positions)
        if host_pos.shape != (T,):
            raise RingLayoutError(f"positions must be [{T}] global ids, "
                                  f"got {host_pos.shape}")
        if causal and use_flash and not np.array_equal(host_pos,
                                                       np.arange(T)):
            raise RingLayoutError(
                "causal flash ring attention requires the contiguous "
                "shard layout: positions must be arange(T) so shard s "
                f"holds [s*{T // n}, (s+1)*{T // n}); got a "
                "non-contiguous layout. Use the dense (use_flash="
                "False) ring for custom position layouts, or call the "
                "raw ring_attention body (which NaN-poisons on "
                "violation) if you know what you are doing")
    pos = torch.as_tensor(host_pos.astype(np.int64), device=q.device)
    out = ring_attention(
        _seq_block(q, n, sid), _seq_block(k, n, sid), _seq_block(v, n, sid),
        _seq_block(pos, n, sid, 0), _seq_block(pos, n, sid, 0),
        _seq_block(pad_mask.float(), n, sid), causal=causal,
        axis_name=SEQ_AXIS, use_flash=use_flash)
    return gather_seq(out, grid)


class _GatherSeq(torch.autograd.Function):
    """The seq group's blocks gathered along dim 0; every rank then holds
    the whole output, so its VJP is this rank's slice of the (equal)
    cotangent."""

    @staticmethod
    def forward(ctx, block, group, index):
        ctx.rows, ctx.index = block.shape[0], index
        return dist_lib.all_gather_cat(block.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None


def gather_seq(block: torch.Tensor, grid=None, dim: int = 1
               ) -> torch.Tensor:
    """Every seq rank's block of ``block`` concatenated along ``dim`` in
    seq order (the reference's out_specs reassembling a seq-sharded
    output), differentiable for a loss every seq rank computes alike;
    the block itself at n = 1."""
    grid = dist_lib.current_grid() if grid is None else grid
    if grid.n_seq == 1:
        return block
    out = _GatherSeq.apply(block.movedim(dim, 0), grid.seq_group,
                           grid.seq_index)
    return out.movedim(0, dim)

