"""The ring all-reduce with a compressed wire (twin of
kubeml_tpu/parallel/collectives.py).

The JAX package builds ``ring_psum`` from ``lax.ppermute`` because a
sub-f32 ``lax.psum`` miscompiles inside a partially-manual shard_map; its
merges take the ring where the mesh keeps inner axes (``use_ring``). The
port keeps the same ring over ranks, hop for hop, so that a merge that
asks for it gives the reference's numbers; no merge of the port asks yet
(``use_ring`` comes with inner mesh axes, ROADMAP A.6/A.12):

  reduce-scatter:  D-1 hops, each rank sending one 1/D chunk in
                   ``wire_dtype`` to rank r+1 and folding the chunk it
                   receives from rank r-1 into its f32 copy;
  all-gather:      D-1 hops circulating the reduced chunks, still in
                   ``wire_dtype``.

Each hop is one batched isend/irecv pair (``distributed.exchange``). The
ring is torch on tensors: no kernel library computes it.
"""

from __future__ import annotations

import torch

from kubeml_tpu_torch.parallel import distributed as dist_lib


def ring_psum(x: torch.Tensor, group=None,
              wire_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks with the wire in
    ``wire_dtype``, accumulating in f32; every rank returns the same
    value, of ``x``'s shape and dtype. At world size 1 (or without a
    group) ``x`` comes back as it is, as the reference's D == 1 ring."""
    if not dist_lib.is_initialized():
        return x
    import torch.distributed as dist

    D = dist.get_world_size(group)
    if D == 1:
        return x
    r = dist.get_rank(group)
    shape, n = x.shape, x.numel()
    pad = (-n) % D
    flat = x.float().reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(D, -1).clone()               # [D, C] f32
    nxt, prv = (r + 1) % D, (r - 1) % D

    # reduce-scatter: at hop s rank r forwards chunk (r - s) mod D, the
    # one it last accumulated, and folds the incoming chunk into
    # (r - s - 1) mod D; after D-1 hops it holds chunk (r + 1) mod D
    # reduced
    for s in range(D - 1):
        recv = dist_lib.exchange(chunks[(r - s) % D].to(wire_dtype),
                                 nxt, prv, group)
        i = (r - s - 1) % D
        chunks[i] = chunks[i] + recv.float()

    # lane identity: the others receive the owned chunk through one
    # wire round trip, so the owner keeps the same rounded value
    own = (r + 1) % D
    chunks[own] = chunks[own].to(wire_dtype).float()

    # all-gather: at hop s rank r sends chunk (r + 1 - s) mod D and
    # stores the incoming one as chunk (r - s) mod D
    for s in range(D - 1):
        recv = dist_lib.exchange(chunks[(r + 1 - s) % D].to(wire_dtype),
                                 nxt, prv, group)
        chunks[(r - s) % D] = recv.float()
    return chunks.reshape(-1)[:n].reshape(shape).to(x.dtype)
