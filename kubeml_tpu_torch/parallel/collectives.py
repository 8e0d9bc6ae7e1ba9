"""The ring all-reduce with a compressed wire (twin of
kubeml_tpu/parallel/collectives.py).

The JAX package builds ``ring_psum`` from ``lax.ppermute`` because a
sub-f32 ``lax.psum`` miscompiles inside a partially-manual shard_map; its
merges take the ring where the mesh keeps inner axes AUTO (``use_ring``:
the GSPMD expert axis without a seq axis). The port keeps the same ring
over the lanes, hop for hop, so that a merge that asks for it gives the
reference's numbers (``parallel/merge.py`` on a rank grid with an expert
axis and no seq round):

  reduce-scatter:  D-1 hops, each lane sending one 1/D chunk in
                   ``wire_dtype`` to lane d+1 and folding the chunk it
                   receives from lane d-1 into its f32 copy;
  all-gather:      D-1 hops circulating the reduced chunks, still in
                   ``wire_dtype``.

The lanes are laid out over the ranks of a group in lane order, each
rank holding a run of them (``lane_ring_psum``'s leading axis): a hop
between two lanes of one rank is a copy, and the hop from a rank's last
lane to the next rank's first is one batched isend/irecv pair
(``distributed.exchange``). ``ring_psum`` is the ring of one lane a rank.
The ring is torch on tensors: no kernel library computes it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubeml_tpu_torch.parallel import distributed as dist_lib


def ring_psum(x: torch.Tensor, group=None,
              wire_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks with the wire in
    ``wire_dtype``, accumulating in f32; every rank returns the same
    value, of ``x``'s shape and dtype. At world size 1 (or without a
    group) ``x`` comes back as it is, as the reference's D == 1 ring."""
    if _ranks(group)[0] == 1:
        return x
    return lane_ring_psum(x[None], group, wire_dtype)


def _ranks(group) -> tuple:
    """(world size, this rank) of the group; (1, 0) without one."""
    if not dist_lib.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def lane_ring_psum(x: torch.Tensor, group=None,
                   wire_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The ring sum over every lane of ``x`` [D_local, ...]: this rank's
    lanes of a ring of D = D_local x world lanes in lane order (rank r
    holding lanes r x D_local onwards; every rank of the group holds as
    many). Returns the sum [...] in ``x``'s dtype, the same on every
    lane and rank; one lane in all gives that lane as it is."""
    R, r = _ranks(group)
    Dl = x.shape[0]
    D, first = R * Dl, r * Dl
    if D == 1:
        return x[0]
    shape, n = x.shape[1:], x[0].numel()
    pad = (-n) % D
    flat = x.float().reshape(Dl, -1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(Dl, pad)], dim=1)
    chunks = flat.reshape(Dl, D, -1).clone()          # [Dl, D, C] f32

    def hop(sent):
        """One hop: local lane j sends its chunk sent(global lane) to the
        next lane; returns what each local lane receives, in wire_dtype
        (the first from the previous rank's last lane)."""
        sends = [chunks[j, sent(first + j) % D].to(wire_dtype)
                 for j in range(Dl)]
        into_first = sends[-1] if R == 1 else dist_lib.exchange(
            sends[-1], (r + 1) % R, (r - 1) % R, group)
        return [into_first] + sends[:-1]

    # reduce-scatter: at hop s lane g forwards chunk (g - s) mod D, the
    # one it last accumulated, and folds the incoming chunk into
    # (g - s - 1) mod D; after D-1 hops it holds chunk (g + 1) mod D
    # reduced
    for s in range(D - 1):
        recv = hop(lambda g: g - s)
        for j in range(Dl):
            i = (first + j - s - 1) % D
            chunks[j, i] = chunks[j, i] + recv[j].float()

    # lane identity: the others receive the owned chunk through one wire
    # round trip, so the owner keeps the same rounded value
    for j in range(Dl):
        own = (first + j + 1) % D
        chunks[j, own] = chunks[j, own].to(wire_dtype).float()

    # all-gather: at hop s lane g sends chunk (g + 1 - s) mod D and stores
    # the incoming one as chunk (g - s) mod D
    for s in range(D - 1):
        recv = hop(lambda g: g + 1 - s)
        for j in range(Dl):
            chunks[j, (first + j - s) % D] = recv[j].float()
    return chunks[0].reshape(-1)[:n].reshape(shape).to(x.dtype)
