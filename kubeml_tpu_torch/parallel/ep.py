"""GShard top-k routing and the expert FFN on one device (twin of the
dispatch/combine half of kubeml_tpu/parallel/ep.py).

Routing is the dense one-hot formulation: ``make_dispatch`` gives a
[T, E, C] 0/1 dispatch tensor and its combine weights, and ``moe_apply``
runs every expert over its C slots with einsums — static shapes, no
gather or scatter. Each expert takes at most C = ceil(T / E *
capacity_factor) tokens a call, slots filling in token order; an
overflow token gets no slot and a zero combine weight. The load-balance
loss is Shazeer et al.'s E * sum_e(fraction routed to e * mean prob of
e), over the first choices of the real tokens.

``moe_apply`` runs every expert on one device. Over the rank grid's
expert axis the same ``route_tokens`` preamble feeds
``parallel/manual.ep_partial_ffn``, which runs a rank's share of the
experts: the one manual path stands for both of the reference's routes
(its GSPMD ``mesh`` argument with its placement rules ``EP_RULES``, and
its manual ``ep_axis``). A JAX ``Mesh`` has no counterpart in the port
(ROADMAP C.13).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def make_dispatch(logits: torch.Tensor, capacity: int, k: int = 2,
                  token_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity.

    logits [T, E] -> (dispatch [T, E, C] 0/1, combine [T, E, C], aux
    scalar). A token goes to at most k experts; within an expert, slots
    fill in token order (GShard's cumsum positions) and overflow drops.
    token_mask [T] (1 = real) keeps masked tokens out of routing, of the
    capacity and of the load-balance statistics. A masked row chooses
    expert 0 (the first maximum of an all-zero row) with weight 0.

    The slot positions come from a float cumsum (exact at these counts).
    A position past the capacity drops: the reference's one_hot of it is
    a zero row, here the slot index is clamped and what lands there is
    ``keep``, which is 0. The k choices of a token claim distinct
    (expert, slot) cells, so combine, the reference's sum over the
    choices of dispatch x probs, is dispatch x probs; the dispatch itself
    carries no gradient (argmax and one_hot have none in the reference).
    """
    t, e = logits.shape
    k = min(k, e)
    probs = torch.softmax(logits, dim=-1)
    valid = (torch.ones(t, dtype=logits.dtype, device=logits.device)
             if token_mask is None else token_mask.to(logits.dtype))
    with torch.no_grad():
        dispatch = torch.zeros(t, e, capacity, dtype=logits.dtype,
                               device=logits.device)
        masked = probs * valid[:, None]
        fill = torch.zeros(e, dtype=logits.dtype, device=logits.device)
        for _ in range(k):
            choice = torch.argmax(masked, dim=-1)                    # [T]
            onehot = F.one_hot(choice, e).to(logits.dtype) \
                * valid[:, None]                                     # [T, E]
            pos = (torch.cumsum(onehot, dim=0) - 1) * onehot
            pos = pos + fill[None, :] * onehot
            keep = onehot * (pos < capacity)
            # dispatch[t, e, pos] += keep: a cell takes one 1 at most
            slot = pos.long().clamp(max=capacity - 1)
            dispatch.scatter_add_(2, slot[..., None], keep[..., None])
            fill += keep.sum(dim=0)
            masked = masked * (1.0 - onehot)  # the next choice skips it
    combine = dispatch * probs[..., None]

    # load balance over the FIRST choice, statistics over real tokens
    n_valid = torch.clamp(valid.sum(), min=1.0)
    first = F.one_hot(torch.argmax(probs, dim=-1), e).to(logits.dtype) \
        * valid[:, None]
    aux = e * torch.sum((first.sum(dim=0) / n_valid)
                        * ((probs * valid[:, None]).sum(dim=0) / n_valid))
    return dispatch, combine, aux


def route_tokens(router: torch.Tensor, x: torch.Tensor, *, k: int = 2,
                 capacity_factor: float = 1.25,
                 token_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing preamble: the f32 router product, the capacity formula
    and ``make_dispatch``. x [T, d_model], router [d_model, E] ->
    (dispatch [T, E, C], combine [T, E, C], aux)."""
    t = x.shape[0]
    e = router.shape[1]
    capacity = max(1, math.ceil((t / e) * capacity_factor))
    logits = x.float() @ router.float()
    return make_dispatch(logits, capacity, k, token_mask=token_mask)


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              k: int = 2, capacity_factor: float = 1.25,
              token_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer over tokens x [T, d_model] -> (y [T, d_model],
    aux). ``params``: router [D, E], wi [E, D, F], bi [E, F], wo [E, F, D],
    bo [E, D] (the flax layouts). Routing, its softmax and the aux
    statistics run in f32; the expert products in x's dtype, the
    parameters cast to it; GELU is the tanh approximation (jax.nn.gelu's
    default). An empty slot gets the biases too, and a zero combine
    weight."""
    dispatch, combine, aux = route_tokens(
        params["router"], x, k=k, capacity_factor=capacity_factor,
        token_mask=token_mask)
    cdt = x.dtype
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(cdt), x)
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, params["wi"].to(cdt))
               + params["bi"].to(cdt)[:, None, :], approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, params["wo"].to(cdt)) \
        + params["bo"].to(cdt)[:, None, :]
    y = torch.einsum("tec,ecd->td", combine.to(cdt), out)
    return y, aux
