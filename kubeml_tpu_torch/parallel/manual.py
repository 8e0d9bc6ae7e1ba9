"""Manual expert parallelism over the rank grid's expert axis (twin of
the expert half of kubeml_tpu/parallel/manual.py).

The JAX package places these collectives by hand inside a fully-manual
shard_map; here the ranks of the grid's expert group
(``distributed.make_grid(..., n_expert)``) run them, each a process:

  axis_slice(t, axis, dim)   this rank's contiguous 1/n of ``t`` along
                             ``dim`` (``lax.dynamic_slice_in_dim`` at
                             ``lax.axis_index``); a view, so gradients
                             reach only the rank's own slice;
  ep_partial_ffn(...)        the GShard expert FFN over replicated tokens:
                             every rank of the expert group routes the
                             same tokens, slices its E/n experts out of
                             the replicated weights and of the [T, E, C]
                             dispatch and combine, runs only those
                             experts, combines only their slots, and the
                             sum over the expert axis (``distributed.
                             psum``, whose backward is the same sum)
                             assembles the output.

The parameters stay whole and replicated in the flax layouts, so
checkpoints, the K-avg merge and ``/infer`` are those of the dense
module; expert parallelism shards the experts' FLOPs and activations,
not their parameters. Each rank's gradient holds its own experts' part
(and 1 / n of what every rank computes alike when each backpropagates
1 / n of the loss); the engine's sum over the inner group assembles the
whole gradient (``parallel/kavg.py``).

The reference's tensor-parallel layers (``TPHeadsDense`` and its kin) and
its token-sharded ``ep_alltoall_ffn``, which serves the pipelined and
forward paths only (its training round refuses ``ep_impl="alltoall"``),
come with ROADMAP A.12. The expert products are ``torch.einsum``: the
reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubeml_tpu_torch.parallel import distributed as dist_lib


def axis_slice(t: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """This rank's contiguous shard of ``t`` along ``dim`` over the grid
    axis ``axis_name`` (the dimension must divide evenly; callers check
    it with a readable error)."""
    size = t.shape[dim] // dist_lib.axis_size(axis_name)
    return t.narrow(dim, dist_lib.axis_index(axis_name) * size, size)


def ep_partial_ffn(wi: torch.Tensor, bi: torch.Tensor, wo: torch.Tensor,
                   bo: torch.Tensor, dispatch: torch.Tensor,
                   combine: torch.Tensor, x: torch.Tensor, axis_name: str,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The expert-sharded GShard FFN over the expert axis ``axis_name``.
    Every argument is whole (the routing computed alike on every rank of
    the axis from the same tokens): wi [E, D, F], bi [E, F], wo [E, F, D],
    bo [E, D], dispatch/combine [T, E, C] (``parallel/ep.make_dispatch``),
    x [T, D]. Computes in ``dtype``; GELU is the tanh approximation.
    Returns y [T, D], equal on every rank of the axis."""
    wi = axis_slice(wi, axis_name, 0).to(dtype)
    bi = axis_slice(bi, axis_name, 0).to(dtype)
    wo = axis_slice(wo, axis_name, 0).to(dtype)
    bo = axis_slice(bo, axis_name, 0).to(dtype)
    disp = axis_slice(dispatch, axis_name, 1).to(dtype)
    comb = axis_slice(combine, axis_name, 1).to(dtype)

    expert_in = torch.einsum("tec,td->ecd", disp, x.to(dtype))
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, wi) + bi[:, None, :],
               approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, wo) + bo[:, None, :]
    y_part = torch.einsum("tec,ecd->td", comb, out)
    return dist_lib.psum(y_part, axis_name)
