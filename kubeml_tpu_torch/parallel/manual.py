"""Manual tensor and expert parallelism over the rank grid's model and
expert axes (twin of kubeml_tpu/parallel/manual.py).

The JAX package places these collectives by hand inside a fully-manual
shard_map; here the ranks of the grid's model group and expert group
(``distributed.make_grid(n_seq, n_expert, n_model)``) run them, each a
process:

  axis_slice(t, axis, dim)   this rank's contiguous 1/n of ``t`` along
                             ``dim`` (``lax.dynamic_slice_in_dim`` at
                             ``lax.axis_index``); a view, so gradients
                             reach only the rank's own slice;
  tp_heads_dense(...)        the Megatron layers on the model axis, as
  tp_out_dense(...)          functions on the torch layouts (a flax
  tp_column_dense(...)       kernel is the torch weight transposed):
  tp_row_dense(...)          the column layers (q/k/v by heads, the FFN's
                             first Dense by columns) slice the weight's
                             output rows, the row layers (the attention
                             out-projection, the FFN's second Dense) its
                             input columns and sum the partial products
                             over the axis; the outputs are never sliced;
  validate_tp_geometry(...)  the readable refusal of heads or an FFN
                             width that does not divide over the axis;
  ep_partial_ffn(...)        the GShard expert FFN over replicated tokens:
                             every rank of the expert group routes the
                             same tokens, slices its E/n experts out of
                             the replicated weights and of the [T, E, C]
                             dispatch and combine, runs only those
                             experts, combines only their slots, and the
                             sum over the expert axis (``distributed.
                             psum``, whose backward is the same sum)
                             assembles the output;
  ep_alltoall_ffn(...)       the token-sharded GShard FFN: each rank
                             routes its own 1/n of the tokens over every
                             expert (per-shard capacity) and two
                             all-to-alls over the expert group move the
                             slot payloads to their experts' ranks and
                             back (``all_to_all``, differentiable: the
                             transpose of an all-to-all is the same
                             all-to-all); ``all_gather`` then hands every
                             rank the whole token set again.

Rounding, as the reference's layers round: a column layer computes as
the dense ``_dense`` does (the product rounded to the compute dtype, then
the bias); a row layer takes its product with f32 accumulation (the
compute-dtype operands upcast, an f32 product), sums the partials in f32
over the axis, adds the f32 bias once after the sum and rounds to the
compute dtype once. So in bf16 a tensor-parallel block is not the dense
block bit for bit, in the reference either. The f32 product needs f32
matmuls (torch's default; TF32 would round the operands).

The parameters stay whole and replicated in the flax layouts, so
checkpoints, the K-avg merge and ``/infer`` are those of the dense
module; tensor and expert parallelism shard the FLOPs and activations,
not the parameters. Each rank's gradient holds its own slices' part (and
1 / n of what every rank computes alike when each backpropagates 1 / n
of the loss); the engine's sum over the inner group assembles the whole
gradient (``parallel/kavg.py``): every sum's backward is a sum, so no
other collective is needed, not even for the column layers' inputs.

``ep_alltoall_ffn`` serves the pipelined and forward paths only, as the
reference's: its training round refuses ``ep_impl="alltoall"`` (the
models' ``enable_expert_parallel``). The products here are
``F.linear``/``torch.einsum``: the reference computes them outside any
Pallas kernel.
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


def tp_column_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    axis_name: str) -> torch.Tensor:
    """``TPColumnDense``: the output columns of a Dense split over the
    model axis. x [..., in] and w [out, in], b [out] in the compute
    dtype -> this rank's [..., out / n], the product rounded, then the
    bias added (``models/gpt._dense``'s rounding)."""
    return F.linear(x, axis_slice(w, axis_name, 0)) \
        + axis_slice(b, axis_name, 0)


def tp_heads_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   heads: int, axis_name: str) -> torch.Tensor:
    """``TPHeadsDense``: a q/k/v projection on this rank's heads / n
    heads. w [heads * Dh, hidden] (head-major rows) -> [..., heads / n,
    Dh], contiguous."""
    y = tp_column_dense(x, w, b, axis_name)
    return y.unflatten(-1, (heads // dist_lib.axis_size(axis_name), -1))


def tp_row_dense(x_local: torch.Tensor, w: torch.Tensor, b32: torch.Tensor,
                 axis_name: str) -> torch.Tensor:
    """``TPRowDense``: the input rows of a Dense split over the model
    axis. x_local [..., in / n] (this rank's columns of the column layer
    before it) and w [out, in] in the compute dtype, b32 [out] in f32 ->
    [..., out] in the compute dtype, equal on every rank of the axis: the
    f32 product of the upcast operands, summed in f32 over the axis, the
    f32 bias added once, one rounding."""
    part = F.linear(x_local.float(), axis_slice(w, axis_name, 1).float())
    return (dist_lib.psum(part, axis_name) + b32).to(x_local.dtype)


def tp_out_dense(attn_local: torch.Tensor, w: torch.Tensor,
                 b32: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``TPOutDense``: the attention out-projection over this rank's
    heads. attn_local [..., heads / n, Dh], w [hidden, heads * Dh] ->
    [..., hidden] (``tp_row_dense``'s rounding)."""
    return tp_row_dense(attn_local.flatten(-2), w, b32, axis_name)


def validate_tp_geometry(heads: int, ffn: int, n_model: int) -> None:
    """Readable rejection of tensor-parallel factors that do not divide
    (the reference's messages)."""
    if heads % n_model:
        raise ValueError(
            f"{heads} attention heads do not divide over a "
            f"{n_model}-way model axis")
    if ffn % n_model:
        raise ValueError(
            f"FFN width {ffn} does not divide over a "
            f"{n_model}-way model axis")


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


class _AllToAll(torch.autograd.Function):
    """``distributed.all_to_all`` over a group, differentiable: chunk i of
    the gradient goes back to rank i, which is the same all-to-all."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return dist_lib.all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return dist_lib.all_to_all(g.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """Every rank's [T_local, ...] concatenated in rank order (the tiled
    ``lax.all_gather``); its VJP is the reduce-scatter: this rank's rows
    of the gradient summed over the group (every sum's VJP a sum, as
    ``distributed.psum``)."""

    @staticmethod
    def forward(ctx, t, group, index):
        ctx.group, ctx.index, ctx.rows = group, index, t.shape[0]
        return dist_lib.all_gather_cat(t, group)

    @staticmethod
    def backward(ctx, g):
        g = dist_lib.all_reduce(g.contiguous(), group=ctx.group)
        return g[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], \
            None, None


def all_to_all(t: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The differentiable all-to-all of a [n, ...] tensor over the grid
    axis ``axis_name``: chunk i goes to rank i of the axis, and chunk i
    of the result came from it. The identity at axis size 1."""
    if dist_lib.axis_size(axis_name) == 1:
        return t
    return _AllToAll.apply(t.contiguous(), dist_lib.axis_group(axis_name))


def all_gather(t: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in the axis's rank
    order, differentiable. The identity at axis size 1."""
    if dist_lib.axis_size(axis_name) == 1:
        return t
    return _AllGather.apply(t.contiguous(), dist_lib.axis_group(axis_name),
                            dist_lib.axis_index(axis_name))


def ep_alltoall_ffn(wi: torch.Tensor, bi: torch.Tensor, wo: torch.Tensor,
                    bo: torch.Tensor, dispatch: torch.Tensor,
                    combine: torch.Tensor, x: torch.Tensor, axis_name: str,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The token-sharded GShard FFN over the expert axis ``axis_name``
    (the reference's ``ep_alltoall_ffn``). x [T_local, D] is this rank's
    token shard, routed locally over every expert (dispatch/combine
    [T_local, E, C_local], per-shard capacity); the weights are whole and
    this rank runs its E/n experts. Exchange 1 sends expert block j of
    the slot payloads [E, C_local, D] to rank j and stacks what every
    rank sent along the capacity axis, [E/n, n·C_local, D] with rank j's
    slots at block j (the reference's tiled ``lax.all_to_all``, split
    axis 0, concat axis 1); exchange 2 is its inverse. Returns y_local
    [T_local, D]: the rank's own tokens, every slot back home."""
    n = dist_lib.axis_size(axis_name)
    wi = axis_slice(wi, axis_name, 0).to(dtype)              # [E/n, D, F]
    bi = axis_slice(bi, axis_name, 0).to(dtype)
    wo = axis_slice(wo, axis_name, 0).to(dtype)
    bo = axis_slice(bo, axis_name, 0).to(dtype)
    e, c, d = dispatch.shape[1], dispatch.shape[2], x.shape[1]
    # this rank's slot payloads for every expert, expert-major
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype),
                             x.to(dtype))                    # [E, Cl, D]
    got = all_to_all(expert_in.reshape(n, e // n, c, d), axis_name)
    recv = got.transpose(0, 1).reshape(e // n, n * c, d)    # block j: rank j
    h = F.gelu(torch.einsum("ecd,edf->ecf", recv, wi) + bi[:, None, :],
               approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, wo) + bo[:, None, :]
    # capacity block j back to rank j; the expert blocks come back
    # rank-major, which is global expert order
    back = all_to_all(out.reshape(e // n, n, c, d).transpose(0, 1),
                      axis_name).reshape(e, c, d)
    return torch.einsum("tec,ecd->td", combine.to(dtype), back)
