"""GPipe pipeline parallelism over the rank grid's stage axis (twin of
kubeml_tpu/parallel/pp.py).

The JAX package runs the pipeline as one SPMD program under
``shard_map``: every stage applies its block at every clock tick and
``ppermute``s the result one hop to its successor, M microbatches
draining in M + P - 1 ticks; ``jax.grad`` differentiates through the
ticks. Here the P ranks of a stage group (``distributed.make_grid(...,
n_stage=P)``) are the stages, each a process holding its own layers'
parameters (sliced out of the whole, replicated parameters, as the
reference slices them), and the hops are ``distributed.ring_shift``'s
exchanges.

  pipeline_lane(...)      the per-stage GPipe body: stage 0 takes in
                          microbatch t at tick t, stage s chews
                          microbatch t - s (with its per-microbatch
                          consts), and the last stage's outputs are
                          handed to every stage by a sum over the stage
                          axis of zeros elsewhere (``distributed.psum``);
                          with ``has_aux`` the stages' scalar aux of
                          every real tick is summed the same way;
  pipeline_apply(...)     stage-stacked parameters, each rank taking its
                          stage's slice, then ``pipeline_lane``;
  sequential_apply(...)   the same chain without pipelining, in one
                          process: every microbatch through every stage
                          in turn (the models' trunk without a stage
                          axis);
  stack_stage_params(...) per-stage parameter trees stacked on a leading
                          [P] dim.

The port decides on the host what the reference selects away (as
``parallel/kavg.py`` does for masked steps): on a fill or drain tick,
whose output never reaches the collected window, a stage computes
nothing and sends zeros on, and its aux is not there to mask. The hops
stay in lockstep, so every rank's batched isend/irecv pairs match: each
tick but the last ends with one hop on every stage (the last tick's hop
carries nothing any stage reads).

The backward runs the schedule in reverse, explicitly: autograd cannot
keep the ranks in lockstep through hops whose outputs a rank does not
read (stage 0 never reads what the last stage sends it). The lane is one
autograd function whose forward keeps each real tick's graph (its input
and the stage's output) and whose backward walks the ticks from the
last: one hop back of the gradients a tick but the last (the VJP of the
forward's hop: each stage sends its input's gradient to its
predecessor), then each real tick's VJP on its saved graph, which gives
the stage parameters' gradients and its input's. The trunk's cotangent
reaches the last stage whole through the closing sum's VJP (a sum over
the stage group), and the embedding's gradient comes out of stage 0
alone; the other stages' layers get no gradient on a rank (the K-avg
engine's inner-group sum adds them as zeros).

What one local step costs a stage rank, with M microbatches over P
stages of L/P layers: the stage function runs M times forward and M
times backward (the flash kernels #2, #3 and #4 M·L/P times each for a
transformer trunk); 2·(M + P - 2) hops (exchanges), M + P - 2 each way;
one all-reduce of the outputs forward and one of their gradients
backward, and one more each way for the aux with ``has_aux``. A stage
axis of 1 runs the same schedule with no exchange and no all-reduce.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel.distributed import STAGE_AXIS

PyTree = Any
# stage_fn(stage_params, activation [B, ...][, const]) -> activation
#   (or -> (activation, aux scalar) with has_aux=True)
StageFn = Callable[..., Any]


def _flatten(tree: PyTree) -> List[torch.Tensor]:
    """The tensor leaves of a tree of dicts, lists and tuples, in order
    (anything else is kept as it is, not a leaf)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flatten(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flatten(v)]
    return []


def _unflatten(tree: PyTree, leaves) -> PyTree:
    """``tree`` with its tensor leaves replaced, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return tree


def _tree_map(fn, *trees: PyTree) -> PyTree:
    """``fn`` over the tensor leaves of trees of one structure."""
    columns = zip(*(_flatten(t) for t in trees))
    return _unflatten(trees[0], iter([fn(*c) for c in columns]))


def stack_stage_params(params_list: Sequence[PyTree]) -> PyTree:
    """Stack per-stage parameter trees (one structure, equal leaf shapes)
    on a new leading [P] dim."""
    return _tree_map(lambda *xs: torch.stack(xs), *params_list)


def _at(tree: PyTree, i: int) -> PyTree:
    """Index i of every leaf of a tree with a leading dim (tensors, or
    lists of per-microbatch values)."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_at(v, i) for v in tree)
    return tree[i]


def _call(stage_fn, params, act, consts, j, has_aux):
    """(output, aux or None) of the stage on microbatch j."""
    out = stage_fn(params, act) if consts is None \
        else stage_fn(params, act, _at(consts, j))
    return out if has_aux else (out, None)


def _chews(t: int, sid: int, m: int):
    """The microbatch stage ``sid`` chews at tick t, or None on a fill or
    drain tick, where the port computes nothing (the reference computes
    on the clipped microbatch and masks the aux away)."""
    j = t - sid
    return j if 0 <= j < m else None


def _hop(x: torch.Tensor, offset: int) -> torch.Tensor:
    """One hop around the stage axis, outside autograd: to s + offset,
    from s - offset."""
    with torch.no_grad():
        return dist_lib.ring_shift(x, STAGE_AXIS, offset)


def _ticks(spec, xs: torch.Tensor, leaves, record: bool):
    """The stage's forward ticks: (this stage's [M, ...] outputs, zeros
    but on the last stage; the aux sum of its real ticks; each real
    tick's (input, output, aux) by microbatch and the stage's parameter
    leaves as the graphs were recorded on, when ``record``)."""
    stage_fn, tree, consts, has_aux = spec
    n = dist_lib.axis_size(STAGE_AXIS)
    sid = dist_lib.axis_index(STAGE_AXIS)
    m = xs.shape[0]
    local = [t.detach().requires_grad_(t.requires_grad) for t in leaves] \
        if record else list(leaves)
    params = _unflatten(tree, iter(local))
    ys = torch.zeros_like(xs)
    aux_sum = torch.zeros((), device=xs.device)
    saved = {}
    act = torch.zeros_like(xs[0])
    for t in range(m + n - 1):
        j = _chews(t, sid, m)
        sent = None
        if j is not None:
            inp = xs[j] if sid == 0 else act
            if record:
                inp = inp.detach().requires_grad_(xs.requires_grad
                                                  or sid > 0)
            with torch.set_grad_enabled(record):
                out, aux = _call(stage_fn, params, inp, consts, j, has_aux)
            if record:
                saved[j] = (inp, out, aux)
            if has_aux:
                aux_sum = aux_sum + aux.detach().float()
            sent = out.detach()
            if sid == n - 1:
                ys[j] = sent
        if t < m + n - 2:
            act = _hop(torch.zeros_like(xs[0]) if sent is None else sent, 1)
    return ys, aux_sum, saved, local


class _Lane(torch.autograd.Function):
    """The stage's ticks (``_ticks``) as one autograd function over xs and
    the stage's parameter leaves; its backward runs them in reverse
    (module docstring)."""

    @staticmethod
    def forward(ctx, spec, xs, *leaves):
        ys, aux_sum, ctx.saved, ctx.local = _ticks(spec, xs, leaves, True)
        ctx.has_aux = spec[3]
        ctx.xs_grad = xs.requires_grad
        ctx.like = xs[0]
        return ys, aux_sum

    @staticmethod
    def backward(ctx, g_ys, g_aux):
        n = dist_lib.axis_size(STAGE_AXIS)
        sid = dist_lib.axis_index(STAGE_AXIS)
        like, local = ctx.like, ctx.local
        m = g_ys.shape[0]
        wants = [i for i, t in enumerate(local) if t.requires_grad]
        g_leaves: list = [None] * len(local)
        g_xs = torch.zeros_like(g_ys) if ctx.xs_grad and sid == 0 \
            else None
        g_next = torch.zeros_like(like)       # the received input's grad
        for t in reversed(range(m + n - 1)):
            # the VJP of tick t's hop: the gradient of what this stage
            # sent, back from its successor, for what it received
            g_out = _hop(g_next, -1) if t < m + n - 2 else None
            g_next = torch.zeros_like(like)
            j = _chews(t, sid, m)
            if j is None:
                continue
            inp, out, aux = ctx.saved.pop(j)
            if sid == n - 1:
                # the last stage's outputs are the window; what it sent
                # on went to stage 0, which never read it
                g_out = g_ys[j]
            outs, grads = [out], [g_out.to(out.dtype)]
            if ctx.has_aux:
                outs.append(aux)
                grads.append(g_aux.to(aux.dtype).reshape(aux.shape))
            first = [inp] if inp.requires_grad else []
            got = torch.autograd.grad(outs, first + [local[i] for i in wants],
                                      grads, allow_unused=True)
            if first and got[0] is not None:
                if sid == 0:
                    g_xs[j] = got[0]
                else:
                    g_next = got[0].to(like.dtype)
            for i, g in zip(wants, got[len(first):]):
                if g is not None:
                    g_leaves[i] = g if g_leaves[i] is None \
                        else g_leaves[i] + g
        del ctx.saved, ctx.local
        return (None, g_xs, *g_leaves)


def pipeline_lane(stage_fn: StageFn, local_params: PyTree, xs: torch.Tensor,
                  has_aux: bool = False, consts: PyTree = None):
    """The per-stage GPipe body over the current grid's stage axis (the
    module docstring): ``local_params`` this stage's parameters (their
    tensor leaves differentiable), ``xs`` [M, B, ...] microbatches, the
    same on every stage; ``consts`` a tree of per-microbatch values with
    a leading [M] (pad masks, dropout keys), of which stage s at tick t
    gets index t - s and ``stage_fn`` is called as stage_fn(params, act,
    const). Every stage maps an activation to one of the same shape and
    dtype. Returns (outputs [M, B, ...], aux sum) equal on every stage;
    the aux sum is 0.0 unless ``has_aux``."""
    leaves = _flatten(local_params)
    spec = (stage_fn, local_params, consts, has_aux)
    if torch.is_grad_enabled() and (xs.requires_grad or any(
            t.requires_grad for t in leaves)):
        ys, aux = _Lane.apply(spec, xs, *leaves)
    else:
        ys, aux = _ticks(spec, xs, leaves, False)[:2]
    # zeros but on the last stage, summed: the outputs on every stage
    ys = dist_lib.psum(ys, STAGE_AXIS)
    if has_aux:
        aux = dist_lib.psum(aux, STAGE_AXIS)
    return ys, aux


def pipeline_apply(stage_fn: StageFn, stage_params: PyTree, x: torch.Tensor,
                   has_aux: bool = False, consts: PyTree = None):
    """x [M, B, ...] through P stages with microbatch pipelining over the
    current grid's stage axis. ``stage_params``: every leaf stacked [P,
    ...] (``stack_stage_params``), P the axis size; each rank takes its
    stage's slice. Returns [M, B, ...] outputs (and the aux sum with
    ``has_aux``), the same on every stage."""
    n_stage = dist_lib.axis_size(STAGE_AXIS)
    for leaf in _flatten(stage_params):
        if leaf.shape[0] != n_stage:
            raise ValueError(
                f"stage_params stack {leaf.shape[0]} stages but the grid's "
                f"stage axis is {n_stage}; they must match")
    sid = dist_lib.axis_index(STAGE_AXIS)
    ys, aux = pipeline_lane(stage_fn, _tree_map(lambda p: p[sid],
                                                stage_params),
                            x, has_aux=has_aux, consts=consts)
    return (ys, aux) if has_aux else ys


def sequential_apply(stage_fn: StageFn, stage_params: PyTree,
                     x: torch.Tensor, has_aux: bool = False,
                     consts: PyTree = None):
    """The same chain with no pipelining, in one process: every leaf of
    ``stage_params`` [P, ...], x [M, B, ...]; microbatch j runs through
    stages 0..P-1 in turn (with ``consts``' index j, as
    ``pipeline_lane``). Returns [M, B, ...] (and the aux summed over
    every (microbatch, stage) with ``has_aux``)."""
    n_stage = _flatten(stage_params)[0].shape[0]
    outs, aux_sum = [], torch.zeros((), device=x.device)
    for j in range(x.shape[0]):
        act = x[j]
        for s in range(n_stage):
            params = _tree_map(lambda q: q[s], stage_params)
            act, aux = _call(stage_fn, params, act, consts, j, has_aux)
            if has_aux:
                aux_sum = aux_sum + aux.float()
        outs.append(act)
    ys = torch.stack(outs)
    return (ys, aux_sum) if has_aux else ys
