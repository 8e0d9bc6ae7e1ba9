"""Data lanes as ``torch.distributed`` ranks (twin of
kubeml_tpu/parallel/distributed.py).

The JAX package scales out with JAX's multi-controller runtime: every
process runs the same program, ``jax.distributed`` forms the cluster, and
the K-avg merge is one psum over a ``data`` mesh axis that spans every
process. Here every process (a rank) runs the same program too,
``torch.distributed`` forms the group, and the ``data`` axis is laid out
over the ranks: each rank runs the workers of its own lanes, and the
cross-lane sums of the merge become all-reduces across ranks
(``parallel/merge.py``, ``parallel/kavg.py``).

  initialize(...)   join (or bootstrap) the group through the same
                    ``KUBEML_*`` environment contract as the JAX package
                    (``tools/launch_distributed.py`` sets it); explicit
                    arguments win. With no arguments and no cluster
                    environment it is a quiet single-process no-op; a
                    failed join with arguments, or with a cluster
                    environment present, raises (N independent copies
                    of a model would be wrong results, not a degraded
                    service).
  lane_layout(D)    D lanes over the ranks, slice-major as the JAX
                    package's ``make_multislice_mesh`` orders its data
                    axis: lane d on rank d // (D / world).
  rank_device(...)  a rank's device: ``cuda:(rank % device_count)``
                    through ``_device.resolve_device`` (which raises
                    without a card unless the caller asks for the CPU).

The backend follows the device the caller resolved: NCCL for CUDA, gloo
for the CPU. ``backend="gloo"`` on CUDA is allowed (two ranks on one
card: NCCL refuses two ranks on one device). There is never a quiet
switch from one backend to the other: a failed NCCL join raises.

The collective helpers below (``all_reduce``, ``all_gather_cat``,
``reduce_scatter``, ``all_gather_into``, ``barrier``, ``exchange``) are
what the engines and the job call. Each is the identity at world size 1
without a group, and each adds one to its ``calls`` count where it
issues a collective. The gloo backend takes CUDA tensors for the
all-reduce, the all-gather, ``reduce_scatter_tensor``,
``all_gather_into_tensor`` and ``all_to_all_single`` (chip_smoke.py
phases 23, 24 and 25 try each directly); for the point-to-point
exchange of the rings (``parallel/collectives.py``,
``parallel/ring_attention.py``) ``exchange`` moves CUDA tensors through
the host on gloo: the named path, never a silent one.

The rank grid (``make_grid``) lays the ranks out as the JAX package's
mesh lays out its devices (``kubeml_tpu/parallel/mesh.py``: ``data``
outermost, then ``model``, ``seq``, ``stage`` and ``expert``): with
n_inner = n_model * n_seq * n_stage * n_expert, global rank r has data
index r // n_inner, model index (r // (n_seq * n_stage * n_expert)) %
n_model, seq index (r // (n_stage * n_expert)) % n_seq, stage index
(r // n_expert) % n_stage and expert index r % n_expert (at n_stage = 1,
the ranks and groups of a (data x model x seq x expert) grid, made in
the same order). The n_inner ranks of one data index are its inner group: they run
the same lane's workers. Each axis's group holds the ranks that differ
along that axis alone: the model group carries tensor parallelism's
row-layer sums, the seq group sequence parallelism's ring hops,
all-to-alls and sums, the stage group the pipeline's activation hops and
its closing sum (``parallel/pp.py``), the expert group the expert FFN's
sum or all-to-alls, and the data group (one index on every inner axis)
the lane merge. ``axis_size``/``axis_index``/``axis_group`` answer for
the model, seq, stage and expert axes of the installed grid as
``lax.axis_size``/``lax.axis_index`` answer inside a shard_map: without
a grid (or a group) an axis has size 1, and the collectives over it are
identities.
``all_to_all`` is counted; ``psum`` is the differentiable sum over an
axis (its backward is the same sum) and ``ring_shift`` the
differentiable ring hop (its backward sends the gradient back the other
way).
"""

from __future__ import annotations

import atexit
import datetime
import itertools
import logging
import math
import os
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from kubeml_tpu_torch._device import DeviceLike, resolve_device

logger = logging.getLogger("kubeml_tpu_torch.distributed")

# Every environment family that can make a process believe it belongs to
# a cluster (a copy of the JAX package's tuple): the launcher's own
# variables plus every family the JAX package auto-detects. The PS strips
# them from standalone job children (control/ps.py): a child inheriting
# its parent's rank re-joins the parent's group and hangs it.
CLUSTER_ENV_VARS = (
    "KUBEML_COORDINATOR_ADDRESS", "KUBEML_NUM_PROCESSES",
    "KUBEML_PROCESS_ID",
    "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
    "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
    "MEGASCALE_SLICE_ID",
    "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
    "SLURM_NTASKS", "SLURM_PROCID", "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
)

def _cluster_env_present() -> bool:
    """True when the environment declares a MULTI-process cluster (a copy
    of the JAX package's rule). A failed join must then raise. Single-host
    values (TPU_WORKER_HOSTNAMES=localhost) do not count."""
    if os.environ.get("JAX_COORDINATOR_ADDRESS") \
            or os.environ.get("MEGASCALE_COORDINATOR_ADDRESS") \
            or os.environ.get("KUBEML_COORDINATOR_ADDRESS"):
        return True
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        return True
    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that runs the control plane and writes what
    one process must write (rank 0); every rank is one without a group."""
    return rank() == 0


def rank_device(device: DeviceLike = None,
                rank_: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` for CUDA (the
    default), the CPU when asked for; raises without a card unless the
    CPU is asked for (``_device.resolve_device``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)            # raises without a CUDA device
        r = rank() if rank_ is None else rank_
        dev = torch.device("cuda", r % torch.cuda.device_count())
    return resolve_device(dev)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device: DeviceLike = None,
               timeout: Optional[float] = None) -> None:
    """Join the process group (idempotent).

    The ``KUBEML_COORDINATOR_ADDRESS`` / ``KUBEML_NUM_PROCESSES`` /
    ``KUBEML_PROCESS_ID`` variables fill the arguments not given; the
    coordinator (``host:port``) is rank 0's TCP store
    (``init_method="tcp://host:port"``). ``backend`` None follows
    ``device`` (None = CUDA: NCCL, with this rank's card made current;
    ``"cpu"``: gloo). ``timeout`` (seconds) bounds the join and every
    collective (torch's default otherwise: 30 minutes for gloo).

    With no arguments and no cluster environment this returns quietly:
    a single-process run. A join that fails with arguments, or with a
    cluster environment present, raises.
    """
    if is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("KUBEML_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("KUBEML_NUM_PROCESSES"):
        num_processes = int(os.environ["KUBEML_NUM_PROCESSES"])
    if process_id is None and os.environ.get("KUBEML_PROCESS_ID"):
        process_id = int(os.environ["KUBEML_PROCESS_ID"])
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        if _cluster_env_present():
            raise RuntimeError(
                "the environment declares a multi-process cluster "
                "(CLUSTER_ENV_VARS) but not the KUBEML_COORDINATOR_ADDRESS"
                " / KUBEML_NUM_PROCESSES / KUBEML_PROCESS_ID this "
                "runtime joins by; refusing to train alone")
        logger.info("single-process run (no cluster arguments or "
                    "environment)")
        return
    if any(v is None for v in given):
        raise ValueError(
            "joining a group needs a coordinator address, a process count "
            f"and a process id (got {given})")
    dev = rank_device(device, int(process_id))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    atexit.register(shutdown)
    logger.info("joined group: rank %d/%d over %s on %s", rank(),
                world_size(), backend, dev)


def shutdown() -> None:
    """Destroy the process group (at exit, or by the caller), and with it
    the rank grids made over it."""
    global _grid
    if is_initialized():
        dist.destroy_process_group()
    _GRIDS.clear()
    _grid = None


# ------------------------------------------------------------ lane layout

@dataclass(frozen=True)
class LaneLayout:
    """D data lanes over ``world`` ranks, slice-major: rank r holds lanes
    [r * per_rank, (r + 1) * per_rank)."""
    n_lanes: int
    world: int
    rank: int

    @property
    def per_rank(self) -> int:
        return self.n_lanes // self.world

    @property
    def first_lane(self) -> int:
        return self.rank * self.per_rank

    @property
    def local_lanes(self) -> range:
        return range(self.first_lane, self.first_lane + self.per_rank)

    def rank_of(self, lane: int) -> int:
        return lane // self.per_rank


def lane_layout(n_lanes: int, world: Optional[int] = None,
                rank_: Optional[int] = None) -> LaneLayout:
    """The layout of ``n_lanes`` over the group (the current one by
    default); D must be a multiple of the world size."""
    world = world_size() if world is None else int(world)
    rank_ = rank() if rank_ is None else int(rank_)
    if n_lanes < 1 or n_lanes % world:
        raise ValueError(f"{n_lanes} lanes cannot be laid out over "
                         f"{world} ranks (lanes % world must be 0)")
    return LaneLayout(int(n_lanes), world, rank_)


# -------------------------------------------------------------- rank grid

MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"
# the mesh's axis order, data outermost (kubeml_tpu/parallel/mesh.py)
GRID_AXES = ("data", MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, EXPERT_AXIS)


@dataclass(frozen=True)
class RankGrid:
    """The ranks as a (data x model x seq x stage x expert) grid, data
    outermost and expert innermost (module docstring). ``model_group``,
    ``seq_group``, ``stage_group`` and ``expert_group`` hold the ranks
    that differ from this one along that axis alone, ``inner_group`` the
    n_inner ranks of its data index (the one inner axis's group when only
    one has size > 1), and ``data_group`` the n_data ranks of its model,
    seq, stage and expert index. A group is None where its axis has size
    1 (its collectives are never issued), and the data group where it is
    the whole group (or there is no group)."""
    n_data: int
    n_seq: int
    data_index: int
    seq_index: int
    data_group: object = None
    seq_group: object = None
    n_expert: int = 1
    expert_index: int = 0
    expert_group: object = None
    inner_group: object = None
    n_model: int = 1
    model_index: int = 0
    model_group: object = None
    n_stage: int = 1
    stage_index: int = 0
    stage_group: object = None

    @property
    def n_inner(self) -> int:
        return self.n_model * self.n_seq * self.n_stage * self.n_expert


_GRIDS: dict = {}   # by (n_seq, n_expert, n_model, n_stage, world), until
                    # the group ends
_grid: Optional[RankGrid] = None


def _split_error(world: int, n_seq: int, n_expert: int,
                 n_model: int, n_stage: int) -> str:
    if n_stage > 1:
        return (f"{world} ranks do not split into inner groups of "
                f"{n_model} model x {n_seq} seq x {n_stage} stage x "
                f"{n_expert} expert ranks")
    if n_model > 1:
        return (f"{world} ranks do not split into inner groups of "
                f"{n_model} model x {n_seq} seq x {n_expert} expert ranks")
    if n_expert > 1:
        return (f"{world} ranks do not split into inner groups of {n_seq} "
                f"seq x {n_expert} expert ranks")
    return f"{world} ranks do not split into seq groups of {n_seq}"


def make_grid(n_seq: int = 1, n_expert: int = 1, n_model: int = 1,
              n_stage: int = 1) -> RankGrid:
    """The rank grid of ``n_model`` model by ``n_seq`` seq by ``n_stage``
    stage by ``n_expert`` expert ranks per data index, made the current
    one (what ``axis_size`` and the models' ``tp_axis``/``seq_axis``/
    ``ep_axis`` and pipelined paths read). Making a grid is collective
    the first time for each shape in a group: every rank must call it,
    in the same order. Raises ValueError unless the world divides by
    n_model * n_seq * n_stage * n_expert."""
    global _grid
    sizes = dict(zip(GRID_AXES[1:], (int(n_model), int(n_seq),
                                     int(n_stage), int(n_expert))))
    inner = math.prod(sizes.values())
    world, r = world_size(), rank()
    if min(sizes.values()) < 1 or world % inner:
        raise ValueError(_split_error(world, sizes[SEQ_AXIS],
                                      sizes[EXPERT_AXIS], sizes[MODEL_AXIS],
                                      sizes[STAGE_AXIS]))
    key = (sizes[SEQ_AXIS], sizes[EXPERT_AXIS], sizes[MODEL_AXIS],
           sizes[STAGE_AXIS], world)
    if key not in _GRIDS:
        sizes = {"data": world // inner, **sizes}
        # this rank's index on every axis: mixed-radix digits of r
        index, rest = {}, r
        for axis in reversed(GRID_AXES):
            index[axis], rest = rest % sizes[axis], rest // sizes[axis]

        def rank_of(idx: dict) -> int:
            out = 0
            for axis in GRID_AXES:
                out = out * sizes[axis] + idx[axis]
            return out

        def made(axes):
            """The group of the ranks that differ from this one along
            ``axes`` alone. Every rank creates every such group, in one
            order (the other axes' indices in grid order), and keeps its
            own."""
            others = [a for a in GRID_AXES if a not in axes]
            mine = None
            for fixed in itertools.product(
                    *(range(sizes[a]) for a in others)):
                group = dist.new_group([
                    rank_of({**dict(zip(others, fixed)),
                             **dict(zip(axes, free))})
                    for free in itertools.product(
                        *(range(sizes[a]) for a in axes))])
                if all(index[a] == f for a, f in zip(others, fixed)):
                    mine = group
            return mine

        groups = {}
        if inner > 1:
            # the stage group after the others, so that a grid without a
            # stage axis makes its groups in the order it always has
            for axis in (SEQ_AXIS, "data", EXPERT_AXIS, MODEL_AXIS,
                         STAGE_AXIS):
                if axis == "data" or sizes[axis] > 1:
                    groups[axis] = made((axis,))
            split = [a for a in GRID_AXES[1:] if sizes[a] > 1]
            groups["inner"] = made(tuple(GRID_AXES[1:])) \
                if len(split) > 1 else groups[split[0]]
        _GRIDS[key] = RankGrid(
            sizes["data"], sizes[SEQ_AXIS], index["data"], index[SEQ_AXIS],
            groups.get("data"), groups.get(SEQ_AXIS), sizes[EXPERT_AXIS],
            index[EXPERT_AXIS], groups.get(EXPERT_AXIS), groups.get("inner"),
            sizes[MODEL_AXIS], index[MODEL_AXIS], groups.get(MODEL_AXIS),
            sizes[STAGE_AXIS], index[STAGE_AXIS], groups.get(STAGE_AXIS))
    _grid = _GRIDS[key]
    return _grid


def use_grid(grid: RankGrid) -> None:
    """Make an already made grid the current one again (an engine does
    at every dispatch, so its collectives run over its own grid)."""
    global _grid
    _grid = grid


def data_group():
    """The current grid's data group: the group the lane merge sums over
    (None: every rank)."""
    return current_grid().data_group


def current_grid() -> RankGrid:
    """The grid ``make_grid`` installed last; without one, every rank is
    its own data index (no inner axis)."""
    if _grid is not None:
        return _grid
    return RankGrid(world_size(), 1, rank(), 0)


def _axis(name: str) -> tuple:
    """(size, index, group) of a grid axis of the current grid."""
    g = current_grid()
    if name == MODEL_AXIS:
        return g.n_model, g.model_index, g.model_group
    if name == SEQ_AXIS:
        return g.n_seq, g.seq_index, g.seq_group
    if name == STAGE_AXIS:
        return g.n_stage, g.stage_index, g.stage_group
    if name == EXPERT_AXIS:
        return g.n_expert, g.expert_index, g.expert_group
    raise ValueError(f"unknown grid axis {name!r}; the models' axes are "
                     f"{MODEL_AXIS!r}, {SEQ_AXIS!r}, {STAGE_AXIS!r} and "
                     f"{EXPERT_AXIS!r}")


def axis_size(name: str) -> int:
    """The size of a grid axis (``lax.axis_size``): 1 without a grid."""
    return _axis(name)[0]


def axis_index(name: str) -> int:
    """This rank's index along a grid axis (``lax.axis_index``)."""
    return _axis(name)[1]


def axis_group(name: str):
    """The process group of a grid axis (None without a split)."""
    return _axis(name)[2]


# ------------------------------------------------------------ collectives

def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The sum (or ``op="max"``) of ``t`` over the group's ranks, as a new
    tensor; ``t`` itself at world size 1 without a group."""
    if not is_initialized():
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    all_reduce.calls += 1
    return out


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order (equal
    shapes on every rank); ``t`` itself without a group."""
    if not is_initialized():
        return t
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in
                                 range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    all_gather_cat.calls += 1
    return torch.cat(parts)


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's segment of the sum over the group's ranks of the flat
    tensor ``t``, cut into world equal contiguous segments (segment r of
    every rank's ``t``, summed); ``t`` itself without a group. The SyncDP
    engine's ZeRO-1 gradient reduce: ``t`` packed rank-major."""
    if not is_initialized():
        return t
    world = dist.get_world_size(group)
    if t.numel() % world:
        raise ValueError(f"{t.numel()} elements do not split over {world} "
                         "ranks")
    out = torch.empty(t.numel() // world, dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.reshape(-1).contiguous(), group=group)
    reduce_scatter.calls += 1
    return out


def all_gather_into(t: torch.Tensor, group=None) -> torch.Tensor:
    """One flat tensor of every rank's equal flat segment ``t``, in rank
    order (``all_gather_into_tensor``); ``t`` itself without a group. The
    SyncDP engine writes its ZeRO-1/FSDP shards back through it."""
    if not is_initialized():
        return t
    src = t.reshape(-1).contiguous()
    out = torch.empty(dist.get_world_size(group) * src.numel(),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    all_gather_into.calls += 1
    return out


def barrier(group=None) -> None:
    """Wait until every rank of the group reaches this point (nothing
    without a group)."""
    if is_initialized():
        dist.barrier(group=group)
        barrier.calls += 1


def exchange(send: torch.Tensor, to: int, frm: int,
             group=None) -> torch.Tensor:
    """Send ``send`` to group rank ``to`` and receive a tensor of its
    shape and dtype from group rank ``frm``, as one batched isend/irecv
    pair (one ring hop). On gloo a CUDA tensor goes through the host:
    gloo's all-reduce and all-gather take CUDA tensors, but its isend of
    one fails in the transport (writev: Bad address; chip_smoke.py phase
    23 tries each collective directly)."""
    routed = send.is_cuda and dist.get_backend(group) == "gloo"
    src = (send.cpu() if routed else send).contiguous()
    recv = torch.empty_like(src)
    peer = (lambda r: r) if group is None else \
        (lambda r: dist.get_global_rank(group, r))
    ops = [dist.P2POp(dist.isend, src, peer(to), group),
           dist.P2POp(dist.irecv, recv, peer(frm), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    exchange.calls += 1
    return recv.to(send.device)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """The all-to-all of a [n, ...] tensor over the group's n ranks:
    chunk i goes to group rank i, and chunk i of the result came from
    group rank i (``all_to_all_single``); ``t`` itself at world size 1.
    gloo takes CUDA tensors here, as for the all-reduce (chip_smoke.py
    phase 25 (e) tries it directly; gloo has no list ``all_to_all``)."""
    if not is_initialized() or dist.get_world_size(group) == 1:
        return t
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    all_to_all.calls += 1
    return out


class _Psum(torch.autograd.Function):
    """psum over a group whose VJP is the same psum (the transpose of a
    sum of every rank's value, handed to every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), group=ctx.group), None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The differentiable sum of ``x`` over a grid axis (``lax.psum``):
    its backward sums the cotangents over the same ranks. Every rank
    that computes from the sum holds the whole upstream gradient, so a
    loss that every rank of the axis computes alike counts 1 / n on
    each (the engine's inner round) for the sum to be counted once. The
    identity at axis size 1."""
    if axis_size(axis_name) == 1:
        return x
    return _Psum.apply(x, axis_group(axis_name))


class _RingShift(torch.autograd.Function):
    """One ring hop: send to ``to``, receive from ``frm``; the VJP sends
    the gradient back the other way."""

    @staticmethod
    def forward(ctx, x, to, frm, group):
        ctx.to, ctx.frm, ctx.group = to, frm, group
        return exchange(x, to, frm, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g.contiguous(), ctx.frm, ctx.to, ctx.group), \
            None, None, None


def ring_shift(x: torch.Tensor, axis_name: str = SEQ_AXIS,
               offset: int = 1) -> torch.Tensor:
    """``lax.ppermute`` of ``x`` by ``offset`` around a grid axis: seq
    index i sends to i + offset and receives from i - offset;
    differentiable. The identity at axis size 1."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    i = axis_index(axis_name)
    return _RingShift.apply(x, (i + offset) % n, (i - offset) % n,
                            axis_group(axis_name))


all_reduce.calls = 0
all_gather_cat.calls = 0
all_to_all.calls = 0
reduce_scatter.calls = 0
all_gather_into.calls = 0
barrier.calls = 0
exchange.calls = 0
