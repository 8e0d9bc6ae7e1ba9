"""Bucket planner and merge strategies of the sync round (twin of
kubeml_tpu/parallel/merge.py).

The K-avg round ends with a merge over data lanes: each lane holds the f32
sum of its workers' weights, and the merge averages those sums over every
live contributor. The reference runs it inside ``shard_map`` with ``psum``
over the ``data`` mesh axis; here the lanes are laid out over the ranks of
the process group (``parallel/distributed.py``; one rank, holding every
lane, without a group), each rank's own lanes a leading axis
``[D_local, ...]`` of every contribution on its device, and:

  * ``psum`` over ``data`` is the sum over the rank's lanes in lane order
    (lane 0 first), which is what the reference's CPU mesh computes in
    f32, then the sum of those over the ranks (an all-reduce; with two
    terms a sum in any order, so two ranks of one lane each equal one
    process of two lanes bit for bit);
  * ``pmax`` is a max over the rank's lanes, then a MAX all-reduce;
  * a lossy wire (bf16) casts each lane's payload, sums the casts in f32
    in lane order and rounds the sum once to the wire dtype — what the
    reference's bf16 ``psum`` gives on its CPU mesh (pinned at D = 4 in
    tests/test_torch_merge.py); across ranks the rounded sums travel in
    the wire dtype (``comm_proxy``'s bytes), and NCCL or gloo sums them
    there;
  * a strategy's EF residual of bucket ``b{i}`` is a flat
    ``[D_local * L]`` f32 tensor, lane-major, the rank's slice of the
    reference's ``[D * L]``.

Two levers, as in the reference:

  * BUCKETING: consecutive leaves (in flax flatten order,
    ``convert.flax_leaf_order``) are packed into size-capped flat f32
    buckets, each reduced at once, and the round's buckets are finished
    together by the fused merge-apply kernel (``ops/fused_merge.py``).
    The f32 bucketed merge equals the monolithic one bit for bit: every
    step is elementwise.
  * ERROR FEEDBACK: each lane quantizes payload = contribution + residual
    to bf16, or to int8 with one scale per bucket shared by all lanes,
    ships the quantized bucket and keeps residual' = payload - decoded for
    the next round. A lane with no live contributor ships zeros and its
    residual is zeroed, so a revived worker never replays stale error.

Every divisor is a tensor on the contributions' device: a Python float or
a CPU scalar divisor sends PyTorch's CUDA ``div`` to a multiply by the
reciprocal, which is not the reference's IEEE division. The one exception
is the reference's own: XLA turns int8's ``amax / 127.0`` into a multiply
(``EFInt8Merge``).

The SyncDP engine (``parallel/syncdp.py``) calls the same ``lane_merge``
once per step over per-lane GRADIENT sums, with ``count`` = 1 and a zero
``ref``: the bucketed and EF strategies then still finish through the
fused merge (a lane sum kept where some lane is alive, zeros where none
is), never around it.

``register_strategy_cost``/``register_merge_cost`` put a strategy's wire
plan into the cost ledger (metrics/ledger.py) as the exact
``merge.<strategy>`` record.

``use_ring``: the reference's lossy wires (a ``wire_dtype`` of the
monolithic or bucketed merge, and ``ef_bf16``) take its ring all-reduce
where its mesh keeps an inner axis AUTO: a sub-f32 psum miscompiles
there. The K-avg engine asks for it where the reference does, on a rank
grid with an expert axis and no seq round (its GSPMD DP x EP route), and
the lane sum is then the reference's ring over every lane in lane order
(``collectives.lane_ring_psum``) across the data group's ranks. f32 and
int8 wires sum directly either way, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from kubeml_tpu_torch.convert import flax_leaf_order
from kubeml_tpu_torch.ops.fused_merge import fused_merge_apply
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel.collectives import lane_ring_psum

State = Dict[str, torch.Tensor]

# default size cap for EF-compressed buckets when the caller sets a
# compression scheme but no explicit merge_bucket_mb
DEFAULT_EF_BUCKET_MB = 4.0
# the f32 reciprocal of 127 by which XLA replaces the reference's
# `amax / 127.0` (a multiply by a Python float rounds it to f32 first)
_INV_127 = 1.0 / 127.0


def _leaf_elems(leaf) -> int:
    return int(leaf.numel())


def _leaf_float(leaf) -> bool:
    return leaf.dtype.is_floating_point


@dataclass(frozen=True)
class Bucket:
    """One merge bucket: a run of consecutive leaves reduced at once.
    ``compressible`` buckets hold only floating leaves (wire compression /
    EF may apply); exact buckets hold integer leaves, whose average-and-
    truncate contract needs a full-precision wire."""
    indices: Tuple[int, ...]     # leaf positions in flax flatten order
    sizes: Tuple[int, ...]       # element count per leaf
    length: int                  # total elements in the bucket
    compressible: bool


@dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def plan_buckets(leaves, bucket_mb: float) -> BucketPlan:
    """Pack consecutive leaves into size-capped buckets.

    Leaves keep their order; consecutive float leaves pack greedily until
    the bucket would exceed ``bucket_mb`` MB of f32 payload (a single leaf
    larger than the cap gets its own bucket), and integer leaves never
    share a bucket with float ones. bucket_mb <= 0 means one bucket per
    run of one kind. Only ``numel()`` and ``dtype`` are read (meta tensors
    will do)."""
    cap_elems = int(bucket_mb * 1024 * 1024 / 4) if bucket_mb > 0 else 0
    buckets: List[Bucket] = []
    cur_idx: List[int] = []
    cur_sizes: List[int] = []
    cur_len = 0
    cur_float = True

    def flush():
        nonlocal cur_idx, cur_sizes, cur_len
        if cur_idx:
            buckets.append(Bucket(tuple(cur_idx), tuple(cur_sizes),
                                  cur_len, cur_float))
        cur_idx, cur_sizes, cur_len = [], [], 0

    leaves = list(leaves)
    for i, leaf in enumerate(leaves):
        n = _leaf_elems(leaf)
        is_float = _leaf_float(leaf)
        if cur_idx and (is_float != cur_float
                        or (cap_elems and cur_len + n > cap_elems)):
            flush()
        cur_float = is_float
        cur_idx.append(i)
        cur_sizes.append(n)
        cur_len += n
    flush()
    return BucketPlan(tuple(buckets), len(leaves))


def _local_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis of this rank's lanes, in lane order."""
    s = x[0]
    for d in range(1, x.shape[0]):
        s = s + x[d]
    return s


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every lane (the reference's ``psum`` over ``data``): this
    rank's lanes in lane order, then the sum across the ranks of the
    rank grid's data group (every rank without a seq split)."""
    return dist_lib.all_reduce(_local_sum(x), group=dist_lib.data_group())


def _wire_sum(x: torch.Tensor, wire_dtype: torch.dtype) -> torch.Tensor:
    """The lane sum over a lossy wire, read back as f32: each lane's
    payload cast to the wire dtype, the casts summed in f32 in lane order
    and rounded once to the wire dtype, then summed across the data
    group's ranks in the wire dtype."""
    local = _local_sum(x.to(wire_dtype).float()).to(wire_dtype)
    return dist_lib.all_reduce(local, group=dist_lib.data_group()).float()


def _ring_sum(x: torch.Tensor, wire_dtype: torch.dtype) -> torch.Tensor:
    """The lane sum over a lossy wire through the reference's ring
    (``use_ring``): every lane in lane order, the data group's ranks
    holding theirs, hops in ``wire_dtype`` and f32 accumulation; f32."""
    return lane_ring_psum(x, dist_lib.data_group(), wire_dtype).float()


# --------------------------------------------------------------- registry

MERGE_STRATEGIES: Dict[str, Callable[..., "MergeStrategy"]] = {}


def _register(name: str):
    def deco(cls):
        MERGE_STRATEGIES[name] = cls
        cls.name = name
        return cls
    return deco


def make_strategy(merge_dtype: Optional[torch.dtype] = None,
                  bucket_mb: float = 0.0, compress: str = "none",
                  use_ring: bool = False) -> "MergeStrategy":
    """Map the engine knobs to a registered strategy instance.

    merge_dtype: lossy wire cast (no EF) of float payloads. bucket_mb > 0
    selects the bucketed strategy; compress in {"bf16", "int8"} selects
    the EF strategies (bucketed, with a DEFAULT_EF_BUCKET_MB cap when
    bucket_mb is unset). merge_dtype and compress are mutually exclusive:
    EF already owns the wire. use_ring: lossy wires sum through the
    reference's ring (module docstring)."""
    compress = str(compress or "none")
    if compress not in ("none", "bf16", "int8"):
        raise ValueError(f"merge_compress must be none|bf16|int8, "
                         f"got {compress!r}")
    if compress != "none":
        if merge_dtype is not None:
            raise ValueError("merge_dtype and merge_compress are mutually "
                             "exclusive (EF compression owns the wire "
                             "dtype)")
        mb = bucket_mb if bucket_mb > 0 else DEFAULT_EF_BUCKET_MB
        cls = MERGE_STRATEGIES["ef_bf16" if compress == "bf16"
                               else "ef_int8"]
        return cls(bucket_mb=mb, use_ring=use_ring)
    if bucket_mb > 0:
        return MERGE_STRATEGIES["bucketed"](wire_dtype=merge_dtype,
                                            bucket_mb=bucket_mb,
                                            use_ring=use_ring)
    return MERGE_STRATEGIES["monolithic"](wire_dtype=merge_dtype,
                                          use_ring=use_ring)


class MergeStrategy:
    """One sync round's merge over data lanes.

    lane_merge(contrib, ref, raw_count, count, lane_alive, residual):
      contrib    f32 contribution sums by parameter name of this rank's
                 lanes, [D_local, *shape]
      ref        round-start values (carry-forward + dtype source)
      raw_count  0-d live-contributor count over all lanes (0 => all
                 dropped)
      count      max(raw_count, 1), the safe divisor (0-d tensor)
      lane_alive [D_local] bool: the lane shipped at least one live
                 contribution
      residual   EF residuals of this rank's lanes by bucket name, flat
                 [D_local * L] (EF only)
    returns (merged values by name, new residuals or None). raw_count == 0
    must return ``ref`` unchanged. The sums across ranks run over the
    current rank grid's data group (``distributed.data_group``)."""

    name = "?"
    needs_residual = False

    def residual_sizes(self, variables: State) -> Dict[str, int]:
        """Per-lane flat residual lengths by bucket name ({} without EF)."""
        return {}

    def lane_merge(self, contrib: State, ref: State,
                   raw_count: torch.Tensor, count: torch.Tensor,
                   lane_alive: Optional[torch.Tensor] = None,
                   residual: Optional[State] = None
                   ) -> Tuple[State, Optional[State]]:
        raise NotImplementedError

    def comm_proxy(self, variables: State) -> Dict[str, int]:
        """Deterministic communication proxy of one merge, from shapes
        alone: wire payload bytes per lane per round and the numbers of
        buckets and collectives per round."""
        raise NotImplementedError


def _wire_bytes(dtype: torch.dtype) -> int:
    return dtype.itemsize


@_register("monolithic")
class MonolithicMerge(MergeStrategy):
    """One reduction per parameter, with an optional lossy wire cast of
    float leaves: the baseline every bit-identity test anchors on."""

    def __init__(self, wire_dtype: Optional[torch.dtype] = None,
                 use_ring: bool = False, **_):
        self.wire_dtype = wire_dtype
        self.use_ring = bool(use_ring) and wire_dtype is not None

    def lane_merge(self, contrib, ref, raw_count, count, lane_alive=None,
                   residual=None):
        out = {}
        wire_sum = _ring_sum if self.use_ring else _wire_sum
        for n, c in contrib.items():
            r = ref[n]
            # integer leaves stay on the exact wire: a bf16 cast would
            # drift a counter above 256 even when every worker agrees
            if self.wire_dtype is not None and r.is_floating_point():
                s = wire_sum(c, self.wire_dtype)
            else:
                s = _lane_sum(c)
            # a select, never a multiply: when every contributor dropped
            # the carried-forward value is exactly the round-start one
            out[n] = torch.where(raw_count > 0, (s / count).to(r.dtype), r)
        return out, None

    def comm_proxy(self, variables):
        payload = sum(
            _leaf_elems(t) * (_wire_bytes(self.wire_dtype)
                              if self.wire_dtype is not None
                              and _leaf_float(t) else 4)
            for t in variables.values())
        return {"merge_payload_bytes": payload,
                "buckets_per_round": len(variables),
                "collectives_per_round": len(variables)}


class _BucketedBase(MergeStrategy):
    """Flat-bucket machinery: concatenate a bucket's leaves (per lane)
    into one f32 vector and reduce it over the lanes; then finish every
    bucket of the round with one fused merge-apply (avg + guard-select),
    and split and cast back per leaf. Every step is elementwise, so the
    f32 variant equals the monolithic merge bit for bit."""

    def __init__(self, bucket_mb: float, use_ring: bool = False, **_):
        self.bucket_mb = float(bucket_mb)
        self.use_ring = bool(use_ring)
        self._wire_sum = _ring_sum if self.use_ring else _wire_sum

    def _plan(self, variables: State) -> Tuple[List[str], BucketPlan]:
        names = flax_leaf_order(variables)
        return names, plan_buckets([variables[n] for n in names],
                                   self.bucket_mb)

    @staticmethod
    def _flat(parts: List[torch.Tensor]) -> torch.Tensor:
        """Concatenate flattened parts along their last axis in f32; one
        part comes back as it is (a view, when it already was f32)."""
        parts = [p.float() for p in parts]
        if len(parts) == 1:
            return parts[0].contiguous()
        return torch.cat(parts, dim=-1)

    def _reduce_bucket(self, flat_c: torch.Tensor, bucket: Bucket,
                       lane_alive, residual):
        """(summed f32 [L], new residual [D_local * L] or None) for one
        bucket; flat_c is [D_local, L]."""
        raise NotImplementedError

    def lane_merge(self, contrib, ref, raw_count, count, lane_alive=None,
                   residual=None):
        names, plan = self._plan(ref)
        merged: State = {}
        new_resid: State = {}
        members, pairs = [], []
        for bi, bucket in enumerate(plan.buckets):
            members.append([names[i] for i in bucket.indices])
            lanes = contrib[members[-1][0]].shape[0]
            flat_c = self._flat([contrib[n].reshape(lanes, -1)
                                 for n in members[-1]])
            ref_f32 = self._flat([ref[n].reshape(-1) for n in members[-1]])
            r_in = (residual[f"b{bi}"]
                    if self.needs_residual and bucket.compressible else None)
            s, r_out = self._reduce_bucket(flat_c, bucket, lane_alive, r_in)
            if r_out is not None:
                new_resid[f"b{bi}"] = r_out
            pairs.append((s.float(), ref_f32))
        # every bucket's apply in one fused merge (one kernel launch)
        outs = fused_merge_apply("avg", pairs, count, raw_count)
        for names_b, bucket, m in zip(members, plan.buckets, outs):
            off = 0
            for n, size in zip(names_b, bucket.sizes):
                merged[n] = m[off:off + size].reshape(ref[n].shape).to(
                    ref[n].dtype)
                off += size
        return ({n: merged[n] for n in contrib},
                new_resid if self.needs_residual else None)

    def residual_sizes(self, variables):
        if not self.needs_residual:
            return {}
        _, plan = self._plan(variables)
        return {f"b{bi}": b.length
                for bi, b in enumerate(plan.buckets) if b.compressible}

    def _bucket_wire_bytes(self, bucket: Bucket) -> int:
        return bucket.length * 4

    def comm_proxy(self, variables):
        _, plan = self._plan(variables)
        payload = sum(self._bucket_wire_bytes(b) for b in plan.buckets)
        return {"merge_payload_bytes": payload,
                "buckets_per_round": plan.n_buckets,
                "collectives_per_round": plan.n_buckets}


@_register("bucketed")
class BucketedMerge(_BucketedBase):
    """Size-capped flat-bucket merge. The f32 wire (default) equals the
    monolithic merge bit for bit; an optional wire_dtype cast compresses
    float buckets as the monolithic path does per leaf."""

    def __init__(self, wire_dtype: Optional[torch.dtype] = None,
                 bucket_mb: float = 0.0, use_ring: bool = False, **_):
        super().__init__(bucket_mb, use_ring)
        self.wire_dtype = wire_dtype

    def _reduce_bucket(self, flat_c, bucket, lane_alive, residual):
        if self.wire_dtype is not None and bucket.compressible:
            return self._wire_sum(flat_c, self.wire_dtype), None
        return _lane_sum(flat_c), None

    def _bucket_wire_bytes(self, bucket):
        if self.wire_dtype is not None and bucket.compressible:
            return bucket.length * _wire_bytes(self.wire_dtype)
        return bucket.length * 4


def _payload(flat_c, lane_alive, residual):
    """(lane mask [D, 1], payload = contribution + residual on live lanes,
    zeros on dead ones)."""
    alive = lane_alive.reshape(-1, 1)
    p = torch.where(alive, flat_c + residual.reshape(flat_c.shape), 0.0)
    return alive, p


@_register("ef_bf16")
class EFBf16Merge(_BucketedBase):
    """Error-feedback bf16 merge: payload = contribution + residual is
    cast to bf16 per lane, the bf16 values are summed over the lanes, and
    residual' = payload - decode(payload) carries the cast error to the
    next round. Dead lanes ship zeros and their residual is zeroed."""

    needs_residual = True

    def _reduce_bucket(self, flat_c, bucket, lane_alive, residual):
        if not bucket.compressible:
            return _lane_sum(flat_c), None
        alive, p = _payload(flat_c, lane_alive, residual)
        decoded = p.to(torch.bfloat16).float()
        new_r = torch.where(alive, p - decoded, 0.0)
        return self._wire_sum(decoded, torch.bfloat16), new_r.reshape(-1)

    def _bucket_wire_bytes(self, bucket):
        return bucket.length * (2 if bucket.compressible else 4)


@_register("ef_int8")
class EFInt8Merge(_BucketedBase):
    """Error-feedback int8 merge with one scale per bucket shared by all
    lanes: scale = max|payload| over every lane / 127, every lane ships
    round(payload / scale) (integers, exact in f32, so their lane sum is
    exact), and the sum is decoded by multiplying it by the scale after
    the sum. residual' = payload - round(payload / scale) * scale. Dead
    lanes ship zeros and zero their residual. ``round`` is half to even,
    as ``jnp.round``.

    Two rounding points follow what XLA makes of the reference's chain:
    ``amax / 127.0`` is folded into a multiply by the f32 reciprocal of
    127, and ``p - q * scale`` is contracted into one fused multiply-add.
    The residual is therefore computed in f64, where the product (a 7-bit
    integer times a 24-bit scale) and the difference (at most scale / 2,
    or p itself when q = 0) are exact, and rounded once to f32 — the
    FMA's result, on either device."""

    needs_residual = True

    def _reduce_bucket(self, flat_c, bucket, lane_alive, residual):
        if not bucket.compressible:
            return _lane_sum(flat_c), None
        alive, p = _payload(flat_c, lane_alive, residual)
        # the lanes' max, then the MAX across ranks: every rank's scale
        amax = dist_lib.all_reduce(p.abs().amax(), "max",
                                   dist_lib.data_group())
        scale = amax * _INV_127
        safe = torch.where(scale > 0, scale, 1.0)
        q = torch.where(scale > 0, torch.round(p / safe), 0.0)
        resid = (p.double() - q.double() * scale.double()).float()
        new_r = torch.where(alive, resid, 0.0)
        return _lane_sum(q) * scale, new_r.reshape(-1)

    def _bucket_wire_bytes(self, bucket):
        # 1 byte per element + one f32 scale per bucket
        if bucket.compressible:
            return bucket.length + 4
        return bucket.length * 4


def strategy_by_name(name: str, wire_dtype: Optional[torch.dtype] = None,
                     bucket_mb: float = 0.0) -> "MergeStrategy":
    """Instantiate a registered strategy by name (the SyncDP engine's
    explicit-merge knob). EF strategies get the default bucket cap when
    bucket_mb is unset."""
    if name not in MERGE_STRATEGIES:
        raise ValueError(f"unknown merge strategy {name!r}; registered: "
                         f"{sorted(MERGE_STRATEGIES)}")
    cls = MERGE_STRATEGIES[name]
    if getattr(cls, "needs_residual", False) and bucket_mb <= 0:
        bucket_mb = DEFAULT_EF_BUCKET_MB
    return cls(wire_dtype=wire_dtype, bucket_mb=bucket_mb)


def merge_comm_proxy(variables: State,
                     merge_dtype: Optional[torch.dtype] = None,
                     bucket_mb: float = 0.0, compress: str = "none"
                     ) -> Dict[str, int]:
    """The comm proxy of the strategy the engine would pick for these
    knobs, with its name."""
    strategy = make_strategy(merge_dtype=merge_dtype, bucket_mb=bucket_mb,
                             compress=compress)
    out = strategy.comm_proxy(variables)
    out["strategy"] = strategy.name
    return out


def register_strategy_cost(ledger, strategy: "MergeStrategy",
                           variables: State) -> Dict[str, int]:
    """Register a strategy's wire plan as an analytic cost-ledger
    record (``merge.<strategy>``, kernel plane) built from the same
    comm_proxy numbers, then reconcile the two exactly
    (metrics/ledger.py). Returns the proxy dict so callers keep the
    bucket/collective counts."""
    proxy = strategy.comm_proxy(variables)
    proxy["strategy"] = strategy.name
    program = f"merge.{strategy.name}"
    ledger.capture_analytic(
        program, "kernel",
        hbm_bytes=float(proxy["merge_payload_bytes"]),
        # the wire reads and writes the payload once per round; the
        # bucket count (the reference's count, one fused merge launch a
        # bucket there; the port merges them all in one launch) rides as
        # the argument-side descriptor so budgets pin it too
        output_bytes=int(proxy["merge_payload_bytes"]),
        argument_bytes=int(proxy["buckets_per_round"]))
    ledger.reconcile(program, "hbm_bytes",
                     proxy["merge_payload_bytes"], tolerance=0.0)
    return proxy


def register_merge_cost(ledger, variables: State,
                        merge_dtype: Optional[torch.dtype] = None,
                        bucket_mb: float = 0.0, compress: str = "none"
                        ) -> Dict[str, int]:
    """Knob-level twin of register_strategy_cost for callers that hold
    engine knobs rather than a strategy."""
    strategy = make_strategy(merge_dtype=merge_dtype, bucket_mb=bucket_mb,
                             compress=compress)
    return register_strategy_cost(ledger, strategy, variables)
