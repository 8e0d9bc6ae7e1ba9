"""Cluster allocator — gang placement, priority preemption, fair sharing
(copy of kubeml_tpu/control/cluster.py: journal replay re-executes every
op, so the decisions, their order and the snapshot's key order must be
the reference's exactly; the port imports nothing of the JAX package).

The per-job `ThroughputBasedPolicy` (control/policy.py) sizes ONE job's
parallelism from its own epoch times, exactly as the reference KubeML
did. Under multi-tenant load many jobs contend for one shared device
mesh, so this module adds the cluster-level layer the reference never
had — in the spirit of Gandiva/DRF-style GPU-cluster schedulers, built
on the repo's preemption grace (SIGTERM → drain → round-granular
checkpoint → budget-free reschedule, docs/architecture.md):

  - gang placement: a job's N worker lanes place atomically or not at
    all — never a partially placed job. The scheduler's 503-defer path
    is reserved for true pool exhaustion; an arrival the pool cannot
    hold YET simply queues here until lanes free.
  - priority preemption: a strictly-higher-priority arrival that cannot
    place selects the cheapest-to-displace running victims (lowest
    priority, then fewest lanes, then least sunk time). The scheduler
    SIGTERMs each victim, which drains its in-flight round, checkpoints,
    and requeues WITHOUT consuming `max_restarts`.
  - weighted fair sharing with per-tenant quotas: deficit-tracked
    shares decide which tenant grows when the pool frees; a tenant at
    its quota is clamped (its jobs wait on its OWN lanes) before any
    under-quota tenant is held back. Aging raises a parked job's
    effective priority over time so sustained higher-priority load can
    never starve it.

The allocator is PURE LOGIC: no HTTP, no threads of its own, and an
injectable clock (the HealthEvaluator/_scan_heartbeats determinism
discipline), so every decision path is unit-testable with a fake
clock. Decisions are explicit
`Decision` records whose `path` names one of DECISION_PATHS below;
tools/check_sched_invariants.py fails the build unless each named path
has a quoted-name test in tests/.

DURABILITY (docs/architecture.md "Control-plane durability"): attach a
DecisionJournal (control/journal.py) and every mutating operation —
submit / release / resize / regrant / fence rejection / the recovery
marker itself — is appended as an OP record (op name, args, the clock
reading it ran under, the decisions it produced, the fencing epoch)
before the decisions reach the caller. `ClusterAllocator.recover()`
replays snapshot+tail by RE-EXECUTING each op under its recorded clock
reading, so the reconstructed `snapshot()` is exactly equal to the
pre-crash state at every journaled index; a replayed op whose decisions
diverge from the journaled ones raises JournalCorruptError rather than
silently forking history. Every lane grant carries a monotone fencing
epoch: a recovered allocator bumps the epoch (`mark_recovered`), so a
stale pre-crash worker presenting an old grant is rejected with a 409
(`fence_check` → StaleGrantError) instead of double-booking lanes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubeml_tpu_torch.api.errors import StaleGrantError
from kubeml_tpu_torch.control.journal import (DecisionJournal,
                                              JournalCorruptError)

# Pseudo job id under which the scheduler feeds allocator snapshots
# through the PS health pipeline (the serve:<model> idiom), so
# `kubeml top --id cluster` renders the cluster pane from GET /health.
CLUSTER_JOB_ID = "cluster"

# Named decision paths. Every entry must be exercised by a test that
# names it (quoted, in an assertion) — tools/check_sched_invariants.py
# walks this literal and lints tests/ for coverage.
DECISION_PATHS = {
    "gang-atomicity": "a job's N lanes place atomically or not at all",
    "no-starvation": "aging raises a parked job's effective priority "
                     "until it places under sustained load",
    "quota-clamp": "an over-quota tenant is clamped before any "
                   "under-quota tenant is held back",
    "preempt-cheapest": "a higher-priority arrival displaces the "
                        "cheapest-to-displace lower-priority victims",
    "serve-elastic": "a serving-replica gang (kind='serving') grows or "
                     "shrinks elastically through the shared pool",
}

DEFAULT_TENANT = "default"
# seconds of queue wait per +1 effective priority (0 disables aging)
DEFAULT_AGING_S = 30.0


@dataclasses.dataclass(frozen=True)
class Decision:
    """One explicit allocator decision, for the scheduler to apply.

    action: 'place'   — start job_id with `lanes` workers (atomic gang)
            'queue'   — job_id stays parked until lanes free
            'preempt' — SIGTERM `victim` to make room for job_id
            'resize'  — running job_id's next-epoch width is `lanes`
    path names the DECISION_PATHS entry that drove the choice.
    epoch is the fencing epoch the grant is valid under ('place' /
    'resize' of a pool member); a worker must present it back on
    re-parallelization and is 409-rejected when it is stale."""

    action: str
    job_id: str
    lanes: int = 0
    victim: str = ""
    path: str = ""
    detail: str = ""
    epoch: int = 0


@dataclasses.dataclass
class _Pending:
    job_id: str
    tenant: str
    priority: int
    lanes: int          # requested gang size (clamped to the pool)
    enqueued_at: float
    kind: str = "train"  # 'train' (worker gang) | 'serving' (replicas)


@dataclasses.dataclass
class _Running:
    job_id: str
    tenant: str
    priority: int
    lanes: int
    placed_at: float
    preempting: bool = False  # victim selected; lanes free on release
    kind: str = "train"


def parse_tenant_spec(spec: str) -> Tuple[str, float, Optional[int]]:
    """Parse a CLI tenant spec ``name=weight[:quota]`` — e.g.
    ``teamA=2:4`` (weight 2, at most 4 lanes) or ``teamB=1`` (weight 1,
    quota = whole pool)."""
    name, _, rest = spec.partition("=")
    name = name.strip()
    if not name or not rest:
        raise ValueError(f"bad tenant spec {spec!r}; want name=weight[:quota]")
    weight_s, _, quota_s = rest.partition(":")
    weight = float(weight_s)
    if weight <= 0:
        raise ValueError(f"tenant {name!r}: weight must be > 0")
    quota = None
    if quota_s:
        quota = int(quota_s)
        if quota < 1:
            raise ValueError(f"tenant {name!r}: quota must be >= 1 lane")
    return name, weight, quota


class ClusterAllocator:
    """Owns the shared pool of worker lanes between the scheduler and
    the PS. All methods are synchronous, deterministic given `clock`,
    and safe to call from the scheduler loop and its HTTP handlers."""

    def __init__(self, pool_lanes: int,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quotas: Optional[Dict[str, int]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 aging_s: float = DEFAULT_AGING_S,
                 journal: Optional[DecisionJournal] = None,
                 compact_every: int = 0):
        if pool_lanes < 1:
            raise ValueError("pool must have at least one lane")
        self.pool_lanes = int(pool_lanes)
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_quotas = dict(tenant_quotas or {})
        self.clock = clock
        self.aging_s = float(aging_s)
        self._running: Dict[str, _Running] = {}
        self._pending: List[_Pending] = []
        # weighted-fair deficit per tenant: accrues (weight-shared) as
        # lanes free, spends as that tenant's jobs place — the
        # tie-break among equal effective priorities, so the tenant the
        # pool has shortchanged longest grows first
        self._deficit: Dict[str, float] = {}
        # lifetime counters (cumulative; snapshot() exports them and
        # metrics/prom.py turns deltas into Prometheus counters)
        self.gang_placements = 0
        self.preemptions = 0
        self.aged_grants = 0
        self.quota_clamps = 0
        # --- durability / fencing state (journaled; survives restart)
        self.fencing_epoch = 1
        self.fencing_rejections = 0
        self.recoveries = 0
        self.journal_records = 0
        self.journal_compactions = 0
        self._grant_epochs: Dict[str, int] = {}
        self._journal = journal
        self.compact_every = int(compact_every)
        self._since_compact = 0
        # replay machinery: when set, mutators run under the RECORDED
        # clock reading instead of self.clock (exact reconstruction)
        self._replaying = False
        self._replay_now: Optional[float] = None
        self._last_now: Optional[float] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ internals

    def _now(self) -> float:
        return self._replay_now if self._replay_now is not None \
            else self.clock()

    def _free(self) -> int:
        return self.pool_lanes - sum(r.lanes
                                     for r in self._running.values())

    def _in_use(self, tenant: str) -> int:
        return sum(r.lanes for r in self._running.values()
                   if r.tenant == tenant)

    def _quota(self, tenant: str) -> int:
        return int(self.tenant_quotas.get(tenant, self.pool_lanes))

    def _weight(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    def _eff_priority(self, p: _Pending, now: float) -> int:
        if self.aging_s <= 0:
            return p.priority
        return p.priority + int((now - p.enqueued_at) // self.aging_s)

    def _accrue_deficit(self, freed: int) -> None:
        """Freed lanes accrue deficit to every tenant with parked work,
        split by weight — the DRR quantum. Bounded to one pool so an
        idle tenant can't bank unbounded future claim."""
        tenants = {p.tenant for p in self._pending}
        if not tenants or freed <= 0:
            return
        total_w = sum(self._weight(t) for t in tenants)
        for t in tenants:
            d = self._deficit.get(t, 0.0) \
                + freed * self._weight(t) / total_w
            self._deficit[t] = min(d, float(self.pool_lanes))

    def _grants(self, now: float) -> List[Decision]:
        """Head-of-line gang placement over the parked queue, ordered by
        effective priority (aging included), then tenant deficit, then
        FIFO. A quota-blocked head is SKIPPED (it waits on its own
        tenant's lanes, and must not hold back under-quota tenants —
        the quota-clamp ordering); a size-blocked head HOLDS the line
        (no backfill behind it, so a wide gang is never starved by a
        stream of narrow ones — aging alone then guarantees it runs)."""
        decisions: List[Decision] = []
        progressed = True
        while progressed and self._pending:
            progressed = False
            order = sorted(
                self._pending,
                key=lambda p: (-self._eff_priority(p, now),
                               -self._deficit.get(p.tenant, 0.0),
                               p.enqueued_at, p.job_id))
            for p in order:
                room = self._quota(p.tenant) - self._in_use(p.tenant)
                if room < 1:
                    continue  # over-quota tenant: never holds the line
                # only an EXPLICIT quota clamps the gang below its ask;
                # the default quota (= the whole pool) must not, or any
                # wide gang would silently shrink to whatever is free
                lanes = min(p.lanes, room) \
                    if p.tenant in self.tenant_quotas else p.lanes
                if lanes > self._free():
                    break  # size-blocked head holds the line: no backfill
                self._pending.remove(p)
                self._running[p.job_id] = _Running(
                    p.job_id, p.tenant, p.priority, lanes, placed_at=now,
                    kind=p.kind)
                self.gang_placements += 1
                aged = self._eff_priority(p, now) > p.priority
                clamped = lanes < p.lanes
                if aged:
                    self.aged_grants += 1
                if clamped:
                    self.quota_clamps += 1
                self._deficit[p.tenant] = \
                    self._deficit.get(p.tenant, 0.0) - lanes
                self._grant_epochs[p.job_id] = self.fencing_epoch
                if aged:
                    path = "no-starvation"
                    detail = (f"placed after aging to effective priority "
                              f"{self._eff_priority(p, now)} "
                              f"(base {p.priority})")
                elif clamped:
                    path = "quota-clamp"
                    detail = (f"gang clamped {p.lanes}->{lanes}: tenant "
                              f"{p.tenant} quota "
                              f"{self._quota(p.tenant)} lanes")
                else:
                    path = "gang-atomicity"
                    detail = f"all {lanes} lanes placed atomically"
                decisions.append(Decision("place", p.job_id, lanes=lanes,
                                          path=path, detail=detail,
                                          epoch=self.fencing_epoch))
                progressed = True
                break  # state changed: re-rank before the next grant
        return decisions

    def _preempt_for(self, p: _Pending, now: float) -> List[Decision]:
        """Greedy cheapest-first victim selection for a parked arrival
        that outranks running work: candidates are strictly-lower-RAW-
        priority running jobs (aging confers ordering, never the right
        to displace), cheapest = lowest priority, then fewest lanes,
        then least sunk time. Victims only marked — their lanes free
        when the drained process actually exits and release() runs."""
        # as in _grants: only an EXPLICIT quota bounds how many lanes
        # the arrival may claim — the default quota equals the pool and
        # would otherwise collapse `need` to 1 whenever the pool is
        # full, displacing too few victims to ever seat the gang
        if p.tenant in self.tenant_quotas:
            need = min(p.lanes,
                       max(1, self._quota(p.tenant)
                           - self._in_use(p.tenant)))
        else:
            need = p.lanes
        avail = self._free() + sum(r.lanes
                                   for r in self._running.values()
                                   if r.preempting)
        if need <= avail:
            return []  # enough already freeing; wait for release()
        cands = sorted(
            (r for r in self._running.values()
             if not r.preempting and r.priority < p.priority),
            key=lambda r: (r.priority, r.lanes, -r.placed_at, r.job_id))
        victims: List[_Running] = []
        for r in cands:
            if avail >= need:
                break
            victims.append(r)
            avail += r.lanes
        if avail < need:
            return []  # even preempting every candidate won't fit: wait
        decisions = []
        for v in victims:
            v.preempting = True
            self.preemptions += 1
            decisions.append(Decision(
                "preempt", p.job_id, victim=v.job_id,
                path="preempt-cheapest",
                detail=(f"priority {p.priority} arrival needs {need} "
                        f"lane(s); displacing {v.job_id} (priority "
                        f"{v.priority}, {v.lanes} lane(s))")))
        return decisions

    # ----------------------------------------------------------- durability

    def _record(self, op: str, args: dict, now: float,
                decisions: List[Decision]) -> None:
        """Journal one completed op (no-op without a journal; during
        replay the disk write is skipped but the counters advance
        identically, so replayed state matches recorded state). Called
        with the lock held, AFTER the op mutated state — the decisions
        are already final when the frame hits disk."""
        self._last_now = now
        if self._journal is None:
            return
        self.journal_records += 1
        if self._replaying:
            return
        self._journal.append({
            "op": op, "args": args, "now": now,
            "epoch": self.fencing_epoch,
            "decisions": [dataclasses.asdict(d) for d in decisions],
        })
        self._since_compact += 1
        if self.compact_every and self._since_compact >= self.compact_every:
            self._since_compact = 0
            self.journal_compactions += 1
            self._journal.compact(self._state_dict())

    def _state_dict(self) -> dict:
        """Complete dynamic state, deterministically ordered, for the
        compaction snapshot. Pool/tenant CONFIG is included for
        recovery-time validation, not restored (config belongs to the
        deployment, not the journal)."""
        return {
            "pool_lanes": self.pool_lanes,
            "tenant_weights": {t: self.tenant_weights[t]
                               for t in sorted(self.tenant_weights)},
            "tenant_quotas": {t: self.tenant_quotas[t]
                              for t in sorted(self.tenant_quotas)},
            "aging_s": self.aging_s,
            "running": [dataclasses.asdict(self._running[j])
                        for j in sorted(self._running)],
            "pending": [dataclasses.asdict(p) for p in self._pending],
            "deficit": {t: self._deficit[t]
                        for t in sorted(self._deficit)},
            "counters": {
                "gang_placements": self.gang_placements,
                "preemptions": self.preemptions,
                "aged_grants": self.aged_grants,
                "quota_clamps": self.quota_clamps,
                "fencing_rejections": self.fencing_rejections,
                "recoveries": self.recoveries,
                "journal_records": self.journal_records,
                "journal_compactions": self.journal_compactions,
            },
            "fencing_epoch": self.fencing_epoch,
            "grant_epochs": {j: self._grant_epochs[j]
                             for j in sorted(self._grant_epochs)},
            "last_now": self._last_now,
        }

    def _restore_state(self, state: dict) -> None:
        if int(state["pool_lanes"]) != self.pool_lanes:
            raise ValueError(
                f"journal snapshot was taken under pool_lanes="
                f"{state['pool_lanes']}, recovering allocator has "
                f"{self.pool_lanes}; refusing to mix incarnations")
        self._running = {r["job_id"]: _Running(**r)
                         for r in state["running"]}
        self._pending = [_Pending(**p) for p in state["pending"]]
        self._deficit = dict(state["deficit"])
        c = state["counters"]
        self.gang_placements = int(c["gang_placements"])
        self.preemptions = int(c["preemptions"])
        self.aged_grants = int(c["aged_grants"])
        self.quota_clamps = int(c["quota_clamps"])
        self.fencing_rejections = int(c["fencing_rejections"])
        self.recoveries = int(c["recoveries"])
        self.journal_records = int(c["journal_records"])
        self.journal_compactions = int(c["journal_compactions"])
        self.fencing_epoch = int(state["fencing_epoch"])
        self._grant_epochs = {j: int(e)
                              for j, e in state["grant_epochs"].items()}
        self._last_now = state["last_now"]

    def _apply_record(self, rec: dict) -> None:
        """Re-execute one journaled op under its recorded clock reading
        and verify it reproduces the journaled decisions — divergence
        means the journal and the code disagree about history, which
        must never be papered over."""
        self._replay_now = float(rec["now"])
        op, args = rec["op"], rec["args"]
        try:
            if op == "submit":
                got = self.submit(**args)
            elif op == "release":
                got = self.release(**args)
            elif op == "resize":
                got = self.resize(**args)
            elif op == "regrant":
                self.regrant(**args)
                got = []
            elif op == "fence_reject":
                try:
                    self.fence_check(**args)
                except StaleGrantError:
                    pass
                got = []
            elif op == "recover":
                self.mark_recovered(**args)
                got = []
            else:
                raise JournalCorruptError(
                    f"journal record {rec.get('i')}: unknown op {op!r}")
        finally:
            self._replay_now = None
        want = rec.get("decisions", [])
        if [dataclasses.asdict(d) for d in got] != want:
            raise JournalCorruptError(
                f"journal record {rec.get('i')} ({op}) replayed to "
                f"different decisions than were journaled — refusing "
                f"to fork history")

    @classmethod
    def recover(cls, journal: DecisionJournal, pool_lanes: int,
                tenant_weights: Optional[Dict[str, float]] = None,
                tenant_quotas: Optional[Dict[str, int]] = None,
                clock: Callable[[], float] = time.monotonic,
                aging_s: float = DEFAULT_AGING_S,
                compact_every: int = 0) -> "ClusterAllocator":
        """Reconstruct an allocator from its journal: restore the
        compaction snapshot, then re-execute the tail ops under their
        recorded clock readings. The result's `snapshot()` equals the
        pre-crash allocator's at the last durable index — the
        crash-at-every-index sweep in tests/test_torch_journal.py
        asserts exactly that. Call `mark_recovered()` afterwards to
        bump the fencing epoch (kept separate so the sweep can compare
        the PURE reconstruction first)."""
        state, tail = journal.replay()
        alloc = cls(pool_lanes, tenant_weights, tenant_quotas,
                    clock=clock, aging_s=aging_s, journal=journal,
                    compact_every=compact_every)
        if state is not None:
            alloc._restore_state(state)
        alloc._replaying = True
        try:
            for rec in tail:
                alloc._apply_record(rec)
        finally:
            alloc._replaying = False
        return alloc

    def mark_recovered(self, delta: Optional[float] = None) -> int:
        """The recovered control plane is live again: bump the fencing
        epoch (all pre-crash grants become stale) and rebase the queue/
        placement timestamps onto this incarnation's clock, preserving
        each job's accrued age (the old process's monotonic readings
        are meaningless here). Journaled as its own op so a second
        crash replays the bump too. Returns the new epoch."""
        with self._lock:
            now = self._now()
            if delta is None:
                delta = 0.0 if self._last_now is None \
                    else now - self._last_now
            for p in self._pending:
                p.enqueued_at += delta
            for r in self._running.values():
                r.placed_at += delta
            self.fencing_epoch += 1
            self.recoveries += 1
            self._record("recover", {"delta": delta}, now, [])
            return self.fencing_epoch

    def fence_check(self, job_id: str, epoch: int) -> None:
        """Validate a worker's grant epoch. A mismatch (or a grant the
        allocator no longer holds) is the split-brain signature — a
        worker from a previous control-plane incarnation whose lanes
        may have been given away. Rejections are journaled (they bump a
        counter that must survive restart) and raise StaleGrantError
        (409)."""
        with self._lock:
            current = self._grant_epochs.get(job_id, 0)
            if int(epoch) == current and current > 0:
                return
            now = self._now()
            self.fencing_rejections += 1
            self._record("fence_reject",
                         {"job_id": job_id, "epoch": int(epoch)}, now, [])
            raise StaleGrantError(job_id, int(epoch), current)

    def regrant(self, job_id: str) -> Optional[Tuple[int, int]]:
        """Re-adopt a surviving pre-crash job: stamp its grant with the
        CURRENT fencing epoch at its journaled width. Returns (lanes,
        epoch), or None when the job is not a running pool member (the
        scheduler then requeues it instead)."""
        with self._lock:
            rec = self._running.get(job_id)
            if rec is None:
                return None
            now = self._now()
            self._grant_epochs[job_id] = self.fencing_epoch
            self._record("regrant", {"job_id": job_id}, now, [])
            return rec.lanes, self.fencing_epoch

    def grant_epoch(self, job_id: str) -> int:
        """Current fencing epoch of `job_id`'s grant (0 = no grant)."""
        with self._lock:
            return self._grant_epochs.get(job_id, 0)

    def running_jobs(self) -> Dict[str, int]:
        """{job_id: lanes} of current pool members, sorted by job id —
        the scheduler's recovery sweep walks this to decide re-adopt
        vs. requeue."""
        with self._lock:
            return {j: self._running[j].lanes
                    for j in sorted(self._running)}

    def pending_jobs(self) -> List[str]:
        """Parked job ids in queue order."""
        with self._lock:
            return [p.job_id for p in self._pending]

    # -------------------------------------------------------------- surface

    def submit(self, job_id: str, tenant: str = DEFAULT_TENANT,
               priority: int = 0, lanes: int = 1,
               kind: str = "train") -> List[Decision]:
        """Admit one job's gang request. Returns the decisions to apply:
        an immediate atomic 'place', or 'queue' (possibly alongside
        'preempt' decisions naming the victims making room). `kind` is
        the gang kind: 'train' worker gangs and 'serving' replica gangs
        (serve/fleet.py via the scheduler's /serve/resize) share the
        one pool and the same placement/preemption machinery."""
        with self._lock:
            now = self._now()
            lanes = max(1, min(int(lanes), self.pool_lanes))
            tenant = tenant or DEFAULT_TENANT
            if job_id in self._running \
                    or any(p.job_id == job_id for p in self._pending):
                raise ValueError(f"job {job_id} already admitted")
            p = _Pending(job_id, tenant, int(priority), lanes,
                         enqueued_at=now, kind=str(kind))
            self._pending.append(p)
            decisions = self._grants(now)
            if any(p.job_id == job_id for p in self._pending):
                decisions += self._preempt_for(p, now)
                decisions.append(Decision(
                    "queue", job_id, lanes=lanes,
                    detail=f"parked: {self._free()} free lane(s), "
                           f"gang wants {lanes}"))
            self._record("submit",
                         {"job_id": job_id, "tenant": tenant,
                          "priority": int(priority), "lanes": lanes,
                          "kind": str(kind)}, now, decisions)
            return decisions

    def release(self, job_id: str) -> List[Decision]:
        """A job left the pool (finished, failed, or a preempted victim
        exited after its drain) or abandoned the queue. Frees its
        lanes, accrues the weighted-fair deficit, and returns any
        'place' grants the freed lanes unlock."""
        with self._lock:
            now = self._now()
            rec = self._running.pop(job_id, None)
            self._grant_epochs.pop(job_id, None)
            if rec is None:
                self._pending = [p for p in self._pending
                                 if p.job_id != job_id]
                self._record("release", {"job_id": job_id}, now, [])
                return []
            self._accrue_deficit(rec.lanes)
            decisions = self._grants(now)
            self._record("release", {"job_id": job_id}, now, decisions)
            return decisions

    def resize(self, job_id: str, requested: int) -> List[Decision]:
        """The per-job advisor (ThroughputBasedPolicy) asked for a new
        width. Shrinks always land (frees lanes → may grant parked
        work); grows are clamped by free lanes, the tenant quota, and
        parked equal-or-higher-priority work (freed lanes go to the
        queue first). First decision is always the 'resize' answer."""
        with self._lock:
            now = self._now()
            requested = max(1, int(requested))
            rec = self._running.get(job_id)
            if rec is None:
                decisions = [Decision("resize", job_id, lanes=requested,
                                      detail="job not pool-managed; "
                                             "advisor width passes "
                                             "through")]
                self._record("resize", {"job_id": job_id,
                                        "requested": requested},
                             now, decisions)
                return decisions
            quota_cap = self._quota(rec.tenant) \
                - self._in_use(rec.tenant) + rec.lanes \
                if rec.tenant in self.tenant_quotas else self.pool_lanes
            allowed = min(requested, quota_cap)
            if allowed > rec.lanes:
                grow_cap = rec.lanes + self._free()
                if any(self._eff_priority(p, now) >= rec.priority
                       for p in self._pending):
                    grow_cap = rec.lanes  # parked peers claim frees first
                allowed = min(allowed, grow_cap)
            allowed = max(1, allowed)
            path = detail = ""
            if allowed < min(requested, quota_cap):
                detail = (f"grow {rec.lanes}->{requested} clamped to "
                          f"{allowed}: free lanes/parked work")
            if quota_cap < requested:
                path = "quota-clamp"
                self.quota_clamps += 1
                detail = (f"advisor asked {requested}, tenant "
                          f"{rec.tenant} quota {self._quota(rec.tenant)} "
                          f"lane(s) allows {allowed}")
            if rec.kind == "serving" and not path:
                # the second gang kind's signature decision: a serving
                # fleet's replica count flexes through the shared pool
                path = "serve-elastic"
                if not detail:
                    detail = (f"serving gang resized {rec.lanes}->"
                              f"{allowed} lane(s) elastically")
            decisions = [Decision("resize", job_id, lanes=allowed,
                                  path=path, detail=detail,
                                  epoch=self._grant_epochs.get(job_id, 0))]
            if allowed != rec.lanes:
                freed = rec.lanes - allowed
                rec.lanes = allowed
                if freed > 0:
                    self._accrue_deficit(freed)
                    decisions += self._grants(now)
            self._record("resize", {"job_id": job_id,
                                    "requested": requested},
                         now, decisions)
            return decisions

    def running_lanes(self, job_id: str) -> Optional[int]:
        """Lanes currently held by `job_id`, or None when it is not a
        running pool member (the scheduler's /serve/resize uses this to
        pick submit-vs-resize for a serving gang)."""
        with self._lock:
            rec = self._running.get(job_id)
            return None if rec is None else rec.lanes

    # ------------------------------------------------------------ telemetry

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The cluster telemetry sample: fed to the PS (POST /cluster)
        for the Prometheus gauges, and through the health pipeline
        under CLUSTER_JOB_ID for the queue-starvation rule and the
        `kubeml top` cluster pane.

        Deterministically ordered — tenants, priorities, gangs and
        counters all sort — so two allocators with equal state produce
        byte-equal JSON and the replay-equality sweep compares
        canonical forms. `now` pins the clock reading (replay-equality
        comparisons across two allocator instances)."""
        with self._lock:
            if now is None:
                now = self.clock()
            in_use = self.pool_lanes - self._free()
            by_prio: Dict[str, int] = {}
            for prio in sorted({p.priority for p in self._pending}):
                by_prio[str(prio)] = sum(1 for p in self._pending
                                         if p.priority == prio)
            tenants = sorted(set(self.tenant_weights)
                             | set(self.tenant_quotas)
                             | {r.tenant for r in self._running.values()}
                             | {p.tenant for p in self._pending})
            oldest = max((now - p.enqueued_at for p in self._pending),
                         default=0.0)
            return {
                "job_id": CLUSTER_JOB_ID,
                "cluster_pool_lanes": self.pool_lanes,
                "cluster_lanes_in_use": in_use,
                "cluster_running_jobs": len(self._running),
                "cluster_queue_depth": len(self._pending),
                "cluster_queue_by_priority": by_prio,
                "cluster_oldest_wait_s": oldest,
                "cluster_tenant_lanes": {
                    t: self._in_use(t) for t in tenants},
                "cluster_tenant_quota": {
                    t: self._quota(t) for t in tenants},
                "cluster_tenant_weight": {
                    t: self._weight(t) for t in tenants},
                "cluster_serving_jobs": sum(
                    1 for r in self._running.values()
                    if r.kind == "serving"),
                "cluster_serving_lanes": sum(
                    r.lanes for r in self._running.values()
                    if r.kind == "serving"),
                "cluster_running_gangs": [
                    {"job_id": j, "lanes": self._running[j].lanes,
                     "kind": self._running[j].kind,
                     "epoch": self._grant_epochs.get(j, 0)}
                    for j in sorted(self._running)],
                "cluster_gang_placements_total": self.gang_placements,
                "cluster_preemptions_total": self.preemptions,
                "cluster_aged_grants_total": self.aged_grants,
                "cluster_quota_clamps_total": self.quota_clamps,
                "cluster_fencing_epoch": self.fencing_epoch,
                "cluster_fencing_rejections_total":
                    self.fencing_rejections,
                "cluster_recoveries_total": self.recoveries,
                "cluster_journal_records_total": self.journal_records,
                "cluster_journal_compactions_total":
                    self.journal_compactions,
                "cluster_journal_torn_drops_total":
                    self._journal.torn_drops
                    if self._journal is not None else 0,
            }


def verify_journal_roundtrip(alloc: ClusterAllocator) -> dict:
    """Round-trip check: replay `alloc`'s journal into a twin and
    assert the twin's snapshot equals the live one at the same pinned
    clock reading. Raises JournalCorruptError on divergence, returns
    the canonical snapshot. Used by the durability tests after every
    workload and by Scheduler.recover() as a post-recovery self-check —
    a recovery that cannot reproduce itself must fail loudly, not
    serve traffic from a forked history."""
    if alloc._journal is None:
        raise ValueError("allocator has no journal to verify against")
    now = alloc.clock()
    live = alloc.snapshot(now=now)
    twin_journal = DecisionJournal(alloc._journal.dir)
    twin_journal.journal_path = alloc._journal.journal_path
    twin_journal.snapshot_path = alloc._journal.snapshot_path
    twin = ClusterAllocator.recover(
        twin_journal, alloc.pool_lanes,
        tenant_weights=alloc.tenant_weights,
        tenant_quotas=alloc.tenant_quotas,
        clock=alloc.clock, aging_s=alloc.aging_s)
    replayed = twin.snapshot(now=now)
    # torn drops are a property of each PROCESS's journal handle (what
    # it repaired at its own boot), not of the journaled history — the
    # twin reads an already-repaired file and legitimately sees zero
    for s in (live, replayed):
        s.pop("cluster_journal_torn_drops_total", None)
    if replayed != live:
        diff = {k for k in set(live) | set(replayed)
                if live.get(k) != replayed.get(k)}
        raise JournalCorruptError(
            f"journal replay diverged from live state on key(s) "
            f"{sorted(diff)}")
    return live
