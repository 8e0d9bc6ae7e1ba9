"""The serving fleet: N decode replicas behind one router, scaled to load
(twin of kubeml_tpu/serve/fleet.py; the PS keeps its durable manifest).

One ``ServeFleet`` fronts N ``ServeService`` replicas of one model:

* **Routing** — consistent-hash prefix affinity over
  ``pager.routing_digest`` (the chain hash of the first full prompt
  page): prompts that share a first page route to the same replica,
  whose prefix cache can then serve one's pages to the other. Sessions
  pin sticky, and a saturated owner spills to the least-loaded admitting
  peer; a request every attempt sheds surfaces with the fleet-minimum
  Retry-After.

* **Lifecycle** — replicas come from a caller-supplied factory (index
  -> unstarted ``ServeService``), retire through ``drain(grace_s)``
  (admission 503s on the victim, its streams finish, then it stops), and
  cold-start from zero on the first request.

* **Autoscaling** — ``autoscale_once`` reads shed deltas, the queue
  fraction and the multi-window SLO burn rate (serve/slo.py), grows
  toward ``replicas_max``, shrinks idle replicas toward ``replicas_min``
  and drains the fleet away after ``scale_to_zero_s`` without
  admissions. Each resize is offered to ``resize_cb`` first, which fails
  open.

* **Failure domains** — ``supervise_once`` ejects a dead replica
  (killed, or its loop gone) or a crash-looping one (restarts past
  ``replica_restart_budget``): off the ring, sessions purged, every
  stream in flight harvested and live-migrated to survivors, where it
  resumes with the same tokens (prompt + emitted tokens re-prefilled,
  per-(seed, position) sampling keys), each move charged against
  ``MIGRATION_BUDGET``. A replacement enters PROBATION (live, off the
  ring) until ``probe_requests`` real requests finish ok; a stream queued
  past ``hedge_after_s`` on a straggler is re-issued on a peer.

Both ticks are public and take the time as an argument, so tests drive
them with a fake clock; the background thread calls them on a cadence.

Lock discipline: replica loop threads call into the fleet
(``_on_replica_publish``) while holding their own ``_cv``, so the only
legal lock order is replica ``_cv`` -> fleet lock. Under the fleet lock
only lock-free replica reads run (``snapshot()``, ``would_admit()``,
``inflight``); anything that takes a replica's ``_cv`` or blocks runs
outside it.
"""

from __future__ import annotations

import bisect
import collections
import hashlib
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubeml_tpu_torch.faults import (FleetFaultPlan, ServeFaultEvent,
                                     ServeFaultPlan)
from kubeml_tpu_torch.metrics.ledger import merge_cost_snapshots
from kubeml_tpu_torch.metrics.sketch import QuantileSketch
from kubeml_tpu_torch.serve.pager import routing_digest
from kubeml_tpu_torch.serve.service import TRACE_FLUSH_EVERY, ServeService
from kubeml_tpu_torch.serve.slo import DEFAULT_SLO_TARGET, SLOEngine
from kubeml_tpu_torch.serve.slots import (GenerateRequest, ServeDraining,
                                          ServeSaturated)

logger = logging.getLogger("kubeml_tpu_torch.serve.fleet")

# Router / lifecycle paths a request or scale event can take (the keys of
# ServeFleet.path_counts).
FLEET_PATH_VARIANTS = (
    "affine_hit",     # routed to the consistent-hash owner and admitted
    "spill",          # owner saturated/draining; a peer took the stream
    "cold_start",     # fleet was at zero; first request built replica 0
    "shrink_drain",   # autoscaler retired an idle replica via drain
    "scale_to_zero",  # idle budget expired; the whole fleet drained away
    "eject",          # supervisor removed a dead/crash-looping replica
    "failover_migrate",  # in-flight stream resumed on a survivor
    "probe_rejoin",   # probation passed; vnodes rejoined the ring
    "hedge",          # queued stream re-issued off a straggler replica
)

# Fleet-level span kinds on a request's trace timeline: every routing and
# failure-domain decision lands on the request's tree (parent
# "generate", the request's trace id), so GET /trace merges one connected
# tree per request across every replica it touched.
FLEET_SPAN_KINDS = (
    "route",            # router entry -> admission, with replica + path
    "affine_hit",       # admitted on the consistent-hash owner
    "spill",            # owner saturated/missing; a peer admitted
    "retry",            # a replica shed; the router retried a peer
    "cold_start_wait",  # request waited on the cold-start build
    "migrate",          # stream resumed on a survivor after ejection
    "hedge",            # queued stream re-issued off a straggler
    "probe",            # half-open probe routed to a probationer
)

# ring points per replica: enough that removing one replica moves only
# ~1/N of the keyspace instead of re-homing every prefix
VNODES = 32

# consecutive idle autoscale ticks before one replica is shrunk — a
# momentary lull between bursts must not thrash the replica count
SHRINK_IDLE_TICKS = 3

# Retry-After handed to requests that arrive WHILE replica 0 is cold
# starting: dominated by the two jitted compiles, so order-seconds
COLD_START_WARM_ESTIMATE_S = 8.0

# sticky session -> replica LRU capacity
SESSION_CACHE = 4096

# Per-stream migration budget: total times one stream may be moved to
# another replica (ejection failover or hedge) before the fleet fails
# it with an attributable error. A request whose decode kills every
# replica it lands on would otherwise tour the ring forever, taking a
# fresh replica down on each hop.
MIGRATION_BUDGET = 2


def _ring_point(idx: int, vnode: int) -> int:
    h = hashlib.sha256(f"replica:{idx}:{vnode}".encode()).digest()
    return int.from_bytes(h[:8], "big")


class ServeFleet:
    """Router + lifecycle manager + autoscaler for one model's replicas.

    ``replica_factory(index)`` returns an UNSTARTED ``ServeService``;
    the fleet silences its per-model gauges, installs its own health
    callback, and starts it. ``resize_cb(replicas)`` (optional) offers
    each resize to the cluster allocator and returns the granted count.
    """

    def __init__(self, model_id: str,
                 replica_factory: Callable[[int], ServeService], *,
                 replicas_min: int = 1, replicas_max: int = 1,
                 scale_to_zero_s: float = 0.0,
                 drain_grace_s: float = 5.0,
                 page_tokens: int = 16,
                 routing: str = "affine",
                 metrics=None,
                 health_cb: Optional[Callable[[dict], None]] = None,
                 resize_cb: Optional[Callable[[int], int]] = None,
                 autoscale_interval_s: float = 1.0,
                 ttft_slo_s: float = 2.0,
                 replica_restart_budget: int = 2,
                 probe_requests: int = 2,
                 hedge_after_s: float = 0.0,
                 fault_plan=None,
                 tracer=None, trace_sink=None,
                 slo_ttft_s: float = 0.0,
                 slo_tpot_s: float = 0.0,
                 slo_target: float = DEFAULT_SLO_TARGET,
                 clock=time.perf_counter):
        if routing not in ("affine", "random"):
            raise ValueError(f"routing must be 'affine' or 'random', "
                             f"got {routing!r}")
        self.model_id = model_id
        self.clock = clock
        self._factory = replica_factory
        self.replicas_min = max(0, int(replicas_min))
        self.replicas_max = max(1, int(replicas_max), self.replicas_min)
        self.scale_to_zero_s = float(scale_to_zero_s)
        self.drain_grace_s = float(drain_grace_s)
        self.page_tokens = max(1, int(page_tokens))
        self.routing = routing
        self.metrics = metrics
        self.health_cb = health_cb
        self.resize_cb = resize_cb
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.ttft_slo_s = float(ttft_slo_s)
        # failure-domain knobs: restarts past the budget = crash loop
        # (eject); probe_requests successful half-open probes graduate a
        # probationer back onto the ring; hedge_after_s > 0 arms hedged
        # retry for streams queued that long on one replica
        self.replica_restart_budget = max(0, int(replica_restart_budget))
        self.probe_requests = max(1, int(probe_requests))
        self.hedge_after_s = float(hedge_after_s)
        self.fault_plan = None if fault_plan is None \
            else FleetFaultPlan.parse(fault_plan)
        # fleet-level tracing: routing / failure-domain decisions land
        # on the request's trace timeline (FLEET_SPAN_KINDS above). The
        # fleet has its own tracer + sink file in the serve:<model>
        # trace dir; merge_job_trace stitches it with the replicas'.
        self.tracer = tracer
        self.trace_sink = trace_sink
        self._events_flushed = 0
        self._trace_dirty = False
        # SLO plane: objectives stamped on every replica (good/bad
        # classification happens where the request finishes), burn-rate
        # windows ticked by the autoscaler from cumulative good/bad
        # deltas. An unset TTFT objective inherits ttft_slo_s so the
        # burn-rate signal always has teeth.
        self.slo_ttft_s = float(slo_ttft_s) if slo_ttft_s > 0 \
            else self.ttft_slo_s
        self.slo_tpot_s = float(slo_tpot_s)
        self._slo = SLOEngine(self.slo_ttft_s, self.slo_tpot_s,
                              target=slo_target)
        self._slo_good_seen = 0
        self._slo_bad_seen = 0

        self._lock = threading.Lock()
        self._replicas: "collections.OrderedDict[int, ServeService]" = \
            collections.OrderedDict()
        self._draining: set = set()      # idxs mid-retire (off the ring)
        # circuit half-open: idx -> {"ok": probes succeeded, "probes":
        # in-flight probe requests}. Probationers are live processes but
        # OFF the ring; _pick hands them real traffic up to the probe
        # quota, and supervise_once graduates or re-arms them.
        self._probation: Dict[int, dict] = {}
        self._supervise_ticks = 0
        self._next_idx = 0
        self._ring: List[Tuple[int, int]] = []   # sorted (point, idx)
        self._sessions: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._stopped = False
        # cold start: first submit against an empty fleet builds replica
        # 0 synchronously (that request is served, not shed); concurrent
        # arrivals shed with the remaining warm estimate
        self._warming = False
        self._warm_started = 0.0
        self._last_submit = clock()
        self._idle_ticks = 0
        self._rr = 0                     # routing="random" counter
        # totals folded in from retired replicas so fleet aggregates
        # stay monotone across shrink / scale-to-zero
        self._retired: Dict[str, int] = collections.defaultdict(int)
        # retired replicas' cost-ledger totals (merged snapshot form),
        # folded in like _retired so GET /cost and the kubeml_cost_*
        # counters do not dip on shrink
        self._retired_cost: Dict[str, dict] = {}
        # per-replica prefix hit/miss cursors for the delta fields the
        # fleet snapshot exposes (satellite: per-replica cache health).
        # Keyed by replica EPOCH (restarts_total) as well: a recovered
        # engine's cumulative counters restart at zero, so deltas must
        # re-baseline per epoch or go negative / double-count.
        self._prefix_seen: Dict[int, Tuple[int, int, int]] = {}
        self._rejected_seen = 0          # autoscaler shed-delta cursor
        self._router_rejected_total = 0  # sheds surfaced BY the router
        # the testable surface: how many times each FLEET_PATH_VARIANTS
        # path was taken
        self.path_counts: Dict[str, int] = {
            name: 0 for name in FLEET_PATH_VARIANTS}
        self.cold_starts_total = 0
        self.spills_total = 0
        self.router_retries_total = 0
        self.grows_total = 0
        self.shrinks_total = 0
        self.scale_to_zero_total = 0
        self.ejections_total = 0
        self.failovers_total = 0         # ejections that moved >= 1 stream
        self.migrated_streams_total = 0  # streams moved (failover + hedge)
        self.probes_total = 0            # half-open probe requests routed
        self.hedges_total = 0
        self.decisions: "collections.deque" = collections.deque(maxlen=64)
        self._stop_event = threading.Event()
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop,
            name=f"fleet-autoscale-{model_id}", daemon=True)
        self._started = False

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "ServeFleet":
        """Spawn the floor replica set and the autoscaler thread. With
        ``replicas_min == 0`` the fleet starts EMPTY and cold-starts on
        the first request (serverless semantics)."""
        self._started = True
        for _ in range(self.replicas_min):
            self._spawn_one()
        if self.autoscale_interval_s > 0:
            self._autoscale_thread.start()
        return self

    def _spawn_one(self, path: Optional[str] = None,
                   probation: bool = False) -> int:
        """Build + start one replica (caller must NOT hold the lock:
        the factory loads checkpoints and compiles nothing yet, but it
        is slow and must never serialize the router). With
        ``probation=True`` the replica comes up in the half-open state:
        live but OFF the ring until its probe requests succeed."""
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        svc = self._factory(idx)
        # the fleet owns the per-model gauges (it publishes the MERGED
        # snapshot); replicas keep their additive counters/histograms
        svc.publish_state_gauges = False
        svc.health_cb = (lambda snap, _i=idx:
                         self._on_replica_publish(_i, snap))
        # SLO objectives ride on the replica: good/bad classification
        # happens where the request reaches its terminal state
        svc.slo_ttft_s = self.slo_ttft_s
        svc.slo_tpot_s = self.slo_tpot_s
        svc.start()
        with self._lock:
            self._replicas[idx] = svc
            if probation:
                self._probation[idx] = {"ok": 0, "probes": []}
            self._rebuild_ring()
            if path is not None:
                self._count_path(path)
        logger.info("fleet %s: replica %d up (%d live%s)", self.model_id,
                    idx, self.replica_count,
                    ", probation" if probation else "")
        return idx

    def _retire(self, idx: int, path: str) -> bool:
        """Drain one replica off the fleet: off the ring first (no new
        work routes to it), then the grace drain (in-flight
        streams finish), then stop. Returns True when the drain emptied
        the replica within the grace budget."""
        with self._lock:
            svc = self._replicas.get(idx)
            if svc is None or idx in self._draining:
                return True
            self._draining.add(idx)
            self._rebuild_ring()
        drained = svc.drain(self.drain_grace_s)
        svc.stop(grace_s=0.0)
        with self._lock:
            self._fold_retired(svc, idx)
            self._replicas.pop(idx, None)
            self._draining.discard(idx)
            self._probation.pop(idx, None)
            self._purge_sessions(idx)
            self._count_path(path)
        logger.info("fleet %s: replica %d retired (%s, drained=%s, "
                    "%d live)", self.model_id, idx, path, drained,
                    self.replica_count)
        return drained

    def _fold_retired(self, svc: ServeService, idx: int) -> None:
        """Accumulate a retiring replica's monotone totals (lock held)
        so fleet aggregates never go backwards on shrink."""
        st = svc.engine.stats
        self._retired["rejected"] += svc.rejected_total
        self._retired["restarts"] += svc.restarts_total
        self._retired["poisoned"] += svc.poisoned_total
        self._retired["deadline"] += svc.deadline_total
        self._retired["slo_good"] += svc.slo_good_total
        self._retired["slo_bad"] += svc.slo_bad_total
        self._retired["prefix_hits"] += int(st["prefix_hits"])
        self._retired["prefix_misses"] += int(st["prefix_misses"])
        self._retired_cost = merge_cost_snapshots(
            [self._retired_cost, svc.engine.ledger.snapshot()])
        self._prefix_seen.pop(idx, None)

    def drain(self, grace_s: float) -> bool:
        """Graceful fleet drain: every replica flips to 503 at once,
        then the grace budget is shared across them (they drain
        concurrently — each polls its own in-flight count)."""
        with self._lock:
            self._stopped = True
            svcs = list(self._replicas.values())
        ok = True
        deadline = self.clock() + float(grace_s)
        for svc in svcs:
            ok = svc.drain(max(0.0, deadline - self.clock())) and ok
        return ok

    def stop(self, timeout: float = 10.0, grace_s: float = 0.0) -> None:
        self._stop_event.set()
        with self._lock:
            self._stopped = True
            svcs = list(self._replicas.values())
            self._replicas.clear()
            self._probation.clear()
            self._ring = []
        for svc in svcs:
            svc.stop(timeout=timeout, grace_s=grace_s)
        if self._autoscale_thread.is_alive():
            self._autoscale_thread.join(timeout)
        self._flush_trace(force=True)

    def scale_to_zero(self, reason: str = "requested") -> None:
        """Drain every live replica away (preemption / idle budget).
        The fleet stays routable: the next submit cold-starts."""
        with self._lock:
            idxs = [i for i in self._replicas if i not in self._draining]
        if not idxs:
            return
        self._resize_grant(0)
        for idx in idxs[:-1]:
            self._retire(idx, "shrink_drain")
        self._retire(idxs[-1], "scale_to_zero")
        with self._lock:
            self.scale_to_zero_total += 1
            self.shrinks_total += len(idxs) - 1
            self._note_decision("scale_to_zero", reason)
        self._publish_merged()

    # -------------------------------------------------------------- routing
    def _live_idxs(self) -> List[int]:
        """Replicas new work may route to (lock held). Probationers are
        excluded — they only receive half-open probe traffic."""
        return [i for i in self._replicas
                if i not in self._draining and i not in self._probation]

    def _rebuild_ring(self) -> None:
        """(lock held) VNODES sha256 points per live replica."""
        self._ring = sorted(
            (_ring_point(i, v), i)
            for i in self._replicas
            if i not in self._draining and i not in self._probation
            for v in range(VNODES))

    def _purge_sessions(self, idx: int) -> None:
        """(lock held) drop sticky entries pinned to a departed replica
        so the next request with that session re-resolves through the
        ring instead of 500ing on a dead index."""
        for key in [k for k, v in self._sessions.items() if v == idx]:
            del self._sessions[key]

    def _ring_owner(self, digest: bytes) -> Optional[int]:
        """(lock held) first ring point at/after the key, wrapping."""
        if not self._ring:
            return None
        key = int.from_bytes(digest[:8], "big")
        pos = bisect.bisect_left(self._ring, (key, -1))
        if pos == len(self._ring):
            pos = 0
        return self._ring[pos][1]

    def _least_loaded(self, live: List[int],
                      exclude: set) -> Optional[int]:
        """(lock held) spill target: fewest in-flight among admitting
        candidates; falls back to fewest in-flight overall."""
        cands = [i for i in live if i not in exclude]
        if not cands:
            return None
        admitting = [i for i in cands if self._replicas[i].would_admit()]
        pool = admitting or cands
        return min(pool, key=lambda i: (self._replicas[i].inflight, i))

    def _pick(self, digest: bytes, session: Optional[str],
              attempted: set) -> Tuple[Optional[int], Optional[str]]:
        """(lock held) choose the next replica to try and the path name
        that a SUCCESSFUL admission there should count. The sentinel
        path "probe" is not a FLEET_PATH_VARIANTS entry — submit()
        tracks it in the probation ledger instead of path_counts (the
        countable event is the later "probe_rejoin")."""
        live = self._live_idxs()
        if not attempted:
            # half-open circuit: a probationer with remaining probe
            # quota takes real traffic BEFORE the ring — serving probes
            # to "ok" is the only way it earns its vnodes back. Retries
            # after a shed skip probation (a shed probe must not burn
            # the client's one retry on the same suspect replica).
            for i, st in self._probation.items():
                if i not in self._replicas:
                    continue
                if st["ok"] + len(st["probes"]) >= self.probe_requests:
                    continue
                if self._replicas[i].would_admit():
                    return i, "probe"
        cands = [i for i in live if i not in attempted]
        if not cands:
            return None, None
        if attempted:
            # the retry after a shed: least-loaded peer, counts as spill
            return self._least_loaded(live, attempted), "spill"
        if self.routing == "random":
            # the control arm: deterministic hash-of-counter choice,
            # deliberately blind to the prompt
            h = hashlib.sha256(str(self._rr).encode()).digest()
            self._rr += 1
            return cands[int.from_bytes(h[:8], "big") % len(cands)], None
        if session is not None:
            owner = self._sessions.get(session)
            if owner is not None and owner in cands:
                self._sessions.move_to_end(session)
                return owner, "affine_hit"
        owner = self._ring_owner(digest)
        if owner is None or owner not in cands:
            return self._least_loaded(live, attempted), "spill"
        if not self._replicas[owner].would_admit():
            # proactive spill: the owner would shed, a peer would not —
            # route around the 429 instead of collecting it
            peer = self._least_loaded(live, attempted | {owner})
            if peer is not None and self._replicas[peer].would_admit():
                return peer, "spill"
        return owner, "affine_hit"

    def _ensure_capacity(self, trace_id: Optional[str] = None) -> None:
        """Cold start from zero: the first thread against an empty
        fleet builds replica 0 synchronously and then SERVES its
        request; concurrent arrivals shed 429 with the remaining warm
        estimate so clients back off instead of dogpiling the build.
        The building request's trace gets a ``cold_start_wait`` span
        covering the build it waited on."""
        build = False
        with self._lock:
            self._last_submit = self.clock()
            if self._stopped:
                raise ServeSaturated(message="serving fleet stopped")
            if self._live_idxs():
                return
            if self._probation:
                # all routable replicas are ejected; half-open probes
                # are the only admission path until one graduates.
                # Fail FAST when no probationer can take this request —
                # the retry-once loop has nothing to retry against.
                for i, st in self._probation.items():
                    if (st["ok"] + len(st["probes"]) < self.probe_requests
                            and i in self._replicas
                            and self._replicas[i].would_admit()):
                        return      # _pick routes it as a probe
                raise self._all_ejected_error()
            if self._warming:
                remaining = max(
                    0.5, self._warm_started + COLD_START_WARM_ESTIMATE_S
                    - self.clock())
                raise ServeSaturated(
                    retry_after_s=remaining,
                    message="cold start in progress: replica warming "
                            "from zero")
            self._warming = True
            self._warm_started = self.clock()
            build = True
        if not build:
            return
        try:
            # offer the gang to the allocator, but proceed even on a
            # zero grant: a model with live traffic holds a serving
            # floor of one replica — the allocator can preempt it later
            # through /preempt (which scales the fleet back to zero)
            t0 = self.clock()
            self._resize_grant(1)
            idx = self._spawn_one(path="cold_start")
            self._span("cold_start_wait", t0, self.clock(),
                       trace_id=trace_id, replica=idx)
            with self._lock:
                self.cold_starts_total += 1
                self.grows_total += 1
                self._idle_ticks = 0
                self._note_decision("cold_start", "first request after "
                                                  "scale-to-zero")
        finally:
            with self._lock:
                self._warming = False

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               trace_id: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               session: Optional[str] = None) -> GenerateRequest:
        """Route one request into the fleet. Same contract as
        ``ServeService.submit`` plus ``session`` stickiness; a shed on
        the affine replica is retried ONCE against the least-loaded
        peer before the fleet surfaces it, and a surfaced shed carries
        the fleet-minimum Retry-After (not the first replica's)."""
        self._ensure_capacity(trace_id=trace_id)
        t_route = self.clock()
        digest = routing_digest(list(prompt), self.page_tokens)
        attempted: set = set()
        sheds: List[Exception] = []
        while True:
            with self._lock:
                idx, path = self._pick(digest, session, attempted)
                svc = self._replicas.get(idx) if idx is not None else None
            if svc is None:
                break
            try:
                req = svc.submit(prompt, max_new_tokens=max_new_tokens,
                                 temperature=temperature, seed=seed,
                                 eos_id=eos_id, trace_id=trace_id,
                                 deadline_ms=deadline_ms)
            except (ServeSaturated, ServeDraining) as e:
                sheds.append(e)
                attempted.add(idx)
                with self._lock:
                    if len(attempted) > 1 or not \
                            [i for i in self._live_idxs()
                             if i not in attempted]:
                        break       # retried once already, or no peer
                    self.router_retries_total += 1
                self._instant("retry", trace_id=trace_id,
                              shed_replica=idx)
                continue
            req.fleet_replica = idx     # cancel() routes on this
            # the routing decision on the request's timeline: router
            # entry -> admission, plus the per-path instant
            # ("affine_hit" / "spill" / "probe")
            now = self.clock()
            self._span("route", t_route, now, rid=req.rid,
                       trace_id=trace_id, replica=idx,
                       path=path or self.routing)
            if path in ("affine_hit", "spill", "probe"):
                self._instant(path, ts=now, rid=req.rid,
                              trace_id=trace_id, replica=idx)
            with self._lock:
                if path == "probe":
                    st = self._probation.get(idx)
                    if st is not None:
                        self.probes_total += 1
                        st["probes"].append(req)
                elif path is not None:
                    self._count_path(path)
                    if path == "spill":
                        self.spills_total += 1
                if session is not None:
                    self._sessions[session] = idx
                    self._sessions.move_to_end(session)
                    while len(self._sessions) > SESSION_CACHE:
                        self._sessions.popitem(last=False)
            return req
        self._surface_shed(sheds, attempted)

    def _surface_shed(self, sheds: List[Exception],
                      attempted: set) -> None:
        """Every routing attempt shed: surface ONE exception carrying
        the fleet-minimum Retry-After (satellite fix — the first
        replica's backlog must not set the whole fleet's hint)."""
        with self._lock:
            self._router_rejected_total += 1
            others = [self._replicas[i].estimated_retry_after_s()
                      for i in self._live_idxs() if i not in attempted]
            if not others and not sheds and self._probation:
                # an ejection raced this submit past _ensure_capacity:
                # same fail-fast 503 as the front door
                raise self._all_ejected_error()
        if len(sheds) == 1 and not others:
            raise sheds[0]          # single replica: verbatim pass-through
        candidates = [e.retry_after_s for e in sheds] + others
        retry = min(candidates) if candidates else 1.0
        if sheds and all(isinstance(e, ServeDraining) for e in sheds):
            raise ServeDraining(retry_after_s=retry)
        raise ServeSaturated(
            retry_after_s=retry,
            message=f"fleet at capacity: {len(sheds)} replica(s) shed "
                    f"the request")

    def cancel(self, req: GenerateRequest) -> None:
        idx = getattr(req, "fleet_replica", None)
        with self._lock:
            svc = self._replicas.get(idx) if idx is not None else None
            fallback = [] if svc is not None \
                else list(self._replicas.values())
        if svc is not None:
            svc.cancel(req)
            return
        for s in fallback:
            s.cancel(req)

    def install_weights(self, variables, stamp: Optional[float] = None
                        ) -> None:
        """Queue the hot-swap on every live replica (each applies it
        before its own next admissions, same zero-downtime contract as
        the single-service path)."""
        with self._lock:
            svcs = list(self._replicas.values())
        for svc in svcs:
            svc.install_weights(variables, stamp)

    # -------------------------------------------------------------- tracing
    # FLEET_SPAN_KINDS emission. Every event parents to the request's
    # "generate" root and carries its trace_id, so the merged document
    # is one connected tree per request even when the request crossed
    # replicas. None-valued args are dropped (a request without a
    # client trace id still gets fleet spans, they just float free).
    def _span(self, name: str, start: float, end: float, **args) -> None:
        if self.tracer is None:
            return
        self.tracer.add_span(
            name, start, end, parent="generate",
            **{k: v for k, v in args.items() if v is not None})
        self._trace_dirty = True

    def _instant(self, name: str, ts: Optional[float] = None,
                 **args) -> None:
        if self.tracer is None:
            return
        self.tracer.instant(
            name, ts=self.clock() if ts is None else ts,
            parent="generate",
            **{k: v for k, v in args.items() if v is not None})
        self._trace_dirty = True

    def _flush_trace(self, force: bool = False) -> None:
        # batched: the sink rewrites the WHOLE file each flush, so a
        # flush-per-event on the publish path is quadratic and starves
        # the replica loops under load. Unforced flushes wait for a
        # batch; stop()/eject flush with force=True so nothing is lost
        # where it matters.
        if self.trace_sink is None or self.tracer is None:
            return
        n = self.tracer.event_count()
        if not force and n - self._events_flushed < TRACE_FLUSH_EVERY:
            return
        try:
            self.trace_sink.write(self.tracer)
            self._events_flushed = n
        except OSError:
            logger.exception("fleet trace flush failed for %s",
                             self.model_id)

    def flush_trace(self) -> None:
        """Force the fleet's and every replica's buffered trace events
        to their sinks. `/trace` calls this before merging: unforced
        flushes are batched, so without it a freshly finished request
        could be missing from the merged document."""
        with self._lock:
            svcs = list(self._replicas.values())
        for svc in svcs:
            svc.flush_trace()
        self._flush_trace(force=True)

    # ------------------------------------------------------ failure domains
    def _all_ejected_error(self) -> ServeDraining:
        """(lock held) the fail-fast 503 for an empty ring with every
        surviving replica stuck in probation: Retry-After is the best
        probationer's own estimate (it is warm — its probes just have
        to land), falling back to the cold-start bound."""
        retries = [self._replicas[i].estimated_retry_after_s()
                   for i in self._probation if i in self._replicas]
        return ServeDraining(
            retry_after_s=max(1.0, min(retries,
                                       default=COLD_START_WARM_ESTIMATE_S)),
            message=f"all replicas ejected: {len(self._probation)} "
                    f"replica(s) in probation must pass half-open "
                    f"probes before the ring repopulates")

    def supervise_once(self, now: Optional[float] = None) -> List[str]:
        """One fleet supervision tick: (1) fire any due fleet fault
        injections, (2) detect failed replicas — killed / loop thread
        gone (``ServeService.failed``) or watchdog restarts past
        ``replica_restart_budget`` (the crash-loop signal the
        serve_crash_loop health rule keys on) — and eject them with
        live stream migration, (3) graduate probationers whose probe
        requests all finished ok back onto the ring, (4) hedge over-age
        queued streams off stragglers. Public and deterministic, same
        contract as ``autoscale_once``: the background thread calls it
        each tick, tests drive it directly. Returns the
        list of actions taken (path-variant names)."""
        now = self.clock() if now is None else now
        actions: List[str] = []
        with self._lock:
            if self._stopped:
                return actions
            self._supervise_ticks += 1
            tick = self._supervise_ticks
            live = self._live_idxs() + list(self._probation)
        # fault delivery runs OUTSIDE the fleet lock: kill and
        # force_restart take the victim replica's _cv
        if self.fault_plan is not None:
            for kind, idx, ev in self.fault_plan.fire(tick, live):
                with self._lock:
                    svc = self._replicas.get(idx)
                if svc is None:
                    continue
                if kind == "fleet_replica_crash":
                    svc.kill("injected fleet_replica_crash")
                elif kind == "fleet_replica_wedge":
                    # drive REAL recoveries until the budget is blown:
                    # the ejection below sees exactly the state a
                    # genuine crash loop leaves behind
                    for _ in range(self.replica_restart_budget + 1):
                        svc.force_restart("injected fleet_replica_wedge")
                elif kind == "fleet_replica_slow":
                    self._slow_replica(svc, ev.duration_s)
        with self._lock:
            candidates = [(i, self._replicas[i]) for i in self._replicas
                          if i not in self._draining]
        for idx, svc in candidates:
            if svc.failed:
                actions += self._eject(idx, "replica dead: loop thread "
                                            "gone or killed")
            elif svc.restarts_total > self.replica_restart_budget:
                actions += self._eject(
                    idx, f"crash-looping: {svc.restarts_total} watchdog "
                         f"restart(s) exceed the budget of "
                         f"{self.replica_restart_budget}")
        actions += self._advance_probation()
        if self.hedge_after_s > 0:
            actions += self._hedge_stragglers(now)
        return actions

    def _slow_replica(self, svc: ServeService, duration_s: float) -> None:
        """Deliver fleet_replica_slow: plant a WILDCARD serve_slow_step
        into the replica's engine fault plan — every subsequent step
        sleeps, turning the replica into a persistent straggler whose
        queued streams age past hedge_after_s and get hedged away."""
        ev = ServeFaultEvent(kind="serve_slow_step",
                             duration_s=float(duration_s))
        plan = getattr(svc.engine, "fault_plan", None)
        if plan is None:
            svc.engine.fault_plan = ServeFaultPlan([ev])
        else:
            plan.events.append(ev)

    def _eject(self, idx: int, reason: str) -> List[str]:
        """Eject one replica (circuit OPEN): off the ring immediately,
        sticky sessions purged, in-flight streams harvested and
        live-migrated to survivors, the dead service stopped, and —
        when the fleet would drop below its floor — a replacement
        spawned into PROBATION (it earns its vnodes back through
        probes; it does not get them for showing up)."""
        actions: List[str] = []
        with self._lock:
            svc = self._replicas.pop(idx, None)
            if svc is None:
                return actions
            self._draining.discard(idx)
            self._probation.pop(idx, None)
            self._purge_sessions(idx)
            self._rebuild_ring()
            self.ejections_total += 1
            self._count_path("eject")
            self._note_decision("eject", f"replica {idx}: {reason}")
            need_replacement = (
                len(self._live_idxs()) + len(self._probation)
                < max(1, self.replicas_min))
        logger.error("fleet %s: replica %d ejected (%s)", self.model_id,
                     idx, reason)
        actions.append("eject")
        # harvest OUTSIDE the fleet lock (eject_streams takes the
        # replica's _cv); the pager audit runs inside the evacuation
        streams = svc.eject_streams()
        # the dead replica's tracer still buffers spans emitted before
        # it died — force them to its sink file now, or the migrated
        # requests' merged trees lose their first half
        svc.flush_trace()
        with self._lock:
            self._fold_retired(svc, idx)
        svc.stop(grace_s=0.0)
        if streams:
            with self._lock:
                self.failovers_total += 1
            moved = self._migrate(streams, from_idx=idx)
            actions.append("failover_migrate")
            logger.warning("fleet %s: %d/%d stream(s) live-migrated off "
                           "replica %d", self.model_id, moved,
                           len(streams), idx)
        if need_replacement and not self._stopped:
            self._spawn_one(probation=True)
        self._publish_merged()
        return actions

    def _migrate(self, streams: List[GenerateRequest],
                 from_idx: Optional[int] = None) -> int:
        """Resume harvested streams on survivors. Routing goes through
        _pick like a fresh submit — the digest is a pure function of
        the prompt, so migration preserves prefix affinity on the
        SHRUNK ring — but unlike submit it tries every survivor before
        giving up (losing a stream is worse than a cold route). Each
        move is charged one migration; past MIGRATION_BUDGET the stream
        fails with an attributable error instead of ping-ponging. The
        request object (and its trace_id) survives the move, and a
        ``migrate`` event with ``resumed_from=<dead replica>`` stitches
        the two replicas' span trees into one."""
        moved = 0
        for req in streams:
            req.migrations += 1
            if req.migrations > MIGRATION_BUDGET:
                req.finish(
                    "error",
                    f"migration budget exhausted: stream moved "
                    f"{req.migrations - 1} time(s) across replica "
                    f"failures and will not be resumed again")
                continue
            digest = routing_digest(list(req.prompt), self.page_tokens)
            attempted: set = set()
            placed = False
            while True:
                with self._lock:
                    idx, path = self._pick(digest, None, attempted)
                    svc = self._replicas.get(idx) \
                        if idx is not None else None
                if svc is None:
                    break
                try:
                    svc.adopt(req)
                except (ServeSaturated, ServeDraining):
                    attempted.add(idx)
                    continue
                placed = True
                req.fleet_replica = idx
                with self._lock:
                    self.migrated_streams_total += 1
                    self._count_path("failover_migrate")
                    if path == "probe":
                        st = self._probation.get(idx)
                        if st is not None:
                            self.probes_total += 1
                            st["probes"].append(req)
                self._instant("migrate", rid=req.rid,
                              trace_id=req.trace_id,
                              resumed_from=from_idx, replica=idx,
                              emitted_tokens=len(req.tokens))
                moved += 1
                break
            if not placed:
                req.finish("error",
                           "replica ejected and no surviving replica "
                           "admitted the migrated stream")
        return moved

    def _advance_probation(self) -> List[str]:
        """Reap probe outcomes and graduate passing probationers back
        onto the ring. A probe that errored re-arms the gate (successes
        reset to zero — the circuit stays half-open); a cancelled probe
        neither counts nor resets (the client walked away, that says
        nothing about the replica)."""
        actions: List[str] = []
        rejoined: List[int] = []
        with self._lock:
            for idx in list(self._probation):
                st = self._probation[idx]
                if idx not in self._replicas:
                    del self._probation[idx]
                    continue
                still = []
                for req in st["probes"]:
                    if req.outcome is None:
                        still.append(req)
                    elif req.outcome == "ok":
                        st["ok"] += 1
                    elif req.outcome != "cancelled":
                        st["ok"] = 0
                st["probes"] = still
                if st["ok"] >= self.probe_requests:
                    del self._probation[idx]
                    self._rebuild_ring()
                    self._count_path("probe_rejoin")
                    self._note_decision(
                        "probe_rejoin",
                        f"replica {idx}: {st['ok']} probe(s) ok; "
                        f"vnodes rejoined")
                    rejoined.append(idx)
                    actions.append("probe_rejoin")
        for idx in rejoined:
            logger.info("fleet %s: replica %d passed probation and "
                        "rejoined the ring", self.model_id, idx)
            self._publish_merged()
        return actions

    def _hedge_stragglers(self, now: float) -> List[str]:
        """Hedged retry for gray failures: a stream still QUEUED (no
        slot, no first token) past hedge_after_s on one replica is
        withdrawn (steal_pending) and re-issued on the least-loaded
        admitting peer. Decode is deterministic per (seed, pos), so the
        re-issue IS the stream — no duplicate races to the client.
        Attached streams are out of scope: they are making (slow)
        progress, and only ejection may touch another replica's slot
        state. At most one stream moves per tick, so a slow replica
        drains gradually instead of stampeding its peers."""
        with self._lock:
            pairs = [(i, self._replicas[i]) for i in self._live_idxs()]
        for idx, svc in pairs:
            for req in list(svc._pending):
                if req.outcome is not None or req.cancelled:
                    continue
                if req.submitted_at is None \
                        or now - req.submitted_at <= self.hedge_after_s:
                    continue
                if req.migrations >= MIGRATION_BUDGET:
                    continue        # budget spent; leave it queued
                with self._lock:
                    peer = self._least_loaded(self._live_idxs(), {idx})
                    peer_svc = self._replicas.get(peer) \
                        if peer is not None else None
                if peer_svc is None or not peer_svc.would_admit():
                    return []       # nowhere better to put it
                if not svc.steal_pending(req):
                    continue        # attached/finished while we looked
                try:
                    peer_svc.adopt(req)
                except (ServeSaturated, ServeDraining):
                    try:
                        svc.adopt(req)      # undo: back where it was
                    except (ServeSaturated, ServeDraining):
                        req.finish("error", "hedge raced admission on "
                                            "both replicas")
                    continue
                req.migrations += 1
                req.fleet_replica = peer
                with self._lock:
                    self.hedges_total += 1
                    self.migrated_streams_total += 1
                    self._count_path("hedge")
                    self._note_decision(
                        "hedge",
                        f"stream {req.rid} queued "
                        f"{now - req.submitted_at:.2f}s on replica "
                        f"{idx}; re-issued on {peer}")
                self._instant("hedge", rid=req.rid,
                              trace_id=req.trace_id,
                              resumed_from=idx, replica=peer)
                return ["hedge"]
        return []

    # ------------------------------------------------------------ autoscaler
    def _autoscale_loop(self) -> None:
        while not self._stop_event.wait(self.autoscale_interval_s):
            try:
                # supervision first: an ejection this tick changes the
                # live set the scaling policy reads
                self.supervise_once()
                self.autoscale_once()
            except Exception:
                logger.exception("fleet %s autoscale tick failed",
                                 self.model_id)

    def autoscale_once(self, now: Optional[float] = None) -> Optional[str]:
        """One policy tick. Reads the per-replica SLO signals (shed
        delta since the last tick, queue fraction, multi-window SLO
        burn rate) and returns the action taken: 'grow', 'shrink',
        'scale_to_zero' or None. Public and deterministic so tests
        drive it directly; the background thread just calls it on a
        cadence."""
        now = self.clock() if now is None else now
        with self._lock:
            if self._stopped or self._warming:
                return None
            live = self._live_idxs()
            n = len(live)
            snaps = [self._replicas[i].snapshot() for i in live]
            inflight = sum(self._replicas[i].inflight for i in live)
            rejected = self._retired["rejected"] + sum(
                s["serve_rejected_total"] for s in snaps)
            shed_delta = max(0, rejected - self._rejected_seen)
            self._rejected_seen = rejected
            queue = sum(s["serve_queue_depth"] for s in snaps)
            qcap = sum(s["serve_queue_cap"] for s in snaps)
            # SLO burn tick: diff the fleet's cumulative good/bad
            # classification (retired replicas folded in) into the
            # fast/slow burn windows. Latency pressure is the BURN
            # RATE, not an instantaneous p99: an idle fleet's windows
            # drain to zero burn on their own, so the old "stale p99
            # over an idle fleet" guard (inflight > 0) is gone — the
            # signal expires instead of being special-cased.
            good = self._retired["slo_good"] + sum(
                s["serve_slo_good_total"] for s in snaps)
            bad = self._retired["slo_bad"] + sum(
                s["serve_slo_bad_total"] for s in snaps)
            good_delta = max(0, good - self._slo_good_seen)
            bad_delta = max(0, bad - self._slo_bad_seen)
            self._slo_good_seen = good
            self._slo_bad_seen = bad
            was_alerting = self._slo.alerting
            if self._slo.tick(good_delta, bad_delta):
                self._note_decision(
                    "slo_burn",
                    f"burn fast={self._slo.burn_fast:.3g} "
                    f"slow={self._slo.burn_slow:.3g} over "
                    f"target={self._slo.target:g}")
            # burn/attainment only move on THIS tick, but replicas
            # publish only while active: without a push on an alert
            # flip, a fleet that goes idle right after its bad requests
            # leaves /health and /metrics frozen at the pre-tick SLO
            # values (bad counted, burn still zero) until the next
            # request arrives. Publish ONLY on the flip — a full merged
            # publish every tick would contend with the router for the
            # fleet lock under load.
            slo_changed = self._slo.alerting != was_alerting
            idle = inflight == 0 and queue == 0 and shed_delta == 0
            idle_for = now - self._last_submit
            # grow needs LIVE pressure: a shed since the last tick, a
            # half-full admission queue, or both SLO burn windows
            # above 1.0 (fast = recent pain, slow = sustained pain)
            pressured = (shed_delta > 0
                         or (qcap > 0 and queue / qcap >= 0.5)
                         or self._slo.alerting)
            # probationers count against the cap: they are live
            # processes about to rejoin, so pressure while one probes
            # must not over-provision past replicas_max
            grow = (pressured and n > 0
                    and n + len(self._probation) < self.replicas_max)
            to_zero = (idle and n > 0 and self.scale_to_zero_s > 0
                       and idle_for >= self.scale_to_zero_s)
            if idle and not to_zero:
                self._idle_ticks += 1
            elif not idle:
                self._idle_ticks = 0
            # a tick can be idle (no inflight/queue/shed) while the
            # burn alert is still inside its fast window; retiring
            # capacity there would flap (shrink now, burn-grow next
            # tick), so shrink waits for the alert to expire too
            shrink = (idle and not pressured and not to_zero
                      and self._idle_ticks >= SHRINK_IDLE_TICKS
                      and n > max(1, self.replicas_min))
            victim = None
            if shrink:
                # least-loaded victim, highest index on ties (retire
                # the newest replica first — its cache is the coldest)
                victim = min(live, key=lambda i: (
                    self._replicas[i].inflight, -i))
        if to_zero:
            self.scale_to_zero(
                f"idle {idle_for:.1f}s >= {self.scale_to_zero_s:g}s")
            return "scale_to_zero"
        if grow:
            granted = self._resize_grant(n + 1)
            if granted <= n:
                if slo_changed:
                    self._publish_merged()
                return None     # allocator said no; try again next tick
            self._spawn_one()
            with self._lock:
                self.grows_total += 1
                self._idle_ticks = 0
                self._note_decision(
                    "grow", f"shed_delta={shed_delta} queue={queue}/"
                            f"{qcap} burn_fast="
                            f"{self._slo.burn_fast:.3g} -> {n + 1}")
            self._publish_merged()
            return "grow"
        if shrink and victim is not None:
            self._resize_grant(n - 1)
            self._retire(victim, "shrink_drain")
            with self._lock:
                self.shrinks_total += 1
                self._idle_ticks = 0
                self._note_decision(
                    "shrink", f"idle {SHRINK_IDLE_TICKS} ticks "
                              f"-> {n - 1}")
            self._publish_merged()
            return "shrink"
        if slo_changed:
            self._publish_merged()
        return None

    def _resize_grant(self, replicas: int) -> int:
        """Offer a resize to the cluster allocator. Fails OPEN: with no
        allocator (standalone PS) or an unreachable one, serving
        elasticity must not stall, so the desired count is granted."""
        if self.resize_cb is None:
            return replicas
        try:
            return int(self.resize_cb(replicas))
        except Exception:
            logger.exception("fleet %s: resize_cb(%d) failed; "
                             "failing open", self.model_id, replicas)
            return replicas

    def _note_decision(self, action: str, detail: str) -> None:
        """(lock held) ring buffer of scale decisions for top/debug."""
        self.decisions.append({"ts": self.clock(), "action": action,
                               "detail": detail,
                               "replicas": len(self._live_idxs())})

    def _count_path(self, path: str) -> None:
        """(lock held)"""
        self.path_counts[path] = self.path_counts.get(path, 0) + 1

    # ------------------------------------------------------------- telemetry
    @property
    def replica_count(self) -> int:
        return len(self._replicas) - len(self._draining)

    def replicas(self) -> List[ServeService]:
        with self._lock:
            return list(self._replicas.values())

    def ensure_replicas(self, n: int) -> int:
        """Grow to at least ``n`` live replicas (capped at
        replicas_max); returns the live count. Control-plane recovery
        rebuilds a persisted fleet at its pre-crash width through this
        instead of waiting for SLO pressure to re-grow it one
        autoscale tick at a time."""
        target = min(max(0, int(n)), self.replicas_max)
        spawned = 0
        while True:
            with self._lock:
                live = len(self._live_idxs())
            if live >= target:
                if spawned:
                    logger.info("fleet %s: recovery grew to %d "
                                "replica(s) (+%d)", self.model_id,
                                live, spawned)
                return live
            self._spawn_one()
            spawned += 1

    def engines(self) -> List[Tuple[int, object]]:
        with self._lock:
            return [(i, svc.engine) for i, svc in self._replicas.items()]

    @property
    def hbm_bytes(self) -> int:
        """Device bytes of the fleet's KV slabs, one per replica (the
        reference's footprint: the PS's /infer cache yields to this)."""
        with self._lock:
            return sum(svc.engine.slab.device_bytes
                       for svc in self._replicas.values())

    def flight_snapshot(self, reason: str) -> None:
        """Forward the black-box dump to every replica (called on serve
        health-rule onsets by the PS; replica flight_snapshot never
        takes _cv, so this is callable from a replica loop thread)."""
        with self._lock:
            svcs = list(self._replicas.values())
        for svc in svcs:
            svc.flight_snapshot(reason)

    def snapshot(self) -> dict:
        """The MERGED health-pipeline sample for ``serve:<model>`` —
        the same serve_* fields a solo service publishes (summed or
        worst-cased across replicas, retired totals folded in so
        counters stay monotone) plus the fleet_* routing/scaling
        fields, including per-replica prefix hit/miss DELTAS since the
        previous fleet snapshot (cache-health per replica: the LRU is
        per-replica, so a routing regression shows up here first)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        idxs = list(self._replicas)
        snaps = {i: self._replicas[i].snapshot() for i in idxs}
        # routable replicas: probationers are live processes but off
        # the ring, reported separately as fleet_probation
        live = [i for i in idxs if i not in self._draining
                and i not in self._probation]

        def tot(field):
            return sum(snaps[i][field] for i in idxs)

        def worst(field):
            return max((snaps[i][field] for i in idxs), default=0.0)

        hits = self._retired["prefix_hits"]
        misses = self._retired["prefix_misses"]
        hit_deltas, miss_deltas = {}, {}
        for i in idxs:
            svc = self._replicas[i]
            st = svc.engine.stats
            h, m = int(st["prefix_hits"]), int(st["prefix_misses"])
            # replica EPOCH = restarts_total: a watchdog recovery (or
            # the crash-loop path) rebuilds the engine and its counters
            # restart at ZERO. A delta against the old epoch's cursor
            # would go negative (silently dropped by update_fleet's
            # `> 0` guard, losing hits) and the fleet total would dip.
            # Re-baseline: fold the dead epoch's last-seen cumulative
            # into the retired totals and start the cursor from zero.
            epoch = svc.restarts_total
            pe, ph, pm = self._prefix_seen.get(i, (epoch, 0, 0))
            if pe != epoch:
                self._retired["prefix_hits"] += ph
                self._retired["prefix_misses"] += pm
                hits += ph
                misses += pm
                ph, pm = 0, 0
            hits += h
            misses += m
            hit_deltas[str(i)] = h - ph
            miss_deltas[str(i)] = m - pm
            self._prefix_seen[i] = (epoch, h, m)
        # fleet percentiles come from the EXACT merge of per-replica
        # windowed sketches (bucket-count addition): the fleet p99 is
        # the p99 of the pooled samples, not the worst replica's
        sketches: Dict[str, QuantileSketch] = {}
        for i in idxs:
            for kind, st in snaps[i].get(
                    "serve_latency_sketches", {}).items():
                part = QuantileSketch.from_state(st)
                if kind in sketches:
                    sketches[kind].merge(part)
                else:
                    sketches[kind] = part
        ttft_sk = sketches.get("ttft", QuantileSketch())
        slo_good = self._retired["slo_good"] + tot("serve_slo_good_total")
        slo_bad = self._retired["slo_bad"] + tot("serve_slo_bad_total")
        util = [snaps[i]["serve_kv_page_utilization"] for i in idxs]
        # decode amortization: the ratio merges from the engine counters
        # (sums of sums), so a busy replica weighs more than an idle one
        disp = toks = acc = vdisp = 0
        for i in idxs:
            st = self._replicas[i].engine.stats
            disp += int(st["dispatches"])
            toks += int(st["generated_tokens"])
            acc += int(st["accepted_tokens"])
            vdisp += int(st["verify_dispatches"])
        return {
            "job_id": f"serve:{self.model_id}",
            "serve_active_slots": tot("serve_active_slots"),
            "serve_slot_cap": tot("serve_slot_cap"),
            "serve_queue_depth": tot("serve_queue_depth"),
            "serve_queue_cap": tot("serve_queue_cap"),
            "serve_kv_page_utilization": round(
                sum(util) / len(util), 4) if util else 0.0,
            "serve_rejected_total": self._retired["rejected"]
            + self._router_rejected_total
            + tot("serve_rejected_total"),
            "serve_ttft_p50": round(ttft_sk.quantile(0.50), 6),
            "serve_ttft_p99": round(ttft_sk.quantile(0.99), 6),
            "serve_latency_sketches": {
                kind: sk.state() for kind, sk in sketches.items()},
            "serve_ttft_queue_s": worst("serve_ttft_queue_s"),
            "serve_ttft_prefill_s": worst("serve_ttft_prefill_s"),
            "serve_ttft_interleave_s": worst("serve_ttft_interleave_s"),
            "serve_prefill_backlog_tokens": tot(
                "serve_prefill_backlog_tokens"),
            "serve_prefix_hit_pct": round(
                100.0 * hits / max(1, hits + misses), 1),
            "serve_weight_generation": worst("serve_weight_generation"),
            "serve_active_generations": worst(
                "serve_active_generations"),
            "serve_engine_restarts": self._retired["restarts"]
            + tot("serve_engine_restarts"),
            "serve_poisoned_total": self._retired["poisoned"]
            + tot("serve_poisoned_total"),
            "serve_deadline_total": self._retired["deadline"]
            + tot("serve_deadline_total"),
            # decode bandwidth: one engine config per fleet (the
            # factory stamps every replica), so the mode and per-token
            # proxy are representative, not summed
            "serve_kv_dtype": next(
                (snaps[i]["serve_kv_dtype"] for i in idxs), "f32"),
            "serve_kv_bytes_per_token": next(
                (snaps[i]["serve_kv_bytes_per_token"] for i in idxs), 0),
            "serve_dispatches_per_token": round(disp / toks, 6)
            if toks else 0.0,
            "serve_accepted_per_dispatch": round(acc / vdisp, 6)
            if vdisp else 0.0,
            # SLO plane: objectives, attainment, and the fast/slow
            # burn-rate windows the autoscaler + slo_burn rule read
            "serve_slo_target": self._slo.target,
            "serve_slo_attainment": round(self._slo.attainment, 6),
            "serve_slo_burn_fast": round(self._slo.burn_fast, 6),
            "serve_slo_burn_slow": round(self._slo.burn_slow, 6),
            "serve_slo_good_total": slo_good,
            "serve_slo_bad_total": slo_bad,
            "serve_slo_alerts_total": self._slo.alerts_total,
            # fleet routing / scaling surface
            "fleet_replicas": len(live),
            "fleet_replicas_min": self.replicas_min,
            "fleet_replicas_max": self.replicas_max,
            "fleet_draining": len(self._draining),
            "fleet_cold_starts_total": self.cold_starts_total,
            "fleet_spills_total": self.spills_total,
            "fleet_router_retries_total": self.router_retries_total,
            "fleet_grows_total": self.grows_total,
            "fleet_shrinks_total": self.shrinks_total,
            "fleet_scale_to_zero_total": self.scale_to_zero_total,
            # failure-domain surface
            "fleet_probation": len(self._probation),
            "fleet_ejections_total": self.ejections_total,
            "fleet_failovers_total": self.failovers_total,
            "fleet_migrated_streams_total": self.migrated_streams_total,
            "fleet_probes_total": self.probes_total,
            "fleet_hedges_total": self.hedges_total,
            "fleet_replica_prefix_hits": hit_deltas,
            "fleet_replica_prefix_misses": miss_deltas,
            # the cost ledger, merged exactly across replicas (totals sum;
            # the per-dispatch records agree, one engine config per
            # fleet) plus the retired replicas' folded totals. An engine
            # restart resets its replica's ledger; update_cost's monotone
            # guard absorbs the dip
            "serve_cost_programs": merge_cost_snapshots(
                [self._retired_cost]
                + [snaps[i].get("serve_cost_programs") or {}
                   for i in idxs]),
        }

    def _on_replica_publish(self, idx: int, snap: dict) -> None:
        """Replica health callback: runs on replica loop threads,
        sometimes with that replica's _cv held — which is why every
        fleet-lock section above reads replicas lock-free only."""
        self._publish_merged()

    def _publish_merged(self) -> None:
        merged = self.snapshot()
        if self.metrics is not None:
            self.metrics.set_serve_state(
                self.model_id, merged["serve_active_slots"],
                merged["serve_queue_depth"],
                merged["serve_kv_page_utilization"],
                merged["serve_prefill_backlog_tokens"])
            self.metrics.set_serve_weight_generation(
                self.model_id, merged["serve_weight_generation"])
            update = getattr(self.metrics, "update_fleet", None)
            if update is not None:
                update(self.model_id, merged)
        if self._trace_dirty:
            self._trace_dirty = False
            self._flush_trace()
        if self.health_cb is not None:
            try:
                self.health_cb(merged)
            except Exception:
                logger.exception("fleet health callback failed")
