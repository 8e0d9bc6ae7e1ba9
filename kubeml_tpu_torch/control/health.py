"""Declarative training-health rules over rolling metric windows (copy of
kubeml_tpu/control/health.py; pure Python, so the port keeps its own copy,
held to the same verdicts by tests/test_torch_health.py).

The PS receives one MetricUpdate per job epoch (control/ps.py
``_h_metrics``, or the in-process publish of a threaded job); this module
keeps a bounded rolling window of those updates per job and evaluates a
declarative rule set into the verdict ``GET /health?id=`` serves and
``kubeml top`` renders:

    {"id": ..., "state": "healthy|warning|critical|unknown",
     "reasons": [{"rule": ..., "severity": ..., "detail": ...}, ...],
     "latest": {...last epoch's stats...}}

Rules look only at the window, never at the wall clock, so tests drive
them with a fake clock (``HealthEvaluator(clock=...)``). The verdict
exists only while the job runs: the PS clears a job's window when it
finishes, and the job then reads ``unknown``.

Rule set (thresholds of the JAX package; all overridable per evaluator):

  worker_divergence  critical  the non-finite guard dropped or
                               quarantined workers this epoch
  grad_explosion     critical  a worker's RMS grad norm exceeds the
                               absolute ceiling, or blew up relative to
                               the window median
  loss_divergence    warning   cross-worker loss spread is large
                               relative to the train loss
  update_stall       warning   every worker's update/param ratio has
                               been ~0 for several epochs
  straggler          warning   the slowest round dispatch is many times
                               the epoch median

and the serving, cluster, continual and control-plane rules, which fire
only on the snapshot fields of their planes, never on training samples.
The PS feeds the serving rules from each fleet's merged snapshot
(``serve:<model>``), the cluster and control-plane rules from the
scheduler's allocator snapshot (``cluster``), and the continual rule
(``data_staleness``) from a continual job's MetricUpdates, whose
(``dataset_generation``, ``data_lag_generations``) pair the job fills
after every epoch.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

# verdict states, ordered by severity (prom.HEALTH_STATES mirrors this)
STATES = ("healthy", "warning", "critical", "unknown")


@dataclasses.dataclass
class HealthRule:
    """One declarative check over a job's metric window.

    `check(window)` sees the job's sample list (oldest first; each a
    dict of the MetricUpdate's health fields) and returns a
    human-readable detail string when firing, else None."""

    name: str
    severity: str              # 'warning' | 'critical'
    description: str
    check: Callable[[List[dict]], Optional[str]]


def _latest(window: List[dict]) -> dict:
    return window[-1] if window else {}


def _rule_worker_divergence(window: List[dict]) -> Optional[str]:
    m = _latest(window)
    dropped = float(m.get("dropped_workers", 0.0))
    quarantined = int(m.get("quarantined_workers", 0))
    if dropped > 0 or quarantined > 0:
        return (f"non-finite guard dropped {dropped:g} worker update(s), "
                f"{quarantined} worker(s) quarantined in the last epoch")
    return None


def _make_grad_explosion(abs_limit: float, rel_limit: float):
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        norms = [float(x) for x in m.get("grad_norms", []) if x > 0]
        if not norms:
            return None
        worst = max(norms)
        if worst > abs_limit:
            return (f"grad norm {worst:.3g} exceeds the absolute limit "
                    f"{abs_limit:g}")
        history = [max((float(x) for x in s.get("grad_norms", [])
                        if x > 0), default=0.0) for s in window[:-1]]
        history = [h for h in history if h > 0]
        if len(history) >= 2:
            base = statistics.median(history)
            if base > 0 and worst > rel_limit * base:
                return (f"grad norm {worst:.3g} is {worst / base:.0f}x "
                        f"the window median {base:.3g}")
        return None
    return check


def _make_loss_divergence(rel_limit: float):
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        spread = float(m.get("loss_spread", 0.0))
        loss = abs(float(m.get("train_loss", 0.0)))
        if spread > rel_limit * max(loss, 1e-6):
            return (f"cross-worker loss spread {spread:.3g} vs train "
                    f"loss {loss:.3g} — workers are diverging")
        return None
    return check


def _make_update_stall(ratio_floor: float, min_epochs: int):
    def check(window: List[dict]) -> Optional[str]:
        if len(window) < min_epochs:
            return None
        recent = window[-min_epochs:]
        for s in recent:
            ratios = [float(x) for x in s.get("update_ratios", [])]
            if not ratios or max(ratios) >= ratio_floor:
                return None
        return (f"update/param ratio below {ratio_floor:g} on every "
                f"worker for {min_epochs} epochs — optimizer stalled")
    return check


def _make_straggler(rel_limit: float, min_rounds: int):
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        times = [float(t) for t in
                 (m.get("phase_times") or {}).get("dispatch", [])]
        if len(times) < min_rounds:
            return None
        med = statistics.median(times)
        worst = max(times)
        if med > 0 and worst > rel_limit * med:
            return (f"slowest round dispatch {worst:.3g}s is "
                    f"{worst / med:.0f}x the epoch median {med:.3g}s")
        return None
    return check


def _make_serve_saturation():
    """Serving plane (serve/service.py snapshots): warn when admission
    starts costing clients — the queue is at cap, or requests were shed
    with 429 since the previous snapshot. Training samples carry none
    of the serve_* fields, so this never fires for them."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        cap = m.get("serve_queue_cap")
        if cap is None:
            return None
        depth = float(m.get("serve_queue_depth", 0.0))
        rej = float(m.get("serve_rejected_total", 0.0))
        prev = next((s for s in reversed(window[:-1])
                     if s.get("serve_queue_cap") is not None), None)
        rej_prev = float(prev.get("serve_rejected_total", 0.0)) \
            if prev else 0.0
        if rej > rej_prev:
            return (f"{rej - rej_prev:g} request(s) shed with 429 since "
                    f"the last snapshot (queue {depth:g}/{cap:g})")
        if float(cap) > 0 and depth >= float(cap):
            return (f"admission queue full ({depth:g}/{cap:g}); the next "
                    f"request will be shed")
        return None
    return check


def _make_queue_starvation(wait_limit_s: float):
    """Cluster allocator (control/cluster.py snapshots under the
    `cluster` pseudo job id): warn when a parked job has waited past
    the limit — either aging is disabled/too slow, or quotas have
    wedged the queue behind a full pool. Training/serving samples
    carry no cluster_* fields, so this never fires for them."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        lanes = m.get("cluster_pool_lanes")
        if lanes is None:
            return None
        depth = float(m.get("cluster_queue_depth", 0.0))
        wait = float(m.get("cluster_oldest_wait_s", 0.0))
        if depth > 0 and wait > wait_limit_s:
            in_use = float(m.get("cluster_lanes_in_use", 0.0))
            return (f"oldest parked job has waited {wait:.0f}s "
                    f"(> {wait_limit_s:g}s) with {depth:g} job(s) "
                    f"queued and {in_use:g}/{float(lanes):g} lanes "
                    f"leased — queue is starving")
        return None
    return check


def _make_data_staleness(lag_limit: int):
    """Continual plane (train/job.py sliding-window passes): warn when
    the dataset registry is more than `lag_limit` generations ahead of
    what the job has trained — appends are outrunning training, so the
    served model is drifting stale. Non-continual jobs publish
    data_lag_generations = -1 (the wire default) and older samples omit
    the field entirely, so this never fires for them."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        lag = m.get("data_lag_generations")
        if lag is None or int(lag) < 0:
            return None
        if int(lag) > lag_limit:
            return (f"dataset registry is {int(lag)} generation(s) ahead "
                    f"of the last trained generation "
                    f"{int(m.get('dataset_generation', 0))} "
                    f"(limit {lag_limit}) — training is falling behind "
                    f"appends")
        return None
    return check


def _make_serve_crash_loop(restart_limit: int = 2):
    """Serving plane: critical when the supervisor rebuilt the engine
    `restart_limit`+ times within the sample window — one restart is
    recovery working, repeated restarts are a crash loop (a fault the
    supervisor keeps resurrecting into). Delta across the window, like
    serve_saturation's 429 accounting, so old restarts age out."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        latest = m.get("serve_engine_restarts")
        if latest is None:
            return None
        first = next((s.get("serve_engine_restarts") for s in window
                      if s.get("serve_engine_restarts") is not None),
                     None)
        delta = float(latest) - float(first if first is not None else 0)
        if delta >= restart_limit:
            return (f"serving engine restarted {delta:g} time(s) within "
                    f"the sample window (limit {restart_limit}) — the "
                    f"supervisor is crash-looping")
        return None
    return check


def _make_fleet_degraded():
    """Serving fleet: warn when the supervisor ejected a replica within
    the sample window — the fleet is serving, but degraded: a pool
    member died or crash-looped, its streams were live-migrated, and a
    probation replica is earning its vnodes back. Delta across the
    window like serve_crash_loop, so old ejections age out; solo-serve
    samples carry no fleet_* fields and never fire this."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        latest = m.get("fleet_ejections_total")
        if latest is None:
            return None
        first = next((s.get("fleet_ejections_total") for s in window
                      if s.get("fleet_ejections_total") is not None),
                     None)
        delta = float(latest) - float(first if first is not None else 0)
        if delta >= 1:
            migrated = m.get("fleet_migrated_streams_total", 0)
            probation = m.get("fleet_probation", 0)
            return (f"{delta:g} replica(s) ejected within the sample "
                    f"window ({float(migrated):g} stream(s) "
                    f"live-migrated, {float(probation):g} replica(s) in "
                    f"probation) — fleet is degraded")
        return None
    return check


def _make_control_flapping(recover_limit: int = 2):
    """Durable control plane: critical when the allocator's
    journaled recovery counter climbed `recover_limit`+ times within
    the sample window — one recovery is the durability layer doing its
    job, repeated recoveries mean the control plane is crash-looping
    ("flapping") and every restart is re-running the adoption sweep.
    Delta across the window like serve_crash_loop, so a single old
    recovery ages out; non-cluster samples carry no cluster_* fields
    and never fire this."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        latest = m.get("cluster_recoveries_total")
        if latest is None:
            return None
        first = next((s.get("cluster_recoveries_total") for s in window
                      if s.get("cluster_recoveries_total") is not None),
                     None)
        delta = float(latest) - float(first if first is not None else 0)
        if delta >= recover_limit:
            epoch = m.get("cluster_fencing_epoch", 0)
            return (f"control plane recovered {delta:g} time(s) within "
                    f"the sample window (limit {recover_limit}, fencing "
                    f"epoch now {float(epoch):g}) — the control plane "
                    f"is flapping")
        return None
    return check


def _make_serve_ttft_slo(slo_s: float):
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        p99 = m.get("serve_ttft_p99")
        if p99 is None or float(p99) <= slo_s:
            return None
        return (f"p99 time-to-first-token {float(p99):.3g}s exceeds the "
                f"{slo_s:g}s SLO (p50 "
                f"{float(m.get('serve_ttft_p50', 0.0)):.3g}s)")
    return check


def _make_slo_burn():
    """Serving SLO plane (serve/slo.py): warn when BOTH burn windows
    exceed 1.0 — the multi-window rule, so a single bad tick (fast
    spike, slow still fine) never pages and a long-ago incident (slow
    elevated, fast recovered) clears. Latest-value check: the burn
    rates are already windowed by the SLO engine itself; solo-serve
    and training samples carry no serve_slo_* fields and never fire."""
    def check(window: List[dict]) -> Optional[str]:
        m = _latest(window)
        fast = m.get("serve_slo_burn_fast")
        slow = m.get("serve_slo_burn_slow")
        if fast is None or slow is None:
            return None
        if float(fast) > 1.0 and float(slow) > 1.0:
            att = m.get("serve_slo_attainment", 1.0)
            target = m.get("serve_slo_target", 0.0)
            return (f"SLO error budget burning in both windows (fast "
                    f"{float(fast):.3g}x, slow {float(slow):.3g}x): "
                    f"attainment {float(att):.4g} vs target "
                    f"{float(target):g}")
        return None
    return check


def default_rules(grad_abs: float = 1e4, grad_rel: float = 50.0,
                  spread_rel: float = 0.75, stall_floor: float = 1e-7,
                  stall_epochs: int = 3, straggler_rel: float = 5.0,
                  straggler_min_rounds: int = 4,
                  serve_ttft_slo_s: float = 2.0,
                  queue_starvation_s: float = 120.0,
                  data_lag_limit: int = 2) -> List[HealthRule]:
    return [
        HealthRule("worker_divergence", "critical",
                   "non-finite guard dropped or quarantined workers",
                   _rule_worker_divergence),
        HealthRule("grad_explosion", "critical",
                   "gradient norm exceeded absolute or relative limits",
                   _make_grad_explosion(grad_abs, grad_rel)),
        HealthRule("loss_divergence", "warning",
                   "cross-worker loss spread large vs train loss",
                   _make_loss_divergence(spread_rel)),
        HealthRule("update_stall", "warning",
                   "update/param ratio ~0 across workers for epochs",
                   _make_update_stall(stall_floor, stall_epochs)),
        HealthRule("straggler", "warning",
                   "one round dispatch far slower than the epoch median",
                   _make_straggler(straggler_rel, straggler_min_rounds)),
        HealthRule("serve_saturation", "warning",
                   "inference admission queue at cap or shedding 429s",
                   _make_serve_saturation()),
        HealthRule("serve_ttft_slo", "warning",
                   "serving p99 time-to-first-token above the SLO",
                   _make_serve_ttft_slo(serve_ttft_slo_s)),
        HealthRule("slo_burn", "warning",
                   "SLO burn rate above 1.0 in both fast and slow windows",
                   _make_slo_burn()),
        HealthRule("serve_crash_loop", "critical",
                   "serving engine restarted repeatedly in the window",
                   _make_serve_crash_loop()),
        HealthRule("fleet_degraded", "warning",
                   "fleet supervisor ejected a replica in the window",
                   _make_fleet_degraded()),
        HealthRule("queue_starvation", "warning",
                   "a cluster-parked job has waited past the limit",
                   _make_queue_starvation(queue_starvation_s)),
        HealthRule("data_staleness", "warning",
                   "continual job's trained generation lags the registry",
                   _make_data_staleness(data_lag_limit)),
        HealthRule("control_flapping", "critical",
                   "control plane recovered repeatedly in the window",
                   _make_control_flapping()),
    ]


# the MetricUpdate fields a window sample keeps (copied out so the
# evaluator never holds live wire objects)
_SAMPLE_FIELDS = ("train_loss", "validation_loss", "accuracy",
                  "parallelism", "epoch_duration", "dropped_workers",
                  "quarantined_workers", "grad_norms", "update_ratios",
                  "worker_losses", "loss_spread", "jit_compiles",
                  "hbm_peak_bytes", "hbm_in_use_bytes", "phase_times",
                  # serving-plane snapshots (serve/service.py) ride the
                  # same pipeline under the serve:<model> pseudo job id
                  "serve_active_slots", "serve_slot_cap",
                  "serve_queue_depth", "serve_queue_cap",
                  "serve_kv_page_utilization", "serve_rejected_total",
                  "serve_ttft_p50", "serve_ttft_p99",
                  # additive TTFT attribution (queue + prefill +
                  # interleave == TTFT) — `kubeml top` breakdown line
                  "serve_ttft_queue_s", "serve_ttft_prefill_s",
                  "serve_ttft_interleave_s",
                  "serve_prefill_backlog_tokens", "serve_prefix_hit_pct",
                  "serve_weight_generation", "serve_active_generations",
                  # fault-tolerance telemetry: restarts feed the
                  # serve_crash_loop rule, the rest the top faults line
                  "serve_engine_restarts", "serve_poisoned_total",
                  "serve_deadline_total",
                  # decode bandwidth: KV storage mode + the
                  # deterministic bytes-per-token proxy for the top
                  # "decode bw" line
                  "serve_kv_dtype", "serve_kv_bytes_per_token",
                  # decode amortization: deterministic
                  # dispatch-count proxies for multi-step / speculative
                  # decode — the top "decode amortization" line
                  "serve_dispatches_per_token",
                  "serve_accepted_per_dispatch",
                  # SLO plane (serve/slo.py): burn rates feed the
                  # slo_burn rule, attainment/target the top "slo" line
                  "serve_slo_target", "serve_slo_attainment",
                  "serve_slo_burn_fast", "serve_slo_burn_slow",
                  "serve_slo_good_total", "serve_slo_bad_total",
                  "serve_slo_alerts_total",
                  # serving-fleet telemetry (serve/fleet.py): replica
                  # count + router/autoscaler counters ride the merged
                  # serve:<model> sample; the per-replica prefix
                  # hit/miss deltas make routing-quality regressions
                  # visible per replica (the cache LRU is per-replica)
                  "fleet_replicas", "fleet_replicas_min",
                  "fleet_replicas_max", "fleet_draining",
                  "fleet_cold_starts_total", "fleet_spills_total",
                  "fleet_router_retries_total", "fleet_grows_total",
                  "fleet_shrinks_total", "fleet_scale_to_zero_total",
                  "fleet_replica_prefix_hits",
                  "fleet_replica_prefix_misses",
                  # fleet failure domains: ejections feed the
                  # fleet_degraded rule, the rest the top fleet-faults
                  # line
                  "fleet_probation", "fleet_ejections_total",
                  "fleet_failovers_total",
                  "fleet_migrated_streams_total",
                  "fleet_probes_total", "fleet_hedges_total",
                  # continual-plane freshness (train/job.py sliding
                  # window); lag -1 = not a continual job
                  "dataset_generation", "data_lag_generations",
                  # cluster-allocator snapshots (control/cluster.py)
                  # ride the same pipeline under the `cluster` pseudo
                  # job id; `kubeml top --id cluster` renders them
                  "cluster_pool_lanes", "cluster_lanes_in_use",
                  "cluster_running_jobs", "cluster_serving_jobs",
                  "cluster_serving_lanes", "cluster_queue_depth",
                  "cluster_queue_by_priority", "cluster_oldest_wait_s",
                  "cluster_tenant_lanes", "cluster_tenant_quota",
                  "cluster_tenant_weight",
                  "cluster_gang_placements_total",
                  "cluster_preemptions_total",
                  "cluster_aged_grants_total",
                  "cluster_quota_clamps_total",
                  # durable control plane: journaled recovery /
                  # fencing counters survive restarts with the journal;
                  # recoveries feed the control_flapping rule, the rest
                  # the top control line
                  "cluster_recoveries_total", "cluster_fencing_epoch",
                  "cluster_fencing_rejections_total",
                  "cluster_journal_records_total",
                  "cluster_journal_compactions_total",
                  "cluster_journal_torn_drops_total",
                  # analytic cost ledger (metrics/ledger.py):
                  # cumulative per-program cost snapshots ride the
                  # sample so `kubeml top` can render the attributed
                  # flops/bytes per sample (train) and per token (serve)
                  "cost_programs", "serve_cost_programs")


class HealthEvaluator:
    """Per-job rolling windows + rule evaluation.

    `observe(m)` ingests a MetricUpdate (or any object with its health
    fields), re-evaluates the rules, and returns the list of NEWLY
    firing rules (deduped against the job's already-active set) so the
    PS can bump `kubeml_health_alerts_total` once per onset instead of
    once per epoch. `verdict(job_id)` returns the machine-readable
    verdict served by `GET /health?id=`.
    """

    def __init__(self, clock: Callable[[], float] = time.time,
                 window_s: float = 600.0, max_samples: int = 32,
                 rules: Optional[List[HealthRule]] = None):
        self.clock = clock
        self.window_s = window_s
        self.max_samples = max_samples
        self.rules = default_rules() if rules is None else rules
        self._windows: Dict[str, List] = {}     # job -> [(t, sample)]
        self._active: Dict[str, Dict[str, dict]] = {}  # job -> rule -> reason

    def _sample(self, m: Any) -> dict:
        s = {}
        for f in _SAMPLE_FIELDS:
            v = getattr(m, f, None) if not isinstance(m, dict) \
                else m.get(f)
            if v is not None:
                s[f] = v
        return s

    def _prune(self, entries: List, now: float) -> List:
        entries = [e for e in entries if now - e[0] <= self.window_s]
        return entries[-self.max_samples:]

    def observe(self, m: Any) -> List[dict]:
        """Ingest one epoch update; returns newly-fired reasons."""
        job_id = m["job_id"] if isinstance(m, dict) else m.job_id
        now = self.clock()
        entries = self._prune(self._windows.get(job_id, []), now)
        entries.append((now, self._sample(m)))
        self._windows[job_id] = entries
        window = [s for _, s in entries]
        firing: Dict[str, dict] = {}
        for rule in self.rules:
            detail = rule.check(window)
            if detail:
                firing[rule.name] = {"rule": rule.name,
                                     "severity": rule.severity,
                                     "detail": detail}
        previous = self._active.get(job_id, {})
        new = [r for name, r in firing.items() if name not in previous]
        self._active[job_id] = firing
        return new

    def verdict(self, job_id: str) -> dict:
        """The served health document. `state` is the worst severity of
        the currently-firing rules; a job with no samples (never
        reported, or window expired) is `unknown`."""
        now = self.clock()
        entries = self._prune(self._windows.get(job_id, []), now)
        self._windows[job_id] = entries
        if not entries:
            return {"id": job_id, "state": "unknown", "reasons": [],
                    "latest": {}}
        reasons = sorted(self._active.get(job_id, {}).values(),
                         key=lambda r: (r["severity"] != "critical",
                                        r["rule"]))
        if any(r["severity"] == "critical" for r in reasons):
            state = "critical"
        elif reasons:
            state = "warning"
        else:
            state = "healthy"
        return {"id": job_id, "state": state, "reasons": reasons,
                "latest": dict(entries[-1][1])}

    def clear(self, job_id: str) -> None:
        self._windows.pop(job_id, None)
        self._active.pop(job_id, None)
