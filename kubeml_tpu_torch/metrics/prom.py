"""Prometheus text-format metrics (copy of kubeml_tpu/metrics/prom.py's
families the training path sets and clears; stdlib only).

The same family names, help strings, label names and exposition text as
the JAX package's, so dashboards and ``tools/check_metrics.py`` read a
port deployment unchanged:

    kubeml_job_{validation_loss,validation_accuracy,train_loss,
        parallelism,epoch_duration_seconds,...}{jobid=...}
    kubeml_job_running_total{type=...}
    kubeml_job_{dispatch,data_wait,merge,merge_overlap}_seconds (histograms)
    kubeml_job_health{jobid=...,state=...} / kubeml_health_alerts_total
    kubeml_http_requests_total / kubeml_http_request_duration_seconds
    kubeml_infer_cache_{entries,hits_total,misses_total}{cache=...}
    kubeml_serve_*{model=...}: the serving loop's latency histograms,
        state gauges and token counters, the fleet's routing, scaling and
        failure-domain counters, and the SLO plane's attainment and burn

    kubeml_cluster_*{pool,priority,tenant}: the cluster allocator's pool
        occupancy, queue by priority, tenant lanes, quota and share, and
        its lifetime decision counters (update_cluster, from the
        scheduler's snapshot pushes)
    kubeml_control_*{role,pool}: control-plane recoveries and their
        seconds per role, journal records and compactions, fencing
        rejections and the fencing epoch

Per-job series are cleared when a job finishes (metrics.go:90-106), a
model's serve series by clear_serve.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple, Union

LabelValues = Union[str, Sequence[str]]

# Latency buckets: 1ms..60s, roughly log-spaced.  Host-side round phases
# on CPU tier-1 land mid-range; real TPU dispatches land in the low
# buckets; stragglers and cold compiles still resolve above 1s instead
# of all collapsing into +Inf.
DEFAULT_TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Tuple[str, str] = None) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{extra[1]}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v) -> str:
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return str(v)


def _key(labels: Sequence[str], values: LabelValues) -> Tuple[str, ...]:
    if isinstance(values, str):
        values = (values,)
    values = tuple(str(v) for v in values)
    if len(values) != len(labels):
        raise ValueError(
            f"expected {len(labels)} label values {tuple(labels)}, "
            f"got {values}")
    return values


class Gauge:
    def __init__(self, name: str, help_: str, label: str):
        self.name = name
        self.help = help_
        self.label = label
        self._values: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, label_value: str, value: float):
        with self._lock:
            self._values[label_value] = value

    def inc(self, label_value: str, delta: float = 1.0):
        with self._lock:
            self._values[label_value] = self._values.get(label_value, 0.0) + delta

    def clear(self, label_value: str):
        with self._lock:
            self._values.pop(label_value, None)

    def collect(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            for lv, v in sorted(self._values.items()):
                lines.append(
                    f'{self.name}{{{self.label}="{_escape(lv)}"}} '
                    f'{_fmt_value(v)}')
        return "\n".join(lines)


class MultiGauge:
    """Gauge family with an arbitrary label tuple (the single-label
    Gauge above predates it and stays for the reference-parity
    families). Used where one job fans out into several series —
    per-worker health stats (`worker` label) and the HBM watermark
    (`kind=peak|in_use`) — so per-worker data rides LABELS, never
    family-name suffixes (the cardinality rule tools/check_metrics.py
    enforces)."""

    def __init__(self, name: str, help_: str, labels: LabelValues):
        self.name = name
        self.help = help_
        self.labels = (labels,) if isinstance(labels, str) else tuple(labels)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, label_values: LabelValues, value: float):
        key = _key(self.labels, label_values)
        with self._lock:
            self._values[key] = value

    def value(self, label_values: LabelValues) -> float:
        key = _key(self.labels, label_values)
        with self._lock:
            return self._values.get(key, 0.0)

    def clear_prefix(self, first_label_value: str):
        """Drop every series whose FIRST label equals the value — the
        job-finish cleanup for jobid-leading families."""
        with self._lock:
            for key in [k for k in self._values
                        if k[0] == str(first_label_value)]:
                del self._values[key]

    def collect(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(
                    f"{self.name}{_fmt_labels(self.labels, key)} "
                    f"{_fmt_value(v)}")
        return "\n".join(lines)


class Counter:
    """Monotone counter family; name must end in ``_total`` by
    convention (enforced by tools/check_metrics.py)."""

    def __init__(self, name: str, help_: str, labels: LabelValues):
        self.name = name
        self.help = help_
        self.labels = (labels,) if isinstance(labels, str) else tuple(labels)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, label_values: LabelValues, delta: float = 1.0):
        if delta < 0:
            raise ValueError("counters only go up")
        key = _key(self.labels, label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + delta

    def value(self, label_values: LabelValues) -> float:
        key = _key(self.labels, label_values)
        with self._lock:
            return self._values.get(key, 0.0)

    def clear_prefix(self, first_label_value: str):
        """Drop series whose FIRST label equals the value. Only for
        jobid-leading counters whose cardinality must not grow without
        bound across the PS's life — dropping a finished job's series
        is the documented reset (scrapers see a fresh start, as after
        any process restart)."""
        with self._lock:
            for key in [k for k in self._values
                        if k[0] == str(first_label_value)]:
                del self._values[key]

    def collect(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(
                    f"{self.name}{_fmt_labels(self.labels, key)} "
                    f"{_fmt_value(v)}")
        return "\n".join(lines)


class Histogram:
    """Cumulative histogram family (exposition format 0.0.4).

    Per labelset: ``name_bucket{...,le="b"}`` for each upper bound plus
    ``le="+Inf"``, then ``name_sum`` and ``name_count``.  Buckets are
    cumulative and monotone by construction; bounds must be strictly
    increasing.
    """

    def __init__(self, name: str, help_: str, labels: LabelValues,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.help = help_
        self.labels = (labels,) if isinstance(labels, str) else tuple(labels)
        buckets = tuple(float(b) for b in buckets)
        if not buckets:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])):
            raise ValueError(f"bucket bounds must strictly increase: "
                             f"{buckets}")
        self.buckets = buckets
        # per labelset: [per-bound counts..., +Inf count], sum
        self._data: Dict[Tuple[str, ...], List] = {}
        self._lock = threading.Lock()

    def observe(self, label_values: LabelValues, value: float):
        key = _key(self.labels, label_values)
        value = float(value)
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                entry = [[0] * (len(self.buckets) + 1), 0.0]
                self._data[key] = entry
            counts, _ = entry
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[len(self.buckets)] += 1
            entry[1] += value

    def clear(self, label_values: LabelValues):
        with self._lock:
            self._data.pop(_key(self.labels, label_values), None)

    @staticmethod
    def _fmt_bound(b: float) -> str:
        s = repr(b)
        return s[:-2] if s.endswith(".0") else s

    def collect(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, (counts, total) in sorted(self._data.items()):
                cum = 0
                for bound, n in zip(self.buckets, counts):
                    cum += n
                    labels = _fmt_labels(self.labels, key,
                                         ("le", self._fmt_bound(bound)))
                    lines.append(f"{self.name}_bucket{labels} {cum}")
                cum += counts[-1]
                labels = _fmt_labels(self.labels, key, ("le", "+Inf"))
                lines.append(f"{self.name}_bucket{labels} {cum}")
                plain = _fmt_labels(self.labels, key)
                lines.append(f"{self.name}_sum{plain} {_fmt_value(total)}")
                lines.append(f"{self.name}_count{plain} {cum}")
        return "\n".join(lines)


class HttpMetrics:
    """Per-endpoint HTTP request counters + duration histogram, recorded
    by the JsonService middleware on every service (PS, scheduler,
    controller, jobserver).  The endpoint label is the registered route
    *pattern* (``/update/{jobId}``), never the raw path, so cardinality
    stays bounded."""

    # HTTP handlers are quick JSON hops; sub-ms matters more than the
    # multi-second tail, so shift the default bucket grid down.
    BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 0.5, 1.0, 2.5, 10.0)

    def __init__(self, service: str):
        self.service = service
        self.requests = Counter(
            "kubeml_http_requests_total",
            "HTTP requests handled, by service/method/endpoint/status",
            ("service", "method", "endpoint", "status"))
        self.duration = Histogram(
            "kubeml_http_request_duration_seconds",
            "HTTP request handling latency, by service/method/endpoint",
            ("service", "method", "endpoint"), buckets=self.BUCKETS)

    def observe(self, method: str, endpoint: str, status: int,
                seconds: float):
        self.requests.inc((self.service, method, endpoint, str(status)))
        self.duration.observe((self.service, method, endpoint), seconds)

    def exposition(self) -> str:
        return (self.requests.collect() + "\n"
                + self.duration.collect() + "\n")




# the complete job-health state space (control/health.py verdicts);
# kubeml_job_health exposes one 0/1 series per state so dashboards can
# alert on `kubeml_job_health{state="critical"} == 1` without regexes
HEALTH_STATES = ("healthy", "warning", "critical", "unknown")


# Round phase (a span name of the job's MetricUpdate.phase_times) ->
# histogram attribute. merge_wait is the blocking epoch-end readback;
# device_drain is its older name and merge_overlap the host bookkeeping
# hidden under the next dispatch, kept so updates from either package land
# in the same families.
PHASE_HISTOGRAMS = {
    "dispatch": "dispatch_seconds",
    "data_wait": "data_wait_seconds",
    "device_drain": "merge_seconds",
    "merge_wait": "merge_seconds",
    "merge_overlap": "merge_overlap_seconds",
}


class MetricsRegistry:
    """The PS metric set of the training path (ml/pkg/ps/metrics.go and
    the JAX package's additions to it)."""

    def __init__(self):
        self.validation_loss = Gauge(
            "kubeml_job_validation_loss", "Validation loss of a job", "jobid")
        self.validation_accuracy = Gauge(
            "kubeml_job_validation_accuracy", "Validation accuracy of a job",
            "jobid")
        self.train_loss = Gauge(
            "kubeml_job_train_loss", "Train loss of a job", "jobid")
        self.parallelism = Gauge(
            "kubeml_job_parallelism", "Parallelism of a job", "jobid")
        self.epoch_duration = Gauge(
            "kubeml_job_epoch_duration_seconds", "Epoch duration of a job",
            "jobid")
        self.running_total = Gauge(
            "kubeml_job_running_total", "Number of running tasks by type",
            "type")
        # fault-tolerance series: per-job drops by the merge guard, and
        # the watchdog restarts, per job (cleared at finish) and a
        # PS-lifetime total that persists
        self.dropped_workers = Gauge(
            "kubeml_job_dropped_workers",
            "Worker updates dropped for non-finite values in the last "
            "epoch of a job", "jobid")
        self.quarantined_workers = Gauge(
            "kubeml_job_quarantined_workers",
            "Workers quarantined for repeated non-finite updates in the "
            "last epoch of a job", "jobid")
        self.restarts = Gauge(
            "kubeml_job_restarts",
            "Watchdog restarts of a job's standalone process", "jobid")
        self.restarts_total = Counter(
            "kubeml_ps_restarts_total",
            "Total watchdog restarts since the PS started", "type")
        # the degraded mode and preemption: reassignment volume, graceful
        # preemptions (per job and a PS-lifetime total), coalesced saves,
        # the heartbeat cursor and the liveness reaper's kills
        self.reassigned_batches = Gauge(
            "kubeml_job_reassigned_batches",
            "Minibatch steps re-dealt from quarantined workers to "
            "survivors in the last epoch of a job", "jobid")
        self.preemptions = Gauge(
            "kubeml_job_preemptions",
            "Graceful preemption reschedules of a job's standalone "
            "process", "jobid")
        self.checkpoint_drops = Gauge(
            "kubeml_job_checkpoint_drops",
            "Async checkpoint saves coalesced into a newer snapshot "
            "because the writer fell behind", "jobid")
        self.heartbeat_epoch = Gauge(
            "kubeml_job_heartbeat_epoch",
            "Epoch cursor of a job's last progress heartbeat", "jobid")
        self.heartbeat_round = Gauge(
            "kubeml_job_heartbeat_round",
            "Round cursor of a job's last progress heartbeat", "jobid")
        self.preemptions_total = Counter(
            "kubeml_ps_preemptions_total",
            "Total graceful preemption reschedules since the PS started",
            "type")
        self.wedged_total = Counter(
            "kubeml_ps_wedged_kills_total",
            "Standalone children killed by the heartbeat reaper for "
            "missing the liveness budget", "type")
        # round-phase latency distributions (MetricUpdate.phase_times)
        self.dispatch_seconds = Histogram(
            "kubeml_job_dispatch_seconds",
            "Round dispatch latency (device step calls) of a job", "jobid")
        self.data_wait_seconds = Histogram(
            "kubeml_job_data_wait_seconds",
            "Time a job's round loop blocked waiting for input data",
            "jobid")
        self.merge_seconds = Histogram(
            "kubeml_job_merge_seconds",
            "Merged-result readback (device drain) latency of a job",
            "jobid")
        self.merge_overlap_seconds = Histogram(
            "kubeml_job_merge_overlap_seconds",
            "Merge-adjacent host bookkeeping of a job overlapped with "
            "device execution (hidden by the dispatch pipeline)", "jobid")
        # training-health telemetry (the stat lanes riding MetricUpdate and
        # control/health.py's verdicts): per-worker stats carry the worker
        # as a LABEL, the verdict fans out one 0/1 series per state
        self.job_health = MultiGauge(
            "kubeml_job_health",
            "Health verdict of a job: 1 on the active state's series",
            ("jobid", "state"))
        self.worker_grad_norm = MultiGauge(
            "kubeml_job_worker_grad_norm",
            "Per-worker RMS global gradient norm in the last epoch of a "
            "job", ("jobid", "worker"))
        self.worker_update_ratio = MultiGauge(
            "kubeml_job_worker_update_ratio",
            "Per-worker update-norm/param-norm ratio in the last epoch "
            "of a job", ("jobid", "worker"))
        self.loss_spread = Gauge(
            "kubeml_job_loss_spread",
            "Cross-worker std of per-round mean losses in the last epoch "
            "of a job", "jobid")
        self.hbm_bytes = MultiGauge(
            "kubeml_device_hbm_bytes",
            "Device memory watermark of a job's process, by kind "
            "(peak|in_use)", ("jobid", "kind"))
        self.health_alerts_total = Counter(
            "kubeml_health_alerts_total",
            "Health-rule alerts fired for a job, by rule",
            ("jobid", "rule"))
        self.jit_compiles_total = Counter(
            "kubeml_jit_compiles_total",
            "Engine round-program jit compiles of a job", "jobid")
        self.trace_dropped_total = Counter(
            "kubeml_trace_events_dropped_total",
            "Tracer events dropped at the per-process ring cap for a job",
            "jobid")
        self.dataset_generation = Gauge(
            "kubeml_dataset_generation",
            "Dataset generation a continual job last trained over",
            "jobid")
        self.data_lag_generations = Gauge(
            "kubeml_data_lag_generations",
            "Generations the dataset registry is ahead of what a "
            "continual job has trained", "jobid")
        # serving plane (serve/): per-model SLO latency distributions
        # (TTFT = submit -> first token, TPOT = decode cadence after it,
        # e2e = submit -> done) + the occupancy/queue/KV gauges the
        # serve health rules and `kubeml top` read, keyed by MODEL, not
        # job — serving outlives any one job and survives clear_job
        self.serve_ttft_seconds = Histogram(
            "kubeml_serve_ttft_seconds",
            "Time to first generated token of a /generate request, by "
            "served model", "model")
        self.serve_tpot_seconds = Histogram(
            "kubeml_serve_tpot_seconds",
            "Mean per-output-token decode latency of a /generate "
            "request after its first token, by served model", "model")
        self.serve_e2e_seconds = Histogram(
            "kubeml_serve_e2e_seconds",
            "End-to-end latency of a /generate request, by served model",
            "model")
        # TTFT attribution: the same TTFT decomposed into
        # additive components — queue (submit -> slot attach), prefill
        # (wall time of the dispatches that computed the prompt), and
        # interleave (scheduler delay between them; the remainder, so
        # the three sum to TTFT per request)
        self.serve_ttft_breakdown_seconds = Histogram(
            "kubeml_serve_ttft_breakdown_seconds",
            "Additive TTFT components of a /generate request "
            "(queue|prefill|interleave; they sum to the TTFT), by "
            "served model", ("model", "component"))
        # producer-side stream lifetime, recorded when the ndjson
        # generator CLOSES (incl. client disconnects that cancel the
        # request). kubeml_http_request_duration_seconds already covers
        # the full server-side write — the middleware observes after the
        # chunked body is written — but it only sees streams whose
        # connection the server finished with; this one is per-model
        # and counts cancelled/abandoned streams' real lifetimes too.
        self.serve_stream_duration_seconds = Histogram(
            "kubeml_serve_stream_duration_seconds",
            "Lifetime of a streaming /generate response from submit to "
            "producer close, by served model", "model")
        self.serve_active_slots = Gauge(
            "kubeml_serve_active_slots",
            "Decode slots occupied by in-flight streams of a served "
            "model", "model")
        self.serve_queue_depth = Gauge(
            "kubeml_serve_queue_depth",
            "Admitted /generate requests waiting for a decode slot, by "
            "served model", "model")
        self.serve_kv_utilization = Gauge(
            "kubeml_serve_kv_page_utilization",
            "Fraction of a served model's KV cache pages in use", "model")
        self.serve_requests_total = Counter(
            "kubeml_serve_requests_total",
            "Finished /generate requests by served model and outcome "
            "(ok|rejected|cancelled|deadline|error)", ("model", "outcome"))
        self.serve_tokens_total = Counter(
            "kubeml_serve_tokens_total",
            "Tokens generated by a served model", "model")
        # chunked prefill + prefix cache: where prompt tokens are
        # spent (bulk prefill vs per-token decode), how often full
        # prompt pages are served from the content-hash cache, and the
        # prompt work queued ahead of any new request's first token
        self.serve_prefill_tokens_total = Counter(
            "kubeml_serve_prefill_tokens_total",
            "Prompt tokens bulk-loaded through the chunked-prefill "
            "program, by served model", "model")
        self.serve_decode_tokens_total = Counter(
            "kubeml_serve_decode_tokens_total",
            "Tokens advanced through the decode program across all "
            "slots, by served model", "model")
        self.serve_prefix_hits_total = Counter(
            "kubeml_serve_prefix_cache_hits_total",
            "Prompt pages attached from the shared prefix cache instead "
            "of being re-prefilled, by served model", "model")
        self.serve_prefix_misses_total = Counter(
            "kubeml_serve_prefix_cache_misses_total",
            "Prompt prefix-cache lookups that found no resident page, "
            "by served model", "model")
        self.serve_prefill_backlog = Gauge(
            "kubeml_serve_prefill_backlog_tokens",
            "Prompt tokens admitted but not yet prefilled, by served "
            "model", "model")
        # fault tolerance: supervisor rebuilds, poisoned-stream
        # quarantines, and KV pager invariant violations (production
        # engines log-and-count instead of crashing; any nonzero value
        # is a bug to chase)
        self.serve_engine_restarts_total = Counter(
            "kubeml_serve_engine_restarts_total",
            "Supervisor engine rebuilds after a dead or wedged serving "
            "loop, by served model", "model")
        self.serve_poisoned_total = Counter(
            "kubeml_serve_poisoned_requests_total",
            "Requests quarantined for poisoning the decode step "
            "(non-finite logits or step exceptions isolated by "
            "bisection), by served model", "model")
        self.serve_page_leaks_total = Counter(
            "kubeml_serve_page_leaks_total",
            "KV pager invariant violations detected on release or "
            "recovery, by served model", "model")
        # decode bandwidth: deterministic device bytes the decode
        # program moved through the paged KV cache (page geometry x
        # storage dtype per decoded token — a comm proxy, not a timer),
        # the observable the int8-KV mode exists to shrink
        self.serve_kv_bytes_total = Counter(
            "kubeml_serve_kv_bytes_total",
            "KV-cache bytes moved by decode dispatches (deterministic "
            "geometry-based proxy), by served model", "model")
        # speculative decoding's token flow: draft proposals in,
        # verifier-kept tokens out (accepted prefix + bonus pick per
        # dispatch), proposals rolled back. Counters, never timers:
        # accepted / verify dispatches is the accepted-per-dispatch proxy
        self.serve_draft_tokens_total = Counter(
            "kubeml_serve_draft_tokens_total",
            "Tokens proposed by the speculative draft model, by served "
            "model", "model")
        self.serve_accepted_tokens_total = Counter(
            "kubeml_serve_accepted_tokens_total",
            "Speculative tokens kept per verify dispatch (accepted "
            "prefix plus the bonus target pick), by served model",
            "model")
        self.serve_rejected_tokens_total = Counter(
            "kubeml_serve_rejected_tokens_total",
            "Draft proposals rejected by the verifier and rolled back "
            "as data, by served model", "model")
        # the weight generation new admissions attach to (advances on
        # every zero-downtime hot-swap)
        self.serve_weight_generation = Gauge(
            "kubeml_serve_weight_generation",
            "Weight generation new admissions of a served model attach "
            "to (advances on hot-swap)", "model")
        # serving fleet (serve/fleet.py), fed by the fleet's merged
        # snapshot (update_fleet): live replica count, router traffic
        # (spills off the affine replica, shed retries, cold starts),
        # autoscaler decisions by action, and per-replica prefix-cache
        # traffic; per-replica series ride a `replica` label
        self.serve_fleet_replicas = Gauge(
            "kubeml_serve_fleet_replicas",
            "Live decode replicas behind the model's fleet router",
            "model")
        self.serve_fleet_spills_total = Counter(
            "kubeml_serve_fleet_spills_total",
            "Requests routed off their affine replica to a peer",
            "model")
        self.serve_fleet_router_retries_total = Counter(
            "kubeml_serve_fleet_router_retries_total",
            "Replica sheds the router retried against a peer", "model")
        self.serve_fleet_cold_starts_total = Counter(
            "kubeml_serve_fleet_cold_starts_total",
            "Replicas built from zero by a first request", "model")
        self.serve_fleet_scale_events_total = Counter(
            "kubeml_serve_fleet_scale_events_total",
            "Fleet autoscaler decisions applied, by action",
            ("model", "action"))
        self.serve_fleet_replica_prefix_hits_total = Counter(
            "kubeml_serve_fleet_replica_prefix_hits_total",
            "Prefix-cache hits per decode replica",
            ("model", "replica"))
        self.serve_fleet_replica_prefix_misses_total = Counter(
            "kubeml_serve_fleet_replica_prefix_misses_total",
            "Prefix-cache misses per decode replica",
            ("model", "replica"))
        # fleet failure domains (serve/fleet.py supervise_once):
        # ejections (replica removed from the ring), failovers
        # (ejections that moved >= 1 in-flight stream), migrated
        # streams (failover + hedge moves), half-open probes, hedges
        self.serve_fleet_ejections_total = Counter(
            "kubeml_serve_fleet_ejections_total",
            "Replicas ejected from the ring (dead or crash-looping)",
            "model")
        self.serve_fleet_failovers_total = Counter(
            "kubeml_serve_fleet_failovers_total",
            "Ejections that live-migrated at least one stream", "model")
        self.serve_fleet_migrated_streams_total = Counter(
            "kubeml_serve_fleet_migrated_streams_total",
            "In-flight streams resumed on another replica", "model")
        self.serve_fleet_probes_total = Counter(
            "kubeml_serve_fleet_probes_total",
            "Half-open probe requests routed to probation replicas",
            "model")
        self.serve_fleet_hedges_total = Counter(
            "kubeml_serve_fleet_hedges_total",
            "Queued streams re-issued off a straggler replica", "model")
        # serving SLO plane (serve/slo.py), fed by the fleet's merged
        # snapshot: attainment and the fast/slow burn-rate windows as
        # gauges (window rides a LABEL, not a family suffix), the
        # good/bad classification and burn-alert onsets as counters
        self.serve_slo_attainment = Gauge(
            "kubeml_serve_slo_attainment",
            "Fraction of finished requests meeting the model's latency "
            "SLO over the slow burn window", "model")
        self.serve_slo_burn_rate = MultiGauge(
            "kubeml_serve_slo_burn_rate",
            "SLO error-budget burn rate (bad fraction over 1-target), "
            "by window (fast|slow)", ("model", "window"))
        self.serve_slo_good_total = Counter(
            "kubeml_serve_slo_good_total",
            "Finished requests that met the model's latency SLO",
            "model")
        self.serve_slo_bad_total = Counter(
            "kubeml_serve_slo_bad_total",
            "Finished requests that missed the model's latency SLO "
            "(slow, errored, or deadline-expired)", "model")
        self.serve_slo_burn_alerts_total = Counter(
            "kubeml_serve_slo_burn_alerts_total",
            "Multi-window SLO burn alert onsets (fast AND slow burn "
            "above 1.0)", "model")
        # the /infer checkpoint LRU
        self.infer_cache_entries = Gauge(
            "kubeml_infer_cache_entries",
            "Deserialized checkpoints resident in an inference cache",
            "cache")
        self.infer_cache_hits_total = Counter(
            "kubeml_infer_cache_hits_total",
            "Inference-cache lookups served without touching storage",
            "cache")
        self.infer_cache_misses_total = Counter(
            "kubeml_infer_cache_misses_total",
            "Inference-cache lookups that deserialized a checkpoint",
            "cache")
        # analytic cost-ledger counters (metrics/ledger.py), advanced by
        # delta from a job's cost_programs and a fleet's
        # serve_cost_programs
        self.cost_flops_total = Counter(
            "kubeml_cost_flops_total",
            "Analytic-ledger FLOPs dispatched, by compiled program and "
            "plane", ("program", "plane"))
        self.cost_hbm_bytes_total = Counter(
            "kubeml_cost_hbm_bytes_total",
            "Analytic-ledger HBM bytes moved, by compiled program and "
            "plane", ("program", "plane"))
        self.cost_dispatches_total = Counter(
            "kubeml_cost_dispatches_total",
            "Device dispatches counted by the analytic cost ledger, by "
            "program and plane", ("program", "plane"))
        # cluster allocator (control/cluster.py), fed by the scheduler's
        # snapshot pushes (POST /cluster): pool occupancy, queue depth
        # by priority, per-tenant lanes vs quota/weighted share, and
        # the lifetime decision counters (placements/preemptions/aged
        # grants/quota clamps — snapshots carry cumulative values, the
        # counters advance by delta like jit_compiles_total)
        self.cluster_pool_lanes = Gauge(
            "kubeml_cluster_pool_lanes",
            "Worker lanes in the shared cluster pool", "pool")
        self.cluster_lanes_in_use = Gauge(
            "kubeml_cluster_lanes_in_use",
            "Worker lanes currently leased to placed jobs", "pool")
        self.cluster_running_jobs = Gauge(
            "kubeml_cluster_running_jobs",
            "Jobs holding lanes in the shared pool", "pool")
        self.cluster_queue_depth = Gauge(
            "kubeml_cluster_queue_depth",
            "Jobs parked by the cluster allocator, by priority",
            "priority")
        self.cluster_oldest_wait = Gauge(
            "kubeml_cluster_oldest_wait_seconds",
            "Queue wait of the longest-parked job", "pool")
        self.cluster_tenant_lanes = Gauge(
            "kubeml_cluster_tenant_lanes",
            "Worker lanes leased to a tenant's running jobs", "tenant")
        self.cluster_tenant_quota = Gauge(
            "kubeml_cluster_tenant_quota_lanes",
            "Lane quota of a tenant (hard cap)", "tenant")
        self.cluster_tenant_share = Gauge(
            "kubeml_cluster_tenant_share",
            "Fraction of the pool a tenant's running jobs hold",
            "tenant")
        self.cluster_gang_placements_total = Counter(
            "kubeml_cluster_gang_placements_total",
            "Atomic gang placements by the cluster allocator", "pool")
        self.cluster_preemptions_total = Counter(
            "kubeml_cluster_preemptions_total",
            "Victims displaced by higher-priority arrivals", "pool")
        self.cluster_aged_grants_total = Counter(
            "kubeml_cluster_aged_grants_total",
            "Placements that needed aging to outrank newer arrivals",
            "pool")
        self.cluster_quota_clamps_total = Counter(
            "kubeml_cluster_quota_clamps_total",
            "Gang or resize asks clamped to a tenant quota", "pool")
        # durable control plane (control/journal.py): recovery counts
        # and latency per role, decision-journal activity, and stale
        # grants rejected by the fencing epoch — the split-brain signal
        self.control_recoveries_total = Counter(
            "kubeml_control_recoveries_total",
            "Control-plane crash recoveries completed", "role")
        self.control_journal_records_total = Counter(
            "kubeml_control_journal_records_total",
            "Decision-journal records appended", "role")
        self.control_journal_compactions_total = Counter(
            "kubeml_control_journal_compactions_total",
            "Decision-journal snapshot compactions", "role")
        self.control_fencing_rejections_total = Counter(
            "kubeml_control_fencing_rejections_total",
            "Stale lane grants rejected by their fencing epoch", "role")
        self.control_recovery_seconds = Histogram(
            "kubeml_control_recovery_seconds",
            "Wall seconds one control-plane role took to recover",
            "role")
        self.control_fencing_epoch = Gauge(
            "kubeml_control_fencing_epoch",
            "Current fencing epoch of the lane-grant allocator "
            "(bumped on every recovery)", "pool")
        # cumulative MetricUpdate values seen per job: the counters
        # advance by delta so a replayed update stays monotone
        self._jit_seen: Dict[str, float] = {}
        self._trace_seen: Dict[str, float] = {}
        self._cost_seen: Dict[tuple, float] = {}
        self._fleet_seen: Dict[tuple, float] = {}
        # the allocator snapshot's lifetime counters seen so far
        self._cluster_seen: Dict[str, float] = {}
        self._job_gauges = [self.validation_loss, self.validation_accuracy,
                            self.train_loss, self.parallelism,
                            self.epoch_duration, self.dropped_workers,
                            self.quarantined_workers, self.restarts,
                            self.reassigned_batches, self.preemptions,
                            self.checkpoint_drops,
                            self.heartbeat_epoch, self.heartbeat_round,
                            self.loss_spread, self.dataset_generation,
                            self.data_lag_generations]
        self._job_hists = [self.dispatch_seconds, self.data_wait_seconds,
                           self.merge_seconds, self.merge_overlap_seconds]
        self._job_multi = [self.job_health, self.worker_grad_norm,
                           self.worker_update_ratio, self.hbm_bytes]
        self._job_counters = [self.health_alerts_total,
                              self.jit_compiles_total,
                              self.trace_dropped_total]
        self._serve_gauges = [self.serve_active_slots,
                              self.serve_queue_depth,
                              self.serve_kv_utilization,
                              self.serve_prefill_backlog,
                              self.serve_weight_generation,
                              self.serve_fleet_replicas,
                              self.serve_slo_attainment]
        self._serve_hists = [self.serve_ttft_seconds,
                             self.serve_tpot_seconds,
                             self.serve_e2e_seconds,
                             self.serve_stream_duration_seconds]
        self._serve_counters = [
            self.serve_requests_total, self.serve_tokens_total,
            self.serve_prefill_tokens_total, self.serve_decode_tokens_total,
            self.serve_prefix_hits_total, self.serve_prefix_misses_total,
            self.serve_engine_restarts_total, self.serve_poisoned_total,
            self.serve_page_leaks_total, self.serve_kv_bytes_total,
            self.serve_draft_tokens_total, self.serve_accepted_tokens_total,
            self.serve_rejected_tokens_total,
            self.serve_fleet_spills_total,
            self.serve_fleet_router_retries_total,
            self.serve_fleet_cold_starts_total,
            self.serve_fleet_scale_events_total,
            self.serve_fleet_replica_prefix_hits_total,
            self.serve_fleet_replica_prefix_misses_total,
            self.serve_fleet_ejections_total,
            self.serve_fleet_failovers_total,
            self.serve_fleet_migrated_streams_total,
            self.serve_fleet_probes_total, self.serve_fleet_hedges_total,
            self.serve_slo_good_total, self.serve_slo_bad_total,
            self.serve_slo_burn_alerts_total]

        self._cluster_gauges = [self.cluster_pool_lanes,
                                self.cluster_lanes_in_use,
                                self.cluster_running_jobs,
                                self.cluster_queue_depth,
                                self.cluster_oldest_wait,
                                self.cluster_tenant_lanes,
                                self.cluster_tenant_quota,
                                self.cluster_tenant_share,
                                self.control_fencing_epoch]
        self._cluster_counters = [self.cluster_gang_placements_total,
                                  self.cluster_preemptions_total,
                                  self.cluster_aged_grants_total,
                                  self.cluster_quota_clamps_total,
                                  self.control_recoveries_total,
                                  self.control_journal_records_total,
                                  self.control_journal_compactions_total,
                                  self.control_fencing_rejections_total]

    def update_job(self, m) -> None:
        """Apply a MetricUpdate (ml/pkg/ps/metrics.go:90-99)."""
        self.validation_loss.set(m.job_id, m.validation_loss)
        self.validation_accuracy.set(m.job_id, m.accuracy)
        self.train_loss.set(m.job_id, m.train_loss)
        self.parallelism.set(m.job_id, m.parallelism)
        self.epoch_duration.set(m.job_id, m.epoch_duration)
        self.dropped_workers.set(m.job_id, m.dropped_workers)
        self.quarantined_workers.set(m.job_id, m.quarantined_workers)
        self.reassigned_batches.set(m.job_id, m.reassigned_batches)
        self.checkpoint_drops.set(m.job_id, m.checkpoint_drops)
        for span, attr in PHASE_HISTOGRAMS.items():
            hist = getattr(self, attr)
            for seconds in m.phase_times.get(span, ()):
                hist.observe(m.job_id, seconds)
        # re-key the per-worker series each epoch so a parallelism
        # shrink leaves no stale worker behind
        if m.grad_norms or m.update_ratios:
            self.worker_grad_norm.clear_prefix(m.job_id)
            self.worker_update_ratio.clear_prefix(m.job_id)
            for i, gn in enumerate(m.grad_norms):
                self.worker_grad_norm.set((m.job_id, str(i)), gn)
            for i, ur in enumerate(m.update_ratios):
                self.worker_update_ratio.set((m.job_id, str(i)), ur)
            self.loss_spread.set(m.job_id, m.loss_spread)
        if m.hbm_peak_bytes:
            self.hbm_bytes.set((m.job_id, "peak"), m.hbm_peak_bytes)
            self.hbm_bytes.set((m.job_id, "in_use"), m.hbm_in_use_bytes)
        for cum, seen, counter in (
                (m.jit_compiles, self._jit_seen, self.jit_compiles_total),
                (m.trace_events_dropped, self._trace_seen,
                 self.trace_dropped_total)):
            if cum > seen.get(m.job_id, 0):
                counter.inc(m.job_id, cum - seen.get(m.job_id, 0))
                seen[m.job_id] = cum
        # lag < 0 marks a non-continual job, which publishes neither gauge
        if m.data_lag_generations >= 0:
            self.dataset_generation.set(m.job_id, m.dataset_generation)
            self.data_lag_generations.set(m.job_id, m.data_lag_generations)
        self.update_cost(m.job_id, m.cost_programs)

    def update_cost(self, owner: str, cost_programs) -> None:
        """Advance the kubeml_cost_* counters from one cumulative ledger
        snapshot (one flat dict per program), by delta per owner."""
        for program, entry in (cost_programs or {}).items():
            plane = str(entry.get("plane", "train"))
            for field_, counter in (
                    ("flops_total", self.cost_flops_total),
                    ("hbm_bytes_total", self.cost_hbm_bytes_total),
                    ("dispatches", self.cost_dispatches_total)):
                cum = float(entry.get(field_, 0))
                seen = self._cost_seen.get((owner, program, field_), 0.0)
                if cum > seen:
                    counter.inc((program, plane), cum - seen)
                    self._cost_seen[(owner, program, field_)] = cum

    def note_restart(self, job_id: str) -> None:
        """One watchdog restart: the per-job gauge and the PS-lifetime
        total (which survives clear_job)."""
        self.restarts.inc(job_id)
        self.restarts_total.inc("standalone")

    def note_preemption(self, job_id: str) -> None:
        """One graceful preemption reschedule: the per-job gauge and the
        PS-lifetime total, as for restarts."""
        self.preemptions.inc(job_id)
        self.preemptions_total.inc("standalone")

    def note_heartbeat(self, job_id: str, epoch: int, rnd: int) -> None:
        self.heartbeat_epoch.set(job_id, epoch)
        self.heartbeat_round.set(job_id, rnd)

    def note_wedged(self, job_id: str) -> None:
        """A heartbeat reaper kill (the restart it leads to is counted by
        the watchdog)."""
        self.wedged_total.inc("standalone")

    def set_health(self, job_id: str, state: str) -> None:
        """Publish a job's health verdict: 1 on the active state's
        series, 0 on the rest (so a state change flips atomically for
        scrapers instead of briefly showing two active states)."""
        for s in HEALTH_STATES:
            self.job_health.set((job_id, s), 1.0 if s == state else 0.0)

    def note_health_alert(self, job_id: str, rule: str) -> None:
        self.health_alerts_total.inc((job_id, rule))

    # ------------------------------------------------------- serving plane

    def observe_serve_request(self, model: str, outcome: str) -> None:
        self.serve_requests_total.inc((model, outcome))

    def observe_serve_latency(self, model: str, ttft: float = None,
                              tpot: float = None,
                              e2e: float = None) -> None:
        if ttft is not None:
            self.serve_ttft_seconds.observe(model, ttft)
        if tpot is not None:
            self.serve_tpot_seconds.observe(model, tpot)
        if e2e is not None:
            self.serve_e2e_seconds.observe(model, e2e)

    def set_serve_state(self, model: str, active_slots: float,
                        queue_depth: float, kv_utilization: float,
                        prefill_backlog: float = 0.0) -> None:
        self.serve_active_slots.set(model, active_slots)
        self.serve_queue_depth.set(model, queue_depth)
        self.serve_kv_utilization.set(model, kv_utilization)
        self.serve_prefill_backlog.set(model, prefill_backlog)

    def set_serve_weight_generation(self, model: str, gen: int) -> None:
        self.serve_weight_generation.set(model, float(gen))

    def note_serve_tokens(self, model: str, n: int) -> None:
        self.serve_tokens_total.inc(model, n)

    def note_serve_prefill(self, model: str, n: int) -> None:
        self.serve_prefill_tokens_total.inc(model, n)

    def note_serve_decode(self, model: str, n: int) -> None:
        self.serve_decode_tokens_total.inc(model, n)

    def note_serve_prefix_hits(self, model: str, n: int) -> None:
        self.serve_prefix_hits_total.inc(model, n)

    def note_serve_prefix_misses(self, model: str, n: int) -> None:
        self.serve_prefix_misses_total.inc(model, n)

    def note_serve_engine_restart(self, model: str) -> None:
        self.serve_engine_restarts_total.inc(model)

    def note_serve_poisoned(self, model: str) -> None:
        self.serve_poisoned_total.inc(model)

    def note_serve_page_leaks(self, model: str, n: int) -> None:
        self.serve_page_leaks_total.inc(model, n)

    def note_serve_kv_bytes(self, model: str, n: int) -> None:
        self.serve_kv_bytes_total.inc(model, n)

    def note_serve_draft_tokens(self, model: str, n: int) -> None:
        self.serve_draft_tokens_total.inc(model, n)

    def note_serve_accepted_tokens(self, model: str, n: int) -> None:
        self.serve_accepted_tokens_total.inc(model, n)

    def note_serve_rejected_tokens(self, model: str, n: int) -> None:
        self.serve_rejected_tokens_total.inc(model, n)

    def observe_serve_ttft_breakdown(self, model: str, queue: float,
                                     prefill: float,
                                     interleave: float) -> None:
        self.serve_ttft_breakdown_seconds.observe((model, "queue"), queue)
        self.serve_ttft_breakdown_seconds.observe((model, "prefill"),
                                                  prefill)
        self.serve_ttft_breakdown_seconds.observe((model, "interleave"),
                                                  interleave)

    def observe_serve_stream(self, model: str, seconds: float) -> None:
        self.serve_stream_duration_seconds.observe(model, seconds)

    def note_serve_trace_dropped(self, model: str, cum: int) -> None:
        """Advance kubeml_trace_events_dropped_total for a serving
        sink's drops, under the serve:<model> pseudo-job id — the value
        is cumulative over the service's life (Tracer.dropped_events),
        the counter advances by delta like the training-plane path in
        update_job."""
        job_id = f"serve:{model}"
        seen = self._trace_seen.get(job_id, 0)
        if cum > seen:
            self.trace_dropped_total.inc(job_id, cum - seen)
            self._trace_seen[job_id] = cum

    def update_fleet(self, model: str, snap: dict) -> None:
        """Apply one merged fleet snapshot (serve/fleet.py). The gauge
        mirrors the live replica count; lifetime counters advance by
        delta against the snapshot's cumulative values (the
        update_cluster discipline, so republished snapshots stay
        monotone); the per-replica prefix hit/miss fields are already
        deltas and feed their counters directly."""
        self.serve_fleet_replicas.set(
            model, float(snap.get("fleet_replicas", 0)))
        # SLO plane: attainment + burn windows mirror the snapshot
        # (gauges), classification counters advance by delta
        self.serve_slo_attainment.set(
            model, float(snap.get("serve_slo_attainment", 1.0)))
        self.serve_slo_burn_rate.set(
            (model, "fast"), float(snap.get("serve_slo_burn_fast", 0.0)))
        self.serve_slo_burn_rate.set(
            (model, "slow"), float(snap.get("serve_slo_burn_slow", 0.0)))
        for field, counter in (
                ("fleet_spills_total", self.serve_fleet_spills_total),
                ("fleet_router_retries_total",
                 self.serve_fleet_router_retries_total),
                ("fleet_cold_starts_total",
                 self.serve_fleet_cold_starts_total),
                ("fleet_ejections_total",
                 self.serve_fleet_ejections_total),
                ("fleet_failovers_total",
                 self.serve_fleet_failovers_total),
                ("fleet_migrated_streams_total",
                 self.serve_fleet_migrated_streams_total),
                ("fleet_probes_total", self.serve_fleet_probes_total),
                ("fleet_hedges_total", self.serve_fleet_hedges_total),
                ("serve_slo_good_total", self.serve_slo_good_total),
                ("serve_slo_bad_total", self.serve_slo_bad_total),
                ("serve_slo_alerts_total",
                 self.serve_slo_burn_alerts_total)):
            cum = float(snap.get(field, 0))
            seen = self._fleet_seen.get((model, field), 0.0)
            if cum > seen:
                counter.inc(model, cum - seen)
                self._fleet_seen[(model, field)] = cum
        for field, action in (("fleet_grows_total", "grow"),
                              ("fleet_shrinks_total", "shrink"),
                              ("fleet_scale_to_zero_total",
                               "scale_to_zero")):
            cum = float(snap.get(field, 0))
            seen = self._fleet_seen.get((model, field), 0.0)
            if cum > seen:
                self.serve_fleet_scale_events_total.inc(
                    (model, action), cum - seen)
                self._fleet_seen[(model, field)] = cum
        for counter, field in (
                (self.serve_fleet_replica_prefix_hits_total,
                 "fleet_replica_prefix_hits"),
                (self.serve_fleet_replica_prefix_misses_total,
                 "fleet_replica_prefix_misses")):
            for replica, n in (snap.get(field) or {}).items():
                if n > 0:
                    counter.inc((model, str(replica)), float(n))
        self.update_cost(f"serve:{model}", snap.get("serve_cost_programs"))

    def clear_serve(self, model: str) -> None:
        for g in (self.serve_active_slots, self.serve_queue_depth,
                  self.serve_kv_utilization, self.serve_prefill_backlog,
                  self.serve_weight_generation,
                  self.serve_fleet_replicas,
                  self.serve_slo_attainment):
            g.clear(model)
        self.serve_slo_burn_rate.clear_prefix(model)
        for h in self._serve_hists:
            h.clear(model)
        for comp in ("queue", "prefill", "interleave"):
            self.serve_ttft_breakdown_seconds.clear((model, comp))
        for c in (self.serve_requests_total, self.serve_tokens_total,
                  self.serve_prefill_tokens_total,
                  self.serve_decode_tokens_total,
                  self.serve_prefix_hits_total,
                  self.serve_prefix_misses_total,
                  self.serve_engine_restarts_total,
                  self.serve_poisoned_total,
                  self.serve_page_leaks_total,
                  self.serve_kv_bytes_total,
                  self.serve_draft_tokens_total,
                  self.serve_accepted_tokens_total,
                  self.serve_rejected_tokens_total,
                  self.serve_fleet_spills_total,
                  self.serve_fleet_router_retries_total,
                  self.serve_fleet_cold_starts_total,
                  self.serve_fleet_scale_events_total,
                  self.serve_fleet_replica_prefix_hits_total,
                  self.serve_fleet_replica_prefix_misses_total,
                  self.serve_fleet_ejections_total,
                  self.serve_fleet_failovers_total,
                  self.serve_fleet_migrated_streams_total,
                  self.serve_fleet_probes_total,
                  self.serve_fleet_hedges_total,
                  self.serve_slo_good_total,
                  self.serve_slo_bad_total,
                  self.serve_slo_burn_alerts_total):
            c.clear_prefix(model)
        self.trace_dropped_total.clear_prefix(f"serve:{model}")
        self._trace_seen.pop(f"serve:{model}", None)
        for key in [k for k in self._fleet_seen if k[0] == model]:
            del self._fleet_seen[key]

    # ---------------------------------------------------- cluster allocator

    def update_cluster(self, snap: dict) -> None:
        """Apply one allocator snapshot (control/cluster.py
        ClusterAllocator.snapshot(), pushed by the scheduler). Gauges
        mirror the snapshot; per-priority/per-tenant series absent from
        it zero out (a drained priority level must not linger at its
        last depth); lifetime counters advance by delta so replays
        after a scheduler restart stay monotone."""
        self.cluster_pool_lanes.set(
            "shared", float(snap.get("cluster_pool_lanes", 0)))
        self.cluster_lanes_in_use.set(
            "shared", float(snap.get("cluster_lanes_in_use", 0)))
        self.cluster_running_jobs.set(
            "shared", float(snap.get("cluster_running_jobs", 0)))
        self.cluster_oldest_wait.set(
            "shared", float(snap.get("cluster_oldest_wait_s", 0.0)))
        by_prio = snap.get("cluster_queue_by_priority") or {}
        with self.cluster_queue_depth._lock:
            stale = [k for k in self.cluster_queue_depth._values
                     if k not in by_prio]
        for k in stale:
            self.cluster_queue_depth.set(k, 0.0)
        for prio, depth in by_prio.items():
            self.cluster_queue_depth.set(str(prio), float(depth))
        pool = float(snap.get("cluster_pool_lanes", 0)) or 1.0
        lanes = snap.get("cluster_tenant_lanes") or {}
        quotas = snap.get("cluster_tenant_quota") or {}
        for t, n in lanes.items():
            self.cluster_tenant_lanes.set(t, float(n))
            self.cluster_tenant_share.set(t, float(n) / pool)
        for t, q in quotas.items():
            self.cluster_tenant_quota.set(t, float(q))
        for field, counter in (
                ("cluster_gang_placements_total",
                 self.cluster_gang_placements_total),
                ("cluster_preemptions_total",
                 self.cluster_preemptions_total),
                ("cluster_aged_grants_total",
                 self.cluster_aged_grants_total),
                ("cluster_quota_clamps_total",
                 self.cluster_quota_clamps_total)):
            cum = float(snap.get(field, 0))
            seen = self._cluster_seen.get(field, 0.0)
            if cum > seen:
                counter.inc("shared", cum - seen)
                self._cluster_seen[field] = cum
        # durable control plane: the allocator's journaled lifetime
        # counters (they survive restart, so deltas stay monotone
        # across control-plane incarnations)
        self.control_fencing_epoch.set(
            "shared", float(snap.get("cluster_fencing_epoch", 0)))
        for field, counter, role in (
                ("cluster_recoveries_total",
                 self.control_recoveries_total, "allocator"),
                ("cluster_journal_records_total",
                 self.control_journal_records_total, "allocator"),
                ("cluster_journal_compactions_total",
                 self.control_journal_compactions_total, "allocator"),
                ("cluster_fencing_rejections_total",
                 self.control_fencing_rejections_total, "allocator")):
            cum = float(snap.get(field, 0))
            seen = self._cluster_seen.get(field, 0.0)
            if cum > seen:
                counter.inc(role, cum - seen)
                self._cluster_seen[field] = cum
        # a just-recovered scheduler stamps its recovery duration onto
        # its first snapshot push
        rs = snap.get("control_recovery_s")
        if rs is not None:
            self.note_control_recovery(
                str(snap.get("control_role", "scheduler")), float(rs))

    def note_control_recovery(self, role: str, seconds: float) -> None:
        """One completed control-plane recovery for `role` (scheduler /
        ps / allocator): lifetime count + wall-seconds histogram."""
        self.control_recoveries_total.inc(role)
        self.control_recovery_seconds.observe(role, seconds)

    def note_infer_cache(self, hit: bool, cache: str = "checkpoints") -> None:
        (self.infer_cache_hits_total if hit
         else self.infer_cache_misses_total).inc(cache)

    def set_infer_cache_entries(self, n: int,
                                cache: str = "checkpoints") -> None:
        self.infer_cache_entries.set(cache, n)

    def clear_job(self, job_id: str) -> None:
        for g in self._job_gauges:
            g.clear(job_id)
        for h in self._job_hists:
            h.clear(job_id)
        for mg in self._job_multi:
            mg.clear_prefix(job_id)
        for c in self._job_counters:
            c.clear_prefix(job_id)
        self._jit_seen.pop(job_id, None)
        self._trace_seen.pop(job_id, None)
        # the (program, plane) cost series are PS-lifetime aggregates;
        # only the job's seen baseline goes
        for key in [k for k in self._cost_seen if k[0] == job_id]:
            del self._cost_seen[key]

    def exposition(self) -> str:
        families = (self._job_gauges
                    + [self.running_total, self.restarts_total,
                       self.preemptions_total, self.wedged_total]
                    + self._job_counters + self._job_multi
                    + self._job_hists
                    + self._serve_gauges + [self.serve_slo_burn_rate]
                    + self._serve_counters + self._serve_hists
                    + [self.serve_ttft_breakdown_seconds]
                    + [self.infer_cache_entries, self.infer_cache_hits_total,
                       self.infer_cache_misses_total, self.cost_flops_total,
                       self.cost_hbm_bytes_total,
                       self.cost_dispatches_total]
                    + self._cluster_gauges + self._cluster_counters
                    + [self.control_recovery_seconds])
        return "\n".join(f.collect() for f in families) + "\n"
