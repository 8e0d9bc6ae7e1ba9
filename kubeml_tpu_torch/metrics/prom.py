"""Prometheus text-format metrics (copy of kubeml_tpu/metrics/prom.py's
families the training path sets and clears; stdlib only).

The same family names, help strings, label names and exposition text as
the JAX package's, so dashboards and ``tools/check_metrics.py`` read a
port deployment unchanged:

    kubeml_job_{validation_loss,validation_accuracy,train_loss,
        parallelism,epoch_duration_seconds,...}{jobid=...}
    kubeml_job_running_total{type=...}
    kubeml_job_{dispatch,data_wait,merge,merge_overlap}_seconds (histograms)
    kubeml_http_requests_total / kubeml_http_request_duration_seconds
    kubeml_infer_cache_{entries,hits_total,misses_total}{cache=...}

Per-job series are cleared when a job finishes (metrics.go:90-106). The
serving, SLO, cluster, health-verdict and durable-control-plane families
come with the modules that set them (ROADMAP A.1, A.15, A.16).
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
        self.reassigned_batches = Gauge(
            "kubeml_job_reassigned_batches",
            "Minibatch steps re-dealt from quarantined workers to "
            "survivors in the last epoch of a job", "jobid")
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
        # training-health stat lanes (per-worker series on a LABEL)
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
        # analytic cost-ledger counters, advanced from a job's
        # cost_programs (empty until the ledger is ported, ROADMAP A.13)
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
        # cumulative MetricUpdate values seen per job: the counters
        # advance by delta so a replayed update stays monotone
        self._jit_seen: Dict[str, float] = {}
        self._trace_seen: Dict[str, float] = {}
        self._cost_seen: Dict[tuple, float] = {}
        self._job_gauges = [self.validation_loss, self.validation_accuracy,
                            self.train_loss, self.parallelism,
                            self.epoch_duration, self.dropped_workers,
                            self.quarantined_workers, self.restarts,
                            self.reassigned_batches, self.checkpoint_drops,
                            self.heartbeat_epoch, self.heartbeat_round,
                            self.loss_spread, self.dataset_generation,
                            self.data_lag_generations]
        self._job_hists = [self.dispatch_seconds, self.data_wait_seconds,
                           self.merge_seconds, self.merge_overlap_seconds]
        self._job_multi = [self.worker_grad_norm, self.worker_update_ratio,
                           self.hbm_bytes]
        self._job_counters = [self.jit_compiles_total,
                              self.trace_dropped_total]

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

    def note_heartbeat(self, job_id: str, epoch: int, rnd: int) -> None:
        self.heartbeat_epoch.set(job_id, epoch)
        self.heartbeat_round.set(job_id, rnd)

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
                    + [self.running_total, self.restarts_total]
                    + self._job_counters + self._job_multi
                    + self._job_hists
                    + [self.infer_cache_entries, self.infer_cache_hits_total,
                       self.infer_cache_misses_total, self.cost_flops_total,
                       self.cost_hbm_bytes_total,
                       self.cost_dispatches_total])
        return "\n".join(f.collect() for f in families) + "\n"
