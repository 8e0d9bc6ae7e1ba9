"""Parameter Server manager — per-job lifecycle, metrics and the serving
plane (twin of kubeml_tpu/control/ps.py, over the port's TrainJob and
ServeFleet).

Parity with ml/pkg/ps/ (parameter_server.go, api.go): tracks a job index,
starts jobs, relays scheduler updates, receives metric updates and finish
signals, exports Prometheus gauges, serves the task list.

REST surface (ml/pkg/ps/api.go:335-345):
    POST   /start             start a task (body: TrainTask)
    POST   /update/{jobId}    apply a new parallelism for the next epoch
    POST   /metrics/{jobId}   metric update push (body: MetricUpdate)
    POST   /heartbeat/{jobId} a standalone job's (epoch, round) cursor,
                              watched by the liveness reaper
    POST   /preempted/{jobId} a standalone job drained and checkpointed at
                              its round cursor: reschedule it
    POST   /finish/{jobId}    job finished notification
    DELETE /stop/{jobId}      stop a running job
    GET    /tasks             running-task list
    GET    /metrics           Prometheus exposition (job families + HTTP)
    GET    /health?id=        a running job's health verdict
                              (control/health.py over its MetricUpdates;
                              bare /health is the liveness answer)
    GET    /trace?id=         the job's merged Chrome trace (every
                              process's TraceSink file, merge_job_trace)
    POST   /infer             inference on a checkpointed model, through a
                              saved_at-keyed LRU of loaded modules and the
                              micro-batcher
    POST   /generate          streaming generation from a checkpointed GPT
                              through the model's serving fleet
                              (serve/fleet.py): ndjson {"token": id} lines,
                              then {"done": ...}; 429/503 + Retry-After
    GET    /flight?id=        the serving engines' flight records
                              (serve:<model> or <model>)
    POST   /cluster           the scheduler's allocator snapshot: the
                              cluster Prometheus families and the
                              ``cluster`` health pseudo job
    POST   /preempt/{jobId}   allocator preemption: a standalone training
                              child gets SIGTERM (drain, cursor,
                              /preempted) and its task goes back to the
                              scheduler's /requeue; a serve:<model> gang's
                              fleet drains to zero

Job execution has the reference's two modes (STANDALONE_JOBS env,
ml/cmd/ml/main.go:115-133):

  - threaded (default): the job runs on a thread of this process, on the
    PS's device — its CUDA work stays on that thread;
  - standalone: one child process per job running
    ``python -m kubeml_tpu_torch.train.jobserver``, spoken to over the
    per-job REST surface (creation + readiness wait + retried /start,
    ml/pkg/ps/job_pod.go:18-62). The parent never touches CUDA: the
    device is resolved lazily, by a threaded job or an /infer, so in
    standalone mode the card belongs to the children (``job_partitions``
    pins each to its cards through CUDA_VISIBLE_DEVICES). A child that
    dies without finishing restarts from its own checkpoint up to
    ``options.max_restarts`` times. A child that announced a preemption
    (/preempted) is respawned from its round cursor without spending that
    budget, or, after an allocator /preempt in cluster mode, handed back
    to the scheduler's queue (POST /requeue). The liveness reaper kills a
    running child whose last heartbeat is older than
    KUBEML_HEARTBEAT_INTERVAL x KUBEML_HEARTBEAT_MISS_BUDGET seconds (0
    turns it off), once per silence, into that same restart path.

``device`` is the port's device argument: None means CUDA (raising
without a card when first used), "cpu" runs the jobs and the children
there.

The health evaluator is fed from every MetricUpdate (pushed by a job
process, or published in-process by a threaded job) and clears a job's
window when the job finishes, so a finished job reads ``unknown``. A
threaded job writes ``$KUBEML_TPU_HOME/logs/<job>.log``; the PS's own
``ps.start_task`` span goes to ``TraceSink(job, "ps")``.

Serving: the first /generate of a model builds its fleet of replicas,
each a ServeService over a DecodeEngine on the PS's device; a checkpoint
saved later (a newer ``saved_at``) is installed into every live replica
as a new weight generation, with no stream dropped. The fleet's merged
snapshot feeds ``/health?id=serve:<model>`` and the serve families of
/metrics; each replica and the router write their spans under the
``serve:<model>`` trace. The ``serve_*`` knobs (constructor or
``KUBEML_SERVE_*``) have the JAX package's defaults;
``serve_decode_steps`` > 1 turns on the multi-step decode program and
``serve_draft_model`` (a checkpoint id) speculative decode with that
model as the draft.

Durable control plane (``state_dir``): the standalone-job registry and
the fleets (checkpoint stamp, replica count) are mirrored to
``ps.jobs.json`` and ``ps.fleets.json``; ``recover()`` re-adopts the
children that survived a restart (probed on their /health, watched by
pid), drops the dead ones for the scheduler's sweep to requeue, and
rebuilds each fleet at its recorded width. A re-grant's fencing epoch
reaches a child through /update/{jobId}.

Cost (``GET /cost?id=``): a training job's latest cost-ledger snapshot,
stashed from every MetricUpdate (POST /metrics from a job-server child,
or a threaded job's publish), or a serving model's (``serve:<model>``)
read live from its fleet's merged snapshot; each with its per-plane
attribution (metrics/ledger.py).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.api.const import kubeml_home
from kubeml_tpu_torch.api.errors import (InvalidArgsError, JobNotFoundError,
                                         KubeMLException)
from kubeml_tpu_torch.api.types import MetricUpdate, TrainTask
from kubeml_tpu_torch.control.health import HealthEvaluator
from kubeml_tpu_torch.control.httpd import (JsonService, Raw, Request,
                                            Stream, http_json)
from kubeml_tpu_torch.control.journal import atomic_write_json, read_json
from kubeml_tpu_torch.data.registry import DatasetRegistry
from kubeml_tpu_torch.metrics.ledger import attributed_from_snapshot
from kubeml_tpu_torch.metrics.prom import MetricsRegistry
from kubeml_tpu_torch.models.base import InferenceInputError, KubeDataset
from kubeml_tpu_torch.parallel.distributed import CLUSTER_ENV_VARS
from kubeml_tpu_torch.train.checkpoint import (checkpoint_saved_at,
                                               load_checkpoint)
from kubeml_tpu_torch.train.functionlib import FunctionRegistry
from kubeml_tpu_torch.train.history import HistoryStore
from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob
from kubeml_tpu_torch.utils.trace import (TRACE_HEADER, TraceSink, Tracer,
                                          get_trace_context, make_trace_id,
                                          merge_job_trace)

logger = logging.getLogger("kubeml_tpu_torch.ps")

def _knob(value, env: str, default: str):
    """A serve knob: the argument, else its KUBEML_SERVE_* variable, else
    the JAX package's default."""
    return value if value is not None else os.environ.get(env, default)


def check_partitions(partitions: Optional[List[Dict[str, str]]],
                     device: DeviceLike) -> None:
    """Refuse device partitions that name cards this machine does not
    have: each is an env dict whose CUDA_VISIBLE_DEVICES lists card
    indices below the card count (none on a CPU deployment)."""
    if partitions is None:
        return
    cards = 0 if device is not None and torch.device(device).type != "cuda" \
        else torch.cuda.device_count()
    for env in partitions:
        if not isinstance(env, dict):
            raise ValueError(f"a job partition is an env dict, got {env!r}")
        named = [c.strip() for c in
                 str(env.get("CUDA_VISIBLE_DEVICES", "")).split(",")
                 if c.strip()]
        for c in named:
            if not c.isdigit() or int(c) >= cards:
                raise ValueError(
                    f"job partition {env!r} names card {c!r}, but this "
                    f"deployment has {cards} card(s) (indices 0..{cards - 1})")


class _InferSlot:
    __slots__ = ("arr", "event", "result", "error")

    def __init__(self, arr):
        self.arr = arr
        self.event = threading.Event()
        self.result = None
        self.error = None


class InferBatcher:
    """Micro-batches concurrent /infer requests into one device call.

    Serving depth the reference never had (its /infer is a single-shot
    function invocation — scheduler/api.go:119-162): a single-request
    stream leaves the device idle between tiny calls, so requests that
    arrive within `window_s` for the same
    (model, sample-shape) group are stacked along the batch dim and
    served by ONE model.infer call, then scattered back — the classic
    leader/follower micro-batcher. The leader pays the window (a few
    ms — small against any model call) of extra latency; followers
    ride free. Stacked batches pad to the next power of two (repeating
    the last row), as the JAX package's do for its jitted inference, so
    a model sees a handful of batch shapes. Oversized
    collections are served in max_batch chunks by the same leader.

    Disable with KUBEML_INFER_BATCH=0 (requests then run unbatched)."""

    def __init__(self, window_s: float = 0.003, max_batch: int = 64,
                 timeout_s: float = 60.0):
        self.window_s = window_s
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._groups: Dict[tuple, list] = {}
        self._last_arrival: Dict[tuple, float] = {}
        self._next_evict = 0.0

    def _evict_stale(self, now: float) -> None:
        """Drop `_last_arrival` entries idle past the dense-traffic
        horizon (call with `_lock` held). The detector only reads back
        8 windows, so anything older is dead weight — without eviction
        a long-lived PS serving many (model, shape) groups grows this
        dict one entry per key it ever saw, forever. Amortized: one
        sweep per ~4 horizons, not per request."""
        horizon = 8 * self.window_s
        if now < self._next_evict:
            return
        self._next_evict = now + 4 * horizon
        cutoff = now - horizon
        for key in [k for k, t in self._last_arrival.items()
                    if t < cutoff]:
            del self._last_arrival[key]

    @staticmethod
    def enabled() -> bool:
        return os.environ.get("KUBEML_INFER_BATCH", "").lower() not in (
            "0", "false", "no")

    def submit(self, key: tuple, arr, run):
        """run(stacked_batch) -> stacked predictions; returns this
        request's slice. Exceptions from the batched call propagate to
        every member."""
        slot = _InferSlot(arr)
        now = time.monotonic()
        with self._lock:
            grp = self._groups.get(key)
            leader = grp is None
            if leader:
                grp = self._groups[key] = []
            grp.append(slot)
            # dense-traffic detector: a leader only pays the collection
            # window when another request for this key arrived recently
            # (within 8 windows); sparse/single-stream traffic serves
            # immediately — no latency tax when there is nothing to
            # batch with
            dense = (now - self._last_arrival.get(key, 0.0)
                     < 8 * self.window_s)
            self._last_arrival[key] = now
            self._evict_stale(now)
        if not leader:
            # follower: the leader serves us (bounded wait: a crashed
            # leader must not hang the request forever)
            if not slot.event.wait(timeout=self.timeout_s):
                # CANCEL before giving up: our row must leave the
                # pending bucket, or a later flush of this key would
                # scatter a result into a slot nobody is waiting on
                # (and mis-align every row after ours). The group may
                # already be gone (leader popped it and is about to set
                # our event) — then removal no-ops and the result is
                # simply dropped.
                with self._lock:
                    grp = self._groups.get(key)
                    if grp is not None and slot in grp:
                        grp.remove(slot)
                        if not grp:
                            del self._groups[key]
                raise KubeMLException("batched inference timed out", 500)
            if slot.error is not None:
                raise slot.error
            return slot.result
        if dense:
            time.sleep(self.window_s)  # collection window
        with self._lock:
            collected = self._groups.pop(key)
        for i in range(0, len(collected), self.max_batch):
            batch = collected[i:i + self.max_batch]
            try:
                lens = [len(s.arr) for s in batch]
                stacked = (batch[0].arr if len(batch) == 1
                           else np.concatenate([s.arr for s in batch]))
                total = len(stacked)
                padded = 1 << (total - 1).bit_length()  # next pow2 bucket
                if padded > total:
                    stacked = np.concatenate(
                        [stacked, np.repeat(stacked[-1:], padded - total,
                                            axis=0)])
                preds = np.asarray(run(stacked))[:total]
                off = 0
                for s, n in zip(batch, lens):
                    s.result = preds[off:off + n]
                    off += n
                for s in batch:
                    s.event.set()
            except BaseException as e:
                # later chunks still get served — a bad first chunk
                # must not strand their followers in the 60 s wait
                for s in batch:
                    s.error = e
                    s.event.set()
        own = collected[0]
        if own.error is not None:
            raise own.error
        return own.result


class _JobRecord:
    """A running job: a thread of this process (job + thread set) or a
    standalone child process (proc + url set)."""

    def __init__(self, task: TrainTask, job: Optional[TrainJob] = None,
                 thread: Optional[threading.Thread] = None,
                 proc: Optional[subprocess.Popen] = None,
                 url: Optional[str] = None):
        self.task = task
        self.job = job
        self.thread = thread
        self.proc = proc
        self.url = url
        self.partition: Optional[int] = None  # device-partition slot
        self.next_parallelism: Optional[int] = None
        self.update_event = threading.Event()
        # lifecycle counters seed from the task, so a requeued task
        # re-/start-ed as a new record carries them forward
        self.restarts = task.restarts  # crash restarts consumed
        self.restarting = False  # watchdog respawn claimed, in progress
        self.preempted = False   # the child announced a preemption
        # reschedules after a preemption: the platform's doing, so they
        # never spend the max_restarts crash budget
        self.preemptions = task.preemptions
        # allocator preemption: on exit, hand the task back to the
        # scheduler's queue instead of respawning in place
        self.requeue_on_exit = False
        self.last_heartbeat: Optional[float] = None  # monotonic stamp
        self.heartbeat_progress = (0, 0)  # (epoch, round) last reported
        # pid of a child RE-ADOPTED from a previous PS incarnation: there
        # is no Popen handle to wait() on, so its watchdog polls the pid
        self.adopted_pid: Optional[int] = None

    def push_update(self, parallelism: int,
                    grant_epoch: Optional[int] = None):
        # standalone-ness is `job is None`: a crash-restarting record has
        # url transiently None and must answer the 503 retry signal
        if self.job is None and self.url is None:
            raise KubeMLException(
                f"job {self.task.job_id} still starting", 503)
        if grant_epoch is not None:
            # a recovered scheduler re-fenced the grant: the child must
            # present the NEW epoch on its next /job ask or be 409'd
            self.task.grant_epoch = int(grant_epoch)
        if self.url is not None:
            body = {"parallelism": parallelism}
            if grant_epoch is not None:
                body["grant_epoch"] = int(grant_epoch)
            http_json("POST", f"{self.url}/update", body)
        else:
            self.next_parallelism = parallelism
            self.update_event.set()

    def request_stop(self):
        if self.url is not None:
            http_json("DELETE", f"{self.url}/stop")
        elif self.job is not None:
            self.job.stop()
        else:
            raise KubeMLException(
                f"job {self.task.job_id} still starting", 503)


class ParameterServer(JsonService):
    name = "ps"

    def __init__(self, device: DeviceLike = None, port: int = 0,
                 scheduler_url: Optional[str] = None,
                 standalone_jobs: Optional[bool] = None,
                 job_partitions: Optional[List[Dict[str, str]]] = None,
                 infer_cache_size: Optional[int] = None,
                 serve_slots: Optional[int] = None,
                 serve_queue_depth: Optional[int] = None,
                 serve_page_tokens: Optional[int] = None,
                 serve_hbm_budget_mb: Optional[float] = None,
                 serve_prefill_chunk: Optional[int] = None,
                 serve_kv_dtype: Optional[str] = None,
                 serve_decode_steps: Optional[int] = None,
                 serve_draft_model: Optional[str] = None,
                 serve_prefix_cache: Optional[bool] = None,
                 serve_drain_grace_s: Optional[float] = None,
                 serve_replicas_min: Optional[int] = None,
                 serve_replicas_max: Optional[int] = None,
                 serve_scale_to_zero_s: Optional[float] = None,
                 serve_replica_restart_budget: Optional[int] = None,
                 serve_probe_requests: Optional[int] = None,
                 serve_hedge_after_s: Optional[float] = None,
                 serve_slo_ttft_ms: Optional[float] = None,
                 serve_slo_tpot_ms: Optional[float] = None,
                 serve_slo_target: Optional[float] = None,
                 state_dir: Optional[str] = None, n_lanes: int = 1):
        super().__init__(port=port)
        # resolved at first use (a threaded job or an /infer): in
        # standalone mode the parent leaves the card to its children
        self._device_arg = device
        self._device: Optional[torch.device] = None
        # data lanes of every job (``kubeml serve --mesh-data``)
        self.n_lanes = int(n_lanes)
        self.scheduler_url = scheduler_url
        if standalone_jobs is None:  # reference env toggle, main.go:115-133
            standalone_jobs = os.environ.get(
                "STANDALONE_JOBS", "").lower() in ("1", "true", "yes")
        self.standalone_jobs = standalone_jobs
        # device-partition slots for concurrent standalone jobs: a
        # starting job leases the first free env dict and holds it until
        # its process exits; with every slot busy, /start answers 503
        # (the scheduler's queue keeps the task). None = no partitioning
        check_partitions(job_partitions, device)
        self.job_partitions = job_partitions
        self._busy_partitions: set = set()
        self.jobs: Dict[str, _JobRecord] = {}
        # jobs deregistered whose per-job series and health are still
        # being cleared: wait_for_job waits them out
        self._finishing: set = set()
        # the error each failed job finished with, by job id
        self.errors: Dict[str, str] = {}
        self._jobs_lock = threading.RLock()
        self._stopping = False  # set by stop(); gates spawns/restarts
        self._infer_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._infer_cache_lock = threading.Lock()
        self.infer_cache_size = max(1, int(
            infer_cache_size if infer_cache_size is not None
            else os.environ.get("KUBEML_INFER_CACHE_SIZE", "4")))
        self._infer_batcher = InferBatcher() if InferBatcher.enabled() \
            else None
        # the checkpoint LRU yields to the serving fleets: cached modules
        # and the fleets' KV slabs share device memory
        self.serve_hbm_budget_bytes = int(float(_knob(
            serve_hbm_budget_mb, "KUBEML_SERVE_HBM_BUDGET_MB", "512"))
            * (1 << 20))
        self._init_serve_knobs(
            serve_slots, serve_queue_depth, serve_page_tokens,
            serve_prefill_chunk, serve_kv_dtype, serve_decode_steps,
            serve_draft_model, serve_prefix_cache, serve_drain_grace_s,
            serve_replicas_min, serve_replicas_max, serve_scale_to_zero_s,
            serve_replica_restart_budget, serve_probe_requests,
            serve_hedge_after_s, serve_slo_ttft_ms, serve_slo_tpot_ms,
            serve_slo_target)
        self._serve: Dict[str, tuple] = {}   # model_id -> (stamp, fleet)
        # latest cost-ledger snapshot per training job (pushed
        # cumulatively with every MetricUpdate; a serving model's cost is
        # read live from its fleet). Whole-value assignment per job id,
        # reads tolerate staleness
        self._cost: Dict[str, dict] = {}
        self._serve_lock = threading.Lock()
        # durable control plane (opt-in): standalone-job and fleet
        # manifests mirrored under state_dir so recover() can re-adopt
        # surviving children and rebuild serving fleets after a crash
        self.state_dir = state_dir
        self._jobs_manifest_path = (
            os.path.join(state_dir, "ps.jobs.json") if state_dir else None)
        self._fleet_manifest_path = (
            os.path.join(state_dir, "ps.fleets.json") if state_dir
            else None)
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
        # one writer at a time per manifest: atomic_write_json stages
        # through a fixed <name>.tmp, which two writers would share
        self._manifest_lock = threading.Lock()
        self.recoveries = 0
        self.last_recovery_s: Optional[float] = None
        self.metrics = MetricsRegistry()
        # training-health verdicts over rolling MetricUpdate windows
        # (control/health.py); served on GET /health?id=
        self.health = HealthEvaluator()
        # job threads publish while handler threads read verdicts; the
        # evaluator's per-job windows are read-modify-write
        self._health_lock = threading.Lock()
        self.fn_registry = FunctionRegistry()
        self.ds_registry = DatasetRegistry()
        self.history_store = HistoryStore()

        self.route("POST", "/start", self._h_start)
        self.route("POST", "/update/{jobId}", self._h_update)
        self.route("POST", "/metrics/{jobId}", self._h_metrics)
        self.route("POST", "/heartbeat/{jobId}", self._h_heartbeat)
        self.route("POST", "/finish/{jobId}", self._h_finish)
        self.route("DELETE", "/stop/{jobId}", self._h_stop)
        self.route("GET", "/tasks", self._h_tasks)
        self.route("GET", "/metrics", self._h_prom)
        self.route("GET", "/health", self._h_health)
        self.route("GET", "/trace", self._h_trace)
        self.route("POST", "/infer", self._h_infer)
        self.route("POST", "/generate", self._h_generate)
        self.route("GET", "/flight", self._h_flight)
        self.route("POST", "/cluster", self._h_cluster)
        self.route("POST", "/preempt/{jobId}", self._h_preempt)
        self.route("POST", "/preempted/{jobId}", self._h_preempted)
        self.route("GET", "/cost", self._h_cost)
        # the liveness reaper: a standalone child silent for interval x
        # miss budget seconds is declared wedged and killed into the
        # checkpoint restart; 0 turns it off
        self.heartbeat_timeout = (
            float(os.environ.get("KUBEML_HEARTBEAT_INTERVAL", "10"))
            * float(os.environ.get("KUBEML_HEARTBEAT_MISS_BUDGET", "6")))
        self._reaper_stop = threading.Event()
        self._reaper_thread: Optional[threading.Thread] = None

    def start(self) -> int:
        port = super().start()
        if self.standalone_jobs and self.heartbeat_timeout > 0:
            self._reaper_thread = threading.Thread(
                target=self._reaper_loop, name="heartbeat-reaper",
                daemon=True)
            self._reaper_thread.start()
        return port

    # ------------------------------------------------------ liveness reaper

    def _reaper_loop(self):
        period = max(1.0, self.heartbeat_timeout / 4)
        while not self._reaper_stop.wait(timeout=period):
            try:
                self._scan_heartbeats(time.monotonic())
            except Exception:  # noqa: BLE001 — the sweep never dies
                logger.exception("heartbeat sweep failed")

    def _scan_heartbeats(self, now: float) -> List[str]:
        """One liveness sweep at ``now`` (a pure function of it, for the
        tests): kill the standalone children whose last heartbeat is
        older than the miss budget. The watchdog then sees the exit and
        restarts the job from its checkpoint. A child that never beat is
        never reaped (liveness starts at its first beat), and a silence
        is reaped once."""
        if self.heartbeat_timeout <= 0:
            return []
        reaped: List[str] = []
        with self._jobs_lock:
            stale = []
            for job_id, rec in self.jobs.items():
                if (rec.proc is None or rec.last_heartbeat is None
                        or rec.task.state == "stopping"):
                    continue
                age = now - rec.last_heartbeat
                if age >= self.heartbeat_timeout:
                    rec.last_heartbeat = None  # one kill per silence
                    stale.append((job_id, rec, age))
        for job_id, rec, age in stale:
            logger.error(
                "job %s: no heartbeat for %.0fs (budget %.0fs) at "
                "epoch %d round %d — declaring wedged; killing pid %s "
                "for checkpoint restart", job_id, age,
                self.heartbeat_timeout, rec.heartbeat_progress[0],
                rec.heartbeat_progress[1],
                rec.proc.pid if rec.proc else "?")
            self.metrics.note_wedged(job_id)
            try:
                rec.proc.kill()
            except OSError:
                pass
            reaped.append(job_id)
        return reaped

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    # ------------------------------------------------------------- handlers

    def _h_start(self, req: Request):
        task = TrainTask.from_dict(req.body)
        # adopt the propagated trace id (header context when the task
        # predates the trace_id field)
        if not task.trace_id:
            task.trace_id = get_trace_context() or make_trace_id()
        # the PS's own mark on the job's timeline: one span covering the
        # launch, flushed to the job's trace directory
        tracer = Tracer(trace_id=task.trace_id)
        with tracer.span("ps.start_task", job_id=task.job_id,
                         mode="standalone" if self.standalone_jobs
                         else "threaded"):
            self.start_task(task)
        try:
            TraceSink(task.job_id, "ps").write(tracer)
        except OSError:
            logger.exception("ps: trace flush failed for %s", task.job_id)
        return {"job_id": task.job_id}

    def _h_update(self, req: Request):
        job_id = req.params["jobId"]
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
        if rec is None:
            raise JobNotFoundError(job_id)
        epoch = req.body.get("grant_epoch") \
            if isinstance(req.body, dict) else None
        rec.push_update(int(req.body["parallelism"]),
                        grant_epoch=None if epoch is None else int(epoch))
        return {"ok": True}

    def _h_metrics(self, req: Request):
        m = MetricUpdate.from_dict(req.body)
        self.metrics.update_job(m)
        if m.cost_programs:
            self._cost[m.job_id] = m.cost_programs
        self._observe_health(m)
        return {"ok": True}

    def _observe_health(self, m) -> None:
        """Feed one update through the health rules: bump the alert
        counter once per rule onset (the evaluator dedupes against the
        already-active rules) and publish the verdict gauge. Takes a
        MetricUpdate (a training epoch) or a snapshot dict (a serving
        fleet's serve:<model> sample); a serve rule's onset dumps the
        model's flight recorders into its trace."""
        job_id = m["job_id"] if isinstance(m, dict) else m.job_id
        with self._health_lock:
            fired = self.health.observe(m)
            state = self.health.verdict(job_id)["state"]
        for reason in fired:
            self.metrics.note_health_alert(job_id, reason["rule"])
            logger.warning("job %s health alert [%s/%s]: %s", job_id,
                           reason["severity"], reason["rule"],
                           reason["detail"])
            if job_id.startswith("serve:"):
                self._serve_flight_snapshot(job_id[len("serve:"):],
                                            reason["rule"])
        self.metrics.set_health(job_id, state)

    def _serve_flight_snapshot(self, model_id: str, rule: str) -> None:
        """Snapshot the model's flight recorders into its serve trace on
        a health-rule onset. Reads the registry WITHOUT _serve_lock: this
        runs on a serving loop thread that may hold its replica's
        condition variable, which _serve_service's install_weights takes
        under _serve_lock. A stale read only snapshots nothing."""
        cur = self._serve.get(model_id)
        if cur is None:
            return
        try:
            cur[1].flight_snapshot(f"health:{rule}")
        except Exception:  # noqa: BLE001 — telemetry never fails serving
            logger.exception("flight snapshot failed for serve:%s",
                             model_id)

    def _h_heartbeat(self, req: Request):
        """Progress cursor (epoch, round) of a standalone child: the
        heartbeat gauges and the liveness reaper's clock."""
        job_id = req.params["jobId"]
        body = req.body if isinstance(req.body, dict) else {}
        progress = (int(body.get("epoch", 0)), int(body.get("round", 0)))
        # under the lock: a beat racing the job's finish must not set the
        # gauges again after _finish has popped the record and clears them
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                raise JobNotFoundError(job_id)
            rec.last_heartbeat = time.monotonic()
            rec.heartbeat_progress = progress
            self.metrics.note_heartbeat(job_id, *progress)
        return {"ok": True}

    def _h_health(self, req: Request):
        """Bare GET /health keeps the liveness contract every service
        answers; ?id=<jobId> serves that job's training-health verdict
        (state, machine-readable reasons, the latest epoch's stats)."""
        job_id = req.query.get("id", "")
        if not job_id:
            return {"ok": True}
        with self._health_lock:
            return self.health.verdict(job_id)

    def _h_finish(self, req: Request):
        self._finish(req.params["jobId"], req.body.get("error")
                     if isinstance(req.body, dict) else None)
        return {"ok": True}

    def _h_stop(self, req: Request):
        job_id = req.params["jobId"]
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
        if rec is None:
            raise JobNotFoundError(job_id)
        rec.request_stop()
        rec.task.state = "stopping"
        return {"ok": True}

    def _h_preempted(self, req: Request):
        """A standalone child drained, checkpointed at its round cursor
        and is about to exit: mark its record so the watchdog reschedules
        it without spending the crash-restart budget."""
        job_id = req.params["jobId"]
        body = req.body if isinstance(req.body, dict) else {}
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                raise JobNotFoundError(job_id)
            rec.preempted = True
            rec.preemptions += 1
        logger.warning("job %s preempted at epoch %s round %s; will "
                       "reschedule from its round checkpoint", job_id,
                       body.get("epoch"), body.get("round"))
        self.metrics.note_preemption(job_id)
        return {"ok": True}

    def _h_preempt(self, req: Request):
        """Cluster-allocator preemption (control/cluster.py). A training
        victim's standalone child gets SIGTERM: it drains the round in
        flight, checkpoints at the round cursor, posts /preempted and
        exits, and the watchdog hands its task back to the scheduler's
        queue (requeue_on_exit) so the freed lanes go to the arrival; no
        restart budget is spent. A threaded job has no process of its own
        to signal: 503. A ``serve:<model>`` victim is the second gang
        kind: its fleet drains to zero (in-flight streams get the grace
        budget, then the replicas stop) and the model cold-starts again
        on its next request."""
        job_id = req.params["jobId"]
        if job_id.startswith("serve:"):
            model_id = job_id[len("serve:"):]
            with self._serve_lock:
                cur = self._serve.get(model_id)
            if cur is None:
                raise JobNotFoundError(job_id)
            logger.warning("serving fleet %s: allocator preemption — "
                           "draining to zero", model_id)
            cur[1].scale_to_zero("allocator preemption")
            self._persist_fleets()
            return {"ok": True}
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
            if rec is None:
                raise JobNotFoundError(job_id)
            if rec.proc is None and rec.adopted_pid is None:
                raise KubeMLException(
                    f"job {job_id} is not a standalone child; "
                    "allocator preemption requires standalone job mode",
                    503)
            rec.requeue_on_exit = True
            proc, pid = rec.proc, rec.adopted_pid
        logger.warning("job %s: allocator preemption — sending SIGTERM "
                       "for drain + checkpoint + requeue", job_id)
        if proc is not None:
            proc.terminate()
        else:
            # a re-adopted child has no Popen handle: signal its pid
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        return {"ok": True}

    def _h_cluster(self, req: Request):
        """Cluster-allocator telemetry push from the scheduler: the
        snapshot lands on the Prometheus cluster families and rides the
        health pipeline under the `cluster` pseudo job id, so the
        queue-starvation rule and `kubeml top --id cluster` see it via
        GET /health?id=cluster."""
        snap = req.body if isinstance(req.body, dict) else {}
        if not snap.get("job_id"):
            raise InvalidArgsError("cluster snapshot requires job_id")
        self.metrics.update_cluster(snap)
        self._observe_health(snap)
        return {"ok": True}

    def _h_tasks(self, req: Request):
        with self._jobs_lock:
            out = []
            for r in self.jobs.values():
                # each child incarnation knows only its own lifetime
                r.task.restarts = r.restarts
                r.task.preemptions = r.preemptions
                out.append(r.task.to_dict())
            return out

    def _h_prom(self, req: Request):
        # job families plus this service's HTTP series, one scrape target
        text = self.metrics.exposition() + self.http_metrics.exposition()
        return Raw(text.encode(), "text/plain; version=0.0.4")

    def _h_trace(self, req: Request):
        """Merged Chrome trace of a job (?id=<jobId>): every process's
        TraceSink file plus any torch_profile capture, one Perfetto-
        loadable document."""
        job_id = req.query.get("id", "")
        if not job_id:
            raise InvalidArgsError("id query parameter required")
        if job_id.startswith("serve:"):
            # live serving tracers batch their flushes: push the tail out
            # so the merge sees every finished request
            with self._serve_lock:
                cur = self._serve.get(job_id[len("serve:"):])
            if cur is not None:
                cur[1].flush_trace()
        try:
            return merge_job_trace(job_id)
        except FileNotFoundError:
            raise JobNotFoundError(f"{job_id} (no trace recorded)")

    def _h_cost(self, req: Request):
        """Per-program analytic cost of a job (?id=<jobId>) or a serving
        model (?id=serve:<model>): the ledger snapshot (flat per-program
        record + attributed totals) and its per-plane attribution
        (flops/bytes per sample and per token). A training job serves its
        latest MetricUpdate's snapshot; a serving model its fleet's live
        merged snapshot."""
        job_id = req.query.get("id", "")
        if not job_id:
            raise InvalidArgsError("id query parameter required")
        if job_id.startswith("serve:"):
            with self._serve_lock:
                cur = self._serve.get(job_id[len("serve:"):])
            if cur is None:
                raise JobNotFoundError(
                    f"{job_id} (no serving service running)")
            programs = cur[1].snapshot().get("serve_cost_programs") or {}
        else:
            programs = self._cost.get(job_id)
            if programs is None:
                raise JobNotFoundError(f"{job_id} (no cost recorded)")
        return {"id": job_id, "programs": programs,
                "attributed": attributed_from_snapshot(programs)}

    def _h_infer(self, req: Request):
        model_id = req.body.get("model_id")
        if not model_id:
            raise InvalidArgsError("model_id required")
        data = req.body.get("data")
        if data is None:
            raise InvalidArgsError("data required")
        try:
            arr = np.asarray(data)
        except ValueError as e:  # ragged/inhomogeneous client payload
            raise InvalidArgsError(f"malformed inference payload: {e}") \
                from e
        model, module = self._load_for_infer(model_id)
        try:
            if self._infer_batcher is not None and arr.ndim >= 1 \
                    and len(arr) > 0:
                # concurrent requests for the same (model, sample shape)
                # stack into one device call, served by the leader's
                # module
                key = (model_id, arr.shape[1:], str(arr.dtype))
                preds = self._infer_batcher.submit(
                    key, arr, lambda stacked: model.infer(module, stacked))
            else:
                preds = model.infer(module, arr)
        except InferenceInputError as e:
            # model input rejections are client errors (4xx); anything
            # else stays on the 500 path
            raise InvalidArgsError(str(e)) from e
        return {"predictions": np.asarray(preds).tolist()}

    def _load_for_infer(self, model_id: str):
        """(model, module) for a checkpoint, through a small LRU keyed on
        the manifest's saved_at stamp, so repeated inference does not
        re-read the weights and a newer checkpoint of the same job
        replaces the cached module."""
        saved_at = checkpoint_saved_at(model_id)
        if saved_at is not None:  # unreadable manifests never hit the cache
            with self._infer_cache_lock:
                hit = self._infer_cache.get(model_id)
                if hit is not None and hit[0] == saved_at:
                    self._infer_cache.move_to_end(model_id)
                    self.metrics.note_infer_cache(True)
                    return hit[1], hit[2]
        self.metrics.note_infer_cache(False)
        variables, manifest = load_checkpoint(model_id)
        model_cls, _ = self.fn_registry.resolve(
            manifest.get("function") or manifest.get("model"))
        model = model_cls()
        module = model.module_from_flax(variables, device=self.device)
        module.eval()
        # key on the LOADED manifest's stamp so (stamp, weights) stay
        # consistent even if a save raced the probe above
        key = manifest.get("saved_at")
        if key is not None:
            with self._infer_cache_lock:
                self._infer_cache[model_id] = (key, model, module)
                self._infer_cache.move_to_end(model_id)
                self._evict_infer_cache_locked()
                self.metrics.set_infer_cache_entries(
                    len(self._infer_cache))
        return model, module

    @staticmethod
    def _module_nbytes(module) -> int:
        return sum(t.numel() * t.element_size()
                   for t in module.state_dict().values())

    def _evict_infer_cache_locked(self) -> None:
        """LRU eviction under two pressures (cache lock held): the entry
        cap, and the serving device budget — cached modules and the live
        fleets' KV slabs share device memory, so cached entries yield
        until the total fits. The freshest entry always
        survives (its request is about to use it)."""
        while len(self._infer_cache) > self.infer_cache_size:
            self._infer_cache.popitem(last=False)
        budget = self.serve_hbm_budget_bytes - self._serve_hbm_bytes()
        while len(self._infer_cache) > 1 \
                and sum(self._module_nbytes(e[2])
                        for e in self._infer_cache.values()) > budget:
            self._infer_cache.popitem(last=False)

    def _serve_hbm_bytes(self) -> int:
        with self._serve_lock:
            fleets = [fleet for _, fleet in self._serve.values()]
        return sum(fleet.hbm_bytes for fleet in fleets)

    # -------------------------------------------------------- serving plane

    def _init_serve_knobs(self, slots, queue_depth, page_tokens,
                          prefill_chunk, kv_dtype, decode_steps,
                          draft_model, prefix_cache, drain_grace_s,
                          replicas_min, replicas_max, scale_to_zero_s,
                          restart_budget, probe_requests, hedge_after_s,
                          slo_ttft_ms, slo_tpot_ms, slo_target) -> None:
        """The serving plane's knobs, each from its argument, its
        KUBEML_SERVE_* variable or the JAX package's default: K fused
        decode steps per dispatch (1 = single step) and an optional draft
        model id that turns on speculative decode."""
        self.serve_slots = int(_knob(slots, "KUBEML_SERVE_SLOTS", "8"))
        self.serve_queue_depth = int(_knob(queue_depth, "KUBEML_SERVE_QUEUE",
                                           "16"))
        self.serve_page_tokens = int(_knob(
            page_tokens, "KUBEML_SERVE_PAGE_TOKENS", "16"))
        self.serve_prefill_chunk = int(_knob(
            prefill_chunk, "KUBEML_SERVE_PREFILL_CHUNK", "16"))
        self.serve_kv_dtype = str(_knob(kv_dtype, "KUBEML_SERVE_KV_DTYPE",
                                        "f32"))
        self.serve_decode_steps = int(_knob(
            decode_steps, "KUBEML_SERVE_DECODE_STEPS", "1"))
        self.serve_draft_model = str(_knob(
            draft_model, "KUBEML_SERVE_DRAFT_MODEL", ""))
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "KUBEML_SERVE_PREFIX_CACHE", "on").lower() \
                not in ("0", "off", "false", "no")
        self.serve_prefix_cache = bool(prefix_cache)
        # stop()'s drain budget: 0 = hard stop
        self.serve_drain_grace_s = float(_knob(
            drain_grace_s, "KUBEML_SERVE_DRAIN_GRACE_S", "0"))
        self.serve_replicas_min = int(_knob(
            replicas_min, "KUBEML_SERVE_REPLICAS_MIN", "1"))
        self.serve_replicas_max = int(_knob(
            replicas_max, "KUBEML_SERVE_REPLICAS_MAX", "1"))
        self.serve_scale_to_zero_s = float(_knob(
            scale_to_zero_s, "KUBEML_SERVE_SCALE_TO_ZERO_S", "0"))
        self.serve_replica_restart_budget = int(_knob(
            restart_budget, "KUBEML_SERVE_REPLICA_RESTART_BUDGET", "2"))
        self.serve_probe_requests = int(_knob(
            probe_requests, "KUBEML_SERVE_PROBE_REQUESTS", "2"))
        self.serve_hedge_after_s = float(_knob(
            hedge_after_s, "KUBEML_SERVE_HEDGE_AFTER_S", "0"))
        self.serve_slo_ttft_ms = float(_knob(
            slo_ttft_ms, "KUBEML_SERVE_SLO_TTFT_MS", "0"))
        self.serve_slo_tpot_ms = float(_knob(
            slo_tpot_ms, "KUBEML_SERVE_SLO_TPOT_MS", "0"))
        self.serve_slo_target = float(_knob(
            slo_target, "KUBEML_SERVE_SLO_TARGET", "0.99"))

    def _serve_replica_factory(self, model_id: str):
        """The replica builder of the model's fleet: one call builds one
        UNSTARTED ServeService over a fresh DecodeEngine on the PS's
        device. It reads the checkpoint cache on every call, so a replica
        born after a hot-swap starts on the newest weights."""
        from kubeml_tpu_torch.serve.engine import DecodeEngine
        from kubeml_tpu_torch.serve.pager import PageGeometry
        from kubeml_tpu_torch.serve.service import ServeService

        def factory(index: int) -> ServeService:
            _, module = self._load_for_infer(model_id)
            try:
                draft_module = draft_variables = None
                if self.serve_draft_model:
                    # a broken draft checkpoint or an incompatible draft
                    # trunk is a client error like any bad serve knob
                    _, draft_module = self._load_for_infer(
                        self.serve_draft_model)
                    draft_variables = draft_module.state_dict()
                engine = DecodeEngine(
                    module,
                    geom=PageGeometry.for_module(
                        slots=self.serve_slots, page=self.serve_page_tokens,
                        max_len=module.max_len),
                    prefill_chunk=self.serve_prefill_chunk,
                    kv_dtype=self.serve_kv_dtype,
                    decode_steps=self.serve_decode_steps,
                    draft_module=draft_module,
                    draft_variables=draft_variables,
                    prefix_cache=self.serve_prefix_cache,
                    # production posture: a pager invariant violation is
                    # logged and counted, never raised mid-stream
                    strict_pager=False, device=self.device)
            except (ValueError, TypeError, AttributeError) as e:
                # a model with no paged decode step, or a bad serve knob
                raise InvalidArgsError(
                    f"model {model_id} does not support streaming decode "
                    f"with the configured serve knobs: {e}") from e
            # each replica writes its spans under the serve:<model> trace
            # as its own process, on the service clock
            return ServeService(
                model_id, engine, max_queue=self.serve_queue_depth,
                metrics=self.metrics, tracer=Tracer(clock=time.perf_counter),
                trace_sink=TraceSink(f"serve:{model_id}", f"serve-r{index}"))
        return factory

    def _serve_resize_cb(self, model_id: str):
        """The fleet's bridge to the cluster pool: each resize is offered
        to the scheduler's POST /serve/resize (ClusterAllocator, gang
        kind 'serving'), so replicas and training lanes contend for one
        pool. Fails OPEN: without a scheduler, or when it is unreachable,
        the fleet gets what it asked for."""
        def resize_cb(replicas: int) -> int:
            granted = replicas
            if self.scheduler_url:
                try:
                    resp = http_json(
                        "POST", f"{self.scheduler_url}/serve/resize",
                        {"model_id": model_id, "replicas": int(replicas)})
                    granted = int(resp.get("granted", replicas))
                except KubeMLException as e:
                    logger.info("serve resize offer for %s not granted "
                                "(%s); failing open", model_id, e.message)
            # each offer (grow, shrink, cold start, scale to zero) records
            # the count the fleet runs after it: the grant, except that an
            # offer of one replica (a cold start, or a shrink to one, which
            # is always granted) keeps the fleet's serving floor of one on
            # a zero grant. A disk error is logged, never made a grant.
            try:
                self._persist_fleets(resized=(
                    model_id, max(granted, 1) if replicas == 1
                    else granted))
            except OSError:
                logger.exception("fleet manifest write for %s failed",
                                 model_id)
            return granted
        return resize_cb

    def _serve_service(self, model_id: str):
        """The model's serving fleet. The first request builds it; when
        the checkpoint's saved_at later changes, the new weights are
        installed into every live replica as a new generation (streams in
        flight finish on their weights, new admissions decode the new
        ones, nothing is stopped)."""
        from kubeml_tpu_torch.serve.fleet import ServeFleet
        _, module = self._load_for_infer(model_id)
        stamp = checkpoint_saved_at(model_id)
        with self._serve_lock:
            cur = self._serve.get(model_id)
            if cur is not None:
                if cur[0] != stamp:
                    cur[1].install_weights(module.state_dict(), stamp)
                    self._serve[model_id] = (stamp, cur[1])
                    self._persist_fleets_async()
                return cur[1]
        fleet = ServeFleet(
            model_id, self._serve_replica_factory(model_id),
            replicas_min=self.serve_replicas_min,
            replicas_max=self.serve_replicas_max,
            scale_to_zero_s=self.serve_scale_to_zero_s,
            # an autoscaler retire always gives streams a real budget
            drain_grace_s=self.serve_drain_grace_s or 5.0,
            page_tokens=self.serve_page_tokens,
            metrics=self.metrics,
            health_cb=self._observe_health,
            resize_cb=self._serve_resize_cb(model_id),
            replica_restart_budget=self.serve_replica_restart_budget,
            probe_requests=self.serve_probe_requests,
            hedge_after_s=self.serve_hedge_after_s,
            tracer=Tracer(clock=time.perf_counter),
            trace_sink=TraceSink(f"serve:{model_id}", "fleet"),
            slo_ttft_s=self.serve_slo_ttft_ms / 1000.0,
            slo_tpot_s=self.serve_slo_tpot_ms / 1000.0,
            slo_target=self.serve_slo_target).start()
        old = None
        with self._serve_lock:
            cur = self._serve.get(model_id)
            if cur is not None:   # lost the build race; ours goes
                old, fleet = fleet, cur[1]
            else:
                self._serve[model_id] = (stamp, fleet)
        if old is not None:
            old.stop()
        self._persist_fleets()
        return fleet

    def _h_generate(self, req: Request):
        """Streaming continuous-batching generation. Body: {model_id,
        prompt: [token ids], max_new_tokens, temperature, seed, eos_id,
        deadline_ms, session, stream}. stream=true (default) answers
        ndjson lines as the loop produces them; stream=false answers one
        JSON document. Saturation, or a deadline_ms the backlog makes
        infeasible, answers 429 + Retry-After; a draining fleet 503 +
        Retry-After. Every answer carries the request's trace id header."""
        from kubeml_tpu_torch.serve.slots import ServeDraining, ServeSaturated
        body = req.body if isinstance(req.body, dict) else {}
        model_id = body.get("model_id")
        if not model_id:
            raise InvalidArgsError("model_id required")
        prompt = body.get("prompt")
        if prompt is None:
            raise InvalidArgsError("prompt required (list of token ids)")
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError) as e:
            raise InvalidArgsError(
                f"prompt must be a list of token ids: {e}") from e
        svc = self._serve_service(model_id)
        trace_id = get_trace_context() or make_trace_id()
        hdrs = {TRACE_HEADER: trace_id}
        try:
            r = svc.submit(
                prompt, max_new_tokens=int(body.get("max_new_tokens", 32)),
                temperature=float(body.get("temperature", 0.0)),
                seed=int(body.get("seed", 0)), eos_id=body.get("eos_id"),
                trace_id=trace_id, deadline_ms=body.get("deadline_ms"),
                session=body.get("session"))
        except InferenceInputError as e:
            raise InvalidArgsError(str(e)) from e
        except (ServeSaturated, ServeDraining) as e:
            retry = max(1, int(round(e.retry_after_s)))
            return Raw(e.to_json().encode(), "application/json",
                       status=e.status_code,
                       headers={"Retry-After": str(retry), **hdrs})
        if body.get("stream", True):
            return Stream(self._generate_chunks(svc, r), headers=hdrs)
        if not r.wait(timeout=600.0):
            svc.cancel(r)
            raise KubeMLException("generation timed out", 504)
        if r.outcome == "ok":
            return Raw(json.dumps({"tokens": r.tokens}).encode(),
                       "application/json", headers=hdrs)
        raise KubeMLException(r.error or f"generation {r.outcome}", 500)

    def _generate_chunks(self, svc, r):
        """ndjson producer of one stream. Its close() (a client
        disconnect, httpd's Stream contract) cancels the request, so its
        slot and KV pages free at once."""
        try:
            for ev in r.events_iter():
                yield (json.dumps(ev) + "\n").encode()
        finally:
            if not r.done:
                svc.cancel(r)
            if r.submitted_at is not None:
                self.metrics.observe_serve_stream(
                    svc.model_id, svc.clock() - r.submitted_at)

    def _h_flight(self, req: Request):
        """The serving engines' flight records (?id=serve:<model> or
        ?id=<model>): the last steps of every replica, oldest first, each
        stamped with its replica."""
        job_id = req.query.get("id", "")
        if not job_id:
            raise InvalidArgsError("id query parameter required")
        model_id = (job_id[len("serve:"):]
                    if job_id.startswith("serve:") else job_id)
        with self._serve_lock:
            cur = self._serve.get(model_id)
        if cur is None:
            raise JobNotFoundError(
                f"serve:{model_id} (no serving service running)")
        capacity = total = 0
        records: list = []
        replicas: list = []
        for idx, engine in cur[1].engines():
            fl = engine.flight
            if fl is None:
                continue
            replicas.append(idx)
            capacity += fl.capacity
            total += fl.total
            records += [dict(rec, replica=idx) for rec in fl.snapshot()]
        return {"id": f"serve:{model_id}", "model": model_id,
                "capacity": capacity, "total_steps": total,
                "replicas": replicas, "records": records}

    # ----------------------------------------------- durable control plane

    def _persist_jobs(self) -> None:
        """Mirror the standalone-job registry to the durable manifest
        (atomic tmp+rename). Threaded jobs are deliberately absent:
        they are threads of THIS process and cannot outlive it."""
        if self._jobs_manifest_path is None:
            return
        with self._manifest_lock:
            with self._jobs_lock:
                doc = {}
                for job_id in sorted(self.jobs):
                    rec = self.jobs[job_id]
                    if rec.job is not None:
                        continue
                    rec.task.restarts = rec.restarts
                    rec.task.preemptions = rec.preemptions
                    pid = rec.proc.pid if rec.proc is not None \
                        else rec.adopted_pid
                    doc[job_id] = {"task": rec.task.to_dict(),
                                   "url": rec.url, "pid": pid,
                                   "partition": rec.partition}
            atomic_write_json(self._jobs_manifest_path, {"jobs": doc})

    def _persist_fleets(self, resized: Optional[tuple] = None) -> None:
        """Mirror the serving registry — checkpoint stamp + live replica
        count per model — so recover() can rebuild each fleet at its
        pre-crash width with the last published weights. ``resized`` =
        (model_id, granted) comes from a resize offer, made before the
        fleet changes: that model is recorded at the count it was
        granted, not the count it has yet."""
        if self._fleet_manifest_path is None:
            return
        with self._manifest_lock:
            with self._serve_lock:
                items = sorted(self._serve.items())
            doc = {m: {"stamp": stamp, "replicas": fleet.replica_count}
                   for m, (stamp, fleet) in items}
            if resized is not None and resized[0] in doc:
                doc[resized[0]]["replicas"] = int(resized[1])
            atomic_write_json(self._fleet_manifest_path, {"fleets": doc})

    def _persist_fleets_async(self) -> None:
        """_persist_fleets for callers already holding _serve_lock (a
        plain, non-reentrant Lock): a short-lived thread takes it."""
        if self._fleet_manifest_path is None:
            return
        threading.Thread(target=self._persist_fleets,
                         name="persist-fleets", daemon=True).start()

    def recover(self) -> dict:
        """Rebuild a restarted PS from its durable manifests.

        Standalone children that survived the control-plane crash are
        RE-ADOPTED: probed over their recorded URL, reinstated in the job
        registry (partition lease re-claimed, counters restored) and
        watched by a pid-poll watchdog — never started a second time.
        Children that died with the control plane are dropped here; the
        scheduler's recovery sweep requeues them budget-free. Serving
        fleets are rebuilt at their recorded replica counts through the
        ordinary build path, which loads the newest checkpoint."""
        t0 = time.monotonic()
        summary: dict = {"adopted": [], "dropped": [], "fleets": {}}
        jobs_doc = (read_json(self._jobs_manifest_path)
                    if self._jobs_manifest_path else None) or {}
        for job_id, ent in sorted(jobs_doc.get("jobs", {}).items()):
            task = TrainTask.from_dict(ent["task"])
            url = ent.get("url")
            alive = False
            if url:
                try:
                    http_json("GET", f"{url}/health")
                    alive = True
                except KubeMLException:
                    alive = False
            if not alive:
                summary["dropped"].append(job_id)
                logger.warning("ps recovery: job %s child is gone; leaving "
                               "the requeue to the scheduler sweep", job_id)
                continue
            rec = _JobRecord(task, url=url)
            rec.partition = ent.get("partition")
            rec.adopted_pid = ent.get("pid")
            with self._jobs_lock:
                if job_id in self.jobs:
                    continue
                self.jobs[job_id] = rec
                if rec.partition is not None and self.job_partitions:
                    self._busy_partitions.add(rec.partition)
            self.metrics.running_total.inc("train")
            threading.Thread(target=self._watch_adopted,
                             args=(job_id, rec, rec.adopted_pid),
                             name=f"watch-{job_id}", daemon=True).start()
            summary["adopted"].append(job_id)
            logger.warning("ps recovery: re-adopted live child %s at %s "
                           "(pid %s)", job_id, url, rec.adopted_pid)
        fleets_doc = (read_json(self._fleet_manifest_path)
                      if self._fleet_manifest_path else None) or {}
        for model_id, ent in sorted(fleets_doc.get("fleets", {}).items()):
            replicas = int(ent.get("replicas", 0))
            if replicas <= 0:
                continue  # was at zero; the next request cold-starts it
            try:
                fleet = self._serve_service(model_id)
                live = fleet.ensure_replicas(replicas)
                summary["fleets"][model_id] = live
                logger.warning("ps recovery: fleet %s rebuilt at %d "
                               "replica(s) (stamp %s)", model_id, live,
                               ent.get("stamp"))
            except Exception:  # noqa: BLE001 — one fleet never fails recovery
                logger.exception("ps recovery: fleet %s rebuild failed",
                                 model_id)
        self.last_recovery_s = time.monotonic() - t0
        self.recoveries += 1
        self.metrics.note_control_recovery("ps", self.last_recovery_s)
        self._persist_jobs()
        self._persist_fleets()
        summary["recovery_s"] = self.last_recovery_s
        logger.warning("ps recovered in %.3fs: %d job(s) adopted, %d "
                       "dropped, %d fleet(s) rebuilt", self.last_recovery_s,
                       len(summary["adopted"]), len(summary["dropped"]),
                       len(summary["fleets"]))
        return summary

    # ------------------------------------------------------------- job mgmt

    def start_task(self, task: TrainTask) -> None:
        """Launch the job: as a child process in standalone mode
        (ps/api.go:139-222, pod -> process) or as a thread otherwise
        (ps/api.go:211-217)."""
        if self.standalone_jobs:
            self._start_standalone(task)
            return
        fn_name = task.parameters.function_name or task.parameters.model_type
        model_cls, dataset_cls = self.fn_registry.resolve(fn_name)
        dataset = (dataset_cls(task.parameters.dataset) if dataset_cls
                   else KubeDataset(task.parameters.dataset))
        job = TrainJob(task, model_cls(), dataset, device=self.device,
                       n_lanes=self.n_lanes, registry=self.ds_registry,
                       history_store=self.history_store,
                       callbacks=JobCallbacks(
                           request_parallelism=self._request_parallelism,
                           publish_metrics=self._publish_metrics,
                           on_finish=self._finish),
                       log_file=os.path.join(kubeml_home(), "logs",
                                             f"{task.job_id}.log"))
        thread = threading.Thread(target=self._run_job, args=(job,),
                                  name=f"job-{task.job_id}", daemon=True)
        with self._jobs_lock:
            if task.job_id in self.jobs:
                raise InvalidArgsError(f"job {task.job_id} already exists")
            self.jobs[task.job_id] = _JobRecord(task, job, thread)
        self.metrics.running_total.inc("train")
        task.state = "running"
        thread.start()

    def _run_job(self, job: TrainJob):
        try:
            job.train()
        except Exception:
            logger.exception("job %s thread failed", job.task.job_id)

    # ------------------------------------------------------- standalone mode

    def _start_standalone(self, task: TrainTask) -> None:
        """Spawn the per-job server process and hand it the task. The job
        id is reserved in the index BEFORE spawning, so duplicates are
        rejected up front and an immediately-failing child whose /finish
        races this method still finds its record."""
        rec = _JobRecord(task)
        with self._jobs_lock:
            if task.job_id in self.jobs:
                raise InvalidArgsError(f"job {task.job_id} already exists")
            if self.job_partitions is not None:
                free = [i for i in range(len(self.job_partitions))
                        if i not in self._busy_partitions]
                if not free:
                    raise KubeMLException(
                        "all device partitions are leased to running "
                        "jobs; retry when one finishes", 503)
                rec.partition = free[0]
                self._busy_partitions.add(free[0])
            self.jobs[task.job_id] = rec
        self.metrics.running_total.inc("train")
        try:
            self._spawn_standalone(rec)
        except Exception:
            with self._jobs_lock:
                popped = self.jobs.pop(task.job_id, None)
            if popped is not None:  # not already finished via /finish
                self.metrics.running_total.inc("train", -1.0)
            if rec.proc is not None:
                # the partition frees only once the terminated child is gone
                threading.Thread(target=self._reap, args=(rec,),
                                 name=f"reap-{task.job_id}",
                                 daemon=True).start()
            else:
                self._release_partition(rec)
            raise

    def _spawn_standalone(self, rec: _JobRecord) -> None:
        """Spawn the per-job child, wait for readiness, push the task, and
        arm the crash watchdog. Shared by the first start and the
        watchdog's checkpoint restart; a failed spawn terminates its own
        child, while record/partition bookkeeping stays with the caller."""
        task = rec.task
        task.state = "starting"
        tmp_dir = tempfile.mkdtemp(prefix=f"kubeml-job-{task.job_id}-")
        port_file = os.path.join(tmp_dir, "port")
        cmd = [sys.executable, "-m", "kubeml_tpu_torch.train.jobserver",
               "--job-id", task.job_id, "--ps-url", self.url,
               "--port-file", port_file]
        if self._device_arg is not None:
            cmd += ["--device", str(self._device_arg)]
        if self.n_lanes > 1:
            cmd += ["--mesh-data", str(self.n_lanes)]
        if self.scheduler_url:
            cmd += ["--scheduler-url", self.scheduler_url]
        env = dict(os.environ)
        # the child must not inherit this process's rank: it would join
        # the parent's group as that rank and hang it. Every family that
        # declares a cluster goes (parallel/distributed.py)
        for var in CLUSTER_ENV_VARS:
            env.pop(var, None)
        if rec.partition is not None:
            env.update(self.job_partitions[rec.partition])
            logger.info("job %s leased device partition %d (%s)",
                        task.job_id, rec.partition,
                        self.job_partitions[rec.partition])
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        try:
            rec.proc = subprocess.Popen(cmd, env=env)
            rec.url = self._wait_job_ready(rec.proc, port_file)
            # retried start push, parity ps/api.go:192-207 (10x backoff)
            delay = 0.1
            for attempt in range(10):
                try:
                    http_json("POST", f"{rec.url}/start", task.to_dict(),
                              trace_id=task.trace_id or None)
                    break
                except KubeMLException:
                    if attempt == 9:
                        raise
                    time.sleep(delay)
                    delay = min(delay * 2, 5.0)
        except Exception:
            # terminate only: the CALLER owns reap/partition bookkeeping
            if rec.proc is not None:
                rec.proc.terminate()
            raise
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
        task.state = "running"
        # a stop() that raced this spawn cleared the index while the child
        # came up: terminate (and reap) it instead of leaking an orphan
        with self._jobs_lock:
            raced_stop = self._stopping
        if raced_stop:
            rec.proc.terminate()
            threading.Thread(target=self._reap, args=(rec,),
                             name=f"reap-{task.job_id}",
                             daemon=True).start()
            raise KubeMLException("parameter server is shutting down", 503)
        # watchdog: a child that dies WITHOUT posting /finish must not pin
        # its record or its partition; _finish pops the record exactly
        # once, so whichever side loses the pop is a no-op
        threading.Thread(target=self._watch_standalone,
                         args=(task.job_id, rec),
                         name=f"watch-{task.job_id}", daemon=True).start()
        self._persist_jobs()

    def _watch_standalone(self, job_id: str, rec: _JobRecord):
        proc = rec.proc
        proc.wait()
        self._on_child_exit(job_id, rec, proc.returncode)

    def _watch_adopted(self, job_id: str, rec: _JobRecord,
                       pid: Optional[int]) -> None:
        """Watchdog of a child RE-ADOPTED from a previous PS incarnation:
        no Popen handle exists to wait() on, so poll the pid's liveness
        (the child's /health without one) and route its death through
        the same exit logic as a spawn-watched child."""
        while True:
            if self._stopping:
                return
            with self._jobs_lock:
                if self.jobs.get(job_id) is not rec:
                    return  # deregistered normally via /finish
            if rec.proc is not None:
                return  # a restart respawned it; its own watchdog owns it
            if pid is not None:
                try:
                    os.kill(pid, 0)
                    alive = True
                except OSError:
                    alive = False
            else:
                try:
                    http_json("GET", f"{rec.url}/health")
                    alive = True
                except KubeMLException:
                    alive = False
            if not alive:
                break
            time.sleep(0.5)
        self._on_child_exit(job_id, rec, None)

    def _on_child_exit(self, job_id: str, rec: _JobRecord,
                       rc: Optional[int]) -> None:
        """A child exited without finishing. After an allocator /preempt
        (cluster mode) its task goes back to the scheduler's queue. After
        a /preempted notice it respawns from its round cursor without
        spending the crash budget. Otherwise it restarts from its own
        latest checkpoint (history, epoch and parallelism restored) up to
        options.max_restarts times. None of these without a checkpoint,
        after a user stop or while the PS stops: then the job fails. The
        claim happens under the jobs lock, so a concurrent /finish sees
        either the dead incarnation or the respawn claim."""
        opts = rec.task.parameters.options
        # file IO outside the lock every handler contends on
        has_checkpoint = checkpoint_saved_at(job_id) is not None
        with self._jobs_lock:
            if self.jobs.get(job_id) is not rec:
                return  # already deregistered via /finish
            preempted, rec.preempted = rec.preempted, False
            # a child that crashed during its drain is requeued too: the
            # eviction was the platform's doing either way
            requeue = (rec.requeue_on_exit
                       and self.scheduler_url is not None
                       and not self._stopping
                       and rec.task.state != "stopping"
                       and has_checkpoint)
            if requeue:
                self.jobs.pop(job_id, None)
            eligible = (not requeue
                        and not self._stopping
                        and rec.task.state != "stopping"
                        and (preempted or rec.restarts < opts.max_restarts)
                        and has_checkpoint)
            if eligible:
                if not preempted:
                    rec.restarts += 1
                rec.proc = None
                rec.url = None
                rec.adopted_pid = None
                rec.restarting = True
                rec.last_heartbeat = None  # a fresh liveness window
                rec.task.parameters.resume_from = job_id
        if requeue:
            self._requeue_preempted(job_id, rec)
            return
        if not preempted:
            logger.warning("job %s process exited without finishing "
                           "(rc=%s)", job_id, rc)
        if not eligible:
            self._finish(job_id,
                         error=f"job process exited unexpectedly (rc={rc})")
            return
        if preempted:
            logger.warning("job %s: rescheduling after preemption (%d so "
                           "far) from its round checkpoint", job_id,
                           rec.preemptions)
        else:
            logger.warning("job %s: restarting from its checkpoint "
                           "(restart %d/%d)", job_id, rec.restarts,
                           opts.max_restarts)
            self.metrics.note_restart(job_id)
        try:
            self._spawn_standalone(rec)  # re-arms the watchdog
        except Exception as e:
            rec.restarting = False
            self._finish(job_id,
                         error=f"job process crashed (rc={rc}) and "
                               f"checkpoint restart failed: {e}")
            return
        rec.restarting = False

    def _requeue_preempted(self, job_id: str, rec: _JobRecord) -> None:
        """Hand an allocator-preempted task back to the scheduler's queue
        (the record is popped and the child gone, so its partition frees
        now). The task carries the restart and preemption counters and
        resumes from its own round cursor when the allocator re-places
        it."""
        self._release_partition(rec)
        self.metrics.running_total.inc("train", -1.0)
        task = rec.task
        task.state = "queued"
        task.elapsed_time_s = -1.0
        task.parameters.resume_from = job_id
        task.restarts = rec.restarts
        task.preemptions = rec.preemptions
        logger.warning("job %s: handing preempted task back to the "
                       "scheduler queue (preemptions=%d, restarts=%d)",
                       job_id, rec.preemptions, rec.restarts)
        self._persist_jobs()
        # a bounded, jittered retry: the scheduler may be mid-restart
        delay = 0.1
        for attempt in range(5):
            try:
                http_json("POST", f"{self.scheduler_url}/requeue",
                          task.to_dict(), trace_id=task.trace_id or None)
                return
            except KubeMLException as e:
                if attempt == 4:
                    logger.error("requeue of preempted job %s failed "
                                 "after %d attempts: %s — the job is "
                                 "stranded until resubmitted", job_id,
                                 attempt + 1, e.message)
                    return
                logger.warning("requeue of %s failed (attempt %d/5): "
                               "%s — retrying", job_id, attempt + 1,
                               e.message)
                time.sleep(delay * (0.5 + random.random() / 2))
                delay = min(delay * 2, 2.0)

    def _wait_job_ready(self, proc: subprocess.Popen, port_file: str,
                        timeout: Optional[float] = None) -> str:
        """Poll for the child's bound port, then its /health — the
        reference's waitForPodRunning loop (job_pod.go:18-62).
        KUBEML_JOB_START_TIMEOUT overrides the 120 s default."""
        if timeout is None:
            timeout = float(os.environ.get("KUBEML_JOB_START_TIMEOUT",
                                           120.0))
        deadline = time.monotonic() + timeout
        while not os.path.exists(port_file):
            if proc.poll() is not None:
                raise KubeMLException(
                    f"job process exited with {proc.returncode} "
                    "before binding", 500)
            if time.monotonic() > deadline:
                proc.terminate()
                raise KubeMLException("job process start timed out", 500)
            time.sleep(0.1)
        url = f"http://127.0.0.1:{int(read_json(port_file))}"
        while True:
            try:
                http_json("GET", f"{url}/health")
                return url
            except KubeMLException:
                if proc.poll() is not None:
                    raise KubeMLException(
                        f"job process exited with {proc.returncode} "
                        "before becoming healthy", 500)
                if time.monotonic() > deadline:
                    proc.terminate()
                    raise
                time.sleep(0.2)

    def _request_parallelism(self, task: TrainTask) -> Optional[int]:
        """Between-epoch parallelism negotiation (job.go:196-215)."""
        if self.scheduler_url is None:
            return None
        with self._jobs_lock:
            rec = self.jobs.get(task.job_id)
        if rec is None:
            return None
        # drop a stale answer from a previous timed-out round
        rec.update_event.clear()
        try:
            http_json("POST", f"{self.scheduler_url}/job", task.to_dict())
        except KubeMLException as e:
            logger.warning("scheduler unreachable for %s: %s", task.job_id,
                           e.message)
            return None
        # the scheduler answers from its queue with POST /update/{jobId}
        if not rec.update_event.wait(timeout=60.0):
            logger.warning("no parallelism update for %s within 60s",
                           task.job_id)
            return None
        rec.update_event.clear()
        return rec.next_parallelism

    def _publish_metrics(self, m: MetricUpdate):
        # in-process twin of POST /metrics/{jobId} for threaded jobs: it
        # stashes the cost snapshot for /cost as well
        self.metrics.update_job(m)
        if m.cost_programs:
            self._cost[m.job_id] = m.cost_programs
        self._observe_health(m)

    def _finish(self, job_id: str, error: Optional[str] = None):
        """Clear per-job series + notify the scheduler
        (ps/api.go:266-327)."""
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
            if rec is not None and rec.restarting:
                # the dead incarnation's last message: the restart owns
                # the record
                return
            rec = self.jobs.pop(job_id, None)
            if rec is not None and error:
                self.errors[job_id] = error
            if rec is not None:
                self._finishing.add(job_id)
        if rec is None:
            return
        try:
            self._clear_finished(job_id, rec)
        finally:
            with self._jobs_lock:
                self._finishing.discard(job_id)
        self._persist_jobs()
        if error:
            logger.warning("job %s exited with error: %s", job_id, error)
        if self.scheduler_url is not None:
            try:
                http_json("DELETE", f"{self.scheduler_url}/finish/{job_id}")
            except KubeMLException as e:
                logger.warning("could not notify scheduler finish: %s",
                               e.message)

    def _clear_finished(self, job_id: str, rec: "_JobRecord") -> None:
        """A deregistered job's bookkeeping: stamp its restarts and
        preemptions, reap its child or free its partition, clear its
        series and health state."""
        if rec.restarts or rec.preemptions:
            # stamp the watchdog's restarts and preemptions into the
            # finished History: each job process knows only its own life
            try:
                h = self.history_store.get(job_id)
                h.data.restarts = rec.restarts
                h.data.preemptions = rec.preemptions
                self.history_store.save(h)
            except JobNotFoundError:
                pass
        if rec.proc is not None:
            # the child exits after its finish notification; reap it
            # off-thread so this handler (called BY that child) returns
            threading.Thread(target=self._reap, args=(rec,),
                             name=f"reap-{job_id}", daemon=True).start()
        else:
            self._release_partition(rec)
        self.metrics.clear_job(job_id)
        with self._health_lock:
            self.health.clear(job_id)
        self.metrics.running_total.inc("train", -1.0)

    def _reap(self, rec: _JobRecord):
        proc = rec.proc
        try:
            proc.wait(30.0)
        except subprocess.TimeoutExpired:
            logger.warning("job process %d did not exit; killing", proc.pid)
            proc.kill()
            proc.wait()
        finally:
            # the partition frees only once the process is gone
            self._release_partition(rec)

    def _release_partition(self, rec: _JobRecord):
        # atomic take-and-clear: concurrent releases free the slot once
        with self._jobs_lock:
            slot, rec.partition = rec.partition, None
            if slot is not None:
                self._busy_partitions.discard(slot)

    def stop(self):
        """Shut the HTTP server down, stop threaded jobs and terminate
        standalone children: a dying PS leaks no orphan job process. The
        serving fleets stop first (draining for serve_drain_grace_s), so
        blocked /generate streams end instead of timing out."""
        super().stop()
        self._reaper_stop.set()
        with self._serve_lock:
            fleets = [fleet for _, fleet in self._serve.values()]
            self._serve.clear()
        for fleet in fleets:
            fleet.stop(grace_s=self.serve_drain_grace_s)
        with self._jobs_lock:
            self._stopping = True  # no further spawns or restarts
            recs = list(self.jobs.values())
            self.jobs.clear()
        for rec in recs:
            if rec.proc is not None and rec.proc.poll() is None:
                rec.proc.terminate()
            elif rec.job is not None:
                rec.job.stop()
        for rec in recs:
            if rec.proc is not None:
                try:
                    rec.proc.wait(10.0)
                except subprocess.TimeoutExpired:
                    rec.proc.kill()
                    rec.proc.wait()
            elif rec.thread is not None and rec.thread.is_alive():
                # bounded: the stop request is read once per epoch
                rec.thread.join(10.0)
            self._release_partition(rec)

    def wait_for_job(self, job_id: str, timeout: Optional[float] = None
                     ) -> bool:
        """Wait until the job is deregistered (finished, failed or
        stopped) and its per-job series are cleared; False on timeout. A
        restarting record stays registered across incarnations, so
        deregistration is the signal."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._jobs_lock:
                if job_id not in self.jobs \
                        and job_id not in self._finishing:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)
