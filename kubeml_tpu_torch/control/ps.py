"""Parameter Server manager — per-job lifecycle + metrics (twin of
kubeml_tpu/control/ps.py, its training routes, over the port's TrainJob).

Parity with ml/pkg/ps/ (parameter_server.go, api.go): tracks a job index,
starts jobs, relays scheduler updates, receives metric updates and finish
signals, exports Prometheus gauges, serves the task list.

REST surface (ml/pkg/ps/api.go:335-345):
    POST   /start             start a task (body: TrainTask)
    POST   /update/{jobId}    apply a new parallelism for the next epoch
    POST   /metrics/{jobId}   metric update push (body: MetricUpdate)
    POST   /heartbeat/{jobId} a standalone job's progress cursor
    POST   /finish/{jobId}    job finished notification
    DELETE /stop/{jobId}      stop a running job
    GET    /tasks             running-task list
    GET    /metrics           Prometheus exposition (job families + HTTP)
    POST   /infer             inference on a checkpointed model, through a
                              saved_at-keyed LRU of loaded modules and the
                              micro-batcher

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
    ``options.max_restarts`` times.

``device`` is the port's device argument: None means CUDA (raising
without a card when first used), "cpu" runs the jobs and the children
there.

Not ported yet, each answering with the error envelope: /generate and
/flight (serving through the PS, ROADMAP A.1), /trace and /cost (ROADMAP
A.13), a job's /health verdict (ROADMAP A.15), /cluster and the durable
state with recover() (ROADMAP A.16), /preempt, /preempted and the
heartbeat reaper (ROADMAP A.17).
"""

from __future__ import annotations

import collections
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.api.errors import (InvalidArgsError, JobNotFoundError,
                                         KubeMLException, NotPortedError)
from kubeml_tpu_torch.api.types import MetricUpdate, TrainTask
from kubeml_tpu_torch.control.httpd import (JsonService, Raw, Request,
                                            http_json, not_ported)
from kubeml_tpu_torch.control.journal import read_json
from kubeml_tpu_torch.data.registry import DatasetRegistry
from kubeml_tpu_torch.metrics.prom import MetricsRegistry
from kubeml_tpu_torch.models.base import InferenceInputError, KubeDataset
from kubeml_tpu_torch.train.checkpoint import (checkpoint_saved_at,
                                               load_checkpoint)
from kubeml_tpu_torch.train.functionlib import FunctionRegistry
from kubeml_tpu_torch.train.history import HistoryStore
from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob
from kubeml_tpu_torch.utils.trace import get_trace_context, make_trace_id

logger = logging.getLogger("kubeml_tpu_torch.ps")

SERVING = "serving through the PS, ROADMAP A.1"
PREEMPTION = "preemption and adoption, ROADMAP A.17"


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
        self.restarts = task.restarts  # crash restarts consumed
        self.restarting = False  # watchdog respawn claimed, in progress

    def push_update(self, parallelism: int):
        # standalone-ness is `job is None`: a crash-restarting record has
        # url transiently None and must answer the 503 retry signal
        if self.job is None and self.url is None:
            raise KubeMLException(
                f"job {self.task.job_id} still starting", 503)
        if self.url is not None:
            http_json("POST", f"{self.url}/update",
                      {"parallelism": parallelism})
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
                 infer_cache_size: Optional[int] = None):
        super().__init__(port=port)
        # resolved at first use (a threaded job or an /infer): in
        # standalone mode the parent leaves the card to its children
        self._device_arg = device
        self._device: Optional[torch.device] = None
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
        self.metrics = MetricsRegistry()
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
        self.route("POST", "/infer", self._h_infer)
        for method, path, brings in (
                ("POST", "/generate", SERVING),
                ("GET", "/flight", SERVING),
                ("GET", "/trace", "the tracer, ROADMAP A.13"),
                ("GET", "/cost", "the cost ledger, ROADMAP A.13"),
                ("POST", "/cluster", "the cluster allocator, ROADMAP A.16"),
                ("POST", "/preempt/{jobId}", PREEMPTION),
                ("POST", "/preempted/{jobId}", PREEMPTION)):
            self.route(method, path, not_ported(f"{method} {path}", brings))

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
        self.start_task(task)
        return {"job_id": task.job_id}

    def _h_update(self, req: Request):
        job_id = req.params["jobId"]
        with self._jobs_lock:
            rec = self.jobs.get(job_id)
        if rec is None:
            raise JobNotFoundError(job_id)
        rec.push_update(int(req.body["parallelism"]))
        return {"ok": True}

    def _h_metrics(self, req: Request):
        self.metrics.update_job(MetricUpdate.from_dict(req.body))
        return {"ok": True}

    def _h_heartbeat(self, req: Request):
        """Progress cursor (epoch, round) of a standalone child, shown on
        the heartbeat gauges; the reaper that kills a silent child comes
        with ROADMAP A.17."""
        job_id = req.params["jobId"]
        body = req.body if isinstance(req.body, dict) else {}
        epoch, rnd = int(body.get("epoch", 0)), int(body.get("round", 0))
        # under the lock: a beat racing the job's finish must not set the
        # gauges again after _finish has popped the record and clears them
        with self._jobs_lock:
            if job_id not in self.jobs:
                raise JobNotFoundError(job_id)
            self.metrics.note_heartbeat(job_id, epoch, rnd)
        return {"ok": True}

    def _h_health(self, req: Request):
        """Bare GET /health is the liveness answer every service gives;
        a job's verdict (?id=) needs the health evaluator."""
        if req.query.get("id"):
            raise NotPortedError("GET /health?id=",
                                 "the health evaluator, ROADMAP A.15", 501)
        return {"ok": True}

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

    def _h_tasks(self, req: Request):
        with self._jobs_lock:
            out = []
            for r in self.jobs.values():
                # each child incarnation knows only its own lifetime
                r.task.restarts = r.restarts
                out.append(r.task.to_dict())
            return out

    def _h_prom(self, req: Request):
        # job families plus this service's HTTP series, one scrape target
        text = self.metrics.exposition() + self.http_metrics.exposition()
        return Raw(text.encode(), "text/plain; version=0.0.4")

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
        if not hasattr(model, "infer"):
            raise NotPortedError(
                f"POST /infer on a {manifest.get('model')} checkpoint",
                SERVING, 501)
        module = model.module_from_flax(variables, device=self.device)
        module.eval()
        # key on the LOADED manifest's stamp so (stamp, weights) stay
        # consistent even if a save raced the probe above
        key = manifest.get("saved_at")
        if key is not None:
            with self._infer_cache_lock:
                self._infer_cache[model_id] = (key, model, module)
                self._infer_cache.move_to_end(model_id)
                while len(self._infer_cache) > self.infer_cache_size:
                    self._infer_cache.popitem(last=False)
                self.metrics.set_infer_cache_entries(
                    len(self._infer_cache))
        return model, module

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
                       registry=self.ds_registry,
                       history_store=self.history_store,
                       callbacks=JobCallbacks(
                           request_parallelism=self._request_parallelism,
                           publish_metrics=self._publish_metrics,
                           on_finish=self._finish))
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
        if self.scheduler_url:
            cmd += ["--scheduler-url", self.scheduler_url]
        env = dict(os.environ)
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

    def _watch_standalone(self, job_id: str, rec: _JobRecord):
        proc = rec.proc
        proc.wait()
        self._on_child_exit(job_id, rec, proc.returncode)

    def _on_child_exit(self, job_id: str, rec: _JobRecord,
                       rc: Optional[int]) -> None:
        """A child exited without finishing: restart it from its own
        latest checkpoint (history, epoch and parallelism restored) up to
        options.max_restarts times, unless the user stopped it or there
        is no checkpoint; else fail the job. The claim happens under the
        jobs lock, so a concurrent /finish sees either the dead
        incarnation or the respawn claim."""
        opts = rec.task.parameters.options
        # file IO outside the lock every handler contends on
        has_checkpoint = checkpoint_saved_at(job_id) is not None
        with self._jobs_lock:
            if self.jobs.get(job_id) is not rec:
                return  # already deregistered via /finish
            eligible = (not self._stopping
                        and rec.task.state != "stopping"
                        and rec.restarts < opts.max_restarts
                        and has_checkpoint)
            if eligible:
                rec.restarts += 1
                rec.proc = None
                rec.url = None
                rec.restarting = True
                rec.task.parameters.resume_from = job_id
        logger.warning("job %s process exited without finishing (rc=%s)",
                       job_id, rc)
        if not eligible:
            self._finish(job_id,
                         error=f"job process exited unexpectedly (rc={rc})")
            return
        logger.warning("job %s: restarting from its checkpoint (restart "
                       "%d/%d)", job_id, rec.restarts, opts.max_restarts)
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
        # in-process twin of POST /metrics/{jobId} for threaded jobs
        self.metrics.update_job(m)

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
        if rec is None:
            return
        if rec.restarts:
            # stamp the watchdog restarts into the finished History: the
            # job process only knows its own lifetime
            try:
                h = self.history_store.get(job_id)
                h.data.restarts = rec.restarts
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
        self.metrics.running_total.inc("train", -1.0)
        if error:
            logger.warning("job %s exited with error: %s", job_id, error)
        if self.scheduler_url is not None:
            try:
                http_json("DELETE", f"{self.scheduler_url}/finish/{job_id}")
            except KubeMLException as e:
                logger.warning("could not notify scheduler finish: %s",
                               e.message)

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
        standalone children: a dying PS leaks no orphan job process."""
        super().stop()
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
        stopped); False on timeout. A restarting record stays registered
        across incarnations, so deregistration is the signal."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._jobs_lock:
                if job_id not in self.jobs:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)
