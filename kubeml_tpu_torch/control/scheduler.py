"""Scheduler — task queue + parallelism policy (twin of kubeml_tpu/
control/scheduler.py, its single-job FIFO path).

Parity with ml/pkg/scheduler/ (scheduler.go, api.go, queue.go):
  - POST /train: accept a TrainRequest, mint an 8-char job id
    (util.go:8-10), enqueue;
  - a scheduling loop pops tasks, asks the policy for parallelism, and
    calls PS /start (first decision) or PS /update/{jobId}
    (re-parallelize) — scheduler.go:48-89, on a condition-variable queue;
  - POST /job: a running job asks for its next-epoch parallelism
    (api.go:47-75), answered through PS /update/{jobId};
  - POST /infer: inference relay to the PS (api.go:119-162);
  - DELETE /finish/{taskId}: drop the job's policy state (api.go:165-181).

Each job's ``scheduler.enqueue`` span goes to ``TraceSink(job,
"scheduler")`` under the client's trace id.

A task the PS turns away with 503 (every device partition leased) goes
back on the queue with a capped, jittered exponential backoff. As in the
JAX package without its allocator, a task's priority and tenant ride the
wire and do not change the FIFO order.

Not ported yet, each refused with the error envelope: the cluster
allocator (GET /cluster, POST /serve/resize, its tenants and lanes) and
durable scheduler state with POST /requeue (ROADMAP A.16), and the
requeue of preempted jobs (ROADMAP A.17).
"""

from __future__ import annotations

import collections
import logging
import random
import threading
import time
from typing import Deque, Dict, Optional

from kubeml_tpu_torch.api.errors import InvalidArgsError, KubeMLException
from kubeml_tpu_torch.api.types import TrainRequest, TrainTask
from kubeml_tpu_torch.control.httpd import (JsonService, Request, http_json,
                                            not_ported)
from kubeml_tpu_torch.control.policy import ThroughputBasedPolicy
from kubeml_tpu_torch.utils.ids import make_job_id
from kubeml_tpu_torch.utils.trace import (TraceSink, Tracer,
                                          get_trace_context, make_trace_id)

logger = logging.getLogger("kubeml_tpu_torch.scheduler")

# Per-task capacity-deferral backoff: exponential from BASE, capped, with
# +/-25% jitter so tasks deferred in one sweep do not re-arrive together.
DEFER_BASE_S = 0.25
DEFER_CAP_S = 5.0

CLUSTER = "the cluster allocator, ROADMAP A.16"


class SchedulerQueue:
    """FIFO with blocking pop (queue.go:15-83)."""

    def __init__(self):
        self._q: Deque[TrainTask] = collections.deque()
        self._cv = threading.Condition()

    def push(self, task: TrainTask):
        with self._cv:
            self._q.append(task)
            self._cv.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[TrainTask]:
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            return self._q.popleft() if self._q else None

    def __len__(self):
        with self._cv:
            return len(self._q)


class Scheduler(JsonService):
    name = "scheduler"

    def __init__(self, ps_url: Optional[str] = None, port: int = 0,
                 policy: Optional[ThroughputBasedPolicy] = None,
                 rng: Optional[random.Random] = None):
        super().__init__(port=port)
        self.ps_url = ps_url
        self.policy = policy or ThroughputBasedPolicy()
        self.queue = SchedulerQueue()
        # capacity-deferred tasks parked with a not-before stamp, so the
        # backoff applies per task; /finish drops a dead job's entry
        self._deferred: list = []  # [(not_before_monotonic, task)]
        self._defer_lock = threading.Lock()
        # consecutive deferrals per task id (loop thread), reset on
        # dispatch — drives the capped exponential backoff
        self._defer_counts: Dict[str, int] = {}
        # backoff jitter source, injectable so tests pin exact delays
        self._rng = rng if rng is not None else random.Random()
        # one tracer per job: TraceSink rewrites the whole file per flush,
        # so every event of a job over the scheduler's life accumulates in
        # ONE tracer, or each flush would clobber the last
        self._job_tracers: Dict[str, Tracer] = {}
        self._tracer_lock = threading.Lock()
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None

        self.route("POST", "/train", self._h_train)
        self.route("POST", "/job", self._h_job)
        self.route("POST", "/infer", self._h_infer)
        self.route("DELETE", "/finish/{taskId}", self._h_finish)
        self.route("POST", "/requeue", not_ported(
            "POST /requeue", "preemption and adoption, ROADMAP A.17"))
        self.route("GET", "/cluster", not_ported("GET /cluster", CLUSTER))
        self.route("POST", "/serve/resize",
                   not_ported("POST /serve/resize", CLUSTER))

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        port = super().start()
        self._loop_thread = threading.Thread(target=self._schedule_loop,
                                             name="scheduler-loop",
                                             daemon=True)
        self._loop_thread.start()
        return port

    def stop(self):
        self._stop.set()
        with self.queue._cv:
            self.queue._cv.notify_all()
        super().stop()

    # ------------------------------------------------------------- handlers

    def _h_train(self, req: Request):
        try:
            train_req = TrainRequest.from_dict(req.body)
        except (KeyError, TypeError, ValueError) as e:
            raise InvalidArgsError(f"bad train request: {e}")
        # the client-minted trace id (header -> thread context) rides the
        # task: the scheduling loop runs in another thread
        task = TrainTask(job_id=make_job_id(), parameters=train_req,
                         trace_id=get_trace_context() or make_trace_id(),
                         priority=train_req.priority,
                         tenant=train_req.tenant)
        tracer = self._job_tracer(task.job_id, trace_id=task.trace_id)
        with tracer.span("scheduler.enqueue", job_id=task.job_id):
            self.queue.push(task)
        self._flush_job_trace(task.job_id)
        logger.info("queued train task %s (%s on %s)", task.job_id,
                    train_req.model_type, train_req.dataset)
        return {"id": task.job_id}

    def _h_job(self, req: Request):
        """A running job asks to be re-parallelized; answered via PS
        /update/{jobId} from the scheduling loop (api.go:47-75)."""
        self.queue.push(TrainTask.from_dict(req.body))
        return {"ok": True}

    def _h_infer(self, req: Request):
        if self.ps_url is None:
            raise KubeMLException("no parameter server configured", 503)
        return http_json("POST", f"{self.ps_url}/infer", req.body)

    def _h_finish(self, req: Request):
        task_id = req.params["taskId"]
        self.policy.task_finished(task_id)
        self._defer_counts.pop(task_id, None)
        # a job that finished while deferred must not be re-dispatched
        # once its backoff ripens
        with self._defer_lock:
            self._deferred = [(nb, t) for nb, t in self._deferred
                              if t.job_id != task_id]
        # its spans are already on disk
        with self._tracer_lock:
            self._job_tracers.pop(task_id, None)
        return {"ok": True}

    def _job_tracer(self, job_id: str, trace_id: str = None) -> Tracer:
        with self._tracer_lock:
            t = self._job_tracers.get(job_id)
            if t is None:
                t = self._job_tracers[job_id] = Tracer(trace_id=trace_id)
            return t

    def _flush_job_trace(self, job_id: str) -> None:
        with self._tracer_lock:
            t = self._job_tracers.get(job_id)
        if t is None:
            return
        try:
            TraceSink(job_id, "scheduler").write(t)
        except OSError:
            logger.exception("trace flush failed for %s", job_id)

    # ----------------------------------------------------------------- loop

    def _defer_delay(self, n: int) -> float:
        """Capped exponential backoff for the n-th consecutive deferral,
        with +/-25% jitter from the injectable RNG."""
        return min(DEFER_CAP_S, DEFER_BASE_S * (2 ** n)) \
            * (0.75 + 0.5 * self._rng.random())

    def _schedule_loop(self):
        while not self._stop.is_set():
            with self._defer_lock:
                now = time.monotonic()
                ripe = [t for nb, t in self._deferred if nb <= now]
                self._deferred = [(nb, t) for nb, t in self._deferred
                                  if nb > now]
            for t in ripe:
                self.queue.push(t)
            task = self.queue.pop(timeout=0.5)
            if task is None:
                continue
            try:
                self._schedule(task)
                self._defer_counts.pop(task.job_id, None)
            except KubeMLException as e:
                if e.status_code != 503:
                    logger.exception("scheduling task %s failed",
                                     task.job_id)
                    continue
                # no capacity: the task goes back with a backoff and
                # takes the /start path again (the policy forgets it)
                logger.info("task %s deferred (%s); requeueing",
                            task.job_id, e.message)
                self.policy.task_finished(task.job_id)
                n = self._defer_counts.get(task.job_id, 0)
                self._defer_counts[task.job_id] = n + 1
                with self._defer_lock:
                    self._deferred.append(
                        (time.monotonic() + self._defer_delay(n), task))
            except Exception:
                logger.exception("scheduling task %s failed", task.job_id)

    def _schedule(self, task: TrainTask):
        parallelism, is_new = self.policy.calculate_parallelism(task)
        task.parallelism = parallelism
        if self.ps_url is None:
            logger.warning("no PS configured; dropping task %s", task.job_id)
            return
        # explicit trace_id: the loop thread has no ambient context
        if is_new:
            logger.info("starting task %s with parallelism %d", task.job_id,
                        parallelism)
            http_json("POST", f"{self.ps_url}/start", task.to_dict(),
                      trace_id=task.trace_id or None)
        else:
            logger.info("updating task %s to parallelism %d", task.job_id,
                        parallelism)
            http_json("POST", f"{self.ps_url}/update/{task.job_id}",
                      {"parallelism": parallelism},
                      trace_id=task.trace_id or None)
