"""Scheduler — task queue + parallelism policy (twin of kubeml_tpu/
control/scheduler.py: its FIFO path, cluster mode and durable state).

Parity with ml/pkg/scheduler/ (scheduler.go, api.go, queue.go):
  - POST /train: accept a TrainRequest, mint an 8-char job id
    (util.go:8-10), enqueue;
  - a scheduling loop pops tasks, asks the policy for parallelism, and
    calls PS /start (first decision) or PS /update/{jobId} (re-parallelize)
    — scheduler.go:48-89. The reference busy-polls every 10ms; we use a
    condition-variable queue (same ordering, no spin);
  - POST /job: a running job asks for its next-epoch parallelism
    (api.go:47-75) — enqueued and answered through PS /update/{jobId};
  - POST /infer: inference relay (api.go:119-162; the reference invokes the
    Fission function directly — here the PS runs it from the checkpoint);
  - DELETE /finish/{taskId}: drop policy state (api.go:165-181).

Each job's ``scheduler.enqueue`` span and the allocator's decision
instants go to ``TraceSink(job, "scheduler")`` under the client's trace
id.

Cluster mode (control/cluster.py, opt-in via `allocator=`): a
ClusterAllocator owning the shared lane pool sits between this queue
and the PS — arrivals gang-place atomically, queue under priority +
aging + weighted-fair deficits, or preempt cheaper running work. The
ThroughputBasedPolicy stays on as the per-job width ADVISOR whose
requested N the allocator may clamp. A serving fleet's replicas are the
allocator's second gang kind (POST /serve/resize). A preempted
``serve:<model>`` gang drains to zero on the PS; a training victim
drains, checkpoints at its round cursor and comes back through POST
/requeue without spending max_restarts (its lanes free there).

Durable state (opt-in via `state_dir=`): every task's lifecycle phase is
mirrored to ``scheduler.state.json``; ``recover()`` rebuilds the queue,
the parked tasks and the grants after a restart, re-adopting jobs whose
children survived and requeueing the rest without spending their
restart budget.
"""

from __future__ import annotations

import collections
import logging
import os
import random
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from kubeml_tpu_torch.api.errors import InvalidArgsError, KubeMLException
from kubeml_tpu_torch.api.types import TrainRequest, TrainTask
from kubeml_tpu_torch.control.cluster import (ClusterAllocator, Decision,
                                              verify_journal_roundtrip)
from kubeml_tpu_torch.control.httpd import JsonService, Request, http_json
from kubeml_tpu_torch.control.journal import atomic_write_json, read_json
from kubeml_tpu_torch.control.policy import ThroughputBasedPolicy
from kubeml_tpu_torch.utils.ids import make_job_id
from kubeml_tpu_torch.utils.trace import (TraceSink, Tracer,
                                          get_trace_context, make_trace_id)

logger = logging.getLogger("kubeml_tpu_torch.scheduler")

# Per-task capacity-deferral backoff: exponential from BASE, CAPPED so a
# task parked behind a long-running fleet still re-probes within ~5 s of
# capacity freeing, with +/-25% jitter so tasks deferred in the same
# sweep don't re-arrive as a synchronized burst that re-defers together.
DEFER_BASE_S = 0.25
DEFER_CAP_S = 5.0


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
                 allocator: Optional[ClusterAllocator] = None,
                 rng: Optional[random.Random] = None,
                 state_dir: Optional[str] = None):
        super().__init__(port=port)
        self.ps_url = ps_url
        self.policy = policy or ThroughputBasedPolicy()
        # cluster mode (opt-in): a ClusterAllocator owning the shared
        # lane pool gang-places/queues/preempts arrivals, with the
        # policy demoted to a per-job width advisor the allocator may
        # clamp. None keeps the legacy single-job FIFO path untouched.
        self.allocator = allocator
        self.queue = SchedulerQueue()
        # capacity-deferred tasks parked with a not-before stamp so the
        # backoff applies per task, not to the whole scheduling loop.
        # Guarded by _defer_lock: the loop re-admits ripe entries while
        # /finish drops a dead job's parked task from another thread
        self._deferred: list = []  # [(not_before_monotonic, task)]
        self._defer_lock = threading.Lock()
        # consecutive deferrals per task id (loop thread owns it), reset
        # on successful dispatch — drives the capped exponential backoff
        self._defer_counts: Dict[str, int] = {}
        # backoff jitter source, injectable so tests pin exact delays
        # instead of sleeping past randomized ones
        self._rng = rng if rng is not None else random.Random()
        # cluster mode: tasks the allocator parked ('queue' decisions),
        # and lane grants awaiting their dispatch pass through the queue
        self._parked: Dict[str, TrainTask] = {}
        # job_id -> (lanes, fencing epoch) awaiting the /start dispatch
        self._granted: Dict[str, Tuple[int, int]] = {}
        # RLock: _apply_decisions mutates _granted under the lock and
        # the durability mirror (_track_locked) persists in the same
        # critical section
        self._cluster_lock = threading.RLock()
        # durability (opt-in): every submitted task + its lifecycle
        # phase, mirrored to <state_dir>/scheduler.state.json on each
        # transition so recover() can rebuild queue/parked/granted
        self.state_dir = state_dir
        self._state_path = (os.path.join(state_dir, "scheduler.state.json")
                            if state_dir else None)
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
        self._submitted: Dict[str, dict] = {}
        # recovery observability: wall seconds the last recover() took
        # (rides the next cluster-state push into the PS histogram)
        self.last_recovery_s: Optional[float] = None
        self.recoveries = 0
        # persistent per-job tracers: TraceSink rewrites the whole file
        # per flush, so every event for a job over its scheduler
        # lifetime (enqueue span + allocator decision instants) must
        # accumulate in ONE tracer or each flush would clobber the last
        self._job_tracers: Dict[str, Tracer] = {}
        self._tracer_lock = threading.Lock()
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None

        self.route("POST", "/train", self._h_train)
        self.route("POST", "/job", self._h_job)
        self.route("POST", "/infer", self._h_infer)
        self.route("POST", "/requeue", self._h_requeue)
        self.route("GET", "/cluster", self._h_cluster)
        self.route("POST", "/serve/resize", self._h_serve_resize)
        self.route("DELETE", "/finish/{taskId}", self._h_finish)

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

    # ----------------------------------------------------------- durability

    def _track(self, task: TrainTask, phase: str,
               lanes: int = 0, epoch: int = 0) -> None:
        """Mirror one task's lifecycle phase (queued | parked |
        granted) to the durable state file. No-op without state_dir."""
        if self._state_path is None:
            return
        with self._cluster_lock:
            self._submitted[task.job_id] = {
                "task": task.to_dict(), "phase": phase,
                "lanes": int(lanes), "epoch": int(epoch)}
            self._persist_locked()

    def _untrack(self, job_id: str) -> None:
        if self._state_path is None:
            return
        with self._cluster_lock:
            if self._submitted.pop(job_id, None) is not None:
                self._persist_locked()

    def _persist_locked(self) -> None:
        atomic_write_json(self._state_path, {
            "tasks": {j: self._submitted[j]
                      for j in sorted(self._submitted)}})

    # ------------------------------------------------------------- handlers

    def _h_train(self, req: Request):
        try:
            train_req = TrainRequest.from_dict(req.body)
        except (KeyError, TypeError, ValueError) as e:
            raise InvalidArgsError(f"bad train request: {e}")
        # bind the client-minted trace id (header -> thread context, set
        # by the middleware) to the task: the scheduling loop runs in
        # another thread, so the id must ride the task, not the context
        task = TrainTask(job_id=make_job_id(), parameters=train_req,
                         trace_id=get_trace_context() or make_trace_id(),
                         priority=train_req.priority,
                         tenant=train_req.tenant)
        tracer = self._job_tracer(task.job_id, trace_id=task.trace_id)
        with tracer.span("scheduler.enqueue", job_id=task.job_id):
            self._track(task, "queued")
            self.queue.push(task)
        self._flush_job_trace(task.job_id)
        logger.info("queued train task %s (%s on %s)", task.job_id,
                    train_req.model_type, train_req.dataset)
        return {"id": task.job_id}

    def _h_job(self, req: Request):
        """A running job requests re-parallelization; answered via PS
        /update/{jobId} from the scheduling loop (api.go:47-75).

        Fencing: a task carrying a grant_epoch is checked against the
        allocator's current epoch for that job. A stale epoch (a
        pre-crash worker that outlived the control plane which granted
        it) is rejected 409 (StaleGrantError propagates through the
        JSON envelope) so a recovered allocator never double-books."""
        task = TrainTask.from_dict(req.body)
        if self.allocator is not None and task.grant_epoch:
            self.allocator.fence_check(task.job_id, task.grant_epoch)
        self.queue.push(task)
        return {"ok": True}

    def _h_infer(self, req: Request):
        if self.ps_url is None:
            raise KubeMLException("no parameter server configured", 503)
        return http_json("POST", f"{self.ps_url}/infer", req.body)

    def _h_finish(self, req: Request):
        task_id = req.params["taskId"]
        self._untrack(task_id)
        self.policy.task_finished(task_id)
        # drop any backoff streak so the id doesn't linger forever
        # (single-key dict pop — safe against the loop thread's reads)
        self._defer_counts.pop(task_id, None)
        # a job that finished (or aborted) while PARKED must drop its
        # deferred entry too, or a dead job's task would be re-admitted
        # and re-dispatched once its backoff ripens
        with self._defer_lock:
            self._deferred = [(nb, t) for nb, t in self._deferred
                              if t.job_id != task_id]
        if self.allocator is not None:
            with self._cluster_lock:
                self._parked.pop(task_id, None)
                self._granted.pop(task_id, None)
            # freed lanes may grant parked work
            self._apply_decisions(self.allocator.release(task_id))
            self._push_cluster_state()
        # release the finished job's tracer (its decision instants are
        # already flushed to the sink file)
        with self._tracer_lock:
            self._job_tracers.pop(task_id, None)
        return {"ok": True}

    def _h_requeue(self, req: Request):
        """A preempted job's task handed back by the PS (the allocator
        SIGTERMed it to make room; it drained and checkpointed, and its
        process is gone). It re-enters the queue as a fresh arrival: its
        resume_from names its own checkpoint, and the policy forgets it so
        the next decision takes the /start path."""
        task = TrainTask.from_dict(req.body)
        self.policy.task_finished(task.job_id)
        task.state = "queued"
        task.elapsed_time_s = -1.0
        task.grant_epoch = 0
        self._track(task, "queued")
        if self.allocator is not None:
            # the victim's lanes free now; a parked arrival places on it
            self._apply_decisions(self.allocator.release(task.job_id))
        logger.info("requeued preempted task %s (preemptions=%d)",
                    task.job_id, task.preemptions)
        self.queue.push(task)
        if self.allocator is not None:
            self._push_cluster_state()
        return {"ok": True}

    def _h_cluster(self, req: Request):
        if self.allocator is None:
            raise KubeMLException("cluster allocator not configured", 503)
        return self.allocator.snapshot()

    def _h_serve_resize(self, req: Request):
        """A serving fleet (serve/fleet.py resize_cb, via the PS) offers
        a replica-count change to the shared pool. Serving gangs are the
        allocator's SECOND gang kind ('serving'): placed, resized, and
        preempted through the same Decision machinery as training gangs,
        so replicas and worker lanes contend for one device pool.
        Answers {"granted": n replicas}.

        Policy: serving gangs never park. A fleet that cannot grow NOW
        is granted 0 and retries on its next autoscale tick (its SLO
        pressure re-asks every second), so a 'queue' decision is
        released immediately instead of holding the line against
        training arrivals."""
        body = req.body or {}
        model_id = body.get("model_id") or body.get("model")
        if not model_id:
            raise InvalidArgsError("model_id required")
        try:
            replicas = int(body.get("replicas", 1))
            lanes_per = max(1, int(body.get("lanes_per_replica", 1)))
            priority = int(body.get("priority", 0))
        except (TypeError, ValueError) as e:
            raise InvalidArgsError(f"bad serve resize request: {e}")
        tenant = body.get("tenant") or ""
        if self.allocator is None:
            # standalone scheduler: no pool to arbitrate — fail open so
            # serving elasticity never stalls on deployment shape
            return {"granted": max(0, replicas)}
        job_id = f"serve:{model_id}"
        if replicas <= 0:
            # fleet drained to zero (idle budget / preemption): its
            # lanes free now and may grant parked training work
            self._apply_decisions(self.allocator.release(job_id))
            self._push_cluster_state()
            return {"granted": 0}
        lanes = replicas * lanes_per
        cur = self.allocator.running_lanes(job_id)
        if cur is None:
            decisions = self.allocator.submit(
                job_id, tenant=tenant, priority=priority, lanes=lanes,
                kind="serving")
            placed = next((d.lanes for d in decisions
                           if d.action == "place"
                           and d.job_id == job_id), 0)
            # the serve gang's own place/queue need no task dispatch;
            # everything else (preempts it triggered, grants unlocked
            # elsewhere) applies normally
            self._apply_decisions(
                [d for d in decisions
                 if not (d.job_id == job_id
                         and d.action in ("place", "queue"))])
            if placed == 0:
                # never park: give the reservation back right away
                self._apply_decisions(self.allocator.release(job_id))
            self._push_cluster_state()
            return {"granted": placed // lanes_per}
        decisions = self.allocator.resize(job_id, lanes)
        granted = decisions[0].lanes
        self._apply_decisions(decisions)
        self._push_cluster_state()
        return {"granted": granted // lanes_per}

    # ----------------------------------------------------------------- loop

    def _defer_delay(self, n: int) -> float:
        """Capped exponential backoff for the n-th consecutive deferral,
        with +/-25% jitter from the injectable RNG so tasks deferred in
        the same sweep don't re-arrive as a synchronized burst."""
        return min(DEFER_CAP_S, DEFER_BASE_S * (2 ** n)) \
            * (0.75 + 0.5 * self._rng.random())

    def _schedule_loop(self):
        while not self._stop.is_set():
            # re-admit ripe deferred tasks
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
                if e.status_code == 503:
                    # no capacity (e.g. every device partition leased):
                    # the task goes BACK on the queue and retries once
                    # capacity frees — dropping it would strand the
                    # client's job id forever. The policy forgets the
                    # task first: it never started, so the retry must
                    # take the is_new /start path again, not /update
                    logger.info("task %s deferred (%s); requeueing",
                                task.job_id, e.message)
                    self.policy.task_finished(task.job_id)
                    # park THIS task with a not-before backoff; other
                    # queued tasks keep dispatching at full rate (an
                    # inline sleep here would stall the whole loop)
                    n = self._defer_counts.get(task.job_id, 0)
                    self._defer_counts[task.job_id] = n + 1
                    delay = self._defer_delay(n)
                    with self._defer_lock:
                        self._deferred.append(
                            (time.monotonic() + delay, task))
                else:
                    logger.exception("scheduling task %s failed",
                                     task.job_id)
            except Exception:
                logger.exception("scheduling task %s failed", task.job_id)

    def _schedule(self, task: TrainTask):
        if self.allocator is not None:
            self._schedule_cluster(task)
            return
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

    # -------------------------------------------------------- cluster mode

    def _schedule_cluster(self, task: TrainTask):
        """One queue pass in cluster mode. Three cases:

        - the allocator already granted this task lanes ('place'
          decision re-pushed it): prime the advisor and /start with the
          granted gang width;
        - a RUNNING job asked to re-parallelize (the advisor knows it):
          the advisor's width goes through allocator.resize, which may
          clamp it to quota/free lanes;
        - a fresh arrival: the advisor's requested width becomes the
          gang ask; the allocator places it atomically, parks it, or
          preempts cheaper work to make room. A parked task leaves the
          policy cache so its eventual grant takes the /start path."""
        job_id = task.job_id
        with self._cluster_lock:
            granted = self._granted.pop(job_id, None)
        if granted is not None:
            lanes, epoch = granted
            # prime the advisor (first call caches the reference slot)
            # but dispatch at the allocator's width, not the advisor's
            self.policy.calculate_parallelism(task)
            task.parallelism = lanes
            task.grant_epoch = epoch
            if self.ps_url is None:
                logger.warning("no PS configured; dropping task %s", job_id)
                return
            logger.info("starting task %s with %d allocator-granted "
                        "lane(s) (fencing epoch %d)", job_id, lanes, epoch)
            try:
                http_json("POST", f"{self.ps_url}/start", task.to_dict(),
                          trace_id=task.trace_id or None)
            except KubeMLException as e:
                if e.status_code == 503:
                    # true pool exhaustion at the PS (e.g. partitions
                    # narrower than the lane pool): give the lanes back
                    # before the generic defer path parks the task
                    self._apply_decisions(self.allocator.release(job_id))
                raise
            self._push_cluster_state()
            return
        parallelism, is_new = self.policy.calculate_parallelism(task)
        if not is_new:
            decisions = self.allocator.resize(job_id, parallelism)
            lanes = next((d.lanes for d in decisions
                          if d.action == "resize"), parallelism)
            task.parallelism = lanes
            if self.ps_url is not None:
                logger.info("updating task %s to %d lane(s) (advisor "
                            "asked %d)", job_id, lanes, parallelism)
                http_json("POST", f"{self.ps_url}/update/{job_id}",
                          {"parallelism": lanes},
                          trace_id=task.trace_id or None)
            self._apply_decisions(decisions)
            self._push_cluster_state()
            return
        # fresh arrival: forget the advisor's priming — the granted
        # dispatch above re-primes, so it still takes the /start path
        self.policy.task_finished(job_id)
        with self._cluster_lock:
            self._parked[job_id] = task
        self._track(task, "parked")
        ask = parallelism or task.parameters.options.default_parallelism
        self._apply_decisions(self.allocator.submit(
            job_id, tenant=task.tenant, priority=task.priority,
            lanes=ask))
        self._push_cluster_state()

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

    def _cluster_instant(self, d: Decision) -> None:
        """Allocator decisions land on the decided job's own timeline as
        instant events (cluster_place / cluster_queue / cluster_preempt
        / cluster_resize), so a merged trace answers WHY a job sat
        between its enqueue span and first epoch — parked behind quota,
        waiting on a preemption, or clamped on resize."""
        args = {"lanes": d.lanes, "path": d.path, "detail": d.detail}
        if d.victim:
            args["victim"] = d.victim
        self._job_tracer(d.job_id).instant(f"cluster_{d.action}", **args)
        self._flush_job_trace(d.job_id)

    def _apply_decisions(self, decisions: List[Decision]):
        """Apply allocator decisions: 'place' re-pushes the parked task
        through the queue with its granted lanes; 'preempt' asks the PS
        to SIGTERM the victim (it drains, checkpoints, and requeues
        through POST /requeue without consuming max_restarts; a
        serve:<model> fleet drains to zero and its lanes free here);
        'queue' and 'resize' need no dispatch action, but every decision
        is recorded on the job's trace timeline (_cluster_instant)."""
        for d in decisions:
            self._cluster_instant(d)
            if d.action == "place":
                with self._cluster_lock:
                    task = self._parked.pop(d.job_id, None)
                    if task is not None:
                        self._granted[d.job_id] = (d.lanes, d.epoch)
                        self._track(task, "granted", d.lanes, d.epoch)
                if task is None:
                    # finished/aborted while parked: give the lanes
                    # back, and apply any grants they unlock in turn
                    self._apply_decisions(
                        self.allocator.release(d.job_id))
                    continue
                logger.info("allocator placed %s: %d lane(s) [%s] %s",
                            d.job_id, d.lanes, d.path, d.detail)
                self.queue.push(task)
            elif d.action == "preempt":
                logger.warning("allocator preempting %s for %s [%s] %s",
                               d.victim, d.job_id, d.path, d.detail)
                if self.ps_url is not None:
                    try:
                        http_json("POST",
                                  f"{self.ps_url}/preempt/{d.victim}")
                    except KubeMLException as e:
                        # victim already gone (finish raced the
                        # decision): its release path frees the lanes
                        # either way
                        logger.warning("preempt of %s failed: %s",
                                       d.victim, e.message)
                if d.victim.startswith("serve:"):
                    # serving victims have no /requeue round-trip: the
                    # PS scaled the fleet to zero synchronously (it
                    # cold-starts again on its next request), so the
                    # lanes free here, not on a process exit
                    self._apply_decisions(
                        self.allocator.release(d.victim))

    def _push_cluster_state(self, extra: Optional[dict] = None):
        """Feed the allocator snapshot to the PS: Prometheus gauges
        (POST /cluster) + the health pipeline under the `cluster`
        pseudo job id, which `kubeml top --id cluster` renders."""
        if self.allocator is None or self.ps_url is None:
            return
        snap = self.allocator.snapshot()
        if extra:
            snap.update(extra)
        try:
            http_json("POST", f"{self.ps_url}/cluster", snap)
        except KubeMLException as e:
            logger.warning("cluster state push failed: %s", e.message)

    # ------------------------------------------------------------- recovery

    def _probe_ps_tasks(self) -> List[dict]:
        """Ask the PS which jobserver children are still alive (GET
        /tasks lists every registered job). Bounded retry with jittered
        backoff: recovery typically races the PS's own restart."""
        if self.ps_url is None:
            return []
        delay = 0.1
        for attempt in range(5):
            try:
                return http_json("GET", f"{self.ps_url}/tasks") or []
            except KubeMLException as e:
                if attempt == 4:
                    logger.warning("PS task probe failed after %d "
                                   "attempts: %s — treating every "
                                   "granted job as dead", attempt + 1,
                                   e.message)
                    return []
                time.sleep(delay * (0.5 + self._rng.random() / 2))
                delay = min(delay * 2, 1.0)
        return []

    def recover(self, ps_tasks: Optional[List[dict]] = None) -> dict:
        """Rebuild a restarted scheduler from the durable state file +
        the allocator's replayed journal. For each persisted task:

        - granted + its jobserver child still alive on the PS: RE-ADOPT
          it — re-grant at the journaled width under the new fencing
          epoch (allocator.regrant), prime the advisor so the child's
          next /job ask takes the resize path (never a double /start),
          and push the new epoch to the live child via PS /update;
        - granted + child dead: release the lanes and requeue as a
          fresh arrival WITHOUT consuming max_restarts (resume_from
          points at its own checkpoint when one exists);
        - parked / queued: re-park behind the replayed allocator state
          or re-push onto the queue.

        `ps_tasks` is injectable for tests; None probes GET /tasks.
        Ends with the journal round-trip self-check (the recovered
        allocator must equal a second replay of its own journal) and a
        cluster-state push carrying the recovery duration."""
        t0 = time.monotonic()
        state = read_json(self._state_path) if self._state_path else None
        entries = (state or {}).get("tasks", {})
        summary = {"adopted": [], "requeued": [], "parked": [],
                   "queued": []}
        if self.allocator is not None:
            summary["fencing_epoch"] = self.allocator.mark_recovered()
        if ps_tasks is None:
            ps_tasks = self._probe_ps_tasks()
        live = {t.get("job_id") or t.get("id") for t in ps_tasks}
        for job_id in sorted(entries):
            ent = entries[job_id]
            task = TrainTask.from_dict(ent["task"])
            phase = ent.get("phase", "queued")
            if phase == "granted" and self.allocator is not None:
                regrant = self.allocator.regrant(job_id) \
                    if job_id in live else None
                if regrant is not None:
                    lanes, epoch = regrant
                    task.parallelism = lanes
                    task.grant_epoch = epoch
                    task.state = "running"
                    # prime the advisor: the child is RUNNING, so its
                    # next /job ask must take the resize path, not a
                    # double /start
                    self.policy.calculate_parallelism(task)
                    with self._cluster_lock:
                        self._submitted[job_id] = {
                            "task": task.to_dict(), "phase": "granted",
                            "lanes": lanes, "epoch": epoch}
                    if self.ps_url is not None:
                        try:
                            http_json(
                                "POST",
                                f"{self.ps_url}/update/{job_id}",
                                {"parallelism": lanes,
                                 "grant_epoch": epoch})
                        except KubeMLException as e:
                            logger.warning(
                                "epoch push to adopted job %s failed: "
                                "%s", job_id, e.message)
                    summary["adopted"].append(job_id)
                    logger.warning("re-adopted running job %s at %d "
                                   "lane(s), fencing epoch %d", job_id,
                                   lanes, epoch)
                    continue
                # child is dead (or the allocator lost the grant):
                # free the lanes and requeue budget-free — the same
                # transformation as a preemption requeue
                self._apply_decisions(self.allocator.release(job_id))
                self.policy.task_finished(job_id)
                task.state = "queued"
                task.elapsed_time_s = -1.0
                task.grant_epoch = 0
                if not task.parameters.resume_from:
                    try:
                        from kubeml_tpu_torch.train.checkpoint import \
                            checkpoint_saved_at
                        if checkpoint_saved_at(job_id) is not None:
                            task.parameters.resume_from = job_id
                    except Exception:
                        pass
                self._track(task, "queued")
                self.queue.push(task)
                summary["requeued"].append(job_id)
                logger.warning("granted job %s died with the control "
                               "plane; requeued without consuming "
                               "max_restarts", job_id)
                continue
            if phase == "parked" and self.allocator is not None and \
                    job_id in self.allocator.pending_jobs():
                with self._cluster_lock:
                    self._parked[job_id] = task
                summary["parked"].append(job_id)
                continue
            # queued — or parked but unknown to the replayed allocator
            # (journal predates the park): re-enter as a fresh arrival
            task.state = "queued"
            task.grant_epoch = 0
            self._track(task, "queued")
            self.queue.push(task)
            summary["queued"].append(job_id)
        # self-check: the recovered allocator must be reconstructible
        # from its own journal — divergence here means the journal and
        # the live state have forked, and raises JournalCorruptError
        if self.allocator is not None and \
                getattr(self.allocator, "_journal", None) is not None:
            verify_journal_roundtrip(self.allocator)
        if self._state_path is not None:
            with self._cluster_lock:
                self._persist_locked()
        self.last_recovery_s = time.monotonic() - t0
        self.recoveries += 1
        summary["recovery_s"] = self.last_recovery_s
        self._push_cluster_state(
            extra={"control_recovery_s": self.last_recovery_s,
                   "control_role": "scheduler"})
        logger.warning(
            "scheduler recovered in %.3fs: %d adopted, %d requeued, "
            "%d parked, %d queued", self.last_recovery_s,
            len(summary["adopted"]), len(summary["requeued"]),
            len(summary["parked"]), len(summary["queued"]))
        return summary
