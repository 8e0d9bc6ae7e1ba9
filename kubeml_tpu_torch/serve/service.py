"""The serving loop: admission control in front, the decode engine behind
(twin of kubeml_tpu/serve/service.py).

One background thread per served model owns the engine (slot state and
the paged programs are single-threaded by design); submitting threads
only enqueue validated requests and drain event queues. Admission is
counted with one in-flight counter under the condition variable —
capacity = slots + queue cap — so the 429 decision is deterministic.

Fault tolerance: a step that raises is bisected (the failed step is
retried with suspect streams masked, and only the request that poisons
it is quarantined); a watchdog thread rebuilds the engine when the loop
dies or wedges and resumes the streams in flight; drain() closes
admission (503) while streams finish. Bisection isolates exceptions
raised on the host; a device fault that poisons the CUDA context is not
caught (ROADMAP C).

Telemetry: per-request TTFT/TPOT/e2e land in windowed sketches and the
serve histogram families (metrics/prom.py), finished requests are
classified good/bad against the SLO objectives the fleet stamps on the
replica, and every loop pass publishes a snapshot under the pseudo job id
``serve:<model>`` (the health rules and ``kubeml top`` read it), with the
engine's cost-ledger snapshot (``serve_cost_programs``) that ``GET /cost``
and the kubeml_cost_* counters read.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Deque, List, Optional

from kubeml_tpu_torch.metrics.sketch import WindowedSketch
from kubeml_tpu_torch.models.base import InferenceInputError
from kubeml_tpu_torch.serve.engine import DecodeEngine
from kubeml_tpu_torch.serve.slots import (GenerateRequest, ServeDraining,
                                          ServeSaturated)

logger = logging.getLogger("kubeml_tpu_torch.serve.service")

# step-exception bisection: how many suspect lanes a failed step is
# retried against before every active stream fails
BISECT_MAX_SUSPECTS = 8

# recent-window size for the TTFT-breakdown means `kubeml top` shows
TTFT_WINDOW = 128

# latency sketches: windowed log-bucket sketches on the service clock,
# which the fleet merges exactly across replicas
SKETCH_WINDOW_S = 60.0
SKETCH_SUBWINDOWS = 6

# unforced trace flushes batch this many events: the sink rewrites the
# whole file per write. Forced flushes (stop, eject, flight snapshots,
# flush_trace()) write at once.
TRACE_FLUSH_EVERY = 256

# Retry-After sizing for the prefill backlog: a conservative prompt
# loading rate. The hint only needs the right order of magnitude.
PREFILL_DRAIN_TOKENS_PER_S = 256.0


class ServeService:
    """Continuous-batching serving loop for one model. The engine carries
    the device (``DecodeEngine(device=None)`` means CUDA)."""

    def __init__(self, model_id: str, engine: DecodeEngine,
                 max_queue: int = 16, metrics=None,
                 health_cb: Optional[Callable[[dict], None]] = None,
                 clock=time.perf_counter, tracer=None, trace_sink=None,
                 wedge_timeout_s: float = 30.0,
                 watchdog_interval_s: float = 0.25,
                 supervise: bool = True):
        self.model_id = model_id
        self.engine = engine
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self.health_cb = health_cb
        self.clock = clock
        # a fleet publishes ONE merged gauge set per model, so it turns
        # its replicas' per-model gauges off; per-request counters and
        # histograms add up across replicas either way
        self.publish_state_gauges = True
        # the tracer records on this service's clock (shared with the
        # engine); each request's trace_id rides in span args
        self.tracer = tracer
        self.trace_sink = trace_sink
        if tracer is not None and getattr(engine, "tracer", None) is None:
            engine.tracer = tracer
        self._events_flushed = 0
        self._trace_dirty = False
        # shed-onset detection for the flight auto-snapshot
        self._shed_total = 0
        self._shed_seen = 0
        self._shed_episode = False
        self._cv = threading.Condition()
        self._pending: Deque[GenerateRequest] = collections.deque()
        self._inflight = 0          # admitted, not yet terminal
        self._stopped = False
        self._draining = False      # admission -> 503, streams drain
        # a KILLED replica (fleet_replica_crash, ejection) exits its loop
        # WITHOUT the drain tail and its watchdog stands down: in-flight
        # state stays for the fleet to harvest (eject_streams)
        self._killed = False
        # supervisor: the loop beats at the top of every round; the
        # watchdog declares a wedge when the beat goes stale with work in
        # flight while the loop is outside engine.step(), or when the
        # loop thread died
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.supervise = bool(supervise)
        self._beat = self.clock()
        self._stepping = False
        self.restarts_total = 0
        self.poisoned_total = 0
        self.deadline_total = 0
        # (variables, stamp) awaiting install by the loop thread: weight
        # swaps marshal through here, never touching the engine from
        # another thread
        self._pending_weights: Optional[tuple] = None
        self.weight_stamp: Optional[float] = None
        self.rejected_total = 0
        self._counters_seen: dict = {}   # engine stat -> last published
        self._sketches = {
            kind: WindowedSketch(window_s=SKETCH_WINDOW_S,
                                 subwindows=SKETCH_SUBWINDOWS,
                                 clock=self.clock)
            for kind in ("ttft", "tpot", "e2e")}
        # SLO objectives (seconds; 0 = none), stamped by the fleet
        self.slo_ttft_s = 0.0
        self.slo_tpot_s = 0.0
        self.slo_good_total = 0
        self.slo_bad_total = 0
        self._breakdowns: Deque[dict] = collections.deque(
            maxlen=TTFT_WINDOW)
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-{model_id}", daemon=True)
        self._watchdog_thread = threading.Thread(
            target=self._watchdog, name=f"serve-watchdog-{model_id}",
            daemon=True)
        self._started = False

    # -------------------------------------------------------------- clients
    def start(self) -> "ServeService":
        self._started = True
        self._thread.start()
        if self.supervise:
            self._watchdog_thread.start()
        return self

    def _shed_retry_s(self) -> float:
        """The Retry-After of a shed (cv held): the prefill backlog a
        retrying client queues behind."""
        return 1.0 + self._backlog_tokens() / PREFILL_DRAIN_TOKENS_PER_S

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               trace_id: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> GenerateRequest:
        """Admit a request or shed it. Raises InferenceInputError (400)
        on a bad prompt or deadline, ServeSaturated (429) at capacity or
        when the deadline is infeasible against the current backlog,
        ServeDraining (503) while draining."""
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
            except (TypeError, ValueError) as e:
                raise InferenceInputError(
                    f"deadline_ms must be a number of milliseconds: "
                    f"{e}") from e
            if not 0 < deadline_ms < float("inf"):
                raise InferenceInputError(
                    f"deadline_ms must be a positive finite number of "
                    f"milliseconds, got {deadline_ms!r}")
        req = GenerateRequest(prompt, max_new_tokens=max_new_tokens,
                              temperature=temperature, seed=seed,
                              eos_id=eos_id, trace_id=trace_id,
                              deadline_ms=deadline_ms)
        # validate on the submitting thread: bad input must 400 before it
        # costs a slot (also strips trailing pads)
        req.prompt = self.engine.check_admissible(req.prompt,
                                                  req.max_new_tokens)
        with self._cv:
            if self._stopped or self._killed:
                raise ServeSaturated(message="serving loop stopped")
            if self._draining:
                raise ServeDraining(retry_after_s=self._shed_retry_s())
            if req.deadline_ms is not None:
                wait_s = self._backlog_tokens() / PREFILL_DRAIN_TOKENS_PER_S
                if req.deadline_ms / 1000.0 <= wait_s:
                    # the queued prompt work alone outlasts the deadline
                    self.rejected_total += 1
                    self._note_outcome("rejected")
                    raise ServeSaturated(
                        retry_after_s=1.0 + wait_s,
                        message=f"deadline_ms={req.deadline_ms:g} is "
                                f"infeasible: ~{wait_s:.2f}s of prompt "
                                f"backlog is queued ahead of admission")
            if self._inflight >= self.capacity:
                self.rejected_total += 1
                self._note_outcome("rejected")
                # an admission shed never reaches a slot: its terminal
                # instant is emitted here
                if self.tracer is not None:
                    args = {"reason": "saturated", "rid": req.rid}
                    if req.trace_id:
                        args["trace_id"] = req.trace_id
                    self.tracer.instant("shed", ts=self.clock(), **args)
                self._note_shed()
                raise ServeSaturated(retry_after_s=self._shed_retry_s())
            self._inflight += 1
            req.submitted_at = self.clock()
            if req.deadline_ms is not None:
                req.deadline_at = req.submitted_at + req.deadline_ms / 1000.0
            self._pending.append(req)
            self._cv.notify()
        return req

    def cancel(self, req: GenerateRequest) -> None:
        req.cancel()
        with self._cv:
            self._cv.notify()

    def install_weights(self, variables, stamp: Optional[float] = None
                        ) -> None:
        """Queue a zero-downtime weight swap (a module state dict). Any
        thread may call; the loop thread applies it before its next
        admissions, so attached streams finish on their weights while
        later admissions decode the new generation."""
        with self._cv:
            if self._stopped:
                return
            self._pending_weights = (variables, stamp)
            self._cv.notify()

    # ------------------------------------------------- fleet router hooks
    # Lock-free reads for the fleet router: they run with the fleet's
    # lock held, and the only legal lock order is replica _cv -> fleet
    # lock, so they never take _cv. A stale read costs a routed request
    # at most a spill or a retry.
    @property
    def capacity(self) -> int:
        """Admission capacity: decode slots plus the queue cap."""
        return self.engine.slot_count + self.max_queue

    @property
    def inflight(self) -> int:
        """Requests admitted but not yet terminal (racy read)."""
        return self._inflight

    def would_admit(self) -> bool:
        """Whether submit() would (probably) admit right now."""
        return (not self._stopped and not self._killed
                and not self._draining and self._inflight < self.capacity)

    @property
    def failed(self) -> bool:
        """The fleet supervisor's replica-death signal: killed outright,
        or the loop thread gone with no watchdog to resurrect it."""
        if not self._started or self._stopped:
            return False
        if self._killed:
            return True
        return not self.supervise and not self._thread.is_alive()

    def estimated_retry_after_s(self) -> float:
        """The Retry-After submit() would give a shed right now (the
        fleet surfaces the minimum across replicas)."""
        try:
            queued = sum(max(0, len(r.prompt) - 1)
                         for r in list(self._pending))
        except RuntimeError:        # deque mutated mid-iteration
            queued = 0
        backlog = self.engine.prefill_backlog_tokens() + queued
        return 1.0 + backlog / PREFILL_DRAIN_TOKENS_PER_S

    def drain(self, grace_s: float) -> bool:
        """Graceful drain: admission answers 503 (ServeDraining), then
        wait up to ``grace_s`` for every stream in flight to end. True
        when it drained in time; False means the caller proceeds to a
        hard stop."""
        with self._cv:
            if self._stopped or self._killed:
                return self._inflight == 0
            if not self._draining:
                self._draining = True
                if self.tracer is not None:
                    self.tracer.instant("drain", ts=self.clock(),
                                        grace_s=float(grace_s))
                    self._trace_dirty = True
                logger.info("model %s draining: admission closed, grace "
                            "budget %.1fs", self.model_id, float(grace_s))
            self._cv.notify_all()
        deadline = self.clock() + float(grace_s)
        while self.clock() < deadline:
            with self._cv:
                if self._inflight == 0:
                    return True
            time.sleep(0.005)
        with self._cv:
            return self._inflight == 0

    def stop(self, timeout: float = 10.0, grace_s: float = 0.0) -> None:
        """Stop the loop; with grace_s > 0 drain first. Streams still in
        flight then end with an error."""
        if grace_s > 0:
            self.drain(grace_s)
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout)

    # ------------------------------------------------- fleet failure domain
    def kill(self, reason: str = "killed") -> None:
        """Abrupt replica death (fleet_replica_crash, forced teardown):
        the engine is abandoned, the loop exits WITHOUT the drain tail and
        the watchdog stands down; queued and attached streams stay for
        the fleet's eject_streams(). A standalone service calls stop()."""
        with self._cv:
            if self._stopped or self._killed:
                return
            self._killed = True
            self.engine.abandon()
            logger.error("model %s: replica killed (%s); streams in "
                         "flight await fleet ejection", self.model_id,
                         reason)
            self._cv.notify_all()

    def force_restart(self, reason: str) -> int:
        """One real supervisor recovery from outside the watchdog
        (fleet_replica_wedge, tests). Returns the new restarts_total."""
        with self._cv:
            if not self._stopped and not self._killed:
                self._recover(reason)
            return self.restarts_total

    def eject_streams(self) -> List[GenerateRequest]:
        """Forced teardown for fleet ejection: abandon the engine,
        evacuate every non-terminal stream (pages freed under the pager
        audit, the request left open with resume_gen pinned) and mark the
        service dead. Returns the evacuated requests in admission order:
        attached slots by seq, then the queue FIFO."""
        with self._cv:
            engine = self.engine
            engine.abandon()
            self._killed = True
            self._cv.notify_all()
            # the loop may be mid-step on this engine: wait for the step
            # to account itself before touching slot state (bounded: a
            # thread that died mid-step never clears _stepping)
            deadline = time.monotonic() + 5.0
            while self._stepping and time.monotonic() < deadline:
                self._cv.wait(0.05)
            harvested = []
            for s in range(engine.slot_count):
                slot = engine._slots[s]
                if slot is None:
                    continue
                req = slot.req
                req.resume_gen = slot.gen
                seq = slot.seq
                engine.evacuate(s)
                if req.outcome is None and not req.cancelled:
                    harvested.append((seq, req))
                elif req.outcome is None:
                    req.finish("cancelled")   # the client walked away
            harvested.sort(key=lambda t: t[0])
            out = [req for _, req in harvested]
            while self._pending:
                r = self._pending.popleft()
                if r.outcome is None and not r.cancelled:
                    out.append(r)
                elif r.outcome is None:
                    r.finish("cancelled")
            self._inflight = 0
            self._stopped = True     # the watchdog stands down
            self._cv.notify_all()
        return out

    def adopt(self, req: GenerateRequest) -> GenerateRequest:
        """Admit an EXISTING request (fleet migration or hedge). It may
        carry emitted tokens; attach() resumes it. Sheds like submit();
        submitted_at and deadline_at are kept (a migration does not reset
        the client's clock)."""
        with self._cv:
            if self._stopped or self._killed:
                raise ServeSaturated(message="serving loop stopped")
            if self._draining:
                raise ServeDraining(retry_after_s=self._shed_retry_s())
            if self._inflight >= self.capacity:
                self.rejected_total += 1
                self._note_outcome("rejected")
                self._note_shed()
                raise ServeSaturated(retry_after_s=self._shed_retry_s())
            self._inflight += 1
            if req.submitted_at is None:
                req.submitted_at = self.clock()
            self._pending.append(req)
            self._cv.notify()
        return req

    def steal_pending(self, req: GenerateRequest) -> bool:
        """Withdraw a still-QUEUED request (fleet hedge). Attached streams
        are not stealable: only ejection moves another replica's slot
        state. False when the request attached, finished or was never
        here."""
        with self._cv:
            try:
                self._pending.remove(req)
            except ValueError:
                return False
            self._inflight = max(0, self._inflight - 1)
            return True

    # ----------------------------------------------------------------- loop
    def _exit_abandoned(self, engine: DecodeEngine) -> None:
        """(cv held) this loop thread no longer drives the service: free
        the abandoned engine's slab as the last thread that held it
        leaves."""
        engine.drop_slab()
        self._cv.notify_all()

    def _loop(self) -> None:
        # pin the engine this thread owns: after a recovery self.engine is
        # a replacement driven by a new thread, and this one must exit
        engine = self.engine
        while True:
            with self._cv:
                if self.engine is not engine or self._killed:
                    self._exit_abandoned(engine)
                    return
                self._beat = self.clock()
                while not self._stopped and not self._killed \
                        and not self._pending \
                        and self._pending_weights is None \
                        and engine.active() == 0:
                    self._publish()
                    self._cv.wait()
                    self._beat = self.clock()
                    if self.engine is not engine or self._killed:
                        self._exit_abandoned(engine)
                        return
                if self._stopped:
                    break
                if self._pending_weights is not None:
                    # the swap lands before this round's admissions:
                    # queued requests attach to the NEW generation
                    variables, stamp = self._pending_weights
                    self._pending_weights = None
                    gen = engine.install_weights(variables)
                    self.weight_stamp = stamp
                    logger.info("model %s hot-swapped to weight generation "
                                "%d", self.model_id, gen)
                # queued requests can expire before a slot frees
                if any(r.deadline_at is not None for r in self._pending):
                    now = self.clock()
                    keep: Deque[GenerateRequest] = collections.deque()
                    while self._pending:
                        r = self._pending.popleft()
                        if r.deadline_at is not None and now >= r.deadline_at:
                            self._terminal(
                                r, "deadline",
                                f"deadline of {r.deadline_ms:g}ms exceeded "
                                f"before a slot was free")
                        else:
                            keep.append(r)
                    self._pending = keep
                while self._pending and engine.free_slots() > 0:
                    req = self._pending.popleft()
                    if req.cancelled:
                        self._terminal(req, "cancelled")
                        continue
                    try:
                        engine.attach(req)
                    except Exception as e:  # noqa: BLE001 — fail the request
                        self._terminal(req, "error", str(e))
                self._stepping = True
            try:
                finished = engine.step()
            except Exception as e:  # noqa: BLE001 — isolate the poisoner
                finished = self._bisect_step_failure(engine, e)
            with self._cv:
                self._stepping = False
                if self.engine is not engine:
                    # recovery swapped the engine mid-step: these requests
                    # belong to state the supervisor already requeued
                    self._exit_abandoned(engine)
                    return
                for req in finished:
                    self._terminal(req, None)
                if self._killed:
                    self._exit_abandoned(engine)
                    return
            self._publish()
            # deterministic wedge injection after the publish: spins until
            # the supervisor abandons this engine
            plan = engine.fault_plan
            if plan is not None and plan.maybe_wedge(engine):
                continue
        # stopped: fail whatever is left so no client hangs
        msg = "drained: grace budget exhausted" if self._draining \
            else "serving loop stopped"
        with self._cv:
            while self._pending:
                self._terminal(self._pending.popleft(), "error", msg)
            for s in range(engine.slot_count):
                slot = engine._slots[s]
                if slot is not None:
                    req = slot.req
                    engine.release(s, "error", msg)
                    self._terminal(req, None)
        self._publish()

    def _bisect_step_failure(self, engine: DecodeEngine,
                             exc: Exception) -> List[GenerateRequest]:
        """A step raised. Retry it with one suspect stream masked at a
        time (newest admission first). If a retry succeeds, the masked
        request poisons the step: quarantine it (terminal error) and
        return the retry's finished list; the other streams never notice.
        The engine's fault hooks run before any page mutation, so every
        retry starts from the same state. If no single stream explains
        the failure, every active stream fails."""
        suspects = []
        with self._cv:
            for s in range(engine.slot_count):
                slot = engine._slots[s]
                if slot is not None:
                    suspects.append((slot.seq, s, slot.req))
        suspects.sort(key=lambda t: t[0], reverse=True)
        for _, _, req in suspects[:BISECT_MAX_SUSPECTS]:
            try:
                finished = engine.step(exclude=frozenset([req.rid]))
            except Exception:  # noqa: BLE001 — try the next suspect
                continue
            with self._cv:
                for s in range(engine.slot_count):
                    slot = engine._slots[s]
                    if slot is not None and slot.req is req:
                        engine.release(
                            s, "error",
                            f"request poisoned the decode step and was "
                            f"quarantined: {exc}")
                        break
            logger.warning("model %s: step exception isolated to request "
                           "%s; quarantined (%s)", self.model_id, req.rid,
                           exc)
            finished.append(req)
            return finished
        logger.error("model %s: decode step failed and no single stream "
                     "explains it; failing the streams in flight: %r",
                     self.model_id, exc)
        with self._cv:
            for s in range(engine.slot_count):
                slot = engine._slots[s]
                if slot is not None:
                    req = slot.req
                    engine.release(s, "error", f"decode step failed: {exc}")
                    self._terminal(req, None)
        return []

    # ------------------------------------------------------------ supervisor
    def _watchdog(self) -> None:
        """Detect a dead or wedged loop and recover. DEAD: the loop
        thread exited with work in flight. WEDGED: the beat is stale past
        wedge_timeout_s with work in flight while the loop is outside
        engine.step() (a first call there may take seconds of kernel
        build and cuBLAS start, which is not a hang)."""
        while True:
            time.sleep(self.watchdog_interval_s)
            with self._cv:
                if self._stopped or self._killed:
                    return
                thread_dead = not self._thread.is_alive()
                stale = self._inflight > 0 and not self._stepping and \
                    (self.clock() - self._beat) > self.wedge_timeout_s
                if not thread_dead and not stale:
                    continue
                self._recover("loop thread died" if thread_dead
                              else "loop wedged past timeout")

    def _recover(self, reason: str) -> None:
        """Rebuild the engine and resume the streams in flight (cv held).
        The old engine is abandoned (a wedged thread that wakes cannot
        double-drive it), its non-terminal slots are requeued at the
        front in admission order with resume_gen pinned, and a fresh
        engine and loop thread take over. The old slab is freed when its
        thread exits."""
        if self._stopped or self._killed:
            return
        old = self.engine
        old.abandon()
        # the black box first: recovery resets the step counter
        self.flight_snapshot(f"engine_restart:{reason}")
        resumed = []
        for s in range(old.slot_count):
            slot = old._slots[s]
            if slot is not None and slot.req.outcome is None:
                slot.req.resume_gen = slot.gen
                resumed.append((slot.seq, slot.req))
        resumed.sort(key=lambda t: t[0])
        for _, req in reversed(resumed):
            self._pending.appendleft(req)
        # requests the dead loop finished but never accounted would leak
        # the counter forever
        self._inflight = len(self._pending)
        self.engine = old.spawn_recovered()
        self._counters_seen = {}
        self.restarts_total += 1
        if self.metrics is not None:
            self.metrics.note_serve_engine_restart(self.model_id)
        if self.tracer is not None:
            self.tracer.instant("engine_restart", ts=self.clock(),
                                reason=reason, resumed=len(resumed))
            self._trace_dirty = True
        logger.error("model %s: serving engine restarted (%s); resuming %d "
                     "stream(s)", self.model_id, reason, len(resumed))
        self._beat = self.clock()
        self._stepping = False
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-{self.model_id}", daemon=True)
        self._thread.start()
        self._cv.notify_all()

    def _terminal(self, req: GenerateRequest, outcome: Optional[str],
                  error: Optional[str] = None) -> None:
        """Account one request reaching a terminal state (cv held).
        outcome None means the engine already called req.finish()."""
        if outcome is not None:
            if req.finished_at is None:
                req.finished_at = self.clock()
            req.finish(outcome, error)
            # the engine never saw this request: its terminal instant
            self._request_instant(req, outcome, error)
        self._inflight = max(0, self._inflight - 1)
        if req.outcome == "error" and req.error and "shed" in req.error:
            self._note_shed()   # engine-side KV-exhaustion shed
        if req.outcome == "deadline":
            self.deadline_total += 1
        if req.outcome == "error" and req.error \
                and "poisoned" in req.error:
            # the non-finite guard and the bisection both land here
            self.poisoned_total += 1
            if self.metrics is not None:
                self.metrics.note_serve_poisoned(self.model_id)
        if self.tracer is not None and req.submitted_at is not None \
                and req.finished_at is not None:
            # root span of the request tree
            args = {"rid": req.rid, "outcome": req.outcome or "error",
                    "tokens": len(req.tokens)}
            if req.trace_id:
                args["trace_id"] = req.trace_id
            self.tracer.add_span("generate", req.submitted_at,
                                 req.finished_at, **args)
        self._trace_dirty = True
        self._observe(req)

    def _request_instant(self, req: GenerateRequest, outcome: str,
                         error: Optional[str]) -> None:
        if self.tracer is None:
            return
        kind = "cancel" if outcome == "cancelled" else "finish"
        args = {"rid": req.rid, "outcome": outcome,
                "tokens": len(req.tokens)}
        if error:
            args["error"] = error
        if req.trace_id:
            args["trace_id"] = req.trace_id
        self.tracer.instant(kind, ts=req.finished_at or self.clock(),
                            parent="generate", **args)

    # -------------------------------------------------- incident black box
    def _note_shed(self) -> None:
        """One request shed. The first shed after a shed-free publish
        pass is an onset: snapshot the flight ring into the trace."""
        self._shed_total += 1
        if not self._shed_episode:
            self._shed_episode = True
            self.flight_snapshot("shed_onset")

    def flight_snapshot(self, reason: str) -> None:
        """Dump the engine's flight ring into the serve trace as one
        instant, then flush the sink (shed onset, engine restart, serve
        health-rule onsets)."""
        fl = self.engine.flight
        if self.tracer is None or fl is None:
            return
        self.tracer.instant("flight_snapshot", ts=self.clock(),
                            reason=reason, total_steps=fl.total,
                            records=fl.snapshot())
        self._flush_trace(force=True)

    def flush_trace(self) -> None:
        """Force the buffered trace events to the sink (GET /trace, a
        dead replica's ejection)."""
        self._flush_trace(force=True)

    def _flush_trace(self, force: bool = False) -> None:
        if self.trace_sink is None or self.tracer is None:
            return
        n = self.tracer.event_count()
        if not force and n - self._events_flushed < TRACE_FLUSH_EVERY:
            return
        try:
            self.trace_sink.write(self.tracer)
            self._events_flushed = n
        except OSError:
            logger.exception("serve trace flush failed for %s",
                             self.model_id)

    # ------------------------------------------------------------ telemetry
    def _note_outcome(self, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.observe_serve_request(self.model_id, outcome)

    def _observe(self, req: GenerateRequest) -> None:
        self._note_outcome(req.outcome or "error")
        ttft = tpot = None
        if req.first_token_at is not None and req.submitted_at is not None:
            ttft = req.first_token_at - req.submitted_at
            self._sketches["ttft"].add(ttft)
            if req.ttft_breakdown:
                self._breakdowns.append(dict(req.ttft_breakdown))
        if req.outcome == "ok" and ttft is not None \
                and req.finished_at is not None:
            decode = req.finished_at - req.first_token_at
            tpot = decode / max(1, len(req.tokens) - 1)
            self._sketches["tpot"].add(tpot)
            self._sketches["e2e"].add(req.finished_at - req.submitted_at)
        # SLO classification: ok within the objectives is good, errors
        # and deadline misses are bad, a client cancel is neither
        if req.outcome == "ok":
            good = (self.slo_ttft_s <= 0.0 or ttft is None
                    or ttft <= self.slo_ttft_s) and \
                   (self.slo_tpot_s <= 0.0 or tpot is None
                    or tpot <= self.slo_tpot_s)
            if good:
                self.slo_good_total += 1
            else:
                self.slo_bad_total += 1
        elif req.outcome in ("error", "deadline"):
            self.slo_bad_total += 1
        if self.metrics is None:
            return
        if req.tokens:
            self.metrics.note_serve_tokens(self.model_id, len(req.tokens))
        if req.ttft_breakdown:
            self.metrics.observe_serve_ttft_breakdown(
                self.model_id, **req.ttft_breakdown)
        if req.outcome == "ok" and ttft is not None \
                and req.finished_at is not None:
            self.metrics.observe_serve_latency(
                self.model_id, ttft=ttft, tpot=tpot,
                e2e=req.finished_at - req.submitted_at)

    def ttft_percentiles(self) -> dict:
        sk = self._sketches["ttft"].merged()
        return {"p50": sk.quantile(0.50), "p99": sk.quantile(0.99)}

    def _backlog_tokens(self) -> int:
        """Prompt tokens owed before new work gets its first token:
        unfilled prompt positions in attached slots plus the prompts still
        waiting in the admission queue."""
        return self.engine.prefill_backlog_tokens() + sum(
            max(0, len(r.prompt) - 1) for r in self._pending)

    def ttft_breakdown_means(self) -> dict:
        """Recent-window mean of each additive TTFT component."""
        bd = list(self._breakdowns)
        k = max(1, len(bd))
        return {c: sum(b[c] for b in bd) / k
                for c in ("queue", "prefill", "interleave")}

    def snapshot(self) -> dict:
        """Health-pipeline sample for the serve:<model> pseudo job (the
        reference's fields)."""
        p = self.ttft_percentiles()
        bd = self.ttft_breakdown_means()
        st = self.engine.stats
        hits, misses = st["prefix_hits"], st["prefix_misses"]
        return {
            "job_id": f"serve:{self.model_id}",
            "serve_active_slots": self.engine.active(),
            "serve_slot_cap": self.engine.slot_count,
            "serve_queue_depth": len(self._pending),
            "serve_queue_cap": self.max_queue,
            "serve_kv_page_utilization": round(
                self.engine.kv_utilization(), 4),
            "serve_rejected_total": self.rejected_total,
            "serve_ttft_p50": round(p["p50"], 6),
            "serve_ttft_p99": round(p["p99"], 6),
            "serve_latency_sketches": {
                kind: sk.state() for kind, sk in self._sketches.items()},
            "serve_slo_good_total": self.slo_good_total,
            "serve_slo_bad_total": self.slo_bad_total,
            "serve_ttft_queue_s": round(bd["queue"], 6),
            "serve_ttft_prefill_s": round(bd["prefill"], 6),
            "serve_ttft_interleave_s": round(bd["interleave"], 6),
            "serve_prefill_backlog_tokens": self._backlog_tokens(),
            "serve_prefix_hit_pct": round(
                100.0 * hits / max(1, hits + misses), 1),
            "serve_weight_generation": self.engine.weight_generation,
            "serve_active_generations": len(
                self.engine.active_generations()),
            "serve_engine_restarts": self.restarts_total,
            "serve_poisoned_total": self.poisoned_total,
            "serve_deadline_total": self.deadline_total,
            "serve_kv_dtype": self.engine.kv_dtype,
            "serve_kv_bytes_per_token": self.engine.kv_bytes_per_token,
            # decode amortization, from counters: dispatches per token
            # (1/K in the multi-step steady state, lower when speculation
            # accepts) and tokens kept per verify call
            "serve_dispatches_per_token": round(
                self.engine.dispatches_per_token, 6),
            "serve_accepted_per_dispatch": round(
                self.engine.accepted_per_dispatch, 6),
            # analytic cost ledger: cumulative per-program snapshot (flat
            # record + totals per program); the fleet merges these across
            # replicas and the PS serves them on GET /cost
            "serve_cost_programs": self.engine.ledger.snapshot(),
        }

    def _publish(self) -> None:
        snap = self.snapshot()
        if self.metrics is not None:
            if self.publish_state_gauges:
                self.metrics.set_serve_state(
                    self.model_id, snap["serve_active_slots"],
                    snap["serve_queue_depth"],
                    snap["serve_kv_page_utilization"],
                    snap["serve_prefill_backlog_tokens"])
                self.metrics.set_serve_weight_generation(
                    self.model_id, snap["serve_weight_generation"])
            # engine stats are cumulative; the counters take deltas (the
            # loop thread is the only publisher)
            for stat, note in (
                    ("prefill_tokens", self.metrics.note_serve_prefill),
                    ("decode_tokens", self.metrics.note_serve_decode),
                    ("prefix_hits", self.metrics.note_serve_prefix_hits),
                    ("prefix_misses",
                     self.metrics.note_serve_prefix_misses),
                    ("page_leaks", self.metrics.note_serve_page_leaks),
                    ("kv_bytes", self.metrics.note_serve_kv_bytes),
                    ("draft_tokens",
                     self.metrics.note_serve_draft_tokens),
                    ("accepted_tokens",
                     self.metrics.note_serve_accepted_tokens),
                    ("rejected_tokens",
                     self.metrics.note_serve_rejected_tokens)):
                cur = int(self.engine.stats[stat])
                delta = cur - self._counters_seen.get(stat, 0)
                if delta > 0:
                    note(self.model_id, delta)
                    self._counters_seen[stat] = cur
            if self.tracer is not None:
                self.metrics.note_serve_trace_dropped(
                    self.model_id, self.tracer.dropped_events)
            # the cost counters advance by delta under the serve:<model>
            # owner; gated like the per-model gauges, so fleet replicas
            # never race the fleet's merged advance under the same owner
            if self.publish_state_gauges:
                self.metrics.update_cost(f"serve:{self.model_id}",
                                         snap.get("serve_cost_programs"))
        # a pass with no new sheds re-arms the onset snapshot; a pass
        # after terminal events flushes the sink (batched)
        if self._shed_total == self._shed_seen:
            self._shed_episode = False
        self._shed_seen = self._shed_total
        if self._trace_dirty:
            self._trace_dirty = False
            self._flush_trace()
        if self.health_cb is not None:
            try:
                self.health_cb(snap)
            except Exception:  # noqa: BLE001 — a callback never kills the loop
                logger.exception("serve health callback failed")
