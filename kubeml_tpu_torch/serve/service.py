"""The serving loop: admission control in front, the decode engine behind
(twin of kubeml_tpu/serve/service.py, without the reference's
supervision/watchdog, drain, SLO sketches and trace flush).

One background thread per served model owns the engine (slot state and
the paged programs are single-threaded by design); submitting threads
only enqueue validated requests and wait on them. Admission is counted
with one in-flight counter under the condition variable — capacity =
slots + queue cap — so the 429 decision is deterministic.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Deque, Optional

from kubeml_tpu_torch.models.base import InferenceInputError
from kubeml_tpu_torch.serve.engine import DecodeEngine
from kubeml_tpu_torch.serve.slots import GenerateRequest, ServeSaturated

logger = logging.getLogger("kubeml_tpu_torch.serve.service")

# Retry-After sizing for the prefill backlog: a conservative prompt
# loading rate. The hint only needs the right order of magnitude.
PREFILL_DRAIN_TOKENS_PER_S = 256.0


class ServeService:
    """Continuous-batching serving loop for one model. The engine carries
    the device (``DecodeEngine(device=None)`` means CUDA)."""

    def __init__(self, model_id: str, engine: DecodeEngine,
                 max_queue: int = 16, clock=time.perf_counter):
        self.model_id = model_id
        self.engine = engine
        self.max_queue = int(max_queue)
        self.clock = clock
        self._cv = threading.Condition()
        self._pending: Deque[GenerateRequest] = collections.deque()
        self._admitted: set = set()   # admitted, not yet accounted
        self._stopped = False
        self.rejected_total = 0
        self.deadline_total = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-{model_id}", daemon=True)

    # -------------------------------------------------------------- clients
    def start(self) -> "ServeService":
        self._thread.start()
        return self

    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> GenerateRequest:
        """Admit a request or shed it. Raises InferenceInputError (400)
        on a bad prompt or deadline, ServeSaturated (429) at capacity or
        when the deadline is infeasible against the current backlog."""
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
                              eos_id=eos_id, deadline_ms=deadline_ms)
        # validate on the submitting thread: bad input must 400 before it
        # costs a slot (also strips trailing pads)
        req.prompt = self.engine.check_admissible(req.prompt,
                                                  req.max_new_tokens)
        with self._cv:
            if self._stopped:
                raise ServeSaturated(message="serving loop stopped")
            backlog_s = self._backlog_tokens() / PREFILL_DRAIN_TOKENS_PER_S
            if req.deadline_ms is not None \
                    and req.deadline_ms / 1000.0 <= backlog_s:
                # the queued prompt work alone outlasts the deadline
                self.rejected_total += 1
                raise ServeSaturated(
                    retry_after_s=1.0 + backlog_s,
                    message=f"deadline_ms={req.deadline_ms:g} is "
                            f"infeasible: ~{backlog_s:.2f}s of prompt "
                            f"backlog is queued ahead of admission")
            if self._live() >= self.capacity:
                self.rejected_total += 1
                raise ServeSaturated(retry_after_s=1.0 + backlog_s)
            self._admitted.add(req)
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

    @property
    def capacity(self) -> int:
        """Admission capacity: decode slots plus the queue cap."""
        return self.engine.slot_count + self.max_queue

    @property
    def inflight(self) -> int:
        """Requests admitted but not yet terminal."""
        with self._cv:
            return self._live()

    def _live(self) -> int:
        """Admitted requests not yet terminal (cv held). A request the
        engine finished inside a step is terminal from that moment — its
        waiter may already be awake — before the loop accounts it."""
        return sum(1 for r in self._admitted if not r.done)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loop; streams still in flight end with an error."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout)

    # ----------------------------------------------------------------- loop
    def _loop(self) -> None:
        engine = self.engine
        while True:
            with self._cv:
                while not self._stopped and not self._pending \
                        and engine.active() == 0:
                    self._cv.wait()
                if self._stopped:
                    break
                # queued requests can expire before a slot frees: reap
                # them here so a deadline never waits on capacity
                now = self.clock()
                keep: Deque[GenerateRequest] = collections.deque()
                while self._pending:
                    r = self._pending.popleft()
                    if r.deadline_at is not None and now >= r.deadline_at:
                        self._terminal(
                            r, "deadline", f"deadline of {r.deadline_ms:g}"
                            f"ms exceeded before a slot was free")
                    else:
                        keep.append(r)
                self._pending = keep
                while self._pending and engine.free_slots() > 0:
                    req = self._pending.popleft()
                    if req.cancelled:
                        self._terminal(req, "cancelled")
                        continue
                    engine.attach(req)
            try:
                finished = engine.step()
            except Exception:  # noqa: BLE001 — the loop must keep serving
                logger.exception("model %s: decode step failed; failing "
                                 "the streams in flight", self.model_id)
                finished = self._fail_active(engine, "decode step failed")
            with self._cv:
                for req in finished:
                    self._terminal(req, None)
        # stopped: fail whatever is left so no client hangs
        with self._cv:
            while self._pending:
                self._terminal(self._pending.popleft(), "error",
                               "serving loop stopped")
            for req in self._fail_active(engine, "serving loop stopped"):
                self._terminal(req, None)

    @staticmethod
    def _fail_active(engine: DecodeEngine, msg: str):
        failed = []
        for s in range(engine.slot_count):
            slot = engine._slots[s]
            if slot is not None:
                failed.append(slot.req)
                engine.release(s, "error", msg)
        return failed

    def _terminal(self, req: GenerateRequest, outcome: Optional[str],
                  error: Optional[str] = None) -> None:
        """Account one request reaching a terminal state (cv held).
        outcome None means the engine already called req.finish()."""
        if outcome is not None:
            if req.finished_at is None:
                req.finished_at = self.clock()
            req.finish(outcome, error)
        self._admitted.discard(req)
        if req.outcome == "deadline":
            self.deadline_total += 1

    def _backlog_tokens(self) -> int:
        """Prompt tokens owed before new work gets its first token:
        unfilled prompt positions in attached slots plus the prompts still
        waiting in the admission queue."""
        return self.engine.prefill_backlog_tokens() + sum(
            max(0, len(r.prompt) - 1) for r in self._pending)
