"""Request objects and admission errors for the decode service (twin of
kubeml_tpu/serve/slots.py).

A GenerateRequest is the handle shared between the submitting thread and
the serving loop: the loop pushes per-token events onto the request's
queue as they come off the device; the submitter drains them or waits.
Cancellation is a flag the loop checks each step.
"""

from __future__ import annotations

import queue
import threading
import uuid
from typing import Dict, List, Optional

from kubeml_tpu_torch.api.errors import KubeMLException


class ServeSaturated(KubeMLException):
    """Admission refused: every slot busy and the queue at cap (429 +
    Retry-After)."""

    def __init__(self, retry_after_s: float = 1.0,
                 message: str = "serving at capacity: all decode slots "
                                "busy and admission queue full"):
        super().__init__(message, 429)
        self.retry_after_s = retry_after_s


class ServeDraining(KubeMLException):
    """Admission refused: the service is draining for shutdown (503 +
    Retry-After)."""

    def __init__(self, retry_after_s: float = 1.0,
                 message: str = "serving is draining for shutdown; "
                                "retry against another replica"):
        super().__init__(message, 503)
        self.retry_after_s = retry_after_s


class GenerateRequest:
    """One generation stream, from admission to EOS/cancel/shed.

    Token ids only: `prompt` is a list of ints, generated ids accumulate
    in `tokens`. The service stamps `submitted_at`, the engine
    `admitted_at`, `first_token_at` and `finished_at` (TTFT =
    first_token_at - submitted_at).
    """

    def __init__(self, prompt: List[int], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 deadline_ms: Optional[float] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = None if eos_id is None else int(eos_id)
        # deadline_at (service clock) is stamped at admission; the
        # engine's reaper releases the slot with the terminal `deadline`
        # outcome once the clock passes it
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)
        self.deadline_at: Optional[float] = None
        # supervisor recovery: the weight generation this stream was
        # pinned to, so a resumed attach decodes the same params
        self.resume_gen: Optional[int] = None
        # fleet failover: times this stream was moved to another replica
        # (ejection migration or hedge), charged against the fleet's
        # migration budget; fleet_replica is where it lives now
        self.migrations = 0
        self.fleet_replica: Optional[int] = None
        # trace_id rides from the client header through every span of the
        # request's tree; rid separates co-resident requests sharing one
        self.trace_id = trace_id or None
        self.rid = uuid.uuid4().hex[:8]
        self.tokens: List[int] = []          # generated ids, in order
        self.events: "queue.Queue[dict]" = queue.Queue()
        # terminal: ok | cancelled | deadline | error
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.submitted_at: Optional[float] = None
        self.admitted_at: Optional[float] = None  # attach() = slot claimed
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # additive TTFT decomposition, filled at the first token:
        # queue + prefill + interleave == first_token_at - submitted_at
        self.ttft_breakdown: Optional[Dict[str, float]] = None
        self._cancel = threading.Event()
        self._done = threading.Event()

    # ------------------------------------------------------------- client side
    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def events_iter(self, timeout: float = 120.0):
        """Yield event dicts ({"token": id} per token, then one
        {"done"/"error": ...}) until the stream ends. A stream stalled
        for `timeout` seconds ends with an error event and is cancelled,
        so the loop reaps it and frees its pages."""
        while True:
            try:
                ev = self.events.get(timeout=timeout)
            except queue.Empty:
                self.cancel()
                yield {"error": f"stream stalled for {timeout:g}s"}
                return
            yield ev
            if "done" in ev or "error" in ev:
                return

    # ------------------------------------------------------------ engine side
    def emit_token(self, token: int) -> None:
        self.tokens.append(int(token))
        self.events.put({"token": int(token)})

    def finish(self, outcome: str, error: Optional[str] = None) -> None:
        """Terminal transition; exactly one per request (the serving
        loop owns it). Emits the closing event and releases waiters."""
        if self.outcome is not None:
            return
        self.outcome = outcome
        self.error = error
        if outcome == "ok":
            self.events.put({"done": True, "tokens": list(self.tokens)})
        elif outcome == "cancelled":
            self.events.put({"done": True, "cancelled": True,
                             "tokens": list(self.tokens)})
        elif outcome == "deadline":
            self.events.put({"error": error or "deadline exceeded",
                             "deadline": True,
                             "tokens": list(self.tokens)})
        else:
            self.events.put({"error": error or outcome})
        self._done.set()
