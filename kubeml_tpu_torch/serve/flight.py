"""Engine flight recorder: the serving plane's always-on black box (copy
of kubeml_tpu/serve/flight.py).

A fixed-size ring of host-side records, one per engine loop step. When
a request sheds or an SLO health rule fires, the question is always
"what was the engine doing for the last N steps?" — and by then it is
too late to turn instrumentation on. So the recorder is always on:
recording is O(1) host bookkeeping per step (a dict build and a ring
slot overwrite; no device work, no allocation growth), cheap enough
that tests pin decode output bit-identical with it on or off.

Drained live via ``GET /flight?id=serve:<model>`` (control/ps.py) and
auto-snapshotted into the serve trace (an instant event carrying the
ring's contents) on shed onset and SLO-breach health transitions —
see ServeService.flight_snapshot; FLIGHT_FIELDS below is the record
schema.
"""

from __future__ import annotations

import threading
from typing import List, Optional

# Record schema version. v2 split the old merged "dispatches" field
# into prefill_dispatches/decode_dispatches: once multi-step and
# speculative-verify dispatches exist, one decode dispatch can emit
# many tokens, so a prefill+decode sum is uninterpretable — consumers
# key on this constant to know which shape they are reading.
FLIGHT_SCHEMA_VERSION = 2

# One record per engine step; every field is host-side and O(1) to
# read; tests assert the schema.
FLIGHT_FIELDS = (
    "step",                # monotone engine step counter
    "ts",                  # engine clock at record time (service timebase)
    "kind",                # prefill | decode | mixed | idle | shed
    "active_slots",        # occupied decode slots after the step
    "prefill_backlog",     # prompt tokens admitted but not yet prefilled
    "kv_pages",            # KV cache pages referenced or cached
    "cow_splits",          # copy-on-write page splits this step
    "prefill_dispatches",  # prefill-program dispatches this step
    "decode_dispatches",   # decode dispatches this step (single-step,
                           # multi-step, and speculative-verify programs)
    "dispatch_s",          # wall time spent inside dispatch calls
    "tokens",              # generated tokens emitted this step
    "weight_generation",   # generation new admissions attach to
    "generations",         # weight generations resident (swap drain depth)
    "deadlines",           # requests reaped by deadline expiry this step
)


class FlightRecorder:
    """Fixed-capacity ring of per-step flight records.

    ``record`` is loop-thread-only in spirit but takes a lock anyway:
    ``snapshot`` is called from HTTP threads (GET /flight) and from
    shed-onset hooks, and a torn read of a wrapping ring would
    interleave old and new steps.
    """

    def __init__(self, capacity: int = 256):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(
                f"flight recorder capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: List[Optional[dict]] = [None] * capacity
        self._total = 0
        self._lock = threading.Lock()

    @property
    def total(self) -> int:
        """Steps ever recorded (records overwritten = total - capacity)."""
        return self._total

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring[self._total % self.capacity] = rec
            self._total += 1

    def snapshot(self) -> List[dict]:
        """The retained records, oldest first. Copies, so the caller can
        serialize while the loop keeps recording."""
        with self._lock:
            if self._total <= self.capacity:
                return [dict(r) for r in self._ring[:self._total]]
            i = self._total % self.capacity
            return [dict(r) for r in self._ring[i:] + self._ring[:i]]
