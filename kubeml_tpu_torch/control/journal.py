"""Durable decision journal for the control plane (copy of
kubeml_tpu/control/journal.py: the same frames, so each package replays
the other's journal; the port imports nothing of the JAX package).

The data plane survives anything (round checkpoints, serve re-prefill,
fleet failure domains) but the orchestrator's own state — allocator
gangs/quotas/deficits, the scheduler queue, the PS registries — lived
only in process memory. This module is the persistence primitive that
fixes that: a CRC-framed write-ahead journal plus an atomically-written
compaction snapshot, both under ``$KUBEML_TPU_HOME/control/``.

Frame format (append-only file ``<name>.journal``):

    [u32 payload_len][u32 crc32(payload)][payload: canonical JSON]

Every payload carries its own monotone record index ``"i"`` so replay
composes with compaction: ``compact(state)`` first writes
``<name>.snapshot.json`` = ``{"index": last, "state": ...}`` via
tmp+rename, then truncates the journal — a crash BETWEEN the two steps
leaves stale records behind, and replay simply skips any record with
``i <= snapshot.index``. No ordering between snapshot and journal is
ever load-bearing beyond that.

Corruption policy (the load-bearing distinction):

  - a torn/truncated TAIL — short header, short payload, or a bad CRC on
    the final frame — is the expected signature of a crash mid-append.
    Replay drops it, repairs the file by truncating at the last valid
    frame, and counts ``torn_drops``. Never mis-replayed.
  - a corrupt record MID-FILE (bad CRC with valid bytes after it) means
    the journal itself is damaged. Replay raises
    :class:`JournalCorruptError` loudly — silently skipping past valid
    records would resurrect a state the allocator never held.

Fault injection: an optional ``ControlFaultPlan`` (faults.py) fires
``control_crash`` (die after a durable append), ``control_torn_write``
(die mid-append leaving a partial frame), and ``control_slow_recover``
(dilate replay) at named record indices, raising
:class:`kubeml_tpu_torch.faults.ControlCrash` so tests can kill the
control plane at exact coordinates.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import zlib
from typing import Any, List, Optional, Tuple

logger = logging.getLogger("kubeml_tpu_torch.journal")

_HEADER = struct.Struct("<II")   # payload length, crc32(payload)


class JournalCorruptError(RuntimeError):
    """A complete journal frame failed its CRC (or decoded to garbage)
    with valid records after it — the journal is damaged, not torn.
    Recovery must fail loudly; replaying around the hole would
    reconstruct a state the allocator never held."""


def atomic_write_json(path: str, doc: Any) -> None:
    """Write ``doc`` as JSON via tmp+rename so readers (and a recovery
    after a crash mid-write) never observe a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Any]:
    """Load a JSON state file; None when absent. A half-written file
    cannot exist (atomic_write_json), so a parse error here is real
    corruption and propagates."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


class DecisionJournal:
    """CRC-framed write-ahead journal + compaction snapshot for one
    control-plane role. Synchronous and deterministic: no threads, no
    wall clock — callers decide when to append and when to compact."""

    def __init__(self, directory: str, name: str = "allocator",
                 fault_plan: Optional[Any] = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.journal_path = os.path.join(directory, f"{name}.journal")
        self.snapshot_path = os.path.join(directory,
                                          f"{name}.snapshot.json")
        self.fault_plan = fault_plan
        self._fh = None
        # None until the first append or replay fixes it from disk
        self.next_index: Optional[int] = None
        # lifetime-of-this-process counters (cumulative totals that must
        # survive restart ride the OWNER's journaled state instead)
        self.records_appended = 0
        self.compactions = 0
        self.torn_drops = 0

    # ------------------------------------------------------------- internals

    def _handle(self):
        if self._fh is None:
            self._fh = open(self.journal_path, "ab")
        return self._fh

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def _read_frames(self) -> Tuple[List[dict], int]:
        """All complete, CRC-valid frames plus the byte offset of the
        first bad/torn one (== file size when clean). Raises
        JournalCorruptError on a bad frame that is NOT the tail."""
        try:
            with open(self.journal_path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return [], 0
        frames: List[dict] = []
        off, n = 0, len(data)
        while off < n:
            if n - off < _HEADER.size:
                break                                # torn header at EOF
            length, crc = _HEADER.unpack_from(data, off)
            end = off + _HEADER.size + length
            if end > n:
                break                                # torn payload at EOF
            payload = data[off + _HEADER.size:end]
            if zlib.crc32(payload) != crc:
                if end == n:
                    break                            # torn final frame
                raise JournalCorruptError(
                    f"{self.journal_path}: CRC mismatch at byte {off} "
                    f"with {n - end} valid byte(s) after it — journal "
                    f"is corrupt, refusing to replay around the hole")
            try:
                frames.append(json.loads(payload))
            except ValueError as e:
                raise JournalCorruptError(
                    f"{self.journal_path}: frame at byte {off} passed "
                    f"CRC but is not JSON: {e}") from None
            off = end
        return frames, off

    def _repair_tail(self, valid_bytes: int) -> None:
        """Truncate the journal at the last valid frame so future
        appends extend a clean file, not a garbage tail."""
        try:
            size = os.path.getsize(self.journal_path)
        except FileNotFoundError:
            return
        if size <= valid_bytes:
            return
        self.close()
        with open(self.journal_path, "r+b") as f:
            f.truncate(valid_bytes)
        self.torn_drops += 1
        logger.warning("journal %s: dropped torn tail (%d byte(s) after "
                       "offset %d)", self.journal_path,
                       size - valid_bytes, valid_bytes)

    # --------------------------------------------------------------- surface

    def replay(self) -> Tuple[Optional[dict], List[dict]]:
        """(snapshot state or None, tail records after the snapshot).

        Repairs a torn tail in place, raises JournalCorruptError on
        mid-file damage, fires control_slow_recover, and leaves
        ``next_index`` pointing one past the last durable record."""
        if self.fault_plan is not None:
            self.fault_plan.sleep_recover()
        snap = read_json(self.snapshot_path)
        snap_index = -1
        state = None
        if snap is not None:
            snap_index = int(snap["index"])
            state = snap["state"]
        frames, valid_bytes = self._read_frames()
        self._repair_tail(valid_bytes)
        tail = [r for r in frames if int(r["i"]) > snap_index]
        last = tail[-1]["i"] if tail else snap_index
        self.next_index = int(last) + 1
        return state, tail

    def append(self, record: dict) -> int:
        """Durably append one record; returns its index. The record
        gains an ``"i"`` key. Fault hooks: control_torn_write writes a
        partial frame then raises ControlCrash; control_crash raises
        AFTER the full frame is flushed (death-after-durable)."""
        if self.next_index is None:
            frames, valid_bytes = self._read_frames()
            self._repair_tail(valid_bytes)
            snap = read_json(self.snapshot_path)
            last = frames[-1]["i"] if frames else \
                (int(snap["index"]) if snap is not None else -1)
            self.next_index = int(last) + 1
        index = self.next_index
        record = dict(record)
        record["i"] = index
        payload = json.dumps(record, sort_keys=True).encode()
        frame = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        fh = self._handle()
        plan = self.fault_plan
        if plan is not None and plan.torn_at(index):
            # die mid-write: a strict prefix of the frame reaches disk
            fh.write(frame[:max(1, len(frame) - 7)])
            fh.flush()
            self.close()
            from kubeml_tpu_torch.faults import ControlCrash
            raise ControlCrash(
                f"injected control_torn_write at journal index {index}")
        fh.write(frame)
        fh.flush()
        self.next_index = index + 1
        self.records_appended += 1
        if plan is not None and plan.crash_at(index):
            self.close()
            from kubeml_tpu_torch.faults import ControlCrash
            raise ControlCrash(
                f"injected control_crash after journal index {index}")
        return index

    def compact(self, state: dict) -> None:
        """Fold everything up to the last appended record into the
        snapshot, then truncate the journal. Each step is individually
        atomic; replay's ``i <= snapshot.index`` skip makes the pair
        crash-safe without any cross-file transaction."""
        if self.next_index is None:
            self.replay()
        atomic_write_json(self.snapshot_path,
                          {"index": self.next_index - 1, "state": state})
        self.close()
        with open(self.journal_path, "wb"):
            pass
        self.compactions += 1
