"""Deterministic fault injection for training, serving and the control
plane (a copy of kubeml_tpu/faults.py: the port imports nothing of the
JAX package, and one plan string drives both packages' tests).

An injection fires at NAMED coordinates, never at random, so every
recovery path replays bit for bit in the CPU tests. The plans parse a
JSON string, a dict ``{"events": [...]}`` or a bare list of event dicts;
coordinate -1 (the default) is a wildcard.

TRAINING (FaultPlan, ``TrainOptions.fault_plan``) counts in (epoch,
round, worker):

  nan      poison the target worker's float batch leaves with NaN before
           staging, so its K local steps go non-finite and the merge's
           finite guard drops it (``worker: -1`` poisons every worker: the
           round merges nothing and the weights carry forward).
  dropout  zero the target worker's mask bit for the round.
  crash    os._exit(CRASH_EXIT_CODE) at the round, after draining the
           pending async checkpoint saves. Fires only in the job's first
           incarnation (a resumed process suppresses it, or the fixed
           coordinates would crash every restart).
  corrupt_checkpoint
           overwrite the published checkpoint's weights.npz.
  slow     time.sleep(duration_s) before the round's dispatch.
  preempt  graceful preemption notice at the round: the job finishes the
           round, drains its saves, writes the round cursor and raises
           JobPreemptedError (the in-process twin of the job server's
           SIGTERM). First incarnation only, like crash.
  quarantine
           force the non-finite guard to quarantine the target worker from
           the round on (needs quarantine_after > 0 and a worker).
  stale_data
           suppress the continual job's window slide after the target
           epoch: the registry poll still sees the new generation, so the
           lag grows deterministically and the data_staleness health rule
           fires without wall-clock races.

The job wires the plan in: ``inject_batch`` wraps the host batch (nan),
the plan itself is the round hook for the rest.

The SERVING plane (ServeFaultPlan) counts in (engine step, decode slot):

  serve_nan_logits
           raise the poison lane for the target slot's decode call at the
           step, driving the on-device non-finite logit guard
           (models/gpt.py build_paged_decode_step): only that slot's
           request terminates (``error``, "poisoned"), concurrent streams
           keep their tokens. Fires once per event.
  serve_step_crash
           raise RuntimeError from the engine step BEFORE any page
           mutation. STICKY BY REQUEST: the event binds to the rid in its
           slot at first fire and crashes every step that schedules that
           rid, which is what ServeService's bisection converges on
           (retries with the rid's lane masked succeed; the quarantined
           request terminates and the crash stops).
  serve_slow_step
           time.sleep(duration_s) at the step: a slow engine round.
  serve_loop_wedge
           spin inside the serving loop (after the step completes) until
           the supervisor abandons the engine: drives the watchdog's wedge
           detection and recovery without killing the process. Fires once
           per event.

The FLEET (FleetFaultPlan) counts in (supervise tick, replica index); the
fleet supervisor (serve/fleet.py supervise_once) is the injection point:

  fleet_replica_crash
           abrupt replica death: the replica's loop exits WITHOUT its
           drain tail (ServeService.kill) and its watchdog stands down,
           leaving in-flight streams for the fleet to eject and
           live-migrate. Fires once per event.
  fleet_replica_wedge
           crash-looping replica: drives the replica's real supervisor
           recovery (ServeService.force_restart) until restarts_total
           exceeds the fleet's replica_restart_budget. Fires once.
  fleet_replica_slow
           gray failure: plants a wildcard serve_slow_step of duration_s
           in the replica's engine plan, so its queued streams age past
           hedge_after_s and get hedged to a peer. Fires once (the
           planted slow step fires every step).

The CONTROL PLANE (ControlFaultPlan) counts in decision-journal record
indices; the DecisionJournal append and replay sites
(control/journal.py) are the injection points:

  control_crash
           raise ControlCrash AFTER the journal frame at the target index
           is durably flushed (death after a durable append). Replay must
           reconstruct the allocator exactly, that last decision
           included. Fires once per event.
  control_torn_write
           raise ControlCrash MID-append at the target index, leaving a
           strict prefix of the frame on disk. Replay must drop the
           partial frame by its CRC and reconstruct the state as of
           index-1. Fires once per event.
  control_slow_recover
           time.sleep(duration_s) at the top of journal replay: a dilated
           recovery window. Fires once per event.

"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("kubeml_tpu_torch.faults")

KINDS = ("nan", "dropout", "crash", "corrupt_checkpoint", "slow",
         "preempt", "quarantine", "stale_data")
SERVE_KINDS = ("serve_nan_logits", "serve_step_crash", "serve_slow_step",
               "serve_loop_wedge")
FLEET_KINDS = ("fleet_replica_crash", "fleet_replica_wedge",
               "fleet_replica_slow")
CONTROL_KINDS = ("control_crash", "control_torn_write",
                 "control_slow_recover")


class ControlCrash(RuntimeError):
    """Simulated control-plane process death, raised from inside a
    DecisionJournal append by an injected control_crash or
    control_torn_write event: the caller abandons the in-memory control
    plane and recovers a fresh one from the journal."""


# distinctive enough that a watchdog test can tell the injected crash from
# an import error or an OOM kill
CRASH_EXIT_CODE = 23


def _event_dicts(spec: Any, what: str) -> List[dict]:
    """The event dicts of a JSON string / dict / list plan spec."""
    if isinstance(spec, str):
        spec = json.loads(spec)
    if isinstance(spec, dict):
        spec = spec.get("events", [])
    if not isinstance(spec, list):
        raise ValueError(f"{what + ' ' if what else ''}fault_plan must be a "
                         "list of events or {'events': [...]}")
    return spec


def _check_kind(e: dict, kinds: tuple, what: str) -> str:
    kind = e.get("kind")
    if kind not in kinds:
        raise ValueError(f"unknown {what + ' ' if what else ''}fault kind "
                         f"{kind!r}; expected one of {kinds}")
    return kind


@dataclasses.dataclass
class FaultEvent:
    """One training injection at (epoch, round, worker); -1 = wildcard."""

    kind: str
    epoch: int = -1
    round: int = -1
    worker: int = -1
    duration_s: float = 0.0   # slow events only

    def matches(self, epoch: int, rnd: int) -> bool:
        return ((self.epoch < 0 or self.epoch == epoch)
                and (self.round < 0 or self.round == rnd))


class FaultPlan:
    """A parsed, coordinate-driven training fault schedule (a callable
    round hook). The owning TrainJob sets ``epoch`` at the top of each
    epoch and calls ``bind(job)`` once (which decides ``is_restart``: a
    resumed incarnation suppresses crash and preempt). ``injected``
    counts the fired events by kind."""

    def __init__(self, events: List[FaultEvent]):
        self.events = events
        self.epoch = 0
        self.is_restart = False
        self._job: Optional[Any] = None
        self.injected = {k: 0 for k in KINDS}

    @classmethod
    def parse(cls, spec: Any) -> "FaultPlan":
        """Parse a JSON string / dict / list of event dicts."""
        if isinstance(spec, FaultPlan):
            return spec
        events = []
        for e in _event_dicts(spec, ""):
            kind = _check_kind(e, KINDS, "")
            if kind == "quarantine" and int(e.get("worker", -1)) < 0:
                raise ValueError(
                    "quarantine events need an explicit worker "
                    "(quarantining every worker would abort the merge)")
            events.append(FaultEvent(
                kind=kind, epoch=int(e.get("epoch", -1)),
                round=int(e.get("round", -1)),
                worker=int(e.get("worker", -1)),
                duration_s=float(e.get("duration_s", 0.0))))
        return cls(events)

    def bind(self, job) -> None:
        self._job = job
        self.is_restart = bool(
            job.req.resume_from and job.req.resume_from == job.task.job_id)

    def has(self, kind: str) -> bool:
        return any(ev.kind == kind for ev in self.events)

    def _active(self, kind: str, rnd: int):
        return [ev for ev in self.events
                if ev.kind == kind and ev.matches(self.epoch, rnd)]

    def stale_at(self, epoch: int) -> bool:
        """True when a stale_data event suppresses the continual registry
        poll after ``epoch`` (counted; round and worker do not apply)."""
        hit = [ev for ev in self.events
               if ev.kind == "stale_data"
               and (ev.epoch < 0 or ev.epoch == epoch)]
        for _ in hit:
            self.injected["stale_data"] += 1
            logger.info("fault stale_data: epoch %d — skipping the "
                        "registry refresh", epoch)
        return bool(hit)

    def inject_batch(self, rb):
        """NaN bursts: poison the target worker's float batch leaves. Runs
        before the round is dispatched, on the host arrays."""
        events = self._active("nan", rb.round_index)
        if not events:
            return rb
        batch = {k: np.array(v, copy=True)
                 if np.issubdtype(np.asarray(v).dtype, np.floating) else v
                 for k, v in rb.batch.items()}
        for ev in events:
            for v in batch.values():
                if not np.issubdtype(v.dtype, np.floating):
                    continue
                if ev.worker < 0:
                    v[...] = np.nan
                else:
                    v[ev.worker] = np.nan
            self.injected["nan"] += 1
            logger.info("fault nan: epoch %d round %d worker %s",
                        self.epoch, rb.round_index,
                        "ALL" if ev.worker < 0 else ev.worker)
        return dataclasses.replace(rb, batch=batch)

    def __call__(self, rb):
        """Round hook: dropout / slow / corrupt_checkpoint / preempt /
        quarantine / crash. preempt and quarantine only record their round
        on the job, which applies them at exactly that round."""
        rnd = rb.round_index
        for ev in self._active("quarantine", rnd):
            if self._job is not None:
                self._job.force_quarantine(ev.worker, rnd)
                self.injected["quarantine"] += 1
                logger.warning(
                    "fault quarantine: epoch %d round %d worker %d",
                    self.epoch, rnd, ev.worker)
        mask = None
        for ev in self._active("dropout", rnd):
            mask = rb.worker_mask.copy() if mask is None else mask
            if ev.worker < 0:
                mask[:] = 0.0
            else:
                mask[ev.worker] = 0.0
            self.injected["dropout"] += 1
            logger.info("fault dropout: epoch %d round %d worker %s",
                        self.epoch, rnd,
                        "ALL" if ev.worker < 0 else ev.worker)
        for ev in self._active("slow", rnd):
            self.injected["slow"] += 1
            logger.info("fault slow: epoch %d round %d sleeping %.3fs",
                        self.epoch, rnd, ev.duration_s)
            time.sleep(ev.duration_s)
        if self._active("corrupt_checkpoint", rnd):
            self._corrupt_checkpoint(rnd)
        if (self._active("preempt", rnd) and not self.is_restart
                and self._job is not None):
            self.injected["preempt"] += 1
            logger.warning("fault preempt: epoch %d round %d — requesting "
                           "graceful drain", self.epoch, rnd)
            self._job.preempt(at_round=rnd)
        if self._active("crash", rnd) and not self.is_restart:
            self._crash(rnd)
        if mask is not None:
            return dataclasses.replace(rb, worker_mask=mask)
        return rb

    def _corrupt_checkpoint(self, rnd: int) -> None:
        from kubeml_tpu_torch.api.const import kubeml_home
        if self._job is None:
            return
        path = os.path.join(kubeml_home(), "models",
                            self._job.task.job_id, "weights.npz")
        if os.path.isfile(path):
            with open(path, "wb") as f:
                f.write(b"corrupted-by-fault-plan")
            self.injected["corrupt_checkpoint"] += 1
            logger.warning("fault corrupt_checkpoint: epoch %d round %d "
                           "truncated %s", self.epoch, rnd, path)

    def _crash(self, rnd: int) -> None:
        job = self._job
        if job is not None:
            try:
                # the restart resumes from a deterministic checkpoint, not
                # from a race with the background writer
                job._checkpointer.wait()
            except Exception:  # noqa: BLE001 — dying anyway
                pass
        self.injected["crash"] += 1
        logger.warning("fault crash: epoch %d round %d — os._exit(%d)",
                       self.epoch, rnd, CRASH_EXIT_CODE)
        logging.shutdown()
        os._exit(CRASH_EXIT_CODE)


@dataclasses.dataclass
class ServeFaultEvent:
    """One serving-plane injection at (engine step, slot); -1 = wildcard
    (any step / whichever eligible slot comes first)."""

    kind: str
    step: int = -1
    slot: int = -1
    duration_s: float = 0.0   # serve_slow_step only

    def at_step(self, step: int) -> bool:
        return self.step < 0 or self.step == step


class ServeFaultPlan:
    """Coordinate-driven fault schedule for the decode engine and the
    serving loop. The engine calls ``nan_hits`` / ``check_crash`` /
    ``sleep`` inside its step; the ServeService calls ``maybe_wedge``
    between steps. A recovered engine (DecodeEngine.spawn_recovered)
    adopts the same plan instance, so once-only and rid-sticky state
    survives restarts and an injected crash does not re-fire into a crash
    loop."""

    def __init__(self, events: List[ServeFaultEvent]):
        self.events = events
        self.injected = {k: 0 for k in SERVE_KINDS}
        self._fired: set = set()               # event index (once-only)
        self._crash_rid: Dict[int, str] = {}   # event index -> bound rid

    @classmethod
    def parse(cls, spec: Any) -> "ServeFaultPlan":
        if isinstance(spec, ServeFaultPlan):
            return spec
        return cls([ServeFaultEvent(
            kind=_check_kind(e, SERVE_KINDS, "serve"),
            step=int(e.get("step", -1)), slot=int(e.get("slot", -1)),
            duration_s=float(e.get("duration_s", 0.0)))
            for e in _event_dicts(spec, "serve")])

    def has(self, kind: str) -> bool:
        return any(ev.kind == kind for ev in self.events)

    def nan_hits(self, step: int, member_slots) -> set:
        """Slots whose decode call at ``step`` gets the poison lane
        raised. Once per event: the first call that contains the target
        slot consumes it."""
        hits: set = set()
        for i, ev in enumerate(self.events):
            if ev.kind != "serve_nan_logits" or i in self._fired \
                    or not ev.at_step(step):
                continue
            targets = [s for s in member_slots
                       if ev.slot < 0 or ev.slot == s]
            if not targets:
                continue
            self._fired.add(i)
            self.injected["serve_nan_logits"] += 1
            hits.update(targets)
            logger.warning("fault serve_nan_logits: step %d slot(s) %s",
                           step, targets)
        return hits

    def check_crash(self, step: int, occupants) -> None:
        """Raise RuntimeError when a serve_step_crash event is live for
        this step. ``occupants`` is [(slot, rid)] of the streams the step
        is about to schedule (masked lanes omitted). At first fire the
        event binds to the rid in its slot, then crashes every step that
        includes that rid."""
        for i, ev in enumerate(self.events):
            if ev.kind != "serve_step_crash":
                continue
            rid = self._crash_rid.get(i)
            if rid is None:
                if not ev.at_step(step):
                    continue
                rid = next((r for s, r in occupants
                            if ev.slot < 0 or ev.slot == s), None)
                if rid is None:
                    continue
                self._crash_rid[i] = rid
            if any(r == rid for _, r in occupants):
                self.injected["serve_step_crash"] += 1
                logger.warning("fault serve_step_crash: step %d rid %s",
                               step, rid)
                raise RuntimeError(
                    f"injected serve_step_crash: stream {rid} poisons "
                    f"the decode step")

    def sleep(self, step: int) -> None:
        for ev in self.events:
            if ev.kind == "serve_slow_step" and ev.at_step(step):
                self.injected["serve_slow_step"] += 1
                time.sleep(ev.duration_s)

    def maybe_wedge(self, engine) -> bool:
        """Spin until the supervisor abandons ``engine`` when a
        serve_loop_wedge event is live for its current step (once per
        event). Called by the serving loop after the step's terminal
        accounting, so the wedge freezes the loop between rounds."""
        for i, ev in enumerate(self.events):
            if ev.kind != "serve_loop_wedge" or i in self._fired \
                    or not ev.at_step(engine._step_count):
                continue
            self._fired.add(i)
            self.injected["serve_loop_wedge"] += 1
            logger.warning("fault serve_loop_wedge: step %d, serving loop "
                           "wedged until abandon", engine._step_count)
            while not engine._abandoned:
                time.sleep(0.005)
            return True
        return False


@dataclasses.dataclass
class FleetFaultEvent:
    """One fleet-plane injection at (supervise tick, replica); -1 =
    wildcard (first tick the target is live / lowest live replica)."""

    kind: str
    tick: int = -1
    replica: int = -1
    duration_s: float = 0.0   # fleet_replica_slow only

    def at_tick(self, tick: int) -> bool:
        return self.tick < 0 or self.tick == tick


class FleetFaultPlan:
    """Coordinate-driven fault schedule for the serving fleet, fired by
    the fleet's supervise tick. Every event fires once."""

    def __init__(self, events: List[FleetFaultEvent]):
        self.events = events
        self.injected = {k: 0 for k in FLEET_KINDS}
        self._fired: set = set()

    @classmethod
    def parse(cls, spec: Any) -> "FleetFaultPlan":
        if isinstance(spec, FleetFaultPlan):
            return spec
        return cls([FleetFaultEvent(
            kind=_check_kind(e, FLEET_KINDS, "fleet"),
            tick=int(e.get("tick", -1)), replica=int(e.get("replica", -1)),
            duration_s=float(e.get("duration_s", 0.0)))
            for e in _event_dicts(spec, "fleet")])

    def has(self, kind: str) -> bool:
        return any(ev.kind == kind for ev in self.events)

    def fire(self, tick: int, live_idxs) -> List[tuple]:
        """Events due at this tick, as (kind, replica, event) with the
        replica wildcard resolved to the lowest live index. An event
        whose target is not live stays armed for a later tick."""
        live = sorted(live_idxs)
        out = []
        for i, ev in enumerate(self.events):
            if i in self._fired or not ev.at_tick(tick):
                continue
            target = ev.replica if ev.replica >= 0 else \
                (live[0] if live else -1)
            if target < 0 or target not in live:
                continue
            self._fired.add(i)
            self.injected[ev.kind] += 1
            logger.warning("fleet fault %s: tick %d replica %d", ev.kind,
                           tick, target)
            out.append((ev.kind, target, ev))
        return out


@dataclasses.dataclass
class ControlFaultEvent:
    """One control-plane injection at a decision-journal record index;
    -1 = wildcard (the first append / the first replay)."""

    kind: str
    index: int = -1
    duration_s: float = 0.0   # control_slow_recover only

    def at_index(self, index: int) -> bool:
        return self.index < 0 or self.index == index


class ControlFaultPlan:
    """Coordinate-driven fault schedule for the control plane: the
    DecisionJournal consults ``torn_at`` / ``crash_at`` inside append()
    at the exact record index and ``sleep_recover`` at the top of
    replay(). Every event fires once."""

    def __init__(self, events: List[ControlFaultEvent]):
        self.events = events
        self.injected = {k: 0 for k in CONTROL_KINDS}
        self._fired: set = set()

    @classmethod
    def parse(cls, spec: Any) -> "ControlFaultPlan":
        """Parse a JSON string / dict / list of control event dicts."""
        if isinstance(spec, ControlFaultPlan):
            return spec
        return cls([ControlFaultEvent(
            kind=_check_kind(e, CONTROL_KINDS, "control"),
            index=int(e.get("index", -1)),
            duration_s=float(e.get("duration_s", 0.0)))
            for e in _event_dicts(spec, "control")])

    def has(self, kind: str) -> bool:
        return any(ev.kind == kind for ev in self.events)

    def _fire_one(self, kind: str, index: int) -> bool:
        for i, ev in enumerate(self.events):
            if ev.kind != kind or i in self._fired or \
                    not ev.at_index(index):
                continue
            self._fired.add(i)
            self.injected[kind] += 1
            logger.warning("control fault %s: journal index %d", kind,
                           index)
            return True
        return False

    def torn_at(self, index: int) -> bool:
        """True when the append at `index` must be torn (partial frame
        on disk, then ControlCrash)."""
        return self._fire_one("control_torn_write", index)

    def crash_at(self, index: int) -> bool:
        """True when the control plane must die AFTER the durable append
        at `index`."""
        return self._fire_one("control_crash", index)

    def sleep_recover(self) -> None:
        """Dilate journal replay by any due control_slow_recover events
        (once each)."""
        for i, ev in enumerate(self.events):
            if ev.kind != "control_slow_recover" or i in self._fired:
                continue
            self._fired.add(i)
            self.injected["control_slow_recover"] += 1
            logger.warning("control fault control_slow_recover: sleeping "
                           "%.3fs", ev.duration_s)
            time.sleep(ev.duration_s)
