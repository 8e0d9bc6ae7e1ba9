"""Cross-process span tracing, Chrome-trace export and the torch.profiler
capture (twin of kubeml_tpu/utils/trace.py).

  - the client mints a ``trace_id`` which rides the ``X-KubeML-Trace-Id``
    header (control/httpd.py) through controller, scheduler and PS, and
    reaches a standalone job process through its task, so spans from all
    four processes correlate on one id;
  - ``Tracer.span(name, **args)`` times a host-side phase. Each completed
    span is an entry in the per-epoch summary (count / total / mean, the
    job log line ``kubeml logs`` prints) and a Chrome trace event
    (``ph: "X"``, microsecond ts/dur, args carrying trace_id / parent /
    the caller's kwargs). Nesting is tracked per thread, so the timeline
    shows epoch > round > {data_wait, dispatch, merge_wait};
  - ``TraceSink`` writes each process's events to
    ``$KUBEML_TPU_HOME/traces/<job_id>/<process>-<pid>.trace.json`` and
    ``merge_job_trace`` combines every such file, plus any ``torch_profile``
    capture dropped in the same directory, into one Perfetto-viewable
    document (the PS's ``GET /trace?id=``, ``kubeml trace --id``). The
    files are the JAX package's, so each package merges the other's;
  - ``torch_profile(dir)`` captures a torch.profiler trace (the CUDA
    kernels of the block beside its host operators) as a Chrome trace file.

Spans time the host. CUDA is asynchronous as JAX's dispatch is, so a
``dispatch`` span is the time to enqueue a round and the blocking
readback shows up where the host waits (``merge_wait``); nothing here
synchronizes the device. All timing goes through an injectable ``clock``
(default ``time.time``, so timestamps of different processes align),
which tests replace with a fake to assert exact span trees.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import logging
import os
import tempfile
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from kubeml_tpu_torch.api.const import kubeml_home

TRACE_HEADER = "X-KubeML-Trace-Id"
TRACE_ENV = "KUBEML_TRACE_ID"

_context = threading.local()


def make_trace_id() -> str:
    """Mint a new 16-hex-char trace id (client side of propagation)."""
    return uuid.uuid4().hex[:16]


def get_trace_context() -> Optional[str]:
    """Trace id bound to the current thread (set by the HTTP middleware
    on the server side, or by ``trace_context`` on the client side)."""
    return getattr(_context, "trace_id", None)


def set_trace_context(trace_id: Optional[str]) -> None:
    _context.trace_id = trace_id


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]):
    """Bind trace_id to this thread for the duration of the block; every
    ``http_json`` call inside carries it as a header."""
    prev = get_trace_context()
    set_trace_context(trace_id)
    try:
        yield
    finally:
        set_trace_context(prev)


class Tracer:
    """Accumulates named spans; cheap enough to stay on in production.

    Thread-safe: a PS job thread and the HTTP handler threads record
    spans, so all mutable state is behind a lock. Per-thread nesting
    stacks give each event a ``parent`` link without cross-thread false
    nesting.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 trace_id: Optional[str] = None, max_events: int = 200_000):
        self._clock = clock or time.time
        self.trace_id = trace_id
        self.max_events = max_events
        self.dropped_events = 0
        self._lock = threading.Lock()
        self._spans: Dict[str, List[float]] = collections.defaultdict(list)
        self._events: List[dict] = []
        self._tls = threading.local()

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _record(self, name: str, t0: float, dur: float,
                parent: Optional[str], args: dict) -> None:
        with self._lock:
            self._spans[name].append(dur)
            if len(self._events) >= self.max_events:
                self.dropped_events += 1
                return
            ev_args = dict(args)
            if self.trace_id:
                ev_args["trace_id"] = self.trace_id
            if parent:
                ev_args["parent"] = parent
            self._events.append({
                "name": name,
                "ph": "X",
                "ts": round(t0 * 1e6),
                "dur": round(dur * 1e6),
                "pid": os.getpid(),
                "tid": threading.get_ident() % (1 << 31),
                "args": ev_args,
            })

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a block. Yields the args dict, which is snapshotted at
        span *end*, so the body can attach facts it only learns while
        running (worker counts, tail markers)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = self._clock()
        try:
            yield args
        finally:
            dur = self._clock() - t0
            stack.pop()
            self._record(name, t0, dur, parent, args)

    def add(self, name: str, seconds: float, **args):
        """Record an externally-timed span ending now."""
        end = self._clock()
        stack = self._stack()
        parent = stack[-1] if stack else None
        self._record(name, end - seconds, seconds, parent, args)

    def add_span(self, name: str, start: float, end: float,
                 parent: Optional[str] = None, **args):
        """Record a span with explicit timestamps and an explicit parent
        link (a span that straddles several iterations of a loop, which
        the per-thread nesting stack cannot parent)."""
        self._record(name, start, max(0.0, end - start), parent, args)

    def instant(self, name: str, ts: Optional[float] = None,
                parent: Optional[str] = None, **args):
        """Record a Chrome instant event (``ph: "i"``): a point on the
        timeline rather than an interval, under the same event cap and
        drop accounting as spans."""
        if ts is None:
            ts = self._clock()
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped_events += 1
                return
            ev_args = dict(args)
            if self.trace_id:
                ev_args["trace_id"] = self.trace_id
            if parent:
                ev_args["parent"] = parent
            self._events.append({
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": round(ts * 1e6),
                "pid": os.getpid(),
                "tid": threading.get_ident() % (1 << 31),
                "args": ev_args,
            })

    def event_count(self) -> int:
        """Events currently buffered (a cheap dirty check for sinks)."""
        with self._lock:
            return len(self._events)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": len(xs),
                    "total_s": round(sum(xs), 4),
                    "mean_s": round(sum(xs) / len(xs), 6),
                }
                for name, xs in self._spans.items()
            }

    def durations(self) -> Dict[str, List[float]]:
        """Raw per-span duration lists (the MetricUpdate's phase_times)."""
        with self._lock:
            return {name: list(xs) for name, xs in self._spans.items()}

    def format_summary(self) -> str:
        parts = []
        for name, s in sorted(self.summary().items()):
            parts.append(f"{name}={s['total_s']:.3f}s/{s['count']}")
        return " ".join(parts)

    def reset(self) -> Dict[str, Dict[str, float]]:
        """Clear the per-epoch duration summaries. Timeline events are
        kept: the epoch log line is periodic, the exported trace is the
        whole job."""
        out = self.summary()
        with self._lock:
            self._spans.clear()
        return out

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)


def trace_dir(job_id: str, home: Optional[str] = None) -> str:
    return os.path.join(home or kubeml_home(), "traces", job_id)


class TraceSink:
    """Writes one process's trace events to the per-job trace directory.

    Each writer owns ``<process>-<pid>.trace.json`` (pid-suffixed, so a
    restarted job process gets its own file instead of clobbering the
    dead one's partial timeline). Writes are atomic (tmp + rename), so the
    merger never reads a torn file, and the whole file is rewritten on
    each flush: callers flush per epoch, keeping a crash-survivable
    partial trace on disk. Each write stages through a tmp file of its
    own (``mkstemp`` beside the target): two sinks of one process on one
    path (a fleet that lost the PS's build race flushes as it stops,
    while the winner flushes) never rename each other's tmp away.
    """

    def __init__(self, job_id: str, process: str,
                 home: Optional[str] = None):
        self.job_id = job_id
        self.process = process
        self.dir = trace_dir(job_id, home)
        self.path = os.path.join(
            self.dir, f"{process}-{os.getpid()}.trace.json")
        # one tracer snapshot per write at a time: a later flush never
        # lands before an earlier one of the same sink
        self._write_lock = threading.Lock()

    def write(self, tracer: Tracer) -> str:
        with self._write_lock:
            return self._write_locked(tracer)

    def _write_locked(self, tracer: Tracer) -> str:
        pid = os.getpid()
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{self.process}:{self.job_id}"},
        }]
        events.extend(tracer.events())
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": {"process": self.process,
                            "job_id": self.job_id,
                            "trace_id": tracer.trace_id or "",
                            # events refused by the max_events cap: a
                            # merged timeline then says it is partial
                            "dropped_events": tracer.dropped_events}}
        os.makedirs(self.dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=self.dir, prefix=os.path.basename(self.path) + ".tmp.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return self.path


def _load_trace_doc(path: str) -> Tuple[List[dict], int]:
    """(events, dropped_events) from one trace file; bare Chrome trace
    arrays (no metadata envelope) report 0 drops."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
    else:
        with open(path) as f:
            doc = json.load(f)
    if isinstance(doc, list):  # bare Chrome trace array form
        return doc, 0
    meta = doc.get("metadata") or {}
    try:
        dropped = int(meta.get("dropped_events", 0))
    except (TypeError, ValueError):
        dropped = 0
    return list(doc.get("traceEvents", [])), dropped


def merge_job_trace(job_id: str, home: Optional[str] = None) -> dict:
    """Merge every per-process trace file under traces/<job_id>/ (each
    ``TraceSink``'s, and any ``torch_profile`` capture) into one Chrome
    trace-event document, sorted by timestamp. Torn or foreign files are
    skipped.

    Raises FileNotFoundError when the job has no trace directory.
    """
    root = trace_dir(job_id, home)
    if not os.path.isdir(root):
        raise FileNotFoundError(root)
    sources, events = [], []
    dropped_events = 0
    for dirpath, _dirs, files in os.walk(root):
        for name in sorted(files):
            if not (name.endswith(".trace.json")
                    or name.endswith(".trace.json.gz")):
                continue
            path = os.path.join(dirpath, name)
            try:
                evs, dropped = _load_trace_doc(path)
            except (OSError, ValueError):  # torn/foreign file: skip it
                continue
            events.extend(evs)
            dropped_events += dropped
            sources.append(os.path.relpath(path, root))
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    trace_ids = sorted({e["args"]["trace_id"] for e in events
                        if isinstance(e.get("args"), dict)
                        and e["args"].get("trace_id")})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"job_id": job_id, "sources": sources,
                         "trace_ids": trace_ids,
                         # nonzero: the merged timeline is partial
                         "dropped_events": dropped_events}}


@contextlib.contextmanager
def torch_profile(log_dir: str):
    """Capture a torch.profiler trace of the block (host operators, and
    the CUDA kernels when a card is present) as
    ``<log_dir>/torch-<pid>.trace.json``; with log_dir a job's trace
    directory, ``merge_job_trace`` lists it beside the host spans.

    Degrades to a no-op, with a logged warning, when the profiler cannot
    start, and logs a failed export without raising."""
    import torch

    log = logging.getLogger("kubeml_tpu_torch.trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # profiler unavailable or a bad directory
        log.warning("torch_profile: could not start trace in %s: %s",
                    log_dir, e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"torch-{os.getpid()}.trace.json"))
            except Exception as e:  # an export failure must not kill the run
                log.warning("torch_profile: could not stop/export trace: "
                            "%s", e)
