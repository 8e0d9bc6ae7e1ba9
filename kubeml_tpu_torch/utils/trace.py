"""The trace context (copy of kubeml_tpu/utils/trace.py:52-83).

The client mints a trace id that rides the ``X-KubeML-Trace-Id`` header
through controller, scheduler and PS (the HTTP middleware binds it to the
handler thread, ``http_json`` sends the thread's id on), and reaches a
standalone job process through its task. Spans, the sinks that write them
and the profiler capture (``Tracer``, ``TraceSink``, ``xla_profile``) are
not ported yet: they come with ROADMAP A.13.
"""

from __future__ import annotations

import contextlib
import threading
import uuid
from typing import Optional

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
