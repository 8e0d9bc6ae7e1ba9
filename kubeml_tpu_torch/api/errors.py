"""Error types shared across the port (copy of kubeml_tpu/api/errors.py's
exceptions that the port raises, and of ``check_error``, the client's
decoding of the ``{code, error}`` envelope; the port imports nothing of
the JAX package). Same names, messages, status codes and wire shape.

``NotPortedError`` is the port's own: the one wording of "not ported yet"
for a refused option, route or knob, naming what brings it.
"""

from __future__ import annotations

import json


class KubeMLException(Exception):
    """Base exception carrying an HTTP-style status code."""

    def __init__(self, message: str, status_code: int = 500):
        super().__init__(message)
        self.message = message
        self.status_code = status_code

    def to_dict(self) -> dict:
        return {"code": self.status_code, "error": self.message}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


class MergeError(KubeMLException):
    def __init__(self, message: str = "Error merging model"):
        super().__init__(message, 500)


class DataError(KubeMLException):
    def __init__(self, message: str = "Error loading data"):
        super().__init__(message, 500)


class InvalidFormatError(KubeMLException):
    def __init__(self, message: str = "Invalid request format"):
        super().__init__(message, 400)


class StorageError(KubeMLException):
    def __init__(self, message: str = "Error accessing storage"):
        super().__init__(message, 500)


class DatasetNotFoundError(KubeMLException):
    def __init__(self, name: str = ""):
        super().__init__(f"Dataset not found{': ' + name if name else ''}",
                         404)


class InvalidArgsError(KubeMLException):
    def __init__(self, message: str = "Invalid arguments"):
        super().__init__(message, 400)


class JobNotFoundError(KubeMLException):
    def __init__(self, job_id: str = ""):
        super().__init__(f"Job not found{': ' + job_id if job_id else ''}",
                         404)


class FunctionNotFoundError(KubeMLException):
    def __init__(self, name: str = ""):
        super().__init__(f"Function not found{': ' + name if name else ''}",
                         404)


class StaleGrantError(KubeMLException):
    """409: the caller presented a lane grant whose fencing epoch
    predates the current allocator incarnation — a pre-crash worker
    that outlived the control plane that granted it. The recovered
    allocator may have given those lanes away; honoring the stale grant
    would double-book them (split-brain). The worker must requeue."""

    def __init__(self, job_id: str = "", presented: int = 0,
                 current: int = 0):
        super().__init__(
            f"stale grant for job {job_id}: fencing epoch {presented} "
            f"predates current epoch {current}", 409)
        self.job_id = job_id
        self.presented = presented
        self.current = current


class JobPreemptedError(KubeMLException):
    """Control-flow signal: the job drained and checkpointed mid-epoch in
    response to a preemption notice (SIGTERM or a ``preempt`` fault event)
    and expects the PS to reschedule it from the round-granular
    checkpoint. Not a failure: train() re-raises it without reporting
    on_finish, so the PS job record stays alive for the watchdog."""

    def __init__(self, job_id: str = "", epoch: int = 0, round_: int = 0):
        super().__init__(
            f"job {job_id} preempted at epoch {epoch} round {round_}", 503)
        self.job_id = job_id
        self.epoch = epoch
        self.round = round_


class NotPortedError(KubeMLException):
    """A feature of the JAX package this port does not carry yet: 400 for
    an option of a request, 501 for a route or a deployment knob."""

    def __init__(self, what: str, brings: str, status_code: int = 400):
        super().__init__(f"{what} is not ported yet to kubeml_tpu_torch "
                         f"(comes with {brings})", status_code)


def check_error(status_code: int, body: bytes) -> None:
    """Raise a KubeMLException from an error-envelope HTTP response: the
    ``{code, error}`` envelope when the body holds one, else the status
    and the body's text."""
    if status_code < 400:
        return
    try:
        payload = json.loads(body.decode("utf-8"))
        raise KubeMLException(payload.get("error", "unknown error"),
                              payload.get("code", status_code))
    except (ValueError, AttributeError, UnicodeDecodeError):
        raise KubeMLException(body.decode("utf-8", "replace")
                              or "unknown error", status_code) from None
