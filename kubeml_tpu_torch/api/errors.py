"""Error types shared across the port (copy of kubeml_tpu/api/errors.py's
exceptions that the port raises; the port imports nothing of the JAX
package). Same names, messages and status codes."""

from __future__ import annotations


class KubeMLException(Exception):
    """Base exception carrying an HTTP-style status code."""

    def __init__(self, message: str, status_code: int = 500):
        super().__init__(message)
        self.message = message
        self.status_code = status_code

    def to_dict(self) -> dict:
        return {"code": self.status_code, "error": self.message}


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
