"""Error types shared across the port (copy of kubeml_tpu/api/errors.py's
base exception; the port imports nothing of the JAX package)."""

from __future__ import annotations


class KubeMLException(Exception):
    """Base exception carrying an HTTP-style status code."""

    def __init__(self, message: str, status_code: int = 500):
        super().__init__(message)
        self.message = message
        self.status_code = status_code

    def to_dict(self) -> dict:
        return {"code": self.status_code, "error": self.message}
