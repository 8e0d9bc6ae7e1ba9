"""Python client SDK for the controller API (twin of kubeml_tpu/control/
client.py).

Parity with the Go client SDK (ml/pkg/controller/client/v1/v1.go:5-38):
``KubemlClient.v1()`` exposes Networks / Datasets / Functions / Histories
/ Tasks resource clients with the same operations (Train/Infer,
Create/Delete/List, Get/Delete/List/Prune, List/Stop). The wire is the
JAX package's, so either package's client drives either package's
deployment. The traces, cost and health clients are kept: a port
deployment answers them with the not-ported envelope (ROADMAP A.13,
A.15), and they work against a JAX deployment. The train call mints the
trace id that rides the X-KubeML-Trace-Id header; the client's own
submit span comes with the tracer (ROADMAP A.13).
"""

from __future__ import annotations

import os
import random
import time
import uuid
from typing import List, Optional

from kubeml_tpu_torch.api.const import CONTROLLER_URL
from kubeml_tpu_torch.api.errors import KubeMLException
from kubeml_tpu_torch.api.types import (DatasetSummary, History,
                                        InferRequest, TrainRequest,
                                        TrainTask)
from kubeml_tpu_torch.control.httpd import http_json
from kubeml_tpu_torch.utils.trace import (get_trace_context, make_trace_id,
                                          trace_context)

# Bounded retry for TRANSIENT connection failures only. httpd.http_json
# maps transport errors (refused/reset/DNS) to a 503 whose message leads
# with "cannot reach" — that exact pairing is the retry predicate, so
# SEMANTIC 503s (e.g. the PS's all-partitions-busy answer) pass straight
# through: retrying those would just hammer a server that already gave a
# considered answer. Capped small so CLI calls and tests never stall
# more than ~1.5 s on a genuinely dead controller.
RETRY_ATTEMPTS = 3
RETRY_BASE_S = 0.1
RETRY_CAP_S = 1.0


def _retryable(e: KubeMLException) -> bool:
    return e.status_code == 503 and "cannot reach" in str(e.message)


def _request(method: str, url: str, body=None, **kw):
    """http_json with exponential backoff + jitter on transient
    connection errors (full jitter halves the thundering-herd sync of
    many clients retrying a controller that just restarted)."""
    delay = RETRY_BASE_S
    for attempt in range(RETRY_ATTEMPTS):
        try:
            return http_json(method, url, body, **kw)
        except KubeMLException as e:
            if attempt == RETRY_ATTEMPTS - 1 or not _retryable(e):
                raise
            time.sleep(min(delay, RETRY_CAP_S) * (0.5 + random.random() / 2))
            delay *= 2


def _multipart_body(files: dict) -> tuple:
    """Build a multipart/form-data body: {field: (filename, bytes)}."""
    boundary = uuid.uuid4().hex
    parts = []
    for field, (filename, payload) in files.items():
        parts.append(
            (f"--{boundary}\r\n"
             f'Content-Disposition: form-data; name="{field}"; '
             f'filename="{filename}"\r\n'
             f"Content-Type: application/octet-stream\r\n\r\n").encode()
            + payload + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class NetworksClient:
    def __init__(self, base: str):
        self.base = base

    def train(self, req: TrainRequest,
              trace_id: Optional[str] = None) -> str:
        """Submit a training job. The trace begins here: a trace_id is
        minted (unless the caller supplies one or the thread carries one)
        and rides the X-KubeML-Trace-Id header through controller ->
        scheduler -> PS -> job process."""
        trace_id = trace_id or get_trace_context() or make_trace_id()
        with trace_context(trace_id):
            out = _request("POST", f"{self.base}/train", req.to_dict())
        return out["id"]

    def infer(self, model_id: str, data) -> list:
        out = _request("POST", f"{self.base}/infer",
                        InferRequest(model_id=model_id, data=data).to_dict())
        return out["predictions"]


class DatasetsClient:
    def __init__(self, base: str):
        self.base = base

    def create(self, name: str, train_data: str, train_labels: str,
               test_data: str, test_labels: str) -> DatasetSummary:
        """Multipart upload of the four files, same field names as the Go
        client (v1/dataset.go:50-106)."""
        files = {}
        for field, path in (("x-train", train_data), ("y-train", train_labels),
                            ("x-test", test_data), ("y-test", test_labels)):
            with open(path, "rb") as f:
                files[field] = (os.path.basename(path), f.read())
        body, ctype = _multipart_body(files)
        out = _request("POST", f"{self.base}/dataset/{name}", raw_body=body,
                        content_type=ctype, timeout=600)
        return DatasetSummary.from_dict(out)

    def append(self, name: str, train_data: str, train_labels: str,
               generation: Optional[int] = None,
               retention: int = 0) -> dict:
        """Generation-tagged train append (two files). Returns the
        post-commit summary dict including the new `generation`."""
        files = {}
        for field, path in (("x-train", train_data),
                            ("y-train", train_labels)):
            with open(path, "rb") as f:
                files[field] = (os.path.basename(path), f.read())
        body, ctype = _multipart_body(files)
        qs = []
        if generation is not None:
            qs.append(f"generation={int(generation)}")
        if retention:
            qs.append(f"retention={int(retention)}")
        url = f"{self.base}/dataset/{name}/append"
        if qs:
            url += "?" + "&".join(qs)
        return _request("POST", url, raw_body=body,
                        content_type=ctype, timeout=600)

    def delete(self, name: str) -> None:
        _request("DELETE", f"{self.base}/dataset/{name}")

    def get(self, name: str) -> DatasetSummary:
        return DatasetSummary.from_dict(
            _request("GET", f"{self.base}/dataset/{name}"))

    def list(self) -> List[DatasetSummary]:
        return [DatasetSummary.from_dict(d)
                for d in _request("GET", f"{self.base}/dataset")]


class FunctionsClient:
    def __init__(self, base: str):
        self.base = base

    def create(self, name: str, code_path: str) -> None:
        with open(code_path, "rb") as f:
            _request("POST", f"{self.base}/functions/{name}",
                      raw_body=f.read(), content_type="text/x-python")

    def get(self, name: str) -> dict:
        return _request("GET", f"{self.base}/functions/{name}")

    def delete(self, name: str) -> None:
        _request("DELETE", f"{self.base}/functions/{name}")

    def list(self) -> List[dict]:
        return _request("GET", f"{self.base}/functions")


class HistoriesClient:
    def __init__(self, base: str):
        self.base = base

    def get(self, task_id: str) -> History:
        return History.from_dict(
            _request("GET", f"{self.base}/history/{task_id}"))

    def delete(self, task_id: str) -> None:
        _request("DELETE", f"{self.base}/history/{task_id}")

    def list(self) -> List[History]:
        return [History.from_dict(d)
                for d in _request("GET", f"{self.base}/history")]

    def prune(self) -> int:
        return _request("DELETE", f"{self.base}/history")["deleted"]


class TasksClient:
    def __init__(self, base: str):
        self.base = base

    def list(self) -> List[TrainTask]:
        return [TrainTask.from_dict(d)
                for d in _request("GET", f"{self.base}/tasks")]

    def stop(self, job_id: str) -> None:
        _request("DELETE", f"{self.base}/tasks/{job_id}")


class TracesClient:
    def __init__(self, base: str):
        self.base = base

    def get(self, job_id: str) -> dict:
        """Merged Chrome trace-event document for a job (Perfetto/
        chrome://tracing loadable)."""
        return _request("GET", f"{self.base}/trace/{job_id}")


class CostClient:
    def __init__(self, base: str):
        self.base = base

    def get(self, job_id: str) -> dict:
        """Per-program analytic cost attribution for a job or serving
        model (serve:<model>): {"id", "programs", "attributed"}."""
        return _request("GET", f"{self.base}/cost/{job_id}")


class HealthClient:
    def __init__(self, base: str):
        self.base = base

    def get(self, job_id: str) -> dict:
        """Training-health verdict for a job: {"id", "state",
        "reasons": [{"rule", "severity", "detail"}], "latest": {...}}
        (control/health.py)."""
        return _request("GET", f"{self.base}/health/{job_id}")


class V1:
    def __init__(self, base: str):
        self._base = base

    def networks(self) -> NetworksClient:
        return NetworksClient(self._base)

    def datasets(self) -> DatasetsClient:
        return DatasetsClient(self._base)

    def functions(self) -> FunctionsClient:
        return FunctionsClient(self._base)

    def histories(self) -> HistoriesClient:
        return HistoriesClient(self._base)

    def tasks(self) -> TasksClient:
        return TasksClient(self._base)

    def traces(self) -> TracesClient:
        return TracesClient(self._base)

    def cost(self) -> CostClient:
        return CostClient(self._base)

    def health(self) -> HealthClient:
        return HealthClient(self._base)


class KubemlClient:
    def __init__(self, controller_url: Optional[str] = None):
        self.controller_url = controller_url or CONTROLLER_URL

    def v1(self) -> V1:
        return V1(self.controller_url)
