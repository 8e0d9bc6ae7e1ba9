"""Storage service — dataset ingest over HTTP (twin of kubeml_tpu/control/
storage.py; parity with python/storage/api.py:43-156).

POST /dataset/{name} takes a multipart form with four file fields
(x-train, y-train, x-test, y-test: the field names the Go client sends,
ml/pkg/controller/client/v1/dataset.go:50-106), rejects duplicates and
registers the dataset (64-sample addressable docs over contiguous
arrays); POST /dataset/{name}/append takes x-train and y-train plus
``?generation=`` and ``?retention=`` and commits one generation of the
continual mode; DELETE drops a dataset, GET lists.

``parse_multipart`` gives what the JAX package's gives ({field:
(filename, bytes)}) but cuts the body at its boundaries with bytes.find
instead of running it through the email parser, so a CIFAR-sized upload
(~184 MB) costs one copy of each file.
"""

from __future__ import annotations

import email.parser
import email.policy
import logging
import os
import re
import tempfile
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

from kubeml_tpu_torch.api.errors import InvalidFormatError
from kubeml_tpu_torch.control.httpd import JsonService, Request
from kubeml_tpu_torch.data.ingest import append_files, ingest_files
from kubeml_tpu_torch.data.registry import DatasetRegistry

logger = logging.getLogger("kubeml_tpu_torch.storage")

FIELDS = ("x-train", "y-train", "x-test", "y-test")
APPEND_FIELDS = ("x-train", "y-train")

_BOUNDARY = re.compile(r'boundary="?([^";]+)"?', re.IGNORECASE)


def parse_multipart(content_type: str, raw: bytes) -> Dict[str, tuple]:
    """Parse multipart/form-data into {field: (filename, bytes)}; parts
    without a field name are skipped."""
    if "multipart/form-data" not in (content_type or ""):
        raise InvalidFormatError("expected multipart/form-data")
    m = _BOUNDARY.search(content_type)
    if m is None:
        raise InvalidFormatError("multipart/form-data without a boundary")
    delim = b"--" + m.group(1).encode()
    headers = email.parser.BytesHeaderParser(policy=email.policy.default)
    out = {}
    pos = raw.find(delim)
    while pos >= 0:
        start = pos + len(delim)
        if raw.startswith(b"--", start):     # the closing delimiter
            break
        head_end = raw.find(b"\r\n\r\n", start)
        end = raw.find(b"\r\n" + delim, head_end + 4) if head_end >= 0 \
            else -1
        if end < 0:
            raise InvalidFormatError("truncated multipart body")
        part = headers.parsebytes(raw[start:head_end].lstrip(b"\r\n")
                                  + b"\r\n\r\n")
        name = part.get_param("name", header="content-disposition")
        if name:
            out[name] = (part.get_filename() or "", raw[head_end + 4:end])
        pos = end + 2
    return out


@contextmanager
def uploaded_files(req: Request, fields) -> Iterator[Dict[str, str]]:
    """The request's multipart ``fields`` written to files in a temporary
    directory, {field: path}, for the duration of the block."""
    parts = parse_multipart(req.headers.get("Content-Type", ""), req.raw)
    missing = [f for f in fields if f not in parts]
    if missing:
        raise InvalidFormatError(f"missing form files: {missing}")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for field in fields:
            filename, payload = parts[field]
            ext = os.path.splitext(filename)[1] or ".npy"
            p = os.path.join(tmp, field + ext)
            with open(p, "wb") as f:
                f.write(payload)
            paths[field] = p
        yield paths


class StorageService(JsonService):
    name = "storage"

    def __init__(self, port: int = 0,
                 registry: Optional[DatasetRegistry] = None):
        super().__init__(port=port)
        self.registry = registry or DatasetRegistry()
        self.route("POST", "/dataset/{name}/append", self._h_append)
        self.route("POST", "/dataset/{name}", self._h_create)
        self.route("DELETE", "/dataset/{name}", self._h_delete)
        self.route("GET", "/dataset", self._h_list)

    def _h_create(self, req: Request):
        name = req.params["name"]
        with uploaded_files(req, FIELDS) as paths:
            handle = ingest_files(name, paths["x-train"], paths["y-train"],
                                  paths["x-test"], paths["y-test"],
                                  registry=self.registry)
        logger.info("ingested dataset %s (%d train / %d test)", name,
                    handle.train_samples, handle.test_samples)
        return handle.summary().to_dict()

    def _h_append(self, req: Request):
        """A generation-tagged train append: the x-train / y-train files,
        ``?generation=`` (the producer's monotone tag, optional) and
        ``?retention=`` (the window in generations). Shape/dtype drift
        and a non-monotonic generation are 400s before any commit."""
        name = req.params["name"]
        try:
            generation = (int(req.query["generation"])
                          if "generation" in req.query else None)
            retention = int(req.query.get("retention", 0))
        except ValueError:
            raise InvalidFormatError(
                "generation/retention must be integers") from None
        with uploaded_files(req, APPEND_FIELDS) as paths:
            handle = append_files(name, paths["x-train"], paths["y-train"],
                                  generation=generation,
                                  retention_generations=retention,
                                  registry=self.registry)
        logger.info("appended to dataset %s -> generation %d (%d train)",
                    name, handle.generation, handle.train_samples)
        doc = handle.summary().to_dict()
        doc["generation"] = handle.generation
        return doc

    def _h_delete(self, req: Request):
        self.registry.delete(req.params["name"])
        return {"ok": True}

    def _h_list(self, req: Request):
        return [s.to_dict() for s in self.registry.list()]
