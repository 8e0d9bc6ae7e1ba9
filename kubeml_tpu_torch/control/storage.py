"""Storage service — dataset ingest over HTTP (twin of kubeml_tpu/control/
storage.py; parity with python/storage/api.py:43-156).

POST /dataset/{name} takes a multipart form with four file fields
(x-train, y-train, x-test, y-test: the field names the Go client sends,
ml/pkg/controller/client/v1/dataset.go:50-106), rejects duplicates and
registers the dataset (64-sample addressable docs over contiguous
arrays); DELETE drops it, GET lists. POST /dataset/{name}/append belongs
to the continual mode and is refused.

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
from typing import Dict, Optional

from kubeml_tpu_torch.api.errors import InvalidFormatError
from kubeml_tpu_torch.control.httpd import JsonService, Request, not_ported
from kubeml_tpu_torch.data.ingest import ingest_files
from kubeml_tpu_torch.data.registry import DatasetRegistry

logger = logging.getLogger("kubeml_tpu_torch.storage")

FIELDS = ("x-train", "y-train", "x-test", "y-test")

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


class StorageService(JsonService):
    name = "storage"

    def __init__(self, port: int = 0,
                 registry: Optional[DatasetRegistry] = None):
        super().__init__(port=port)
        self.registry = registry or DatasetRegistry()
        # the job's own refusal of the continual options, same wording
        self.route("POST", "/dataset/{name}/append",
                   not_ported("POST /dataset/{name}/append",
                              "the continual mode", 400))
        self.route("POST", "/dataset/{name}", self._h_create)
        self.route("DELETE", "/dataset/{name}", self._h_delete)
        self.route("GET", "/dataset", self._h_list)

    def _h_create(self, req: Request):
        name = req.params["name"]
        parts = parse_multipart(req.headers.get("Content-Type", ""), req.raw)
        missing = [f for f in FIELDS if f not in parts]
        if missing:
            raise InvalidFormatError(f"missing form files: {missing}")
        with tempfile.TemporaryDirectory() as tmp:
            paths = {}
            for field in FIELDS:
                filename, payload = parts[field]
                ext = os.path.splitext(filename)[1] or ".npy"
                p = os.path.join(tmp, field + ext)
                with open(p, "wb") as f:
                    f.write(payload)
                paths[field] = p
            handle = ingest_files(name, paths["x-train"], paths["y-train"],
                                  paths["x-test"], paths["y-test"],
                                  registry=self.registry)
        logger.info("ingested dataset %s (%d train / %d test)", name,
                    handle.train_samples, handle.test_samples)
        return handle.summary().to_dict()

    def _h_delete(self, req: Request):
        self.registry.delete(req.params["name"])
        return {"ok": True}

    def _h_list(self, req: Request):
        return [s.to_dict() for s in self.registry.list()]
