"""JSON state files written atomically (copy of kubeml_tpu/control/
journal.py:62-83). The decision journal itself (``DecisionJournal``)
comes with the durable control plane, ROADMAP A.16."""

from __future__ import annotations

import json
import os
from typing import Any, Optional


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
