"""Training-history store (copy of kubeml_tpu/train/history.py; the port
imports nothing of the JAX package): one History record per job with the
per-epoch metric arrays, in sqlite at $KUBEML_TPU_HOME/history.db — the
same schema and file, so either package reads the other's records.
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
from typing import List, Optional

from kubeml_tpu_torch.api.const import kubeml_home
from kubeml_tpu_torch.api.errors import JobNotFoundError
from kubeml_tpu_torch.api.types import History, JobHistory, TrainRequest


class HistoryStore:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.path.join(kubeml_home(), "history.db")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with self._conn():
            pass  # fail fast on an unwritable path

    @contextlib.contextmanager
    def _conn(self):
        conn = sqlite3.connect(self.path)
        try:
            with conn:  # transaction
                # per-connection: sqlite silently recreates a db file that
                # was deleted under a live service; ensure the schema on
                # every open so such a store heals instead of erroring
                conn.execute("CREATE TABLE IF NOT EXISTS history ("
                             "id TEXT PRIMARY KEY, task TEXT, data TEXT)")
                yield conn
        finally:
            conn.close()

    def save(self, record: History) -> None:
        with self._conn() as c:
            c.execute("INSERT OR REPLACE INTO history VALUES (?,?,?)",
                      (record.id, json.dumps(record.task.to_dict()),
                       json.dumps(record.data.to_dict())))

    def get(self, job_id: str) -> History:
        with self._conn() as c:
            row = c.execute("SELECT task, data FROM history WHERE id=?",
                            (job_id,)).fetchone()
        if row is None:
            raise JobNotFoundError(job_id)
        return History(id=job_id,
                       task=TrainRequest.from_dict(json.loads(row[0])),
                       data=JobHistory.from_dict(json.loads(row[1])))

    def delete(self, job_id: str) -> None:
        with self._conn() as c:
            n = c.execute("DELETE FROM history WHERE id=?", (job_id,)).rowcount
        if n == 0:
            raise JobNotFoundError(job_id)

    def list(self) -> List[History]:
        with self._conn() as c:
            rows = c.execute("SELECT id, task, data FROM history").fetchall()
        return [History(id=i, task=TrainRequest.from_dict(json.loads(t)),
                        data=JobHistory.from_dict(json.loads(d)))
                for i, t, d in rows]

    def prune(self) -> int:
        """Delete all records (CLI `history prune`,
        ml/pkg/kubeml-cli/cmd/history.go)."""
        with self._conn() as c:
            return c.execute("DELETE FROM history").rowcount
