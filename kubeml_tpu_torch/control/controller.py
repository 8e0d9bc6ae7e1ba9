"""Controller — the public API gateway (twin of kubeml_tpu/control/
controller.py; parity with ml/pkg/controller/api.go:16-42):

    POST   /train              -> scheduler /train
    POST   /infer              -> scheduler /infer
    GET    /dataset            -> dataset summaries (storageApi.go:70-189)
    POST   /dataset/{name}     -> proxied to the storage service
                                  (storageApi.go:35-67 ReverseProxy)
    DELETE /dataset/{name}     -> storage service delete
    GET    /dataset/{name}     -> single summary
    GET    /tasks              -> PS task list (tasksApi.go:10-36)
    DELETE /tasks/{jobId}      -> PS stop
    GET    /history            -> all histories (historyApi.go:14-111)
    GET    /history/{taskId}   -> one history
    DELETE /history/{taskId}   -> delete one
    DELETE /history            -> prune all
    GET|POST|DELETE /functions[/{name}] -> the function registry
    GET    /health

Refused with the error envelope until their modules are ported: POST
/dataset/{name}/append (the continual mode), GET /trace/{jobId} and
/cost/{jobId} (ROADMAP A.13), GET /health/{jobId} (ROADMAP A.15) and GET
/cluster (ROADMAP A.16).
"""

from __future__ import annotations

import logging
import tempfile
from typing import Optional

from kubeml_tpu_torch.api.errors import KubeMLException
from kubeml_tpu_torch.control.httpd import (JsonService, Request, http_json,
                                            not_ported)
from kubeml_tpu_torch.data.registry import DatasetRegistry
from kubeml_tpu_torch.models import model_names
from kubeml_tpu_torch.train.functionlib import FunctionRegistry
from kubeml_tpu_torch.train.history import HistoryStore

logger = logging.getLogger("kubeml_tpu_torch.controller")


class Controller(JsonService):
    name = "controller"

    def __init__(self, scheduler_url: Optional[str] = None,
                 ps_url: Optional[str] = None,
                 storage_url: Optional[str] = None, port: int = 0,
                 registry: Optional[DatasetRegistry] = None,
                 history_store: Optional[HistoryStore] = None):
        super().__init__(port=port)
        self.scheduler_url = scheduler_url
        self.ps_url = ps_url
        self.storage_url = storage_url
        self.registry = registry or DatasetRegistry()
        self.history_store = history_store or HistoryStore()

        self.route("POST", "/train", self._h_train)
        self.route("POST", "/infer", self._h_infer)
        self.route("GET", "/dataset", self._h_dataset_list)
        self.route("GET", "/dataset/{name}", self._h_dataset_get)
        self.route("POST", "/dataset/{name}", self._h_dataset_create)
        self.route("DELETE", "/dataset/{name}", self._h_dataset_delete)
        self.route("GET", "/tasks", self._h_tasks)
        self.route("DELETE", "/tasks/{jobId}", self._h_task_stop)
        self.route("GET", "/history", self._h_history_list)
        self.route("GET", "/history/{taskId}", self._h_history_get)
        self.route("DELETE", "/history/{taskId}", self._h_history_delete)
        self.route("DELETE", "/history", self._h_history_prune)
        self.route("GET", "/functions", self._h_fn_list)
        self.route("GET", "/functions/{name}", self._h_fn_get)
        self.route("POST", "/functions/{name}", self._h_fn_create)
        self.route("DELETE", "/functions/{name}", self._h_fn_delete)
        # the job's 400 for the continual mode; 501 for the rest
        self.route("POST", "/dataset/{name}/append",
                   not_ported("POST /dataset/{name}/append",
                              "the continual mode", 400))
        for path, brings in (
                ("/trace/{jobId}", "the tracer, ROADMAP A.13"),
                ("/cost/{jobId}", "the cost ledger, ROADMAP A.13"),
                ("/health/{jobId}", "the health evaluator, ROADMAP A.15"),
                ("/cluster", "the cluster allocator, ROADMAP A.16")):
            self.route("GET", path, not_ported(f"GET {path}", brings))

    def _need(self, url, what):
        if url is None:
            raise KubeMLException(f"no {what} configured", 503)
        return url

    # ------------------------------------------------------------ train/infer

    def _h_train(self, req: Request):
        return http_json("POST",
                         f"{self._need(self.scheduler_url, 'scheduler')}/train",
                         req.body)

    def _h_infer(self, req: Request):
        return http_json("POST",
                         f"{self._need(self.scheduler_url, 'scheduler')}/infer",
                         req.body)

    # -------------------------------------------------------------- datasets

    def _h_dataset_list(self, req: Request):
        return [s.to_dict() for s in self.registry.list()]

    def _h_dataset_get(self, req: Request):
        return self.registry.get(req.params["name"]).summary().to_dict()

    def _h_dataset_create(self, req: Request):
        """Reverse-proxy the multipart upload to the storage service
        (storageApi.go:35-67)."""
        url = f"{self._need(self.storage_url, 'storage service')}" \
              f"/dataset/{req.params['name']}"
        return http_json("POST", url, raw_body=req.raw,
                         content_type=req.headers.get("Content-Type", ""),
                         timeout=600)

    def _h_dataset_delete(self, req: Request):
        return http_json(
            "DELETE",
            f"{self._need(self.storage_url, 'storage service')}"
            f"/dataset/{req.params['name']}")

    # ----------------------------------------------------------------- tasks

    def _h_tasks(self, req: Request):
        return http_json("GET", f"{self._need(self.ps_url, 'PS')}/tasks")

    def _h_task_stop(self, req: Request):
        return http_json(
            "DELETE",
            f"{self._need(self.ps_url, 'PS')}/stop/{req.params['jobId']}")

    # --------------------------------------------------------------- history

    def _h_history_list(self, req: Request):
        return [h.to_dict() for h in self.history_store.list()]

    def _h_history_get(self, req: Request):
        return self.history_store.get(req.params["taskId"]).to_dict()

    def _h_history_delete(self, req: Request):
        self.history_store.delete(req.params["taskId"])
        return {"ok": True}

    def _h_history_prune(self, req: Request):
        return {"deleted": self.history_store.prune()}

    # ------------------------------------------------------------- functions

    def _h_fn_list(self, req: Request):
        return ([{"name": n, "kind": "user"}
                 for n in FunctionRegistry().list()]
                + [{"name": n, "kind": "builtin"} for n in model_names()])

    def _h_fn_get(self, req: Request):
        FunctionRegistry().resolve(req.params["name"])  # 404 if absent
        return {"name": req.params["name"]}

    def _h_fn_create(self, req: Request):
        with tempfile.NamedTemporaryFile("wb", suffix=".py") as f:
            f.write(req.raw)
            f.flush()
            FunctionRegistry().create(req.params["name"], f.name)
        return {"name": req.params["name"]}

    def _h_fn_delete(self, req: Request):
        FunctionRegistry().delete(req.params["name"])
        return {"ok": True}
