"""Controller — the public API gateway (twin of kubeml_tpu/control/
controller.py; parity with ml/pkg/controller/api.go:16-42):

    POST   /train              -> scheduler /train
    POST   /infer              -> scheduler /infer
    GET    /dataset            -> dataset summaries (storageApi.go:70-189)
    POST   /dataset/{name}     -> proxied to the storage service
                                  (storageApi.go:35-67 ReverseProxy)
    POST   /dataset/{name}/append -> proxied to the storage service with
                                  its ?generation=/?retention= query
    DELETE /dataset/{name}     -> storage service delete
    GET    /dataset/{name}     -> single summary
    GET    /tasks              -> PS task list (tasksApi.go:10-36)
    DELETE /tasks/{jobId}      -> PS stop
    GET    /history            -> all histories (historyApi.go:14-111)
    GET    /history/{taskId}   -> one history
    DELETE /history/{taskId}   -> delete one
    DELETE /history            -> prune all
    GET|POST|DELETE /functions[/{name}] -> the function registry
    GET    /trace/{jobId}      -> PS /trace?id= (the merged job timeline)
    GET    /health/{jobId}     -> PS /health?id= (the job's health verdict)
    GET    /cost/{jobId}       -> PS /cost?id= (the job's or serve:<model>'s
                                  cost-ledger attribution)
    GET    /cluster            -> scheduler /cluster (the allocator's
                                  snapshot; 503 without cluster mode)
    GET    /health             (the gateway's own liveness)
"""

from __future__ import annotations

import logging
import tempfile
from typing import Optional
from urllib.parse import urlencode

from kubeml_tpu_torch.api.errors import KubeMLException
from kubeml_tpu_torch.control.httpd import JsonService, Request, http_json
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
        self.route("POST", "/dataset/{name}/append", self._h_dataset_append)
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
        self.route("GET", "/trace/{jobId}", self._h_trace)
        # /health stays the gateway's own liveness probe; the job-health
        # verdict gets its own path segment
        self.route("GET", "/health/{jobId}", self._h_job_health)
        self.route("GET", "/cluster", self._h_cluster)
        self.route("GET", "/cost/{jobId}", self._h_cost)

    def _need(self, url, what):
        if url is None:
            raise KubeMLException(f"no {what} configured", 503)
        return url

    def _h_cluster(self, req: Request):
        """Cluster-allocator snapshot (pool, queues, tenant shares),
        proxied to the scheduler, which owns the allocator; 503 when the
        deployment runs without cluster mode."""
        return http_json(
            "GET", f"{self._need(self.scheduler_url, 'scheduler')}/cluster")

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

    def _h_dataset_append(self, req: Request):
        """Reverse-proxy a generation-tagged append, keeping the
        ?generation=/?retention= query the storage service validates."""
        url = f"{self._need(self.storage_url, 'storage service')}" \
              f"/dataset/{req.params['name']}/append"
        if req.query:
            url += "?" + urlencode(req.query)
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

    def _h_trace(self, req: Request):
        """Merged job timeline, proxied to the PS (which owns the trace
        directory) so ``kubeml trace --id`` needs only the gateway URL."""
        return http_json(
            "GET",
            f"{self._need(self.ps_url, 'PS')}/trace"
            f"?id={req.params['jobId']}")

    def _h_cost(self, req: Request):
        """Per-program cost attribution, proxied to the PS (which holds
        the latest ledger snapshots) so ``kubeml cost --id`` needs only
        the gateway URL."""
        return http_json(
            "GET",
            f"{self._need(self.ps_url, 'PS')}/cost"
            f"?id={req.params['jobId']}")

    def _h_job_health(self, req: Request):
        """Training-health verdict, proxied to the PS (which owns the
        rolling metric windows) so ``kubeml health/top --id`` need only
        the gateway URL."""
        return http_json(
            "GET",
            f"{self._need(self.ps_url, 'PS')}/health"
            f"?id={req.params['jobId']}")

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
