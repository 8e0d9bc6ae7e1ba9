"""Single-host deployment: the whole training control plane in one
process (twin of kubeml_tpu/control/deployment.py).

The reference ships one binary whose role is chosen by flag
(ml/cmd/ml/main.go:60-156) and an in-process integration mode
(ml/tests/integration.go:14-36). Here storage, PS, scheduler and
controller start in one process; each binds its own port and talks HTTP,
so any role can be split out to another host unchanged.

    dep = start_deployment()                    # jobs on the card
    dep = start_deployment(device="cpu")        # jobs on the CPU (tests)
    client = KubemlClient(dep.controller_url).v1()
    ...
    dep.stop()
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from kubeml_tpu_torch._device import DeviceLike, require_cuda
from kubeml_tpu_torch.api import const
from kubeml_tpu_torch.control.controller import Controller
from kubeml_tpu_torch.control.ps import ParameterServer
from kubeml_tpu_torch.control.scheduler import Scheduler
from kubeml_tpu_torch.control.storage import StorageService

# the JAX package's deployment knobs this port does not carry yet, and
# the ROADMAP item that brings each
NOT_PORTED_KNOBS = {
    **{k: "serving through the PS, ROADMAP A.1" for k in (
        "serve_slots", "serve_queue_depth", "serve_prefill_chunk",
        "serve_kv_dtype", "serve_decode_steps", "serve_draft_model",
        "serve_prefix_cache", "serve_drain_grace_s", "serve_replicas_min",
        "serve_replicas_max", "serve_scale_to_zero_s",
        "serve_replica_restart_budget", "serve_probe_requests",
        "serve_hedge_after_s", "serve_slo_ttft_ms", "serve_slo_tpot_ms",
        "serve_slo_target")},
    **{k: "the cluster allocator, ROADMAP A.16" for k in (
        "cluster_lanes", "cluster_tenants", "cluster_aging_s")},
    **{k: "the durable control plane, ROADMAP A.16" for k in (
        "control_durable", "control_dir")},
}


@dataclasses.dataclass
class Deployment:
    controller: Controller
    scheduler: Scheduler
    ps: ParameterServer
    storage: StorageService

    @property
    def controller_url(self) -> str:
        return self.controller.url

    def stop(self):
        for svc in (self.controller, self.scheduler, self.ps, self.storage):
            svc.stop()


def start_deployment(device: DeviceLike = None, controller_port: int = 0,
                     scheduler_port: int = 0, ps_port: int = 0,
                     storage_port: int = 0,
                     use_default_ports: bool = False,
                     standalone_jobs: bool = False,
                     job_partitions: Optional[List[Dict[str, str]]] = None,
                     infer_cache_size: Optional[int] = None,
                     **not_ported) -> Deployment:
    """Start storage, PS, scheduler, controller wired together.

    ``device`` is where the jobs run: None means CUDA, and the call
    raises without a card; "cpu" runs them on the CPU. Port 0 picks a
    free port (tests); use_default_ports uses the configured service
    ports (api/const.py). standalone_jobs runs each job in its own
    ``kubeml_tpu_torch.train.jobserver`` process; job_partitions gives
    concurrent standalone jobs an env dict each (CUDA_VISIBLE_DEVICES),
    naming at most the cards present. The JAX package's serving, cluster
    and durability knobs raise ValueError naming the ROADMAP item that
    brings them (NOT_PORTED_KNOBS).
    """
    for knob, value in not_ported.items():
        if knob not in NOT_PORTED_KNOBS:
            raise TypeError(f"start_deployment() got an unexpected keyword "
                            f"argument {knob!r}")
        if value is not None and value is not False:
            raise ValueError(f"{knob} is not ported yet to kubeml_tpu_torch "
                             f"(comes with {NOT_PORTED_KNOBS[knob]})")
    if device is None:
        # checked up front, not at the first job: the parent of
        # standalone jobs never touches the card itself
        require_cuda()
    if use_default_ports:
        controller_port = controller_port or const.CONTROLLER_PORT
        scheduler_port = scheduler_port or const.SCHEDULER_PORT
        ps_port = ps_port or const.PS_PORT
        storage_port = storage_port or const.STORAGE_PORT

    ps = ParameterServer(device=device, port=ps_port,
                         standalone_jobs=standalone_jobs or None,
                         job_partitions=job_partitions,
                         infer_cache_size=infer_cache_size)
    storage = StorageService(port=storage_port, registry=ps.ds_registry)
    storage.start()
    ps.start()
    scheduler = Scheduler(ps_url=ps.url, port=scheduler_port)
    scheduler.start()
    ps.scheduler_url = scheduler.url
    controller = Controller(scheduler_url=scheduler.url, ps_url=ps.url,
                            storage_url=storage.url, port=controller_port,
                            registry=ps.ds_registry,
                            history_store=ps.history_store)
    controller.start()
    return Deployment(controller=controller, scheduler=scheduler, ps=ps,
                      storage=storage)
