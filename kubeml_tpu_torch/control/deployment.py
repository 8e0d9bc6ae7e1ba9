"""Single-host deployment: the whole control plane in one process (twin of
kubeml_tpu/control/deployment.py).

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

Cluster mode and the durable control plane, as the JAX package's:

    dep = start_deployment(cluster_lanes=4,
                           cluster_tenants=["prod=3:4", "batch=1"],
                           control_durable=True, control_dir=D)

puts the ClusterAllocator between the scheduler's queue and the PS, and
journals its decisions and the scheduler's and PS's state under D. A
second start on the same D is a restart: ``ps.recover()`` then
``scheduler.recover()`` re-adopt the children that survived, requeue the
dead ones, rebuild the fleets and re-fence the grants.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from kubeml_tpu_torch._device import DeviceLike, require_cuda
from kubeml_tpu_torch.api import const
from kubeml_tpu_torch.control.cluster import (ClusterAllocator,
                                              parse_tenant_spec)
from kubeml_tpu_torch.control.controller import Controller
from kubeml_tpu_torch.control.journal import DecisionJournal
from kubeml_tpu_torch.control.ps import ParameterServer
from kubeml_tpu_torch.control.scheduler import Scheduler
from kubeml_tpu_torch.control.storage import StorageService

# the serving knobs the PS takes (ParameterServer's serve_* arguments)
SERVE_KNOBS = (
    "serve_slots", "serve_queue_depth", "serve_prefill_chunk",
    "serve_kv_dtype", "serve_decode_steps", "serve_draft_model",
    "serve_prefix_cache", "serve_drain_grace_s", "serve_replicas_min",
    "serve_replicas_max", "serve_scale_to_zero_s",
    "serve_replica_restart_budget", "serve_probe_requests",
    "serve_hedge_after_s", "serve_slo_ttft_ms", "serve_slo_tpot_ms",
    "serve_slo_target")

# compaction cadence of the allocator's decision journal when the durable
# control plane is on: fold state into the snapshot every N journaled
# operations so replay length stays bounded
CONTROL_COMPACT_EVERY = 256


def control_state_dir() -> str:
    """Default durable-control-plane state directory."""
    return os.path.join(const.kubeml_home(), "control")


def build_allocator(cluster_lanes, cluster_tenants=None, aging_s=None,
                    journal_dir: Optional[str] = None,
                    fault_plan=None) -> Optional[ClusterAllocator]:
    """Build the scheduler's ClusterAllocator from deployment knobs.
    cluster_lanes <= 0 / None disables cluster mode (the FIFO path).
    cluster_tenants: iterable of ``name=weight[:quota]`` specs (the
    --cluster-tenant CLI flag) or a {name: (weight, quota)} mapping.
    journal_dir (durable control plane): attach a CRC-framed decision
    journal so the allocator is crash-recoverable; an existing journal
    there is REPLAYED — a restart reconstructs the pre-crash state."""
    if not cluster_lanes or int(cluster_lanes) <= 0:
        return None
    weights, quotas = {}, {}
    if isinstance(cluster_tenants, dict):
        for name, (weight, quota) in cluster_tenants.items():
            weights[name] = float(weight)
            if quota is not None:
                quotas[name] = int(quota)
    else:
        for spec in cluster_tenants or ():
            name, weight, quota = parse_tenant_spec(spec)
            weights[name] = weight
            if quota is not None:
                quotas[name] = quota
    kwargs = {} if aging_s is None else {"aging_s": float(aging_s)}
    if journal_dir is None:
        return ClusterAllocator(int(cluster_lanes), tenant_weights=weights,
                                tenant_quotas=quotas, **kwargs)
    journal = DecisionJournal(journal_dir, fault_plan=fault_plan)
    if os.path.exists(journal.journal_path) or \
            os.path.exists(journal.snapshot_path):
        return ClusterAllocator.recover(
            journal, int(cluster_lanes), tenant_weights=weights,
            tenant_quotas=quotas, compact_every=CONTROL_COMPACT_EVERY,
            **kwargs)
    return ClusterAllocator(int(cluster_lanes), tenant_weights=weights,
                            tenant_quotas=quotas, journal=journal,
                            compact_every=CONTROL_COMPACT_EVERY, **kwargs)


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
                     cluster_lanes: Optional[int] = None,
                     cluster_tenants=None,
                     cluster_aging_s: Optional[float] = None,
                     control_durable: bool = False,
                     control_dir: Optional[str] = None,
                     n_lanes: int = 1, **serve) -> Deployment:
    """Start storage, PS, scheduler, controller wired together.

    ``device`` is where the jobs run: None means CUDA, and the call
    raises without a card; "cpu" runs them on the CPU. Port 0 picks a
    free port (tests); use_default_ports uses the configured service
    ports (api/const.py). standalone_jobs runs each job in its own
    ``kubeml_tpu_torch.train.jobserver`` process; job_partitions gives
    concurrent standalone jobs an env dict each (CUDA_VISIBLE_DEVICES),
    naming at most the cards present. n_lanes is the data lanes of every
    job (``kubeml serve --mesh-data``). The serve_* knobs (SERVE_KNOBS)
    go to the PS's serving plane.

    cluster_lanes > 0 turns on the cluster allocator (control/cluster.py)
    over that many shared worker lanes, with cluster_tenants
    (``name=weight[:quota]`` specs) keying quotas and weighted fair
    shares and cluster_aging_s its aging; None/0 keeps the FIFO path.
    control_durable=True turns on the durable control plane: the
    allocator journals every decision, the scheduler and PS mirror their
    registries to state files under control_dir (default
    ``$KUBEML_TPU_HOME/control/``; giving control_dir implies it), and a
    start with state already there RECOVERS instead of starting cold.
    """
    for knob in serve:
        if knob not in SERVE_KNOBS:
            raise TypeError(f"start_deployment() got an unexpected keyword "
                            f"argument {knob!r}")
    if device is None:
        # checked up front, not at the first job: the parent of
        # standalone jobs never touches the card itself
        require_cuda()
    if use_default_ports:
        controller_port = controller_port or const.CONTROLLER_PORT
        scheduler_port = scheduler_port or const.SCHEDULER_PORT
        ps_port = ps_port or const.PS_PORT
        storage_port = storage_port or const.STORAGE_PORT

    state_dir = None
    prior_state = False
    if control_durable or control_dir:
        state_dir = control_dir or control_state_dir()
        # decide BEFORE the services create their (empty) state files:
        # anything already on disk means this start is a restart
        prior_state = os.path.isdir(state_dir) and \
            any(os.scandir(state_dir))
    # before any service starts: a bad tenant spec leaks nothing
    allocator = build_allocator(cluster_lanes, cluster_tenants,
                                cluster_aging_s, journal_dir=state_dir)

    ps = ParameterServer(device=device, port=ps_port,
                         standalone_jobs=standalone_jobs or None,
                         job_partitions=job_partitions,
                         infer_cache_size=infer_cache_size,
                         state_dir=state_dir, n_lanes=n_lanes, **serve)
    storage = StorageService(port=storage_port, registry=ps.ds_registry)
    storage.start()
    ps.start()
    scheduler = Scheduler(ps_url=ps.url, port=scheduler_port,
                          allocator=allocator, state_dir=state_dir)
    scheduler.start()
    ps.scheduler_url = scheduler.url
    if prior_state:
        # state on disk means this start RESTARTS a crashed control
        # plane: rebuild the PS's registries and fleets before the
        # scheduler's sweep decides re-adopt vs. requeue
        ps.recover()
        scheduler.recover()
    controller = Controller(scheduler_url=scheduler.url, ps_url=ps.url,
                            storage_url=storage.url, port=controller_port,
                            registry=ps.ds_registry,
                            history_store=ps.history_store)
    controller.start()
    return Deployment(controller=controller, scheduler=scheduler, ps=ps,
                      storage=storage)
