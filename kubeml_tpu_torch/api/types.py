"""Wire types (copy of kubeml_tpu/api/types.py's TrainOptions,
TrainRequest, TrainTask, JobHistory, History, MetricUpdate, InferRequest,
DatasetSummary and ``dumps``; the port imports nothing of the JAX
package).

Every field is kept, in the same order, with the same default, so
``to_dict``/``from_dict`` are wire-equal to the JAX package's: a request,
task or history written by either package reads back in the other. What
each option does is documented on the JAX package's type; a TrainJob of
the port rejects with 400 each option whose module it has not ported yet
(kubeml_tpu_torch/train/job.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List


def _asdict(obj) -> dict:
    return dataclasses.asdict(obj)


@dataclass
class TrainOptions:
    """Tunable training options (ml/pkg/api/types.go:24-34)."""

    default_parallelism: int = 5
    static_parallelism: bool = False
    validate_every: int = 1
    k: int = 1                     # K-step local SGD period; -1 => once per epoch
    goal_accuracy: float = 100.0   # early-stop accuracy target (percent)
    checkpoint_every: int = 0
    engine: str = "kavg"
    shuffle: bool = False
    n_model: int = 1
    n_seq: int = 1
    n_expert: int = 1
    n_stage: int = 1
    pp_microbatches: int = 0
    fsdp: bool = False
    rounds_per_dispatch: int = 1
    seq_impl: str = "ring"         # 'ring' | 'ulysses'
    tp_impl: str = "gspmd"         # 'gspmd' | 'manual'
    max_parallelism: int = 0
    max_restarts: int = 1
    device_cache: str = "auto"
    device_cache_mb: int = 512
    quarantine_after: int = 0
    abort_after: int = 0
    fault_plan: str = ""
    checkpoint_every_rounds: int = 0
    reassign_on_quarantine: bool = False
    train_stats: bool = True
    merge_dtype: str = ""
    merge_compress: str = "none"
    merge_bucket_mb: float = 0.0
    continual: bool = False
    window_generations: int = 0
    publish_every_rounds: int = 0

    def to_dict(self) -> dict:
        return {
            "default_parallelism": self.default_parallelism,
            "static_parallelism": self.static_parallelism,
            "validate_every": self.validate_every,
            "K": self.k,
            "goal_accuracy": self.goal_accuracy,
            "checkpoint_every": self.checkpoint_every,
            "engine": self.engine,
            "shuffle": self.shuffle,
            "n_model": self.n_model,
            "n_seq": self.n_seq,
            "n_expert": self.n_expert,
            "n_stage": self.n_stage,
            "pp_microbatches": self.pp_microbatches,
            "fsdp": self.fsdp,
            "rounds_per_dispatch": self.rounds_per_dispatch,
            "seq_impl": self.seq_impl,
            "tp_impl": self.tp_impl,
            "max_parallelism": self.max_parallelism,
            "max_restarts": self.max_restarts,
            "device_cache": self.device_cache,
            "device_cache_mb": self.device_cache_mb,
            "quarantine_after": self.quarantine_after,
            "abort_after": self.abort_after,
            "fault_plan": self.fault_plan,
            "checkpoint_every_rounds": self.checkpoint_every_rounds,
            "reassign_on_quarantine": self.reassign_on_quarantine,
            "train_stats": self.train_stats,
            "merge_dtype": self.merge_dtype,
            "merge_compress": self.merge_compress,
            "merge_bucket_mb": self.merge_bucket_mb,
            "continual": self.continual,
            "window_generations": self.window_generations,
            "publish_every_rounds": self.publish_every_rounds,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TrainOptions":
        return cls(
            default_parallelism=d.get("default_parallelism", 5),
            static_parallelism=d.get("static_parallelism", False),
            validate_every=d.get("validate_every", 1),
            k=d.get("K", d.get("k", 1)),
            goal_accuracy=d.get("goal_accuracy", 100.0),
            checkpoint_every=d.get("checkpoint_every", 0),
            engine=d.get("engine", "kavg"),
            shuffle=d.get("shuffle", False),
            n_model=int(d.get("n_model", 1)),
            n_seq=int(d.get("n_seq", 1)),
            n_expert=int(d.get("n_expert", 1)),
            n_stage=int(d.get("n_stage", 1)),
            pp_microbatches=int(d.get("pp_microbatches", 0)),
            fsdp=bool(d.get("fsdp", False)),
            rounds_per_dispatch=int(d.get("rounds_per_dispatch", 1)),
            seq_impl=d.get("seq_impl", "ring"),
            tp_impl=d.get("tp_impl", "gspmd"),
            max_parallelism=int(d.get("max_parallelism", 0)),
            max_restarts=int(d.get("max_restarts", 1)),
            device_cache=d.get("device_cache", "auto"),
            device_cache_mb=int(d.get("device_cache_mb", 512)),
            quarantine_after=int(d.get("quarantine_after", 0)),
            abort_after=int(d.get("abort_after", 0)),
            fault_plan=d.get("fault_plan", ""),
            checkpoint_every_rounds=int(d.get("checkpoint_every_rounds", 0)),
            reassign_on_quarantine=bool(d.get("reassign_on_quarantine",
                                              False)),
            train_stats=bool(d.get("train_stats", True)),
            merge_dtype=d.get("merge_dtype", ""),
            merge_compress=d.get("merge_compress", "none"),
            merge_bucket_mb=float(d.get("merge_bucket_mb", 0.0)),
            continual=bool(d.get("continual", False)),
            window_generations=int(d.get("window_generations", 0)),
            publish_every_rounds=int(d.get("publish_every_rounds", 0)),
        )


@dataclass
class TrainRequest:
    """A train submission (ml/pkg/api/types.go:9-22)."""

    model_type: str        # registered function/model name
    batch_size: int
    epochs: int
    dataset: str
    lr: float
    function_name: str = ""
    options: TrainOptions = field(default_factory=TrainOptions)
    resume_from: str = ""
    priority: int = 0
    tenant: str = ""

    def to_dict(self) -> dict:
        return {
            "model_type": self.model_type,
            "batch_size": self.batch_size,
            "epochs": self.epochs,
            "dataset": self.dataset,
            "lr": self.lr,
            "function_name": self.function_name or self.model_type,
            "options": self.options.to_dict(),
            "resume_from": self.resume_from,
            "priority": self.priority,
            "tenant": self.tenant,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TrainRequest":
        return cls(
            model_type=d.get("model_type", d.get("function_name", "")),
            batch_size=int(d["batch_size"]),
            epochs=int(d["epochs"]),
            dataset=d["dataset"],
            lr=float(d["lr"]),
            function_name=d.get("function_name", ""),
            options=TrainOptions.from_dict(d.get("options", {})),
            resume_from=d.get("resume_from", ""),
            priority=int(d.get("priority", 0)),
            tenant=d.get("tenant", ""),
        )


@dataclass
class TrainTask:
    """A scheduled job (ml/pkg/api/types.go:44-58)."""

    job_id: str
    parameters: TrainRequest
    parallelism: int = 0
    elapsed_time_s: float = -1.0   # last epoch duration fed back to the policy
    state: str = "queued"          # queued | starting | running | finished | failed | stopped
    trace_id: str = ""
    restarts: int = 0
    preemptions: int = 0
    priority: int = 0
    tenant: str = ""
    grant_epoch: int = 0

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "parameters": self.parameters.to_dict(),
            "parallelism": self.parallelism,
            "elapsed_time_s": self.elapsed_time_s,
            "state": self.state,
            "trace_id": self.trace_id,
            "restarts": self.restarts,
            "preemptions": self.preemptions,
            "priority": self.priority,
            "tenant": self.tenant,
            "grant_epoch": self.grant_epoch,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TrainTask":
        return cls(
            job_id=d["job_id"],
            parameters=TrainRequest.from_dict(d["parameters"]),
            parallelism=d.get("parallelism", 0),
            elapsed_time_s=d.get("elapsed_time_s", -1.0),
            state=d.get("state", "queued"),
            trace_id=d.get("trace_id", ""),
            restarts=int(d.get("restarts", 0)),
            preemptions=int(d.get("preemptions", 0)),
            priority=int(d.get("priority", 0)),
            tenant=d.get("tenant", ""),
            grant_epoch=int(d.get("grant_epoch", 0)),
        )


@dataclass
class JobHistory:
    """Per-epoch metric arrays (ml/pkg/api/types.go:75-81)."""

    validation_loss: List[float] = field(default_factory=list)
    accuracy: List[float] = field(default_factory=list)
    train_loss: List[float] = field(default_factory=list)
    parallelism: List[int] = field(default_factory=list)
    epoch_duration: List[float] = field(default_factory=list)
    dropped_workers: List[float] = field(default_factory=list)
    quarantined_workers: List[int] = field(default_factory=list)
    reassigned_batches: List[int] = field(default_factory=list)
    grad_norm_summary: List[List[float]] = field(default_factory=list)
    update_ratio_summary: List[List[float]] = field(default_factory=list)
    loss_spread: List[float] = field(default_factory=list)
    restarts: int = 0
    preemptions: int = 0

    def to_dict(self) -> dict:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobHistory":
        return cls(
            validation_loss=list(d.get("validation_loss", [])),
            accuracy=list(d.get("accuracy", [])),
            train_loss=list(d.get("train_loss", [])),
            parallelism=list(d.get("parallelism", [])),
            epoch_duration=list(d.get("epoch_duration", [])),
            dropped_workers=list(d.get("dropped_workers", [])),
            quarantined_workers=list(d.get("quarantined_workers", [])),
            reassigned_batches=list(d.get("reassigned_batches", [])),
            grad_norm_summary=[list(x) for x in
                               d.get("grad_norm_summary", [])],
            update_ratio_summary=[list(x) for x in
                                  d.get("update_ratio_summary", [])],
            loss_spread=list(d.get("loss_spread", [])),
            restarts=int(d.get("restarts", 0)),
            preemptions=int(d.get("preemptions", 0)),
        )


@dataclass
class History:
    """A persisted training history record (ml/pkg/api/types.go:84-100)."""

    id: str
    task: TrainRequest
    data: JobHistory

    def to_dict(self) -> dict:
        return {"_id": self.id, "task": self.task.to_dict(), "data": self.data.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "History":
        return cls(
            id=d.get("_id", d.get("id", "")),
            task=TrainRequest.from_dict(d["task"]),
            data=JobHistory.from_dict(d["data"]),
        )


@dataclass
class MetricUpdate:
    """A per-epoch metric push from a job to the PS (ml/pkg/api/types.go:103-112)."""

    job_id: str
    validation_loss: float
    accuracy: float
    train_loss: float
    parallelism: int
    epoch_duration: float
    dropped_workers: float = 0.0
    quarantined_workers: int = 0
    reassigned_batches: int = 0
    checkpoint_drops: int = 0
    phase_times: Dict[str, List[float]] = field(default_factory=dict)
    grad_norms: List[float] = field(default_factory=list)
    update_ratios: List[float] = field(default_factory=list)
    worker_losses: List[float] = field(default_factory=list)
    loss_spread: float = 0.0
    jit_compiles: int = 0
    hbm_peak_bytes: int = 0
    hbm_in_use_bytes: int = 0
    trace_events_dropped: int = 0
    dataset_generation: int = 0
    data_lag_generations: int = -1
    cost_programs: Dict[str, dict] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MetricUpdate":
        return cls(**{k: d[k] for k in
                      ("job_id", "validation_loss", "accuracy", "train_loss",
                       "parallelism", "epoch_duration")},
                   dropped_workers=float(d.get("dropped_workers", 0.0)),
                   quarantined_workers=int(d.get("quarantined_workers", 0)),
                   reassigned_batches=int(d.get("reassigned_batches", 0)),
                   checkpoint_drops=int(d.get("checkpoint_drops", 0)),
                   phase_times={str(k): [float(x) for x in v]
                                for k, v in (d.get("phase_times")
                                             or {}).items()},
                   grad_norms=[float(x) for x in d.get("grad_norms", [])],
                   update_ratios=[float(x) for x in
                                  d.get("update_ratios", [])],
                   worker_losses=[float(x) for x in
                                  d.get("worker_losses", [])],
                   loss_spread=float(d.get("loss_spread", 0.0)),
                   jit_compiles=int(d.get("jit_compiles", 0)),
                   hbm_peak_bytes=int(d.get("hbm_peak_bytes", 0)),
                   hbm_in_use_bytes=int(d.get("hbm_in_use_bytes", 0)),
                   trace_events_dropped=int(d.get("trace_events_dropped",
                                                  0)),
                   dataset_generation=int(d.get("dataset_generation", 0)),
                   data_lag_generations=int(d.get("data_lag_generations",
                                                  -1)),
                   cost_programs=dict(d.get("cost_programs") or {}))


@dataclass
class InferRequest:
    """Inference request (ml/pkg/api/types.go:37-41)."""

    model_id: str          # jobId of the trained model
    data: Any = None       # JSON payload handed to the model's infer()

    def to_dict(self) -> dict:
        return {"model_id": self.model_id, "data": self.data}

    @classmethod
    def from_dict(cls, d: dict) -> "InferRequest":
        return cls(model_id=d["model_id"], data=d.get("data"))


@dataclass
class DatasetSummary:
    """Dataset listing entry (ml/pkg/api/types.go:66-72)."""

    name: str
    train_set_size: int
    test_set_size: int

    def to_dict(self) -> dict:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DatasetSummary":
        return cls(name=d["name"],
                   train_set_size=d.get("train_set_size", 0),
                   test_set_size=d.get("test_set_size", 0))


def dumps(obj) -> str:
    """Serialize any wire type (or list of them) to JSON."""
    if isinstance(obj, list):
        return json.dumps([o.to_dict() if hasattr(o, "to_dict") else o
                           for o in obj])
    return json.dumps(obj.to_dict() if hasattr(obj, "to_dict") else obj)
