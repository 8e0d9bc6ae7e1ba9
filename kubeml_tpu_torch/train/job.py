"""TrainJob — the per-job training loop (twin of kubeml_tpu/train/job.py)
over the port's one-device K-avg engine, or its SyncDP engine.

    TrainJob(task, model, dataset, device=None).train()
      -> the dataset handle from the registry
      -> RoundLoader epoch plans, rounds assembled in a prefetch thread
         (grouped R at a time under options.rounds_per_dispatch): the
         samples themselves, or, when the job runs from the device-resident
         dataset cache, [W, S, B] gather indices (epoch_index_rounds)
      -> KAvgEngine.train_round(s) or train_round(s)_indexed: K local
         steps per virtual worker and the merge (the flash kernels and
         the fused merge kernel on the card)
      -> eval_round, the parallelism callback, checkpoints, the history.

Kept from the JAX package's job:
  - the per-epoch flow: train; ask ``callbacks.request_parallelism``
    unless the job is static (never after the last epoch), capped by
    ``max_parallelism`` from epoch 1; validate every ``validate_every``
    epochs; stop on request or at the goal accuracy; a final validation
    when the last epoch ran none; ``publish_metrics`` after every epoch;
  - the checkpoint cadence (``checkpoint_every`` N > 0 every N epochs, 0
    every validated epoch, -1 the final only), drained before the final
    save, or ``mark_checkpoint_completed`` when the last periodic save
    already holds the final state;
  - ``resume_from``: a warm start from another job's checkpoint (function
    name and shapes checked), or crash recovery from the job's own (start
    epoch, history and parallelism from the manifest; a completed one
    finishes at once);
  - elastic shape pinning: W is pinned at the lane-padded cap (the port
    runs no masked worker, so this costs nothing; the round tensors stay
    equal to the JAX package's);
  - the epoch loss: the mean over the workers that ran of loss sum /
    steps; a round with no contributor aborts; per-worker health stats;
  - the merge options with the JAX package's validation;
  - the device cache decision (``device_cache`` auto/on/off): the same
    eligibility (an identity ``transform_train`` or a
    ``transform_train_device`` twin), the same layout (replicated under
    shuffle, sharded otherwise), the same ``device_cache_mb`` budget under
    ``auto`` with host staging and a log line as the fallback, the same
    400 under ``on``, and the same one-time log of the per-round payload;
  - the checkpoint's variable tree: ``{"params"}``, or ``{"params",
    "batch_stats"}`` for a model with running statistics.

Kept too: the multi-process rules. Under a process group
(``parallel/distributed.py``; the ``KUBEML_*`` contract of
``tools/launch_distributed.py``) the ``n_lanes`` lanes are laid out over
the ranks (``n_lanes % world`` is checked at construction) and every
rank runs the same host loop in lockstep over the same data: the same
plans, the same round hooks, its own lanes' workers, the merge's
all-reduces, and the whole validation on every rank (so every rank's
history is the same). The collectives are issued only from the thread
that runs ``train()``, never from the prefetch thread (the JAX package
records a Gloo deadlock there). ``device_cache='on'`` raises the JAX
package's 400 and ``'auto'`` stages the rounds from the host;
``rounds_per_dispatch`` is 1. Every rank writes its own history and
checkpoint under its own ``KUBEML_TPU_HOME``, after a barrier: the
validation runs no collective, so without it a rank whose peer died
would checkpoint an epoch its peer never saved, and a restarted cluster
would resume its ranks at different epochs. A syncdp job does the same
over the SyncDP engine: every rank is handed each reflowed global batch
and its whole mask, and the engine copies its lanes' slice; the
engine's variables view (its fsdp shards gathered, a collective every
rank makes after every epoch) feeds validation and the checkpoints.

What differs:
  - ``device`` (None = CUDA) and ``n_lanes`` replace the mesh;
  - a job without ``resume_from`` starts from the model's
    ``init_module``: flax's default distributions drawn from a
    ``torch.Generator`` seeded by ``seed`` (jax.random's bits cannot be
    reproduced). A JAX checkpoint warm-starts a port job bit for bit;
  - the seconds an epoch spends building and loading kernels at first use
    (ops/_build.py) are left out of the time the throughput policy sees,
    as the JAX package leaves out its compiles;
  - ``jit_compiles`` counts the dispatches at which the JAX package would
    compile (a new round key, ``RoundStats.compiled``; the same count for
    the same plan), and ``cost_programs`` carries the engine's cost
    ledger with the closed-form records the JAX package writes with
    ``KUBEML_COST_LEDGER=0`` (metrics/ledger.py);
  - ``hbm_*`` come from the CUDA caching allocator on the card; on the
    CPU from the bytes of the job's state, the merge residuals and the
    device cache (metrics/runtime.py), not the JAX package's live-array
    sum.

Kept too: the tracer. Host spans ``epoch`` > ``round`` > {``data_wait``,
``dispatch``}, ``cache_upload`` where the device cache lays out its
slabs, ``merge_overlap`` around a grouped dispatch's bookkeeping and
``merge_wait`` around the epoch's blocking readback; ``phase_times`` come
from ``tracer.durations()``, the epoch's log line carries
``tracer.format_summary()``, and the timeline goes to ``TraceSink(job,
"job")`` after every epoch. The spans time the host and never synchronize
the card: a ``dispatch`` span is the time to enqueue a round, and the
device's time shows up where the host waits. With ``log_file`` the job
writes its log lines there too (what ``kubeml logs`` prints).

Kept too: the degraded mode and preemption. ``fault_plan``
(faults.FaultPlan: its NaN bursts poison the host batch before the round
is dispatched, the rest runs as the round hook, composed with a user
``round_hook``, the plan first); the non-finite guard (``quarantine_after``
consecutive drops quarantine a worker for the rest of the epoch, a
host-side edit of the worker mask between dispatches; ``abort_after``
rounds in a row in which every worker dropped fail the job);
``reassign_on_quarantine`` (makeup rounds after the planned ones deal a
quarantined worker's untrained samples to the survivors, exactly once);
``checkpoint_every_rounds`` (the ``train_state`` round cursor in the
manifest, in the JAX package's keys, so either package resumes the
other's); ``preempt()`` (the job server's SIGTERM, or a ``preempt``
event): the job finishes the round, saves the cursor and raises
JobPreemptedError. These need per-round host control, so they dispatch
one round at a time. A NaN plan turns the device cache off (index-fed
rounds carry no host floats to poison), and reassignment forces its
replicated layout. A resume at the cursor, under unchanged membership,
gives the weights of an uninterrupted run bit for bit; a cursor whose
worker count or round no longer fits the epoch is discarded and the
epoch replays from round 0.

Kept too: the continual mode (``continual``, ``window_generations``,
``publish_every_rounds``, with the JAX package's 400s,
``check_continual_options``). Between epochs the job polls the registry
(``_continual_refresh``): a newer generation swaps a fresh handle, over
the newest ``window_generations`` when set, into the loader and the
device cache, whose next ``ensure`` re-lays out only the lanes whose
absolute sample range moved. ``epochs <= 0`` runs an unbounded epoch
loop; every MetricUpdate carries the (trained generation, registry lag)
pair; every ``publish_every_rounds`` rounds the round-cursor save writes
a stamped checkpoint, which the PS's fleet hot-swaps into serving.

Kept too: the SyncDP engine (``engine='syncdp'``, ``fsdp``,
``merge_compress``/``merge_bucket_mb`` mapped to its ef_bf16, ef_int8 or
bucketed gradient merge, ``check_merge_options``). A syncdp epoch
(``_train_epoch_syncdp``) reflows each planned round [W, S, B] into S
global batches [S, W*B] (``_to_global``, worker-major), folds the worker
mask into the sample mask, and dispatches them to
``SyncDPEngine.train_steps(_indexed)`` with ``rngs[0]``; the engine's
state (its persistent optimizer, its EF residuals) lives across epochs,
and the variables view is refreshed after every epoch for validation,
checkpoints and /infer. A NaN fault poisons the global gradient (the
step is skipped, counted in ``dropped_workers``); ``abort_after``
consecutive skipped steps fail the job; the device cache is replicated;
the round-cursor options, reassignment and quarantine events are the JAX
package's 400s (they need kavg), as are fsdp with an explicit merge or
without syncdp, and merge_dtype under syncdp.

Tensor, sequence, pipeline and expert parallelism (``n_model`` > 1
under ``tp_impl`` gspmd or manual, alone or with a ring ``n_seq``;
``n_seq`` > 1 with ``seq_impl`` ring or ulysses; ``n_stage`` > 1 with
``pp_microbatches`` M, alone or with ``n_expert``; ``n_expert`` > 1,
alone or with ``n_seq``) run over ranks laid out as the rank grid
(``distributed.make_grid``: data outermost, expert innermost): the job
checks them with the JAX package's 400s in its order (``_inner_axes``,
``_check_seq_lengths``), the model builds tensor-, seq- and
expert-parallel modules and takes its pipelined loss
(``enable_pipeline_parallel``), the K-avg engine runs its inner round
over the data group's lanes, and every round is host-staged (the device
cache stays off, as in the JAX package). Without a group the world is
one device, so an inner axis is the JAX package's 400; it never runs
dense. The GSPMD tensor-parallel route runs the same Megatron layers as
the manual one, with the JAX package's rule table read as a plan
(``parallel/tp.shard_plan``: a pair that does not divide runs whole, as
``shard_variables`` replicates it); the parameters stay whole on every
rank (ROADMAP C.14), under pipeline parallelism too (the reference's own
layout there).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.api.errors import (JobPreemptedError, KubeMLException,
                                         MergeError)
from kubeml_tpu_torch.api.types import (History, JobHistory, MetricUpdate,
                                        TrainTask)
from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache
from kubeml_tpu_torch.data.loader import (RoundGroup, RoundLoader,
                                          group_rounds, prefetch_rounds)
from kubeml_tpu_torch.data.registry import DatasetRegistry
from kubeml_tpu_torch.metrics.ledger import merge_cost_snapshots
from kubeml_tpu_torch.metrics.prom import PHASE_HISTOGRAMS
from kubeml_tpu_torch.metrics.runtime import HbmWatermark, JitCompileTracker
from kubeml_tpu_torch.models.base import KubeDataset, KubeModel, module_state
from kubeml_tpu_torch.ops import _build
from kubeml_tpu_torch.parallel import distributed as dist_lib
from kubeml_tpu_torch.parallel import tp as tp_lib
from kubeml_tpu_torch.parallel.kavg import KAvgEngine
from kubeml_tpu_torch.parallel.manual import validate_tp_geometry
from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine
from kubeml_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                               load_checkpoint,
                                               mark_checkpoint_completed,
                                               save_checkpoint)
from kubeml_tpu_torch.train.history import HistoryStore
from kubeml_tpu_torch.utils.trace import (TraceSink, Tracer,
                                          get_trace_context, make_trace_id)

logger = logging.getLogger("kubeml_tpu_torch.train")


def _minmeanmax(xs) -> list:
    """[min, mean, max] over the workers' per-epoch stat; [0, 0, 0] when
    the epoch carried no stats."""
    vals = [float(x) for x in xs if x == x]
    if not vals:
        return [0.0, 0.0, 0.0]
    return [min(vals), sum(vals) / len(vals), max(vals)]


def _limit_parallelism() -> bool:
    """LIMIT_PARALLELISM set: the job ignores parallelism updates (the
    JAX package's gate of the same name)."""
    return os.environ.get("LIMIT_PARALLELISM", "").lower() in (
        "1", "true", "yes")


@dataclasses.dataclass
class JobCallbacks:
    """Control-plane hooks, injected so the job has no HTTP dependency;
    no-ops by default."""

    request_parallelism: Callable[[TrainTask], Optional[int]] = \
        lambda task: None
    publish_metrics: Callable[[MetricUpdate], None] = lambda m: None
    on_finish: Callable[[str, Optional[str]], None] = lambda job_id, err: None


def check_continual_options(opts) -> None:
    """The continual mode's option checks and the engine's, with the JAX
    package's 400s in its order. The job runs them before any other
    check, so a misconfigured job 400s before it loads data."""
    window, pub_rounds = opts.window_generations, opts.publish_every_rounds
    if window < 0 or pub_rounds < 0:
        raise KubeMLException(
            "window_generations and publish_every_rounds must be "
            f">= 0 (got {window}, {pub_rounds})", 400)
    if not opts.continual and (window or pub_rounds):
        raise KubeMLException(
            "window_generations / publish_every_rounds require "
            "--continual: both describe the sliding-window loop "
            "(a one-shot job trains its dataset snapshot as-is)", 400)
    if opts.engine not in ("kavg", "syncdp"):
        raise KubeMLException(f"unknown training engine {opts.engine!r}; "
                              "expected 'kavg' or 'syncdp'", 400)
    if pub_rounds > 0 and opts.engine != "kavg":
        raise KubeMLException(
            "publish_every_rounds requires the kavg engine: the "
            "round-cadence publish rides the round-granular "
            "checkpoint machinery (weights + round cursor), which "
            "syncdp's persistent device optimizer state cannot "
            "represent", 400)


def check_degraded_options(opts) -> None:
    """The degraded mode's option checks, with the JAX package's 400s."""
    if opts.quarantine_after < 0 or opts.abort_after < 0:
        raise KubeMLException(
            "quarantine_after and abort_after must be >= 0 "
            f"(got {opts.quarantine_after}, {opts.abort_after})", 400)
    if opts.checkpoint_every_rounds < 0:
        raise KubeMLException(
            f"checkpoint_every_rounds must be >= 0, got "
            f"{opts.checkpoint_every_rounds}", 400)
    if opts.checkpoint_every_rounds > 0 and opts.engine != "kavg":
        raise KubeMLException(
            "checkpoint_every_rounds requires the kavg engine: kavg "
            "re-derives optimizer state from the weights every "
            "round, so weights + round cursor fully determine the "
            "resumed trajectory; syncdp's persistent device "
            "optimizer state has no durable representation in the "
            "checkpoint manifest", 400)
    if opts.reassign_on_quarantine and (opts.engine != "kavg"
                                        or opts.quarantine_after <= 0):
        raise KubeMLException(
            "reassign_on_quarantine requires the kavg engine with "
            "quarantine_after > 0 — reassignment re-deals exactly "
            "what the quarantine guard masked out", 400)


def check_merge_options(opts):
    """The merge options' checks, the engine's and fsdp's, with the JAX
    package's 400s in its order; returns (merge_dtype, the SyncDP
    engine's explicit merge strategy or None). A syncdp job's
    merge_compress picks error feedback ("ef_bf16", "ef_int8"), else
    merge_bucket_mb > 0 the bucketed merge, else the implicit
    global-batch gradient."""
    merge_dtype = opts.merge_dtype or ""
    merge_compress = opts.merge_compress or "none"
    merge_bucket_mb = float(opts.merge_bucket_mb)
    if merge_dtype not in ("", "bf16"):
        raise KubeMLException(f"merge_dtype must be '' or 'bf16', got "
                              f"{merge_dtype!r}", 400)
    if merge_compress not in ("none", "bf16", "int8"):
        raise KubeMLException(
            f"merge_compress must be 'none', 'bf16' or 'int8', got "
            f"{merge_compress!r}", 400)
    if merge_dtype and merge_compress != "none":
        raise KubeMLException(
            "merge_dtype and merge_compress are mutually exclusive: "
            "merge_dtype is a plain lossy wire cast, merge_compress "
            "is error-feedback compression with residual carry", 400)
    if opts.fsdp and (merge_compress != "none" or merge_bucket_mb > 0):
        raise KubeMLException(
            "merge_compress / merge_bucket_mb require an unsharded "
            "merge payload; fsdp reduce-scatters grads leaf-by-leaf "
            "under GSPMD, so the explicit merge path is unavailable",
            400)
    if opts.fsdp and opts.engine != "syncdp":
        raise KubeMLException(
            "--fsdp requires --engine syncdp: the K-avg round's "
            "semantics (per-round weight average of full replicas) "
            "preclude parameter sharding; ZeRO-3 lives in the "
            "per-step gradient-averaging engine", 400)
    strategy = None
    if opts.engine == "syncdp":
        if merge_dtype:
            raise KubeMLException(
                "merge_dtype applies to the kavg engine's weight "
                "merge only; for syncdp use merge_compress "
                "(error-feedback gradient compression)", 400)
        strategy = {"bf16": "ef_bf16", "int8": "ef_int8"}.get(
            merge_compress)
        if strategy is None and merge_bucket_mb > 0:
            strategy = "bucketed"
    return merge_dtype, strategy


class _NonFiniteGuard:
    """Per-epoch host policy over the engine's per-round [W] drop flags
    (the JAX package's): a worker dropped for ``quarantine_after``
    consecutive rounds is masked out for the rest of the epoch (a host
    edit of the worker mask between dispatches), and when every
    contributing worker is non-finite for ``abort_after`` rounds in a row
    (a streak the job owns: frozen weights persist across epochs, so the
    streak does too) the job fails with a diagnostic. Reading the flags
    synchronizes on each round, which is why the layer is opt-in."""

    def __init__(self, job, quarantine_after: int, abort_after: int):
        self.job = job
        self.quarantine_after = quarantine_after
        self.abort_after = abort_after
        self._consec: Optional[np.ndarray] = None      # [W] drop streaks
        self.quarantined: Optional[np.ndarray] = None  # [W] 0/1
        self.dropped_total = 0.0
        # worker -> first round its dispatches were masked out: its chunks
        # from that round on never trained (what reassignment re-deals)
        self.quarantined_since: dict = {}
        self._forced: dict = {}  # worker -> round, pending fault marks

    def force(self, worker: int, rnd: int) -> None:
        """Quarantine ``worker`` from round ``rnd`` on (a ``quarantine``
        event), applied by ``apply`` at that round."""
        if worker not in self._forced or rnd < self._forced[worker]:
            self._forced[worker] = rnd

    def seed(self, consec, quarantined, quarantined_since,
             dropped_total: float) -> None:
        """Restore the guard's state from a round cursor."""
        self._consec = np.asarray(consec, dtype=np.float64)
        self.quarantined = np.asarray(quarantined, dtype=np.float32)
        self.quarantined_since = {int(w): int(r)
                                  for w, r in quarantined_since.items()}
        self.dropped_total = float(dropped_total)

    def apply(self, rb):
        """Mask the quarantined workers out of the round before dispatch."""
        due = [w for w, r in self._forced.items() if r <= rb.round_index]
        if due:
            W = rb.worker_mask.shape[0]
            if self.quarantined is None:
                self._consec = np.zeros(W)
                self.quarantined = np.zeros(W, np.float32)
            for w in due:
                del self._forced[w]
                if 0 <= w < W and not self.quarantined[w]:
                    self.quarantined[w] = 1.0
                    self.quarantined_since.setdefault(w, rb.round_index)
                    self.job._log(
                        "job %s force-quarantined worker %d from round "
                        "%d (fault plan)", self.job.task.job_id, w,
                        rb.round_index)
        if self.quarantined is None or not self.quarantined.any():
            return rb
        mask = rb.worker_mask * (1.0 - self.quarantined)
        if mask.sum() < 1:
            raise MergeError(
                f"round {rb.round_index}: every worker is quarantined "
                "for repeated non-finite updates")
        return dataclasses.replace(rb, worker_mask=mask)

    def observe(self, stats, rb) -> None:
        """Fold one round's drop flags into the streak counters."""
        dropped = stats.dropped  # [W] device readback (see class doc)
        if self._consec is None:
            self._consec = np.zeros(dropped.shape[0])
            self.quarantined = np.zeros(dropped.shape[0], np.float32)
        self.dropped_total += float(dropped.sum())
        active = rb.worker_mask > 0
        hit = (dropped > 0) & active
        self._consec = np.where(hit, self._consec + 1, 0.0)
        if self.quarantine_after > 0:
            newq = ((self._consec >= self.quarantine_after)
                    & (self.quarantined == 0))
            if newq.any():
                self.quarantined[newq] = 1.0
                for w in np.flatnonzero(newq):
                    # the first MASKED round is the next one: this round's
                    # contribution was dropped by the merge, not withheld
                    self.quarantined_since.setdefault(
                        int(w), rb.round_index + 1)
                self.job._log(
                    "job %s quarantined workers %s after %d consecutive "
                    "non-finite rounds (rest of epoch)",
                    self.job.task.job_id,
                    np.flatnonzero(newq).tolist(), self.quarantine_after)
        if active.any() and hit[active].all():
            self.job._all_dropped_rounds += 1
        else:
            self.job._all_dropped_rounds = 0
        if 0 < self.abort_after <= self.job._all_dropped_rounds:
            raise KubeMLException(
                f"aborting job {self.job.task.job_id}: every contributing "
                f"worker produced non-finite updates for "
                f"{self.job._all_dropped_rounds} consecutive rounds "
                f"(abort_after={self.abort_after}) — the model has "
                "diverged and no merge can move the weights", 500)

    @property
    def quarantined_count(self) -> int:
        return (int(self.quarantined.sum())
                if self.quarantined is not None else 0)


class TrainJob:
    """One training job on one device, or one rank's part of it under a
    process group. ``train()`` runs it to the end and returns the saved
    History."""

    def __init__(self, task: TrainTask, model: KubeModel,
                 dataset: KubeDataset, device: DeviceLike = None,
                 n_lanes: int = 1,
                 registry: Optional[DatasetRegistry] = None,
                 history_store: Optional[HistoryStore] = None,
                 callbacks: Optional[JobCallbacks] = None,
                 seed: int = 0, checkpoint: bool = True,
                 log_file: Optional[str] = None,
                 round_hook: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.task = task
        self.log_file = log_file
        self._file_logger: Optional[logging.Logger] = None
        self._file_handler: Optional[logging.FileHandler] = None
        self.req = task.parameters
        self.model = model
        self.dataset = dataset
        self.n_lanes = int(n_lanes)
        self._world = dist_lib.world_size()
        if max(int(self.req.options.n_seq), int(self.req.options.n_expert),
               int(self.req.options.n_model),
               int(self.req.options.n_stage)) <= 1:
            # the lanes over the group's ranks (raises unless they
            # divide); under an inner axis over the data group's,
            # checked after the inner axes' 400s (_inner_axes)
            dist_lib.lane_layout(self.n_lanes)
        self._n_seq = 1
        self.registry = registry or DatasetRegistry()
        self.history_store = history_store
        self.callbacks = callbacks or JobCallbacks()
        self.seed = seed
        self.checkpoint = checkpoint
        # round_hook(RoundBatch) -> RoundBatch: fault injection and chaos
        # runs (utils/chaos.py); a fault_plan composes with it, plan first
        self.round_hook = round_hook
        self._fault_plan = None
        # the continual mode (options.continual), set by _init_model
        self._continual = False
        self._window_generations = 0
        # the all-workers-dropped streak spans epochs; the per-epoch
        # totals go to the history and the MetricUpdate
        self._all_dropped_rounds = 0
        self._epoch_quarantined = 0
        self._epoch_reassigned = 0
        # preemption (the job server's SIGTERM or a preempt event), the
        # epoch's guard (force_quarantine routes to it), the cursor a
        # round-granular resume consumes, and the (epoch, round) progress
        # the job server's heartbeats carry
        self._preempt_event = threading.Event()
        self._preempt_at_round: Optional[int] = None
        self._guard: Optional[_NonFiniteGuard] = None
        self._resume_state: Optional[dict] = None
        self._progress = (0, 0)
        self._checkpointer = AsyncCheckpointer()
        self.tracer = Tracer()  # host-phase spans, summarized per epoch
        self._trace_sink: Optional[TraceSink] = None
        self.history = JobHistory()
        self.exit_err: Optional[str] = None
        self.stop_requested = False
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self._start_epoch = 0
        self._epoch_dropped = 0.0
        self._epoch_stats: dict = {}
        # runtime introspection (metrics/runtime.py): compiles noted per
        # dispatch, the device-memory watermark sampled at epoch end; on
        # the CPU the watermark sums the tensors the job keeps live
        self._jit_tracker = JitCompileTracker()
        self._hbm = HbmWatermark(self.device)
        self._hbm.track(self._live_tensors)

    # ------------------------------------------------------------------ api

    def stop(self) -> None:
        """Stop after the current epoch (``kubeml task stop``)."""
        self.stop_requested = True

    def preempt(self, at_round: Optional[int] = None) -> None:
        """Graceful preemption: finish the round in flight, drain the
        pending saves, checkpoint at the round cursor and raise
        JobPreemptedError. ``at_round`` pins the drain to that round (a
        ``preempt`` event); None means after the next round that
        completes (or at the epoch's end for grouped dispatch)."""
        if at_round is not None:
            cur = self._preempt_at_round
            self._preempt_at_round = (at_round if cur is None
                                      else min(cur, at_round))
        self._preempt_event.set()

    def force_quarantine(self, worker: int, rnd: int) -> None:
        """``quarantine`` event: quarantine ``worker`` from round ``rnd``
        on, through the epoch's guard."""
        if self._guard is not None:
            self._guard.force(int(worker), int(rnd))

    def train(self) -> History:
        job_id = self.task.job_id
        self._open_log_file()
        # correlate this process's spans with the client-minted trace id
        # (the task's for a job process, the thread's for a threaded job);
        # mint one for a job started directly
        if not self.tracer.trace_id:
            self.tracer.trace_id = (self.task.trace_id
                                    or get_trace_context()
                                    or make_trace_id())
        self.task.trace_id = self.tracer.trace_id
        self._trace_sink = TraceSink(job_id, "job")
        try:
            self._init_model()
            opts = self.req.options
            parallelism = self.task.parallelism or opts.default_parallelism
            epochs = self.req.epochs
            if opts.max_parallelism < 0:
                raise KubeMLException(
                    f"max_parallelism must be >= 0, got "
                    f"{opts.max_parallelism}", 400)
            if opts.max_parallelism > 0:
                parallelism = min(parallelism, opts.max_parallelism)
            if self._start_epoch:
                self._log("job %s resuming at epoch %d/%d (N=%d) from its "
                            "own checkpoint", job_id, self._start_epoch + 1,
                            epochs, parallelism)

            last_ckpt_epoch = -1
            continual = self._continual
            # a continual job with epochs <= 0 never finishes on its own:
            # stop, preemption and the goal accuracy are its exits;
            # epochs > 0 stays a total cap
            epoch_iter = (itertools.count(self._start_epoch)
                          if continual and epochs <= 0
                          else iter(range(self._start_epoch, epochs)))
            for epoch in epoch_iter:
                t0 = time.time()
                built = _build.load_seconds()
                used_parallelism = parallelism
                with self.tracer.span("epoch", epoch=epoch,
                                      parallelism=parallelism):
                    train_loss = self._train_epoch(parallelism, epoch)
                elapsed = time.time() - t0
                # the policy sees steady-state time: kernel builds at first
                # use are not throughput signal
                self.task.elapsed_time_s = max(
                    0.0, elapsed - (_build.load_seconds() - built))
                self.task.parallelism = parallelism

                if not opts.static_parallelism and (
                        continual or epoch < epochs - 1):
                    new_p = self.callbacks.request_parallelism(self.task)
                    if new_p and not _limit_parallelism():
                        parallelism = max(1, int(new_p))
                        if opts.max_parallelism > 0:
                            parallelism = min(parallelism,
                                              opts.max_parallelism)

                val_loss, accuracy = float("nan"), float("nan")
                ran_validation = opts.validate_every > 0 and \
                    (epoch + 1) % opts.validate_every == 0
                if ran_validation:
                    val_loss, accuracy = self._validate(parallelism)
                self._record_epoch(train_loss, val_loss, accuracy,
                                   used_parallelism, elapsed)
                self._log("job %s epoch %d/%d loss=%.4f val=%.4f acc=%.2f "
                          "N=%d %.2fs [%s]", job_id, epoch + 1, epochs,
                          train_loss, val_loss, accuracy, used_parallelism,
                          elapsed, self.tracer.format_summary())
                self.tracer.reset()
                self._flush_trace()  # crash-survivable partial timeline

                if opts.checkpoint_every > 0:
                    want_ckpt = (epoch + 1) % opts.checkpoint_every == 0
                elif opts.checkpoint_every == 0:
                    want_ckpt = ran_validation
                else:
                    want_ckpt = False  # -1: final checkpoint only
                if self.checkpoint and want_ckpt:
                    # every rank saves the same epoch: a rank that died
                    # since the last collective holds the others here,
                    # before they checkpoint past its own last save
                    dist_lib.barrier()
                    self._checkpointer.save(
                        job_id, self.state,
                        self._manifest(epoch=epoch + 1,
                                       parallelism=parallelism),
                        self._flax_tree)
                    last_ckpt_epoch = epoch + 1

                if self._preempt_event.is_set():
                    # the epoch boundary's drain: the fallback when the
                    # epoch ran without per-round host control (grouped
                    # dispatch) or the notice came after its last round
                    self._checkpointer.wait()
                    save_checkpoint(
                        job_id, self._flax_tree(self.state),
                        self._manifest(epoch=epoch + 1,
                                       parallelism=parallelism))
                    raise JobPreemptedError(job_id, epoch + 1, 0)
                if self.stop_requested:
                    self._log("job %s stopped by request", job_id)
                    break
                if accuracy == accuracy and accuracy >= opts.goal_accuracy:
                    self._log("job %s reached goal accuracy %.2f", job_id,
                                accuracy)
                    break
                if continual:
                    # appended generations slide the window under the same
                    # loop: the next epoch's plan and cache read the handle
                    self._continual_refresh(epoch)

            if not self.history.accuracy or \
                    self.history.accuracy[-1] != self.history.accuracy[-1]:
                val_loss, accuracy = self._validate(parallelism)
                if self.history.accuracy:
                    self.history.validation_loss[-1] = val_loss
                    self.history.accuracy[-1] = accuracy

            # drain the periodic saves, then the final one (a periodic
            # failure gets the final save as its remedy)
            if self.checkpoint:
                dist_lib.barrier()
                ckpt_err = None
                try:
                    self._checkpointer.wait()
                except Exception as e:
                    ckpt_err = e
                    self._log("job %s periodic checkpoint failed (%s); "
                                "attempting final save", job_id, e)
                if ckpt_err is not None or \
                        last_ckpt_epoch != len(self.history.train_loss):
                    save_checkpoint(
                        job_id, self._flax_tree(self.state),
                        self._manifest(epoch=len(self.history.train_loss),
                                       parallelism=parallelism,
                                       completed=True))
                else:
                    mark_checkpoint_completed(job_id)
            record = History(id=job_id, task=self.req, data=self.history)
            if self.history_store is not None:
                self.history_store.save(record)
            self.task.state = "finished"
            self.callbacks.on_finish(job_id, None)
            return record
        except JobPreemptedError as e:
            # neither failed nor finished: the cursor is on disk and the
            # PS reschedules the job (no on_finish, which would tear down
            # the record the restart needs)
            self.task.state = "preempted"
            self._log("job %s preempted at epoch %d round %d — "
                      "checkpointed for reschedule", job_id, e.epoch,
                      e.round)
            raise
        except Exception as e:  # the job's abort reports exitErr
            self.exit_err = str(e)
            self.task.state = "failed"
            self._log("job %s failed", job_id, exc=True)
            self.callbacks.on_finish(job_id, self.exit_err)
            raise
        finally:
            self._checkpointer.close()
            self._flush_trace()
            self._close_log_file()

    # ------------------------------------------------------------ internals

    def _log(self, msg, *args, exc=False):
        """Log to the module logger and to the job's log file (the
        ``kubeml logs --id`` stream)."""
        (logger.exception if exc else logger.info)(msg, *args)
        if self._file_logger is not None:
            (self._file_logger.exception if exc
             else self._file_logger.info)(msg, *args)

    def _open_log_file(self):
        if not self.log_file:
            return
        os.makedirs(os.path.dirname(self.log_file), exist_ok=True)
        self._file_handler = logging.FileHandler(self.log_file)
        self._file_handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        # an isolated, non-propagating logger, built directly (not through
        # getLogger) so it is collected with the job: the file gets the
        # whole job stream whatever the application's logging levels
        self._file_logger = logging.Logger(
            f"kubeml_tpu_torch.joblog.{self.task.job_id}")
        self._file_logger.setLevel(logging.INFO)
        self._file_logger.propagate = False
        self._file_logger.addHandler(self._file_handler)

    def _close_log_file(self):
        if self._file_handler is not None:
            self._file_logger.removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None
            self._file_logger = None

    def _flush_trace(self) -> None:
        """Rewrite this process's trace file; never fails the job."""
        if self._trace_sink is None:
            return
        try:
            self._trace_sink.write(self.tracer)
        except OSError:
            self._log("job %s: trace flush failed", self.task.job_id,
                      exc=True)

    def _flax_tree(self, state: Dict[str, torch.Tensor]) -> dict:
        """The checkpoint's variable tree, in the JAX package's layout."""
        if self.model.collections == ("params",):
            return {"params": self.model.params_to_flax(state)}
        return self.model.params_to_flax(state)

    def _manifest(self, epoch: Optional[int] = None,
                  parallelism: Optional[int] = None,
                  completed: bool = False,
                  train_state: Optional[dict] = None) -> dict:
        m = {"model": self.req.model_type,
             "function": self.req.function_name or self.req.model_type,
             "dataset": self.req.dataset}
        if completed:
            m["completed"] = True
        if train_state is not None:
            # the round cursor: ``epoch`` below is then the count of
            # completed epochs, and the cursor the round inside the next
            m["train_state"] = train_state
        if epoch is not None:
            # what crash recovery needs: completed epochs, their history
            # (to_dict copies the lists) and the next epoch's parallelism
            m["epoch"] = epoch
            m["history"] = self.history.to_dict()
            if parallelism is not None:
                m["parallelism"] = parallelism
        return m

    def _live_tensors(self):
        """What the job keeps on its device between rounds: the state,
        the merge's EF residuals, the SyncDP engine's persistent
        optimizer state and residuals, and the dataset cache's slabs (the
        K-avg optimizer is made afresh for every worker of every
        round)."""
        out = list((self.state or {}).values())
        engine = getattr(self, "_engine", None)
        if engine is not None and engine._ef_state:
            out += list(engine._ef_state.values())
        sync = getattr(self, "_sync_state", None)
        if sync is not None:
            seen = {id(t) for t in out}
            out += [t for t in self._sync_engine.held_tensors(sync)
                    if id(t) not in seen]
        cache = getattr(self, "_device_cache", None)
        if cache is not None and cache.arrays:
            out += list(cache.arrays.values())
        return out

    def _cost_snapshot(self) -> dict:
        """The engines' cost-ledger snapshots merged (cumulative, flat
        record + totals per program; the K-avg engine's and, for a
        syncdp job, the SyncDP engine's, whose program names are
        disjoint): the PS keeps the latest per job for GET /cost and
        advances the kubeml_cost_* counters by delta."""
        snaps = [eng.ledger.snapshot()
                 for eng in (getattr(self, "_engine", None),
                             getattr(self, "_sync_engine", None))
                 if eng is not None]
        snaps = [snap for snap in snaps if snap]
        return merge_cost_snapshots(snaps) if snaps else {}

    def _record_epoch(self, train_loss, val_loss, accuracy, parallelism,
                      elapsed) -> None:
        """Append the epoch to the history and publish its MetricUpdate."""
        h, stats = self.history, self._epoch_stats
        grad_norms = list(stats.get("grad_norms", []))
        update_ratios = list(stats.get("update_ratios", []))
        h.train_loss.append(train_loss)
        h.validation_loss.append(val_loss)
        h.accuracy.append(accuracy)
        h.parallelism.append(parallelism)
        h.epoch_duration.append(elapsed)
        h.dropped_workers.append(self._epoch_dropped)
        h.quarantined_workers.append(self._epoch_quarantined)
        h.reassigned_batches.append(self._epoch_reassigned)
        h.grad_norm_summary.append(_minmeanmax(grad_norms))
        h.update_ratio_summary.append(_minmeanmax(update_ratios))
        h.loss_spread.append(float(stats.get("loss_spread", 0.0)))
        # epoch end is a sync point (the loss readback), so the
        # watermark's sample costs nothing
        self._hbm.sample()
        self.callbacks.publish_metrics(MetricUpdate(
            job_id=self.task.job_id, validation_loss=val_loss,
            accuracy=accuracy, train_loss=train_loss,
            parallelism=parallelism, epoch_duration=elapsed,
            dropped_workers=self._epoch_dropped,
            quarantined_workers=self._epoch_quarantined,
            reassigned_batches=self._epoch_reassigned,
            checkpoint_drops=self._checkpointer.dropped_saves,
            phase_times={k: v for k, v in self.tracer.durations().items()
                         if k in PHASE_HISTOGRAMS},
            grad_norms=grad_norms, update_ratios=update_ratios,
            worker_losses=list(stats.get("worker_losses", [])),
            loss_spread=float(stats.get("loss_spread", 0.0)),
            # cumulative counters: the PS advances its counters by delta
            jit_compiles=self._jit_tracker.compiles,
            hbm_peak_bytes=self._hbm.peak_bytes,
            hbm_in_use_bytes=self._hbm.in_use_bytes,
            trace_events_dropped=self.tracer.dropped_events,
            # the freshness pair; a lag of -1 marks a one-shot job
            dataset_generation=(self._trained_generation
                                if self._continual else 0),
            data_lag_generations=(self._registry_generation
                                  - self._trained_generation
                                  if self._continual else -1),
            cost_programs=self._cost_snapshot()))

    def _init_model(self) -> None:
        opts = self.req.options
        check_continual_options(opts)
        self._continual = bool(opts.continual)
        self._window_generations = int(opts.window_generations)
        handle = self._open_handle()
        self._handle = handle
        # trained vs registry generation: the freshness pair behind the
        # kubeml_data_lag_generations gauge and the data_staleness rule
        self._trained_generation = int(handle.generation)
        self._registry_generation = self._trained_generation
        check_degraded_options(opts)
        if opts.fault_plan:
            from kubeml_tpu_torch.faults import FaultPlan
            try:
                plan = FaultPlan.parse(opts.fault_plan)
            except (ValueError, KeyError, TypeError) as e:
                raise KubeMLException(f"invalid fault_plan: {e}", 400)
            plan.bind(self)
            if plan.has("quarantine") and (opts.engine != "kavg"
                                           or opts.quarantine_after <= 0):
                raise KubeMLException(
                    "fault_plan 'quarantine' events require the kavg "
                    "engine with quarantine_after > 0 (they drive the "
                    "quarantine guard directly)", 400)
            self._fault_plan = plan
            if self.round_hook is None:
                self.round_hook = plan
            else:
                # the plan first, so the user's hook sees the faulted round
                user_hook = self.round_hook
                self.round_hook = lambda rb: user_hook(plan(rb))
        n_model, n_seq, n_stage, n_expert, manual = self._inner_axes(opts)
        self._n_seq = n_seq
        merge_dtype, sync_strategy = check_merge_options(opts)
        self._init_device_cache(handle, opts)

        # elastic shape pinning: a parallelism change alters mask
        # contents, not the [W, S] shape (eval always pins)
        self._elastic = not opts.static_parallelism
        self._eval_parallelism = 0
        w_floor = 0
        if self._elastic:
            D = self.n_lanes
            n0 = max(1, int(self.task.parallelism
                            or opts.default_parallelism))
            target = opts.max_parallelism if opts.max_parallelism > 0 \
                else n0
            padded = ((max(target, n0) + D - 1) // D) * D
            self._eval_parallelism = padded
            if opts.k != -1:
                w_floor = padded
        self._loader = RoundLoader(handle, self.dataset,
                                   n_lanes=self.n_lanes, seed=self.seed,
                                   shuffle=opts.shuffle, w_floor=w_floor)

        restored = None
        if self.req.resume_from:
            restored, manifest = load_checkpoint(self.req.resume_from)
            ckpt_fn = manifest.get("function") or manifest.get("model")
            this_fn = self.req.function_name or self.req.model_type
            if ckpt_fn != this_fn:
                raise KubeMLException(
                    f"checkpoint {self.req.resume_from} holds function "
                    f"{ckpt_fn!r}, not {this_fn!r}", 400)
            if self.req.resume_from == self.task.job_id and \
                    (manifest.get("epoch") or manifest.get("completed")
                     or manifest.get("train_state")):
                # crash recovery of this same job: continue its history
                # (epoch may be 0 for a round cursor inside the first)
                self._start_epoch = int(manifest.get("epoch") or 0)
                ts = manifest.get("train_state")
                if ts and not manifest.get("completed"):
                    # resume inside the cursor's epoch (_train_epoch)
                    self._resume_state = dict(ts)
                    self._start_epoch = int(ts.get("epoch",
                                                   self._start_epoch))
                if manifest.get("completed"):
                    self._start_epoch = max(self._start_epoch,
                                            self.req.epochs)
                if manifest.get("history"):
                    self.history = JobHistory.from_dict(manifest["history"])
                if manifest.get("parallelism"):
                    self.task.parallelism = int(manifest["parallelism"])

        # the module sized from one real batch, like the JAX package's
        # init from a sample
        x, y = handle.doc_range("train", 0, 1)
        sample = self.dataset.transform_train(
            np.asarray(x[: self.req.batch_size]),
            np.asarray(y[: self.req.batch_size]))
        if n_seq > 1:
            self._check_seq_lengths(handle, sample, n_seq)
        module = self.model.init_module(
            sample, torch.Generator().manual_seed(self.seed),
            device=self.device)
        self.state = {n: t.detach().clone()
                      for n, t in module_state(module).items()}
        if restored is not None:
            self._load_restored(restored)
        # the K-avg engine runs every job's validation (and a kavg job's
        # rounds); a syncdp job trains through the SyncDP engine over the
        # same module
        self._engine = KAvgEngine(
            module, self.model.loss, self.model.metrics,
            self.model.configure_optimizers, n_lanes=self.n_lanes,
            merge_dtype=torch.bfloat16 if merge_dtype == "bf16" else None,
            merge_bucket_mb=float(opts.merge_bucket_mb),
            merge_compress=opts.merge_compress or "none",
            collect_stats=bool(opts.train_stats), n_seq=n_seq,
            batch_seq_dims=self.model.seq_batch_dims if n_seq > 1 else None,
            n_expert=n_expert, n_model=n_model, n_stage=n_stage,
            manual_inner=manual)
        self._sync_engine: Optional[SyncDPEngine] = None
        self._sync_state: Optional[dict] = None
        if opts.engine == "syncdp":
            self._sync_engine = SyncDPEngine(
                module, self.model.loss, self.model.configure_optimizers,
                n_lanes=self.n_lanes, fsdp=bool(opts.fsdp),
                collect_stats=bool(opts.train_stats),
                merge_strategy=sync_strategy,
                merge_bucket_mb=float(opts.merge_bucket_mb))

    def _inner_axes(self, opts) -> tuple:
        """The JAX package's inner-axes checks, with its 400s in its
        order: pipeline parallelism with tensor or sequence parallelism;
        an engine other than kavg; an unknown tp_impl (whenever an inner
        axis is > 1); tensor with sequence parallelism forces the manual
        route, and refuses Ulysses; a world that does not split into
        inner groups (without a group the world is one device); on the
        manual route the model's own enable_tensor_parallel refusal, then
        heads or an FFN width that do not divide
        (``validate_tp_geometry``); on the GSPMD route a model without
        tp_rules; then the seq checks (the model's own
        enable_seq_parallel refusal; no seq_batch_dims), the pipeline
        checks (a negative pp_microbatches; the model's own
        enable_pipeline_parallel refusal; a batch size that does not
        split into the microbatches) and the expert checks (the model's
        own enable_expert_parallel refusal; experts that do not divide).
        Then the data group's lane layout. Returns (n_model, n_seq,
        n_stage, n_expert, whether the round is fully manual: the manual
        TP route or a pipeline); the model builds tensor-, seq- and
        expert-parallel modules and takes its pipelined loss from here
        on."""
        n_model = max(1, int(opts.n_model))
        n_seq = max(1, int(opts.n_seq))
        n_expert = max(1, int(opts.n_expert))
        n_stage = max(1, int(opts.n_stage))
        if n_stage > 1 and (n_model > 1 or n_seq > 1):
            raise KubeMLException(
                "--pipeline-parallel composes with --expert-parallel "
                "only (the pipelined trunk owns the layer split that "
                "--tensor-parallel/--seq-parallel would reshard)", 400)
        if n_model == n_seq == n_expert == n_stage == 1:
            return 1, 1, 1, 1, False
        if opts.engine != "kavg":
            raise KubeMLException(
                "tensor/sequence/pipeline/expert parallelism "
                "requires the kavg engine", 400)
        tp_impl = opts.tp_impl or "gspmd"
        if tp_impl not in ("gspmd", "manual"):
            raise KubeMLException(
                f"unknown tp_impl {tp_impl!r}; expected 'gspmd' or "
                "'manual'", 400)
        if n_model > 1 and n_seq > 1:
            # the seq round is fully manual: tensor with sequence
            # parallelism always takes the manual route
            tp_impl = "manual"
            if opts.seq_impl == "ulysses":
                raise KubeMLException(
                    "tensor parallelism composes with seq_impl='ring' "
                    "only (ulysses re-shards the head axis the TP split "
                    "owns)", 400)
        world = dist_lib.world_size()
        inner = n_model * n_seq * n_stage * n_expert
        if world % inner:
            raise KubeMLException(
                f"{world} devices not divisible by the requested model x "
                f"seq x stage x expert factor {inner}", 400)
        manual_tp = n_model > 1 and tp_impl == "manual"
        if manual_tp:
            try:
                self.model.enable_tensor_parallel()
                meta = self.model.build(device="meta")
                validate_tp_geometry(meta.heads, meta.ffn, n_model)
            except ValueError as e:
                raise KubeMLException(str(e), 400)
        elif n_model > 1:
            rules = self.model.tp_rules
            if rules is None:
                raise KubeMLException(
                    f"function {self.req.model_type!r} does not publish "
                    "tensor-parallel sharding rules", 400)
            # shard_variables' fallback as a plan, over the flax layout
            # of uninitialised parameters of the model's shapes
            shapes = {k: torch.empty(v.shape) for k, v in
                      self.model.build(device="meta").state_dict().items()}
            self.model.enable_tensor_parallel(tp_lib.shard_plan(
                self.model.params_to_flax(shapes), rules, n_model))
        if n_seq > 1:
            try:
                self.model.enable_seq_parallel(opts.seq_impl)
            except ValueError as e:
                raise KubeMLException(str(e), 400)
            if self.model.seq_batch_dims is None:
                raise KubeMLException(
                    f"function {self.req.model_type!r} enabled sequence "
                    "parallelism but declares no seq_batch_dims", 400)
        if n_stage > 1:
            mb = int(opts.pp_microbatches)
            if mb < 0:
                raise KubeMLException("pp_microbatches must be >= 0", 400)
            try:
                self.model.enable_pipeline_parallel(n_stage, mb)
            except ValueError as e:
                raise KubeMLException(str(e), 400)
            mb = self.model._pp_microbatches
            if self.req.batch_size % mb:
                raise KubeMLException(
                    f"batch size {self.req.batch_size} not divisible by "
                    f"{mb} pipeline microbatches", 400)
        if n_expert > 1:
            try:
                self.model.enable_expert_parallel()
            except ValueError as e:
                raise KubeMLException(str(e), 400)
            n_experts = self.model.build(device="meta").n_experts
            if n_experts % n_expert:
                raise KubeMLException(
                    f"{n_experts} experts do not divide over a "
                    f"{n_expert}-way expert axis", 400)
        dist_lib.lane_layout(self.n_lanes, world // inner, 0)
        self._log("job %s grid: data=%d model=%d seq=%d stage=%d expert=%d "
                  "tp_impl=%s seq_impl=%s microbatches=%s", self.task.job_id,
                  world // inner, n_model, n_seq, n_stage, n_expert,
                  tp_impl if n_model > 1 else "-",
                  opts.seq_impl if n_seq > 1 else "-",
                  self.model._pp_microbatches if n_stage > 1 else "-")
        return n_model, n_seq, n_stage, n_expert, manual_tp or n_stage > 1

    def _check_seq_lengths(self, handle, sample, n_seq: int) -> None:
        """Both splits' sequence lengths divide by n_seq (the JAX
        package's pre-flight: a test split of another width would fail in
        validation, after the training compute was spent)."""
        probes = [("train", sample)]
        if handle.test_samples > 0:
            xt, yt = handle.doc_range("test", 0, 1)
            probes.append(("test", self.dataset.transform_test(
                np.asarray(xt[:1]), np.asarray(yt[:1]))))
        for split, probe in probes:
            for k, d in self.model.seq_batch_dims.items():
                T = np.asarray(probe[k]).shape[1 + d]
                if T % n_seq:
                    raise KubeMLException(
                        f"{split}-split sequence length {T} of batch key "
                        f"{k!r} is not divisible by --seq-parallel "
                        f"{n_seq}", 400)

    def _load_restored(self, restored: dict) -> None:
        """Warm start: the checkpoint's flax variables (params, and
        batch_stats for a model with running statistics) into the state,
        after checking they are shaped for this model."""
        bad = KubeMLException(f"checkpoint {self.req.resume_from} is shaped "
                              "for a different model configuration", 400)
        collections = tuple(self.model.collections)
        if set(restored) != set(collections):
            raise bad
        try:
            loaded = self.model.params_from_flax(
                restored["params"] if collections == ("params",)
                else restored)
        except (KeyError, ValueError):
            raise bad from None
        if {k: tuple(v.shape) for k, v in loaded.items()} != \
                {k: tuple(v.shape) for k, v in self.state.items()}:
            raise bad
        self.state = {k: loaded[k].to(self.device) for k in self.state}
        self._log("job %s warm-started from checkpoint %s",
                    self.task.job_id, self.req.resume_from)

    def _init_device_cache(self, handle, opts) -> None:
        """Decide the on-device round assembly (data/device_cache.py), as
        the JAX package's job does.

        Eligibility: a dataset whose host transform_train is the identity
        (the cached raw arrays are then what staging would ship) or one
        with a transform_train_device twin. Layout: per-epoch shuffle
        needs arbitrary global gathers, hence a replicated cache;
        otherwise the plan's contiguous per-lane ranges allow the sharded
        layout. 'auto' also requires the per-lane footprint to fit
        device_cache_mb (else host staging, logged); 'on' skips the
        budget but rejects an ineligible dataset with a 400."""
        self._device_cache: Optional[DeviceDatasetCache] = None
        self._cache_logged = False
        mode = str(getattr(opts, "device_cache", "auto") or "auto")
        if mode not in ("auto", "on", "off"):
            raise KubeMLException(
                f"device_cache must be 'auto', 'on', or 'off', "
                f"got {mode!r}", 400)
        if mode == "off":
            return
        if self._fault_plan is not None and self._fault_plan.has("nan"):
            # index-fed rounds dispatch int32 indices: no host float batch
            # for a NaN burst to poison
            if mode == "on":
                raise KubeMLException(
                    "device_cache='on' is incompatible with fault_plan "
                    "'nan' events: index-fed rounds carry no host float "
                    "batch to poison", 400)
            self._log("job %s device cache disabled: fault_plan injects "
                      "NaN into host batches", self.task.job_id)
            return
        identity = (type(self.dataset).transform_train
                    is KubeDataset.transform_train)
        dev_hook = getattr(self.dataset, "transform_train_device", None)
        if self._world > 1 or self._n_seq > 1 \
                or not (identity or callable(dev_hook)):
            if mode == "on":
                raise KubeMLException(
                    "device_cache='on' requires a single-process job "
                    "without sequence-parallel/pipeline/manual-TP "
                    "rounds and an identity transform_train (or a "
                    "transform_train_device hook)", 400)
            return
        # the SyncDP engine's global batch interleaves every worker's
        # samples, and reassignment deals a quarantined worker's samples
        # to ANY surviving lane: lane-local indices address neither
        layout = ("replicated"
                  if (opts.engine == "syncdp" or opts.shuffle
                      or opts.reassign_on_quarantine)
                  else "sharded")
        budget = max(0, int(getattr(opts, "device_cache_mb", 512))) << 20
        per_chip = DeviceDatasetCache.per_chip_bytes(handle, layout,
                                                     self.n_lanes)
        if mode == "auto" and per_chip > budget:
            self._log(
                "job %s device cache disabled: ~%d MB/chip (%s) exceeds "
                "the %d MB budget — host-staged rounds",
                self.task.job_id, per_chip >> 20, layout, budget >> 20)
            return
        self._device_cache = DeviceDatasetCache(
            handle, self.device, n_lanes=self.n_lanes, layout=layout,
            device_transform=dev_hook if not identity else None,
            # a continual job's window slides: reuse each lane's overlap,
            # and round slab widths up so growth within the quantum keeps
            # the cache's signature (the engine's program key)
            incremental=self._continual,
            grow_quantum=512 if self._continual else 0)

    def _open_handle(self):
        """The dataset at its committed generation: the newest
        ``window_generations`` of it for a continual job that sets one."""
        if self._continual and self._window_generations > 0:
            return self.registry.get(
                self.req.dataset,
                window_generations=self._window_generations)
        return self.registry.get(self.req.dataset)

    def _continual_refresh(self, epoch: int) -> None:
        """The continual job's registry poll between epochs: a newer
        generation (or a moved window) swaps a fresh handle into the
        loader and the device cache, which are idle here, and advances
        the trained generation. A registry failure keeps the current
        window; a ``stale_data`` fault sees the registry move on (the lag
        grows) without sliding the window."""
        try:
            fresh = self._open_handle()
        except Exception as e:
            self._log("job %s: continual registry poll failed (%s); "
                      "keeping generation %d", self.task.job_id, e,
                      self._trained_generation)
            return
        self._registry_generation = int(fresh.generation)
        if self._fault_plan is not None and \
                self._fault_plan.stale_at(epoch):
            return
        if (self._registry_generation == self._trained_generation
                and fresh.train_samples == self._handle.train_samples):
            return
        self._log("job %s: continual refresh — generation %d -> %d "
                  "(%d train samples)", self.task.job_id,
                  self._trained_generation, self._registry_generation,
                  fresh.train_samples)
        self._handle = fresh
        self._loader.handle = fresh
        if self._device_cache is not None:
            self._device_cache.refresh(fresh)
        self._trained_generation = self._registry_generation

    def _log_cache_payload(self, W: int, S: int, B: int) -> None:
        """One-time log of what the index path saves per round: the
        [W, S, B] sample payload in host-staged bytes vs index bytes."""
        if self._cache_logged or self._device_cache is None:
            return
        self._cache_logged = True
        per_sample = self._device_cache.per_sample_bytes(
            self._device_cache.handle)
        slots = W * S * B
        self._log(
            "job %s device cache active (%s, ~%d MB/chip): per-round "
            "dispatch payload %d B (indices) vs %d B (host-staged), "
            "%.0fx smaller",
            self.task.job_id, self._device_cache.layout,
            self._device_cache.device_bytes >> 20,
            slots * 4, slots * per_sample,
            max(1.0, (slots * per_sample) / max(1, slots * 4)))

    def _rounds_per_dispatch(self) -> int:
        """Rounds per engine call (options.rounds_per_dispatch), or 1
        where per-round host control is the point: a round hook, the
        guard's per-round flags and mask edits, the round cursor (of the
        checkpoint cadence and of the continual publish cadence), and
        several ranks."""
        opts = self.req.options
        R = max(1, int(opts.rounds_per_dispatch))
        if R > 1 and (self.round_hook is not None or self._world > 1
                      or opts.quarantine_after > 0 or opts.abort_after > 0
                      or opts.checkpoint_every_rounds > 0
                      or opts.publish_every_rounds > 0):
            return 1
        return R

    def _round_source(self, plan, epoch: int, start_round: int):
        """The epoch's planned rounds from ``start_round`` on: samples, or
        [W, S, B] gather indices from the device cache (uploading it
        first, as ``cache_upload``, when the plan's lane layout needs
        it)."""
        cache = self._device_cache
        if cache is None:
            return self._loader.epoch_rounds(plan, epoch,
                                             start_round=start_round)
        W, S, B = self._loader.round_geometry(plan)
        with self.tracer.span("cache_upload"):
            cache.ensure(plan, W)
        self._log_cache_payload(W, S, B)
        return self._loader.epoch_index_rounds(
            plan, epoch, lane_starts=cache.lane_starts,
            start_round=start_round)

    def _epoch_round_iter(self, source, group: int):
        """Rounds of ``source`` from the prefetch thread (RoundGroups of
        ``group`` rounds when > 1). A fault plan's NaN bursts poison the
        host batch in that thread; the round hook then runs here, and a
        round with no contributing worker aborts the job.

        Each iteration runs inside a ``round`` span that opens before the
        ``data_wait`` and stays open across the yield: the consumer's
        dispatch runs while this generator is suspended inside it, so
        both phases nest under the round. The last probe of the exhausted
        iterator records a round with only its data_wait, tagged
        ``tail=True``."""
        plan_f = self._fault_plan
        if plan_f is not None and plan_f.has("nan"):
            source = (plan_f.inject_batch(rb) for rb in source)
        if group > 1:
            source = group_rounds(source, group)
        rounds = prefetch_rounds(source, depth=1)
        round_no = 0
        try:
            while True:
                with self.tracer.span("round", round=round_no) as sp:
                    with self.tracer.span("data_wait"):
                        rb = next(rounds, None)
                    if rb is None:
                        sp["tail"] = True
                        return
                    if isinstance(rb, RoundGroup):
                        sp["rounds"] = rb.rounds
                    else:
                        if self.round_hook is not None:
                            rb = self.round_hook(rb)
                        if rb.worker_mask.sum() < 1:
                            raise MergeError(f"round {rb.round_index}: no "
                                             "workers contributed")
                        sp["workers"] = int(rb.worker_mask.sum())
                    yield rb
                round_no += 1
        finally:
            rounds.close()

    def _take_resume(self, epoch: int, W: int, num_rounds: int):
        """The round cursor for this epoch, consumed; None when there is
        none, or when the worker count or the round no longer fits the
        epoch (the membership changed across the restart: the epoch then
        replays from round 0 over the cursor's weights)."""
        resume = self._resume_state
        if resume is None or int(resume.get("epoch", -1)) != epoch:
            return None
        self._resume_state = None
        stored = list(resume.get("step_counts", []))
        if (len(stored) != W
                or not 0 <= int(resume.get("round", -1)) <= num_rounds):
            self._log(
                "job %s: discarding round cursor (stored W=%d round=%s vs "
                "W=%d rounds=%d) — replaying epoch %d from round 0",
                self.task.job_id, len(stored), resume.get("round"), W,
                num_rounds, epoch)
            return None
        return resume

    def _preempt_due(self, round_index: int) -> bool:
        return self._preempt_event.is_set() and (
            self._preempt_at_round is None
            or round_index >= self._preempt_at_round)

    def _train_epoch(self, parallelism: int, epoch: int) -> float:
        job_id = self.task.job_id
        opts = self.req.options
        self._progress = (epoch, 0)   # the job server's heartbeat cursor
        if self._sync_engine is not None:
            return self._train_epoch_syncdp(parallelism, epoch)
        plan = self._loader.plan(parallelism, opts.k, self.req.batch_size)
        group = self._rounds_per_dispatch()
        if self._fault_plan is not None:
            self._fault_plan.epoch = epoch
        guard = None
        if opts.quarantine_after > 0 or opts.abort_after > 0:
            guard = _NonFiniteGuard(self, opts.quarantine_after,
                                    opts.abort_after)
        self._guard = guard
        self._epoch_reassigned = 0
        ckpt_rounds = int(opts.checkpoint_every_rounds)
        # the continual publish cadence: every P rounds a stamped
        # checkpoint through the same async round-cursor save, which the
        # serving plane hot-swaps on its saved_at stamp
        pub_rounds = int(opts.publish_every_rounds) if self._continual \
            else 0
        dev_losses, dev_dropped, dev_stats, dev_spread = [], [], [], []
        stat_rounds = 0
        step_counts = np.zeros(0)
        cache = self._device_cache

        # round-granular resume: the loader still draws the skipped
        # rounds' keys, and the host accumulators (step counts, partial
        # loss sums, guard state) come from the cursor, so the weights
        # equal an uninterrupted run's bit for bit (the reported loss may
        # differ in its last bits: the sums associate differently)
        W, S, B = self._loader.round_geometry(plan)
        start_round, loss_base, dropped_base = 0, None, 0.0
        resume = self._take_resume(epoch, W, len(plan.rounds))
        if resume is not None:
            start_round = int(resume["round"])
            step_counts = np.asarray(resume["step_counts"], dtype=float)
            loss_base = np.asarray(resume.get("loss_sums", np.zeros(W)),
                                   dtype=float)
            dropped_base = float(resume.get("dropped", 0.0))
            self._all_dropped_rounds = int(
                resume.get("all_dropped_rounds", 0))
            self._epoch_reassigned = int(resume.get("reassigned", 0))
            if guard is not None and resume.get("quarantined") is not None:
                guard.seed(resume.get("consec", np.zeros(W)),
                           resume["quarantined"],
                           resume.get("quarantined_since", {}),
                           dropped_base)
            group = 1   # the resumed epoch needs per-round accounting
            self._log("job %s resuming epoch %d at round %d/%d", job_id,
                      epoch, start_round, len(plan.rounds))

        def note(st, worker_mask, rounds: int):
            # count only merged workers' steps: a masked-out worker adds
            # neither loss nor steps
            nonlocal step_counts, stat_rounds
            steps = (st.step_count * worker_mask).astype(np.float64)
            loss, dropped = st.loss_sum_device, st.dropped_device
            stats, spread = st.stat_device, st.spread_device
            if rounds > 1:   # [R, W] -> [W], one reduction per group
                with self.tracer.span("merge_overlap"):
                    steps, loss, dropped = (steps.sum(axis=0), loss.sum(0),
                                            dropped.sum(0))
                    if stats is not None:
                        stats, spread = stats.sum(0), spread.sum()
            step_counts = steps if step_counts.size == 0 \
                else step_counts + steps
            dev_losses.append(loss)
            if guard is None:
                dev_dropped.append(dropped)
            if stats is not None:
                dev_stats.append(stats)
                dev_spread.append(spread)
                stat_rounds += rounds

        round_times = []   # (dispatch s, rounds, compiled?, program)

        def dispatch(rb):
            grouped = isinstance(rb, RoundGroup)
            if guard is not None:
                # quarantined workers masked out before dispatch; raises
                # when every worker is quarantined
                rb = guard.apply(rb)
            with self.tracer.span("dispatch"):
                t_r = time.time()
                if cache is not None:
                    run = self._engine.train_rounds_indexed if grouped \
                        else self._engine.train_round_indexed
                    self.state, st = run(self.state, cache, rb.batch["idx"],
                                         rb.sample_mask, rb.step_mask,
                                         rb.worker_mask, rb.rngs,
                                         lr=self.req.lr, epoch=epoch)
                else:
                    run = self._engine.train_rounds if grouped \
                        else self._engine.train_round
                    self.state, st = run(self.state, rb.batch,
                                         rb.sample_mask, rb.step_mask,
                                         rb.worker_mask, rb.rngs,
                                         lr=self.req.lr, epoch=epoch)
                round_times.append((
                    time.time() - t_r, rb.rounds if grouped else 1,
                    st.compiled,
                    "kavg." + ("train_multi" if grouped else "train")
                    + ("_indexed" if cache is not None else "")))
            note(st, rb.worker_mask, rb.rounds if grouped else 1)
            if guard is not None:
                # the per-round [W] readback the guard opts into; may
                # raise the abort diagnostic
                guard.observe(st, rb)

        def round_state(cursor: int) -> dict:
            return self._round_train_state(epoch, cursor, guard,
                                           step_counts, dev_losses,
                                           dev_dropped, loss_base,
                                           dropped_base)

        source = self._round_source(plan, epoch, start_round)
        for rb in self._epoch_round_iter(source, group):
            dispatch(rb)
            if isinstance(rb, RoundGroup):
                continue
            rounds_done = rb.round_index + 1
            self._progress = (epoch, rounds_done)
            due = ((ckpt_rounds and rounds_done % ckpt_rounds == 0)
                   or (pub_rounds and rounds_done % pub_rounds == 0))
            if due and self.checkpoint:
                # the cursor's readback syncs on the partial loss sums:
                # the cost the cadence opts into
                self._checkpointer.save(
                    job_id, self.state,
                    self._manifest(epoch=epoch, parallelism=parallelism,
                                   train_state=round_state(rounds_done)),
                    self._flax_tree)
            if self._preempt_due(rb.round_index):
                # the round just completed: drain the pending saves so
                # the cursor is the newest publish, write it, hand the job
                # back to the PS
                self._checkpointer.wait()
                save_checkpoint(
                    job_id, self._flax_tree(self.state),
                    self._manifest(epoch=epoch, parallelism=parallelism,
                                   train_state=round_state(rounds_done)))
                raise JobPreemptedError(job_id, epoch, rounds_done)

        # reassignment: a second pass after the planned rounds (the
        # quarantine set is final only once they all ran) deals the
        # quarantined workers' untrained samples to the survivors
        if (guard is not None and opts.reassign_on_quarantine
                and guard.quarantined_since):
            makeup = self._loader.makeup_rounds(
                plan, epoch, guard.quarantined_since,
                index_mode=cache is not None)
            for rb in self._epoch_round_iter(makeup, 1):
                redealt = int(round(float(np.asarray(rb.step_mask).sum())))
                dispatch(rb)
                self._epoch_reassigned += redealt
                self._progress = (epoch, rb.round_index + 1)
            if self._epoch_reassigned:
                self._log(
                    "job %s epoch %d re-dealt %d minibatch steps from "
                    "quarantined workers %s to the survivors", job_id,
                    epoch, self._epoch_reassigned,
                    sorted(guard.quarantined_since))
        self._guard = None
        # the compile tracker sees every dispatch (a compiling one with
        # its wall time, kernel builds at first use included); the
        # program name keys its per-program storm window
        for dt, _r, c, prog in round_times:
            self._jit_tracker.note(bool(c), dt if c else 0.0, program=prog)
        # merge_wait: the blocking readback that waits on every round
        with self.tracer.span("merge_wait"):
            loss_sums = torch.stack(dev_losses).sum(0).cpu().numpy() \
                if dev_losses else np.zeros(0)
            if guard is not None:
                self._epoch_dropped = guard.dropped_total
                self._epoch_quarantined = guard.quarantined_count
            else:
                self._epoch_dropped = dropped_base + (
                    float(torch.stack(dev_dropped).sum())
                    if dev_dropped else 0.0)
                self._epoch_quarantined = 0
        if loss_base is not None:
            # the sums before the restart (a cursor at the last round
            # trains no live round: the epoch closes from them alone)
            loss_sums = loss_base if loss_sums.size == 0 \
                else loss_sums + loss_base
        ran = step_counts > 0
        if not ran.any():
            raise MergeError("epoch produced no training steps")
        per_worker = loss_sums[ran] / step_counts[ran]
        self._epoch_stats = {}
        if dev_stats:
            # a resumed epoch's stats cover its post-resume rounds only
            stat_tot = torch.stack(dev_stats).sum(0).cpu().numpy()
            spread_tot = float(torch.stack(dev_spread).sum())
            steps = np.maximum(step_counts, 1.0)
            gsq, usq, psq = stat_tot[:, 0], stat_tot[:, 1], stat_tot[:, 2]
            grad_norms = np.where(ran, np.sqrt(gsq / steps), 0.0)
            update_ratios = np.where(
                ran & (psq > 0), np.sqrt(usq / np.maximum(psq, 1e-30)), 0.0)
            worker_losses = np.where(ran, loss_sums / steps, 0.0)
            n = min(parallelism, len(grad_norms))   # the virtual workers
            self._epoch_stats = {
                "grad_norms": [float(x) for x in grad_norms[:n]],
                "update_ratios": [float(x) for x in update_ratios[:n]],
                "worker_losses": [float(x) for x in worker_losses[:n]],
                "loss_spread": spread_tot / max(1, stat_rounds),
            }
        return float(per_worker.mean())

    @staticmethod
    def _to_global(a) -> np.ndarray:
        """The [W, S, B, ...] -> [S, W*B, ...] reflow of a round (step s
        = every worker's step-s samples side by side, worker-major): one
        definition for the batch leaves, the gather indices and the
        masks, which must interleave alike."""
        a = np.asarray(a)
        W, S, B = a.shape[:3]
        return np.ascontiguousarray(np.moveaxis(a, 0, 1)).reshape(
            (S, W * B) + a.shape[3:])

    def _train_epoch_syncdp(self, parallelism: int, epoch: int) -> float:
        """One epoch of per-step gradient averaging (options.engine =
        'syncdp'), as the JAX package's: the K-avg loader's plan (N
        workers' contiguous shards), but every step is one GLOBAL batch
        of all workers' step-s samples. A masked-out worker (a lost
        function, a round hook) contributes no sample: the worker mask
        folds into the per-sample mask. The device cache, when on, is
        replicated and feeds global indices; a NaN fault poisons the host
        batch before the reflow, so it reaches the global gradient and
        the step is skipped. With ``abort_after`` the per-dispatch skip
        flags are read back and that many consecutive skipped steps fail
        the job."""
        opts = self.req.options
        plan = self._loader.plan(parallelism, opts.k, self.req.batch_size)
        engine = self._sync_engine
        self._guard = None
        self._epoch_reassigned = 0       # syncdp never re-deals
        self._epoch_stats = {}
        if self._fault_plan is not None:
            self._fault_plan.epoch = epoch
        cache = self._device_cache
        if cache is not None:
            W, S, B = self._loader.round_geometry(plan)
            with self.tracer.span("cache_upload"):
                cache.ensure()
            self._log_cache_payload(W, S, B)
            source = self._loader.epoch_index_rounds(plan, epoch)
        else:
            source = self._loader.epoch_rounds(plan, epoch)
        program = "syncdp.train" + ("_indexed" if cache is not None else "")
        dev_losses, dev_skipped, dev_stats = [], [], []
        real_steps = 0
        round_times = []
        for rb in self._epoch_round_iter(source, 1):
            smask = self._to_global(rb.sample_mask
                                    * rb.step_mask[:, :, None]
                                    * rb.worker_mask[:, None, None])
            batch = {k: self._to_global(v) for k, v in rb.batch.items()}
            if self._sync_state is None:
                self._sync_state = engine.init_state(self.state)
            with self.tracer.span("dispatch"):
                t_r = time.time()
                if cache is not None:
                    self._sync_state, losses = engine.train_steps_indexed(
                        self._sync_state, cache, batch["idx"], smask,
                        rb.rngs[0], lr=self.req.lr, epoch=epoch)
                else:
                    self._sync_state, losses = engine.train_steps(
                        self._sync_state, batch, smask, rb.rngs[0],
                        lr=self.req.lr, epoch=epoch)
                round_times.append((time.time() - t_r, 1,
                                    engine.last_compiled, program))
            real = smask.sum(axis=1) > 0
            real_steps += int(real.sum())
            dev_losses.append(losses)
            dev_skipped.append(engine.last_skipped_device)
            if engine.last_stats_device is not None:
                dev_stats.append(engine.last_stats_device)
            self._progress = (epoch, rb.round_index + 1)
            if opts.abort_after > 0:
                # the opt-in per-dispatch readback: in syncdp "every
                # worker non-finite" is a skipped step
                skipped = dev_skipped[-1].cpu().numpy()
                for s in np.flatnonzero(real):
                    if skipped[s] > 0:
                        self._all_dropped_rounds += 1
                        if self._all_dropped_rounds >= opts.abort_after:
                            raise KubeMLException(
                                f"aborting job {self.task.job_id}: the "
                                "global gradient was non-finite for "
                                f"{self._all_dropped_rounds} consecutive "
                                f"steps (abort_after={opts.abort_after}) "
                                "— every step is a skip and the weights "
                                "cannot move", 500)
                    else:
                        self._all_dropped_rounds = 0
        for dt, _r, c, prog in round_times:
            self._jit_tracker.note(bool(c), dt if c else 0.0, program=prog)
        skipped_total = (float(torch.stack(dev_skipped).sum())
                         if dev_skipped else 0.0)
        self._epoch_dropped = skipped_total
        self._epoch_quarantined = 0
        with self.tracer.span("merge_wait"):
            loss_sums = (torch.stack(dev_losses).sum(0).cpu().numpy()
                         if dev_losses else np.zeros(0))
        if real_steps == 0:
            raise MergeError("epoch produced no training steps")
        # the variables view for validation, checkpoints and /infer
        self.state = engine.variables(self._sync_state)
        # masked steps and skipped ones added 0 to the sums: the divisor
        # is the real steps that produced a finite loss
        counted = max(1, real_steps - int(round(skipped_total)))
        epoch_loss = float(loss_sums.sum()) / counted
        if dev_stats:
            # one model trains one global batch a step: a single series
            # (worker 0), the per-step RMS over the applied steps, no
            # cross-worker spread
            tot = torch.stack(dev_stats).sum(0).sum(0).cpu().numpy()
            gsq, usq, psq = (float(v) for v in tot)
            self._epoch_stats = {
                "grad_norms": [float(np.sqrt(gsq / counted))],
                "update_ratios": [float(np.sqrt(usq / max(psq, 1e-30)))
                                  if psq > 0 else 0.0],
                "worker_losses": [epoch_loss],
                "loss_spread": 0.0,
            }
        return epoch_loss

    def _round_train_state(self, epoch: int, cursor: int, guard,
                           step_counts, dev_losses, dev_dropped,
                           loss_base, dropped_base) -> dict:
        """The cursor of an epoch in progress at ``cursor`` (the next
        planned round): what a restart needs to continue it with the same
        weights under unchanged membership, in the JAX package's keys.
        Reads the partial loss sums back from the device."""
        sums = torch.stack(dev_losses).sum(0).cpu().numpy() \
            if dev_losses else np.zeros(len(step_counts))
        if loss_base is not None:
            sums = sums + loss_base
        if guard is not None:
            dropped = float(guard.dropped_total)
        else:
            dropped = dropped_base + (float(torch.stack(dev_dropped).sum())
                                      if dev_dropped else 0.0)
        state = {
            "epoch": int(epoch),
            "round": int(cursor),
            "step_counts": [float(x) for x in step_counts],
            "loss_sums": [float(x) for x in sums],
            "dropped": dropped,
            "all_dropped_rounds": int(self._all_dropped_rounds),
            "reassigned": int(self._epoch_reassigned),
        }
        if guard is not None and guard.quarantined is not None:
            state["consec"] = [float(x) for x in guard._consec]
            state["quarantined"] = [float(x) for x in guard.quarantined]
            state["quarantined_since"] = {
                str(w): int(r) for w, r in guard.quarantined_since.items()}
        return state

    def _validate(self, parallelism: int):
        if self._handle.test_samples == 0:
            return float("nan"), float("nan")
        if self._elastic:
            # datapoint-weighted metrics do not depend on the split
            parallelism = max(parallelism, self._eval_parallelism)
        batch, sample_mask = self._loader.eval_batches(
            parallelism, self.req.batch_size)
        out = self._engine.eval_round(self.state, batch, sample_mask)
        return float(out["loss"]), float(out["accuracy"]) * 100.0
