"""TrainJob — the per-job training loop (twin of kubeml_tpu/train/job.py)
over the port's one-device K-avg engine.

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

What differs:
  - ``device`` (None = CUDA) and ``n_lanes`` replace the mesh;
  - a job without ``resume_from`` starts from the model's
    ``init_module``: flax's default distributions drawn from a
    ``torch.Generator`` seeded by ``seed`` (jax.random's bits cannot be
    reproduced). A JAX checkpoint warm-starts a port job bit for bit;
  - the seconds an epoch spends building and loading kernels at first use
    (ops/_build.py) are left out of the time the throughput policy sees,
    as the JAX package leaves out its compiles;
  - ``phase_times`` (data_wait, dispatch, merge_wait per round) come from
    ``time.perf_counter`` around the loop's phases; ``jit_compiles`` is 0
    and ``cost_programs`` empty (no compiled programs, no cost ledger
    yet).

Options whose module is not ported yet raise KubeMLException(400) naming
the option (``_reject_unported``); none is quietly ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kubeml_tpu_torch._device import DeviceLike, resolve_device
from kubeml_tpu_torch.api.errors import (KubeMLException, MergeError,
                                         NotPortedError)
from kubeml_tpu_torch.api.types import (History, JobHistory, MetricUpdate,
                                        TrainTask)
from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache
from kubeml_tpu_torch.data.loader import (RoundGroup, RoundLoader,
                                          group_rounds, prefetch_rounds)
from kubeml_tpu_torch.data.registry import DatasetRegistry
from kubeml_tpu_torch.models.base import KubeDataset, KubeModel, module_state
from kubeml_tpu_torch.ops import _build
from kubeml_tpu_torch.parallel.kavg import KAvgEngine
from kubeml_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                               load_checkpoint,
                                               mark_checkpoint_completed,
                                               save_checkpoint)
from kubeml_tpu_torch.train.history import HistoryStore

logger = logging.getLogger("kubeml_tpu_torch.train")

PHASES = ("data_wait", "dispatch", "merge_wait")


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


def _reject_unported(opts, round_hook) -> None:
    """400 for every option whose module the port has not ported yet."""
    def refuse(option: str, brings: str):
        raise NotPortedError(option, brings)

    if opts.engine == "syncdp":
        refuse("engine='syncdp'", "the SyncDP engine")
    if opts.engine != "kavg":
        raise KubeMLException(f"unknown training engine {opts.engine!r}; "
                              "expected 'kavg' or 'syncdp'", 400)
    if opts.fsdp:
        refuse("fsdp", "the SyncDP engine")
    for name in ("n_model", "n_seq", "n_stage", "n_expert"):
        if int(getattr(opts, name)) > 1:
            refuse(f"{name} > 1", "model parallelism over NCCL ranks")
    for name in ("continual", "window_generations", "publish_every_rounds"):
        if getattr(opts, name):
            refuse(name, "the continual mode")
    for name in ("fault_plan", "quarantine_after", "abort_after",
                 "reassign_on_quarantine", "checkpoint_every_rounds"):
        if getattr(opts, name):
            refuse(name, "the degraded mode")
    if round_hook is not None:
        refuse("a round_hook", "the degraded mode")


class TrainJob:
    """One training job on one device. ``train()`` runs it to the end and
    returns the saved History."""

    def __init__(self, task: TrainTask, model: KubeModel,
                 dataset: KubeDataset, device: DeviceLike = None,
                 n_lanes: int = 1,
                 registry: Optional[DatasetRegistry] = None,
                 history_store: Optional[HistoryStore] = None,
                 callbacks: Optional[JobCallbacks] = None,
                 seed: int = 0, checkpoint: bool = True,
                 round_hook: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.task = task
        self.req = task.parameters
        self.model = model
        self.dataset = dataset
        self.n_lanes = int(n_lanes)
        self.registry = registry or DatasetRegistry()
        self.history_store = history_store
        self.callbacks = callbacks or JobCallbacks()
        self.seed = seed
        self.checkpoint = checkpoint
        self.round_hook = round_hook   # not ported: refused by train()
        self._checkpointer = AsyncCheckpointer()
        self.history = JobHistory()
        self.exit_err: Optional[str] = None
        self.stop_requested = False
        self.state: Optional[Dict[str, torch.Tensor]] = None
        self._start_epoch = 0
        self._epoch_dropped = 0.0
        self._epoch_stats: dict = {}
        self._phases: Dict[str, List[float]] = {}

    # ------------------------------------------------------------------ api

    def stop(self) -> None:
        """Stop after the current epoch (``kubeml task stop``)."""
        self.stop_requested = True

    def train(self) -> History:
        job_id = self.task.job_id
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
                logger.info("job %s resuming at epoch %d/%d (N=%d) from its "
                            "own checkpoint", job_id, self._start_epoch + 1,
                            epochs, parallelism)

            last_ckpt_epoch = -1
            for epoch in range(self._start_epoch, epochs):
                t0 = time.time()
                built = _build.load_seconds()
                used_parallelism = parallelism
                self._phases = {name: [] for name in PHASES}
                train_loss = self._train_epoch(parallelism, epoch)
                elapsed = time.time() - t0
                # the policy sees steady-state time: kernel builds at first
                # use are not throughput signal
                self.task.elapsed_time_s = max(
                    0.0, elapsed - (_build.load_seconds() - built))
                self.task.parallelism = parallelism

                if not opts.static_parallelism and epoch < epochs - 1:
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
                logger.info("job %s epoch %d/%d loss=%.4f val=%.4f "
                            "acc=%.2f N=%d %.2fs", job_id, epoch + 1,
                            epochs, train_loss, val_loss, accuracy,
                            used_parallelism, elapsed)

                if opts.checkpoint_every > 0:
                    want_ckpt = (epoch + 1) % opts.checkpoint_every == 0
                elif opts.checkpoint_every == 0:
                    want_ckpt = ran_validation
                else:
                    want_ckpt = False  # -1: final checkpoint only
                if self.checkpoint and want_ckpt:
                    self._checkpointer.save(
                        job_id, self.state,
                        self._manifest(epoch=epoch + 1,
                                       parallelism=parallelism),
                        self._flax_tree)
                    last_ckpt_epoch = epoch + 1

                if self.stop_requested:
                    logger.info("job %s stopped by request", job_id)
                    break
                if accuracy == accuracy and accuracy >= opts.goal_accuracy:
                    logger.info("job %s reached goal accuracy %.2f", job_id,
                                accuracy)
                    break

            if not self.history.accuracy or \
                    self.history.accuracy[-1] != self.history.accuracy[-1]:
                val_loss, accuracy = self._validate(parallelism)
                if self.history.accuracy:
                    self.history.validation_loss[-1] = val_loss
                    self.history.accuracy[-1] = accuracy

            # drain the periodic saves, then the final one (a periodic
            # failure gets the final save as its remedy)
            if self.checkpoint:
                ckpt_err = None
                try:
                    self._checkpointer.wait()
                except Exception as e:
                    ckpt_err = e
                    logger.info("job %s periodic checkpoint failed (%s); "
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
        except Exception as e:  # the job's abort reports exitErr
            self.exit_err = str(e)
            self.task.state = "failed"
            logger.exception("job %s failed", job_id)
            self.callbacks.on_finish(job_id, self.exit_err)
            raise
        finally:
            self._checkpointer.close()

    # ------------------------------------------------------------ internals

    def _flax_tree(self, state: Dict[str, torch.Tensor]) -> dict:
        """The checkpoint's variable tree, in the JAX package's layout."""
        if self.model.collections == ("params",):
            return {"params": self.model.params_to_flax(state)}
        return self.model.params_to_flax(state)

    def _manifest(self, epoch: Optional[int] = None,
                  parallelism: Optional[int] = None,
                  completed: bool = False) -> dict:
        m = {"model": self.req.model_type,
             "function": self.req.function_name or self.req.model_type,
             "dataset": self.req.dataset}
        if completed:
            m["completed"] = True
        if epoch is not None:
            # what crash recovery needs: completed epochs, their history
            # (to_dict copies the lists) and the next epoch's parallelism
            m["epoch"] = epoch
            m["history"] = self.history.to_dict()
            if parallelism is not None:
                m["parallelism"] = parallelism
        return m

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
        h.quarantined_workers.append(0)
        h.reassigned_batches.append(0)
        h.grad_norm_summary.append(_minmeanmax(grad_norms))
        h.update_ratio_summary.append(_minmeanmax(update_ratios))
        h.loss_spread.append(float(stats.get("loss_spread", 0.0)))
        peak = in_use = 0
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            in_use = torch.cuda.memory_allocated(self.device)
        self.callbacks.publish_metrics(MetricUpdate(
            job_id=self.task.job_id, validation_loss=val_loss,
            accuracy=accuracy, train_loss=train_loss,
            parallelism=parallelism, epoch_duration=elapsed,
            dropped_workers=self._epoch_dropped, quarantined_workers=0,
            reassigned_batches=0,
            checkpoint_drops=self._checkpointer.dropped_saves,
            phase_times={k: list(v) for k, v in self._phases.items()},
            grad_norms=grad_norms, update_ratios=update_ratios,
            worker_losses=list(stats.get("worker_losses", [])),
            loss_spread=float(stats.get("loss_spread", 0.0)),
            jit_compiles=0, hbm_peak_bytes=int(peak),
            hbm_in_use_bytes=int(in_use), trace_events_dropped=0,
            dataset_generation=0, data_lag_generations=-1,
            cost_programs={}))

    def _init_model(self) -> None:
        opts = self.req.options
        _reject_unported(opts, self.round_hook)
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
        handle = self.registry.get(self.req.dataset)
        self._handle = handle
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
                    (manifest.get("epoch") or manifest.get("completed")):
                # crash recovery of this same job: continue its history
                self._start_epoch = int(manifest.get("epoch") or 0)
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
        module = self.model.init_module(
            sample, torch.Generator().manual_seed(self.seed),
            device=self.device)
        self.state = {n: t.detach().clone()
                      for n, t in module_state(module).items()}
        if restored is not None:
            self._load_restored(restored)
        self._engine = KAvgEngine(
            module, self.model.loss, self.model.metrics,
            self.model.configure_optimizers, n_lanes=self.n_lanes,
            merge_dtype=torch.bfloat16 if merge_dtype == "bf16" else None,
            merge_bucket_mb=merge_bucket_mb, merge_compress=merge_compress,
            collect_stats=bool(opts.train_stats))

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
        logger.info("job %s warm-started from checkpoint %s",
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
        identity = (type(self.dataset).transform_train
                    is KubeDataset.transform_train)
        dev_hook = getattr(self.dataset, "transform_train_device", None)
        if not (identity or callable(dev_hook)):
            if mode == "on":
                raise KubeMLException(
                    "device_cache='on' requires a single-process job "
                    "without sequence-parallel/pipeline/manual-TP "
                    "rounds and an identity transform_train (or a "
                    "transform_train_device hook)", 400)
            return
        layout = "replicated" if opts.shuffle else "sharded"
        budget = max(0, int(getattr(opts, "device_cache_mb", 512))) << 20
        per_chip = DeviceDatasetCache.per_chip_bytes(handle, layout,
                                                     self.n_lanes)
        if mode == "auto" and per_chip > budget:
            logger.info(
                "job %s device cache disabled: ~%d MB/chip (%s) exceeds "
                "the %d MB budget — host-staged rounds",
                self.task.job_id, per_chip >> 20, layout, budget >> 20)
            return
        self._device_cache = DeviceDatasetCache(
            handle, self.device, n_lanes=self.n_lanes, layout=layout,
            device_transform=dev_hook if not identity else None)

    def _log_cache_payload(self, W: int, S: int, B: int) -> None:
        """One-time log of what the index path saves per round: the
        [W, S, B] sample payload in host-staged bytes vs index bytes."""
        if self._cache_logged or self._device_cache is None:
            return
        self._cache_logged = True
        per_sample = self._device_cache.per_sample_bytes(
            self._device_cache.handle)
        slots = W * S * B
        logger.info(
            "job %s device cache active (%s, ~%d MB/chip): per-round "
            "dispatch payload %d B (indices) vs %d B (host-staged), "
            "%.0fx smaller",
            self.task.job_id, self._device_cache.layout,
            self._device_cache.device_bytes >> 20,
            slots * 4, slots * per_sample,
            max(1.0, (slots * per_sample) / max(1, slots * 4)))

    def _epoch_round_iter(self, plan, epoch: int, group: int):
        """Rounds of the epoch from the prefetch thread (RoundGroups of
        ``group`` rounds when > 1), each wait timed as data_wait; a round
        with no contributing worker aborts the job. With the device cache
        the rounds carry gather indices (uploading the cache first when
        the plan's lane layout needs it)."""
        cache = self._device_cache
        if cache is not None:
            W, S, B = self._loader.round_geometry(plan)
            cache.ensure(plan, W)
            self._log_cache_payload(W, S, B)
            source = self._loader.epoch_index_rounds(
                plan, epoch, lane_starts=cache.lane_starts)
        else:
            source = self._loader.epoch_rounds(plan, epoch)
        if group > 1:
            source = group_rounds(source, group)
        rounds = prefetch_rounds(source, depth=1)
        try:
            while True:
                t = time.perf_counter()
                rb = next(rounds, None)
                self._phases["data_wait"].append(time.perf_counter() - t)
                if rb is None:
                    return
                if not isinstance(rb, RoundGroup) and \
                        rb.worker_mask.sum() < 1:
                    raise MergeError(
                        f"round {rb.round_index}: no workers contributed")
                yield rb
        finally:
            rounds.close()

    def _train_epoch(self, parallelism: int, epoch: int) -> float:
        opts = self.req.options
        plan = self._loader.plan(parallelism, opts.k, self.req.batch_size)
        group = max(1, int(opts.rounds_per_dispatch))
        dev_losses, dev_dropped, dev_stats, dev_spread = [], [], [], []
        stat_rounds = 0
        step_counts = np.zeros(0)
        cache = self._device_cache
        for rb in self._epoch_round_iter(plan, epoch, group):
            grouped = isinstance(rb, RoundGroup)
            t = time.perf_counter()
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
                self.state, st = run(self.state, rb.batch, rb.sample_mask,
                                     rb.step_mask, rb.worker_mask, rb.rngs,
                                     lr=self.req.lr, epoch=epoch)
            self._phases["dispatch"].append(time.perf_counter() - t)
            # count only merged workers' steps: a masked-out worker adds
            # neither loss nor steps
            steps = (st.step_count * rb.worker_mask).astype(np.float64)
            loss, dropped = st.loss_sum_device, st.dropped_device
            stats, spread = st.stat_device, st.spread_device
            rounds = 1
            if grouped:   # [R, W] -> [W], one reduction per group
                steps, loss, dropped = (steps.sum(axis=0), loss.sum(0),
                                        dropped.sum(0))
                if stats is not None:
                    stats, spread = stats.sum(0), spread.sum()
                rounds = rb.rounds
            step_counts = steps if step_counts.size == 0 \
                else step_counts + steps
            dev_losses.append(loss)
            dev_dropped.append(dropped)
            if stats is not None:
                dev_stats.append(stats)
                dev_spread.append(spread)
                stat_rounds += rounds
        # merge_wait: the blocking readback that waits on every round
        t = time.perf_counter()
        loss_sums = torch.stack(dev_losses).sum(0).cpu().numpy() \
            if dev_losses else np.zeros(0)
        self._epoch_dropped = float(torch.stack(dev_dropped).sum()) \
            if dev_dropped else 0.0
        self._phases["merge_wait"].append(time.perf_counter() - t)
        ran = step_counts > 0
        if not ran.any():
            raise MergeError("epoch produced no training steps")
        per_worker = loss_sums[ran] / step_counts[ran]
        self._epoch_stats = {}
        if dev_stats:
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
