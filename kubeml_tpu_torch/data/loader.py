"""Host-side input pipeline: EpochPlan -> dense masked round tensors (twin
of kubeml_tpu/data/loader.py's numpy path; the port imports nothing of
the JAX package).

One dense [W, S, B, ...] tensor per sync round, whatever keys the
dataset's ``transform_train`` returns. Ragged edges are masks (see
data/sharding.py); padded slots cycle the chunk's real samples, and the
masks keep them out of weights, losses and metrics. Rounds, masks and the
per-step rng keys equal the JAX package's RoundLoader bit for bit at the
same ``n_lanes`` (the native ``roundloader.cc`` of the JAX package is an
optional fast path with the same outputs and is not ported).

Doc order is unshuffled by default (the reference never shuffles);
``shuffle`` permutes the full docs per epoch.

``epoch_index_rounds`` is the index-fed twin of ``epoch_rounds`` for the
device-resident dataset cache (data/device_cache.py): the same rounds,
masks and rng keys, with [W, S, B] int32 gather indices in place of the
sample leaves.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from kubeml_tpu_torch.api.errors import DataError, MergeError
from kubeml_tpu_torch.data.registry import DatasetHandle
from kubeml_tpu_torch.data.sharding import EpochPlan, plan_epoch
from kubeml_tpu_torch.models.base import KubeDataset


@dataclasses.dataclass
class RoundGroup:
    """R consecutive sync rounds stacked for ONE engine call
    (KAvgEngine.train_rounds): every RoundBatch field gains a leading
    [R] round axis. Produced by `group_rounds`; consumed by the job's
    grouped epoch path (train/job.py, options.rounds_per_dispatch)."""

    batch: Dict[str, "np.ndarray"]  # leaves [R, W, S, B, ...]
    sample_mask: "np.ndarray"       # [R, W, S, B]
    step_mask: "np.ndarray"         # [R, W, S]
    worker_mask: "np.ndarray"       # [R, W]
    rngs: "np.ndarray"              # [R, W, S, 2]
    rounds: int


def group_rounds(rounds: Iterator["RoundBatch"], r: int
                 ) -> Iterator[object]:
    """Stack consecutive RoundBatches into RoundGroups of r rounds.

    The tail (fewer than r rounds left) is yielded as plain
    RoundBatches — padding a group with fully-masked rounds is NOT a
    no-op (a zero-contributor merge zeroes the model; the job aborts on
    those — job.go:188-193), so short groups must never be faked.
    Zero-contributor rounds raise MergeError here, preserving the
    per-round abort contract the ungrouped path enforces. Runs inside
    prefetch_rounds' feeder thread, so the np.stack copies overlap the
    rounds being trained."""
    buf = []
    for rb in rounds:
        if rb.worker_mask.sum() < 1:
            raise MergeError(
                f"round {rb.round_index}: no workers contributed")
        buf.append(rb)
        if len(buf) == r:
            yield RoundGroup(
                batch={k: np.stack([b.batch[k] for b in buf])
                       for k in buf[0].batch},
                sample_mask=np.stack([b.sample_mask for b in buf]),
                step_mask=np.stack([b.step_mask for b in buf]),
                worker_mask=np.stack([b.worker_mask for b in buf]),
                rngs=np.stack([b.rngs for b in buf]),
                rounds=r)
            buf = []
    yield from buf  # tail rounds dispatch singly


@dataclasses.dataclass
class RoundBatch:
    """Everything KAvgEngine.train_round needs for one sync round (host
    numpy arrays)."""

    batch: Dict[str, np.ndarray]   # leaves [W, S, B, ...]
    sample_mask: np.ndarray        # [W, S, B]
    step_mask: np.ndarray          # [W, S]
    worker_mask: np.ndarray        # [W]
    rngs: np.ndarray               # [W, S, 2] uint32
    round_index: int
    num_rounds: int


def _pad_workers(n_workers: int, n_lanes: int) -> int:
    """W = n_workers padded to a multiple of the lane count."""
    return ((n_workers + n_lanes - 1) // n_lanes) * n_lanes


def _pad_steps(tb: Dict[str, np.ndarray], smask: np.ndarray, S: int
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Zero-pad [steps, B, ...] chunk tensors up to the round-wide S.

    Operates on the full transform dict: batches are whatever keys the
    dataset's transform produced ({'x','y'} for classifiers, {'x'} for
    language models, arbitrary user structures otherwise).
    """
    steps, B = smask.shape
    if steps < S:
        tb = {k: np.concatenate(
            [v, np.zeros((S - steps,) + v.shape[1:], v.dtype)])
            for k, v in tb.items()}
        smask = np.concatenate([smask, np.zeros((S - steps, B), np.float32)])
    return tb, smask


def _fill_missing_workers(tbs, W) -> Dict[str, np.ndarray]:
    """Materialize zero tensors for inactive chunks + lane-padding workers,
    then stack each transform key to [W, S, B, ...]."""
    tmpl = next(t for t in tbs if t is not None)
    zeros = {k: np.zeros(v.shape, v.dtype) for k, v in tmpl.items()}
    filled = [t if t is not None else zeros for t in tbs]
    filled += [zeros] * (W - len(filled))
    return {k: np.stack([t[k] for t in filled]) for k in tmpl}


def _fill_chunk(tb: Dict[str, np.ndarray], steps: int, batch: int
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Cycle-pad a chunk's samples to [steps*batch] and reshape each
    transform key to [steps, batch, ...]; returns (batch dict, sample_mask)."""
    if not tb:
        raise DataError("dataset transform returned an empty batch dict")
    n = len(next(iter(tb.values())))
    if any(len(v) != n for v in tb.values()):
        raise DataError(
            f"transform produced unequal lengths: "
            f"{ {k: len(v) for k, v in tb.items()} }")
    need = steps * batch
    mask = np.zeros(need, dtype=np.float32)
    mask[:n] = 1.0
    out = {}
    for k, v in tb.items():
        if n == 0:
            pad = np.zeros((need,) + v.shape[1:], dtype=v.dtype)
        else:
            reps = -(-need // n)  # ceil
            pad = np.concatenate([v] * reps)[:need]
        out[k] = pad.reshape((steps, batch) + v.shape[1:])
    return out, mask.reshape(steps, batch)


def prefetch_rounds(rounds: Iterator[RoundBatch], depth: int = 2
                    ) -> Iterator[RoundBatch]:
    """Assemble upcoming rounds in a background thread, so round r+1's
    host-side gather (numpy slicing and copies, which release the GIL for
    large arrays) overlaps the training of round r. `depth` bounds host
    memory at depth extra round tensors.

    If the consumer abandons the iterator (error mid-epoch, early stop),
    the feeder is told to quit and the queue is drained, so assembled
    rounds don't stay alive for the life of the process.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        try:
            for rb in rounds:
                if not put(rb):
                    return
            put(done)
        except BaseException as e:  # surfaced in the consumer thread
            put(e)

    threading.Thread(target=feeder, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        abandoned.set()
        while True:  # release any assembled rounds still queued
            try:
                q.get_nowait()
            except queue.Empty:
                break


class RoundLoader:
    """Materializes train/eval round tensors for one job."""

    def __init__(self, handle: DatasetHandle, dataset: KubeDataset,
                 n_lanes: int, seed: int = 0, shuffle: bool = False,
                 w_floor: int = 0, s_floor: int = 0):
        """w_floor/s_floor: minimum round-tensor shape [W, S, ...], the
        elastic-parallelism contract of the JAX package (which compiles
        one round program per shape): an elastic job pins them to the
        largest shape any parallelism can need, so a parallelism change
        alters mask contents, never shapes. Both are grow-only high-water
        marks. The port runs no masked worker, so the pinning costs it
        nothing; it keeps the round tensors equal to the JAX package's."""
        self.handle = handle
        self.dataset = dataset
        self.n_lanes = n_lanes
        self.w_floor = w_floor
        self.s_floor = s_floor
        self.shuffle = shuffle
        self._root_rng = np.random.SeedSequence(seed)

    # ------------------------------------------------------------- training

    def plan(self, n_workers: int, k: int, batch_size: int) -> EpochPlan:
        return plan_epoch(self.handle.train_samples, n_workers, k, batch_size,
                          self.handle.subset_size)

    def round_geometry(self, plan: EpochPlan) -> Tuple[int, int, int]:
        """The epoch's shared round-tensor shape (W, S, B), with the
        grow-only elastic floors updated as a side effect (idempotent:
        a second call with the same plan returns the same shape). Only
        K-step plans pin the floors; sparse averaging (k == -1) has S of
        the whole shard, shrinking ~1/N, so its shapes track N."""
        W = max(_pad_workers(plan.num_workers, self.n_lanes),
                _pad_workers(self.w_floor, self.n_lanes))
        S = max(max((r.max_steps for r in plan.rounds), default=0),
                self.s_floor)
        if plan.k != -1:
            self.w_floor = W
            self.s_floor = S
        return W, S, plan.batch_size

    def _epoch_perm(self, epoch: int) -> Optional[np.ndarray]:
        """Per-epoch doc permutation (None when shuffle is off). Only the
        FULL docs move: the plan sizes chunks from the contiguous layout,
        where only the globally last doc is short."""
        if not self.shuffle:
            return None
        ss = np.random.SeedSequence([self._root_rng.entropy, epoch])
        n_docs = self.handle.num_train_docs
        n_full = (self.handle.train_samples // self.handle.subset_size)
        perm = np.arange(n_docs)
        perm[:n_full] = np.random.default_rng(ss).permutation(n_full)
        return perm

    def _epoch_key_rng(self, epoch: int) -> np.random.Generator:
        """The per-round rng-key stream: one (W, S, 2) uint32 draw per
        round, in round order — the JAX package's stream, so the keys
        equal its bit for bit (the port seeds each step's dropout
        generator from them)."""
        return np.random.default_rng(
            np.random.SeedSequence([self._root_rng.entropy, epoch, 7]))

    def epoch_rounds(self, plan: EpochPlan, epoch: int
                     ) -> Iterator[RoundBatch]:
        """Yield one RoundBatch per sync round of the epoch, all of the
        same [W, S_max, B] shape."""
        W, S, B = self.round_geometry(plan)
        x_mm, y_mm = self.handle.train_arrays()
        perm = self._epoch_perm(epoch)
        key_rng = self._epoch_key_rng(epoch)

        for rp in plan.rounds:
            tbs = []
            sample_mask = np.zeros((W, S, B), dtype=np.float32)
            step_mask = np.zeros((W, S), dtype=np.float32)
            worker_mask = np.zeros(W, dtype=np.float32)
            for c in rp.chunks:
                if c.active:
                    data, labels = self._chunk_samples(x_mm, y_mm, c.doc_start,
                                                       c.doc_end, perm)
                    tb = self.dataset.transform_train(data, labels)
                    tb, smask = _fill_chunk(tb, c.num_steps, B)
                    tb, smask = _pad_steps(tb, smask, S)
                    sample_mask[c.worker] = smask
                    step_mask[c.worker, :c.num_steps] = 1.0
                    worker_mask[c.worker] = 1.0
                    tbs.append(tb)
                else:
                    tbs.append(None)

            rngs = key_rng.integers(0, 2**32, size=(W, S, 2),
                                    dtype=np.uint32)
            yield RoundBatch(
                batch=_fill_missing_workers(tbs, W),
                sample_mask=sample_mask, step_mask=step_mask,
                worker_mask=worker_mask, rngs=rngs,
                round_index=rp.index, num_rounds=len(plan.rounds))

    def epoch_index_rounds(self, plan: EpochPlan, epoch: int,
                           lane_starts: Optional[np.ndarray] = None
                           ) -> Iterator[RoundBatch]:
        """Index-fed twin of ``epoch_rounds``: each round's batch is
        ``{"idx": [W, S, B] int32}`` gather indices instead of the sample
        leaves. Geometry, masks, the rng stream, cycle-padding and round
        order are the same, so an index-fed round gathers the values
        ``epoch_rounds`` would have shipped (padded slots of masked steps
        gather sample 0 instead of zeros; those steps are never run).

        ``lane_starts`` ([D] global offset of each lane's slab, from a
        sharded cache) makes the indices lane-LOCAL; None means a
        replicated cache and GLOBAL indices (needed under shuffle, where
        a chunk's samples are scattered)."""
        W, S, B = self.round_geometry(plan)
        perm = self._epoch_perm(epoch)
        if perm is not None and lane_starts is not None:
            raise DataError("shuffled epochs need a replicated cache: "
                            "permuted docs are not lane-contiguous")
        key_rng = self._epoch_key_rng(epoch)
        wpl = max(1, W // self.n_lanes)

        for rp in plan.rounds:
            idx = np.zeros((W, S, B), dtype=np.int32)
            sample_mask = np.zeros((W, S, B), dtype=np.float32)
            step_mask = np.zeros((W, S), dtype=np.float32)
            worker_mask = np.zeros(W, dtype=np.float32)
            for c in rp.chunks:
                if not c.active:
                    continue
                ids = self._chunk_global_ids(c, perm)
                need = c.num_steps * B
                # _fill_chunk's cycle-pad: padded slots repeat the chunk's
                # real samples in order
                flat = ids[np.arange(need) % max(1, len(ids))]
                if lane_starts is not None:
                    flat = flat - lane_starts[c.worker // wpl]
                idx[c.worker, :c.num_steps] = flat.reshape(c.num_steps, B)
                smask = np.zeros(need, dtype=np.float32)
                smask[:len(ids)] = 1.0
                sample_mask[c.worker, :c.num_steps] = \
                    smask.reshape(c.num_steps, B)
                step_mask[c.worker, :c.num_steps] = 1.0
                worker_mask[c.worker] = 1.0

            rngs = key_rng.integers(0, 2**32, size=(W, S, 2),
                                    dtype=np.uint32)
            yield RoundBatch(
                batch={"idx": idx},
                sample_mask=sample_mask, step_mask=step_mask,
                worker_mask=worker_mask, rngs=rngs,
                round_index=rp.index, num_rounds=len(plan.rounds))

    def _chunk_global_ids(self, c, perm) -> np.ndarray:
        """GLOBAL sample ids of one plan chunk, in chunk order: exactly
        the samples ``epoch_rounds`` materializes for it."""
        n = self.handle.train_samples
        ss = self.handle.subset_size
        if perm is None:
            lo = c.doc_start * ss
            hi = min(c.doc_end * ss, n)
            return np.arange(lo, hi, dtype=np.int64)
        return np.concatenate([
            np.arange(perm[d] * ss, min((perm[d] + 1) * ss, n),
                      dtype=np.int64)
            for d in range(c.doc_start, c.doc_end)])

    def _chunk_samples(self, x_mm, y_mm, doc_start, doc_end, perm):
        ss = self.handle.subset_size
        if perm is None:
            lo = doc_start * ss
            hi = min(doc_end * ss, len(x_mm))
            return np.asarray(x_mm[lo:hi]), np.asarray(y_mm[lo:hi])
        parts_x, parts_y = [], []
        for d in range(doc_start, doc_end):
            pd = perm[d]
            lo, hi = pd * ss, min((pd + 1) * ss, len(x_mm))
            parts_x.append(x_mm[lo:hi])
            parts_y.append(y_mm[lo:hi])
        return np.concatenate(parts_x), np.concatenate(parts_y)

    # ----------------------------------------------------------- validation

    def eval_batches(self, n_workers: int, batch_size: int
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Shard the test split over workers, one dense [W, S, B] tensor
        (metrics are datapoint-weighted, so the split does not change
        them)."""
        if self.handle.test_samples == 0:
            raise DataError(
                f"dataset {self.handle.name} has no test samples")
        plan = plan_epoch(self.handle.test_samples, n_workers, -1, batch_size,
                          self.handle.subset_size)
        W = _pad_workers(n_workers, self.n_lanes)
        S = plan.rounds[0].max_steps
        B = batch_size
        x_mm, y_mm = self.handle.test_arrays()
        tbs = []
        sample_mask = np.zeros((W, S, B), dtype=np.float32)
        for c in plan.rounds[0].chunks:
            if c.active:
                lo = c.doc_start * self.handle.subset_size
                hi = min(c.doc_end * self.handle.subset_size, len(x_mm))
                tb = self.dataset.transform_test(np.asarray(x_mm[lo:hi]),
                                                 np.asarray(y_mm[lo:hi]))
                tb, smask = _fill_chunk(tb, c.num_steps, B)
                tb, smask = _pad_steps(tb, smask, S)
                sample_mask[c.worker] = smask
                tbs.append(tb)
            else:
                tbs.append(None)
        return (_fill_missing_workers(tbs, W), sample_mask)
