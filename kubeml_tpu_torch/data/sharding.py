"""Shard assignment and K-chunk scheduling math (copy of
kubeml_tpu/data/sharding.py; the port imports nothing of the JAX
package). Epoch plans must equal the JAX package's exactly: the two
packages then cut the same rounds out of the same dataset.

This module reproduces, exactly, the data-sharding semantics of the reference
(python/kubeml/kubeml/util.py:46-81 and the per-chunk loop in
python/kubeml/kubeml/network.py:252-310), then extends them into a *static
schedule* of dense rounds: every epoch becomes a fixed number of
"sync rounds"; each round gives every logical worker a (possibly empty) doc
range, and ragged edges (short final chunks, workers with fewer chunks) are
expressed as masks rather than dynamic shapes, so the round sees only dense
[n_workers, steps, batch, ...] arrays.

Terminology (same as the reference):
  - "doc"/"subset": one fixed-size storage batch of `subset_size` samples
    (64 by default — ml/pkg/controller/storageApi.go:20).
  - "worker": one logical data-parallel shard (a Fission function replica in
    the reference; a virtual worker of the K-avg round here).
  - K: number of local optimizer steps between weight averages; K == -1
    means one sync per epoch (CLI --sparse-avg).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

from kubeml_tpu_torch.api.const import STORAGE_SUBSET_SIZE


def split_minibatches(a: range, n: int) -> List[range]:
    """Contiguous near-equal split of doc ids over n workers.

    Parity: python/kubeml/kubeml/util.py:46-56 — the first `len(a) % n`
    workers receive one extra doc.
    """
    k, m = divmod(len(a), n)
    return [a[i * k + min(i, m):(i + 1) * k + min(i + 1, m)] for i in range(n)]


def get_subset_period(k: int, batch_size: int, assigned_subsets: range,
                      subset_size: int = STORAGE_SUBSET_SIZE) -> int:
    """Docs loaded per sync round to cover K local batches.

    Parity: python/kubeml/kubeml/util.py:59-81. K == -1 → the whole shard
    (one sync per epoch).
    """
    if k == -1:
        return len(assigned_subsets)
    return int(math.ceil((batch_size * k) / subset_size))


@dataclass
class WorkerChunk:
    """One worker's slice of one sync round."""

    worker: int
    doc_start: int          # inclusive
    doc_end: int            # exclusive; doc_start == doc_end => inactive
    num_samples: int        # real samples in [doc_start, doc_end)
    num_steps: int          # ceil(num_samples / batch_size) local steps

    @property
    def active(self) -> bool:
        return self.num_steps > 0


@dataclass
class RoundPlan:
    """One global sync round: a chunk per worker + the max step count."""

    index: int
    chunks: List[WorkerChunk]

    @property
    def max_steps(self) -> int:
        return max((c.num_steps for c in self.chunks), default=0)

    @property
    def active_workers(self) -> int:
        return sum(1 for c in self.chunks if c.active)


@dataclass
class EpochPlan:
    """Static schedule for one epoch at a given (num_docs, N, K, batch)."""

    num_workers: int
    batch_size: int
    k: int
    subset_size: int
    rounds: List[RoundPlan] = field(default_factory=list)

    @property
    def total_steps(self) -> int:
        return sum(c.num_steps for r in self.rounds for c in r.chunks)

    @property
    def total_samples(self) -> int:
        return sum(c.num_samples for r in self.rounds for c in r.chunks)


def _doc_samples(doc_start: int, doc_end: int, num_samples: int,
                 subset_size: int) -> int:
    """Real sample count in docs [doc_start, doc_end) when the dataset holds
    `num_samples` samples packed `subset_size`-per-doc (last doc short)."""
    if doc_end <= doc_start:
        return 0
    lo = doc_start * subset_size
    hi = min(doc_end * subset_size, num_samples)
    return max(0, hi - lo)


def plan_epoch(num_samples: int, n_workers: int, k: int, batch_size: int,
               subset_size: int = STORAGE_SUBSET_SIZE) -> EpochPlan:
    """Build the static sync-round schedule for one epoch.

    Matches the reference's per-function loop (network.py:261-306): worker w
    iterates its contiguous doc shard in `get_subset_period` chunks; here the
    chunks are aligned into global rounds so the merge barrier becomes one
    collective per round. Workers whose shard runs out early are inactive
    (masked) in later rounds — this reproduces the reference's
    merge-with-whoever-reports behavior (ml/pkg/train/job.go:388-398) for
    ragged shards.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")

    num_docs = math.ceil(num_samples / subset_size)
    shards = split_minibatches(range(num_docs), n_workers)

    # per-worker interval starts, exactly as network.py:270-276
    worker_intervals: List[List[tuple]] = []
    for w in range(n_workers):
        assigned = shards[w]
        if len(assigned) == 0:
            worker_intervals.append([])
            continue
        period = get_subset_period(k, batch_size, assigned, subset_size)
        starts = range(assigned.start, assigned.stop, period)
        worker_intervals.append(
            [(i, min(assigned.stop, i + period)) for i in starts])

    n_rounds = max((len(iv) for iv in worker_intervals), default=0)
    plan = EpochPlan(num_workers=n_workers, batch_size=batch_size, k=k,
                     subset_size=subset_size)
    for r in range(n_rounds):
        chunks = []
        for w in range(n_workers):
            if r < len(worker_intervals[w]):
                start, end = worker_intervals[w][r]
            else:
                start = end = 0
            samples = _doc_samples(start, end, num_samples, subset_size)
            steps = math.ceil(samples / batch_size) if samples else 0
            chunks.append(WorkerChunk(worker=w, doc_start=start, doc_end=end,
                                      num_samples=samples, num_steps=steps))
        plan.rounds.append(RoundPlan(index=r, chunks=chunks))
    return plan
