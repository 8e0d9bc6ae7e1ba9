"""Random worker loss for straggler and failure-tolerance runs (a copy of
kubeml_tpu/utils/chaos.py: the port imports nothing of the JAX package).

The merge proceeds with whichever workers reported; this round hook knocks
out random workers, as if their function had died mid-epoch. Its
``np.random.RandomState(seed)`` stream is the reference's, so the masks
are equal for a seed.

Use via TrainJob(round_hook=WorkerLossInjector(p=0.2, seed=0)).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WorkerLossInjector:
    """Zero each worker's contribution with probability p per round,
    always leaving at least one survivor (a zero-survivor round is the
    job-abort path, which is its own test)."""

    p: float = 0.2
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        self.rounds = 0
        self.degraded_rounds = 0
        self.workers_lost = 0

    def __call__(self, rb):
        mask = rb.worker_mask.copy()
        alive = np.flatnonzero(mask > 0)
        if len(alive) > 1:
            kill = alive[self._rng.rand(len(alive)) < self.p]
            if len(kill) == len(alive):  # leave one survivor
                kill = kill[:-1]
            mask[kill] = 0.0
            self.workers_lost += len(kill)
            if len(kill):
                self.degraded_rounds += 1
        self.rounds += 1
        return dataclasses.replace(rb, worker_mask=mask)
