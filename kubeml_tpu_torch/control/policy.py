"""Scheduler policies: dynamic (elastic) parallelism (copy of
kubeml_tpu/control/policy.py; the port imports nothing of the JAX
package). ``ThroughputBasedPolicy`` is the same state machine:
  1st call (no cache entry): cache 0, return the task's own
      default_parallelism;
  2nd call (cached 0): parallelism + 1, cache the elapsed time;
  later: elapsed <= 1.05 x cached -> +1, refresh the cache;
         elapsed >= 1.20 x cached -> -1 (floored at 1), refresh;
         in between              -> unchanged, cache kept.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from kubeml_tpu_torch.api.const import POLICY_LOWER_BOUND, POLICY_UPPER_BOUND
from kubeml_tpu_torch.api.types import TrainTask


class ThroughputBasedPolicy:
    def __init__(self, upper: float = POLICY_UPPER_BOUND,
                 lower: float = POLICY_LOWER_BOUND):
        self.upper = upper
        self.lower = lower
        self._time_cache: Dict[str, float] = {}
        self._lock = threading.Lock()

    def calculate_parallelism(self, task: TrainTask) -> Tuple[int, bool]:
        """(parallelism for the task's next epoch, is_new_task)."""
        with self._lock:
            prev = self._time_cache.get(task.job_id)
            if prev is None:
                self._time_cache[task.job_id] = 0.0
                return task.parameters.options.default_parallelism, True
            if prev == 0.0:
                # no reference time yet: scale up and record one
                self._time_cache[task.job_id] = task.elapsed_time_s
                return task.parallelism + 1, False
            if task.elapsed_time_s <= prev * self.lower:
                self._time_cache[task.job_id] = task.elapsed_time_s
                return task.parallelism + 1, False
            if task.elapsed_time_s >= prev * self.upper:
                self._time_cache[task.job_id] = task.elapsed_time_s
                # floored at 1: no job runs on zero workers
                return max(1, task.parallelism - 1), False
            return task.parallelism, False

    def task_finished(self, job_id: str) -> None:
        """Drop the job's policy state."""
        with self._lock:
            self._time_cache.pop(job_id, None)
