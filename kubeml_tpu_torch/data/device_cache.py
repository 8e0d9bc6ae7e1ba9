"""Device-resident training-set cache for index-fed sync rounds (twin of
kubeml_tpu/data/device_cache.py, on one device).

The host-staged path ships every round's [W, S, B, ...] sample tensor to
the device, every round, although the train split does not change across
rounds: only which samples each worker sees does. The cache uploads the
split once per job (again only when the lane layout moves), and each
round then carries [W, S, B] int32 gather indices; the engine gathers the
samples on the device (``KAvgEngine.train_round(s)_indexed``).

Two layouts, as in the reference:

  sharded     per-lane slabs [D, L, ...] on a leading lane axis: lane d
              holds exactly the sample range its workers' doc shards
              cover (contiguous, since the plan deals contiguous doc
              ranges in worker order and lane d owns workers
              [d W / D, (d + 1) W / D)). Indices are lane-LOCAL. A
              parallelism change moves the lane boundaries, so ``ensure``
              re-lays the slabs out when the plan's lane ranges change.
  replicated  the whole split [n, ...], indices GLOBAL. Needed when a
              lane's samples are not a contiguous range of the stored
              array (per-epoch doc shuffling).

The cache holds the RAW stored arrays ({"x": data, "y": labels}), so a
dataset is eligible when its host ``transform_train`` is the identity, or
when it has a ``transform_train_device`` twin (models/base.KubeDataset)
that the round applies to the gathered leaves on the device.

Not ported: ``refresh`` and ``incremental``/``grow_quantum`` (they come
with the continual mode).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kubeml_tpu_torch.data.registry import DatasetHandle
from kubeml_tpu_torch.data.sharding import EpochPlan

LAYOUTS = ("sharded", "replicated")


class DeviceDatasetCache:
    """One job's device-resident train split and its layout.

    Construct with a layout decision (train/job.py makes it from shuffle
    and the budget), then ``ensure(plan, W)`` before each epoch: a no-op
    when the device arrays already serve the plan."""

    def __init__(self, handle: Optional[DatasetHandle],
                 device: torch.device, n_lanes: int = 1,
                 layout: str = "sharded",
                 device_transform: Optional[Callable] = None):
        if layout not in LAYOUTS:
            raise ValueError(
                f"layout must be 'sharded' or 'replicated', got {layout!r}")
        self.handle = handle
        self.device = torch.device(device)
        self.layout = layout
        self.device_transform = device_transform
        self.n_lanes = int(n_lanes)
        #: {"x", "y"} device tensors: [D, L, ...] slabs (sharded) or the
        #: whole [n, ...] split (replicated)
        self.arrays: Optional[Dict[str, torch.Tensor]] = None
        #: [D] global sample offset of each lane's slab (sharded only);
        #: None means indices are global (replicated)
        self.lane_starts: Optional[np.ndarray] = None
        #: bytes resident per lane after the last upload
        self.device_bytes = 0
        self._plan_key = None
        self.stats: Dict[str, int] = {"uploads": 0}

    # ------------------------------------------------------------- estimates

    @staticmethod
    def dataset_bytes(handle: DatasetHandle) -> int:
        """Total bytes of the train split (mmap metadata only, no read)."""
        x_mm, y_mm = handle.train_arrays()
        return int(x_mm.nbytes) + int(y_mm.nbytes)

    @staticmethod
    def per_sample_bytes(handle: DatasetHandle) -> int:
        """Bytes one sample costs on the host-staged wire (data + label)."""
        x_mm, y_mm = handle.train_arrays()
        n = max(1, len(x_mm))
        return int(x_mm.nbytes) // n + int(y_mm.nbytes) // n

    @classmethod
    def per_chip_bytes(cls, handle: DatasetHandle, layout: str,
                       n_lanes: int) -> int:
        """Static per-lane device-memory estimate for the budget decision
        (slab zero-padding adds at most one worker shard of slack)."""
        total = cls.dataset_bytes(handle)
        if layout == "replicated":
            return total
        return -(-total // max(1, n_lanes))

    # --------------------------------------------------------------- uploads

    def _put(self, host: Dict[str, np.ndarray]) -> None:
        def tensor(a: np.ndarray) -> torch.Tensor:
            a = np.asarray(a)
            if not (a.flags.writeable and a.flags.c_contiguous):
                a = np.array(a)          # a read-only mmap: one host copy
            return torch.from_numpy(a).to(self.device)

        self.arrays = {k: tensor(v) for k, v in host.items()}
        per_lane = 1 if self.layout == "replicated" else self.n_lanes
        self.device_bytes = sum(
            a.numel() * a.element_size() for a in self.arrays.values()
        ) // per_lane
        self.stats["uploads"] += 1

    @classmethod
    def from_arrays(cls, device, arrays: Dict[str, np.ndarray],
                    layout: str = "replicated", n_lanes: int = 1,
                    device_transform: Optional[Callable] = None
                    ) -> "DeviceDatasetCache":
        """A cache built straight from host arrays (no registry handle):
        ``sharded`` splits sample axis 0 into contiguous near-equal lane
        slabs and records ``lane_starts``."""
        self = cls(None, device, n_lanes=n_lanes, layout=layout,
                   device_transform=device_transform)
        if layout == "replicated":
            self._put({k: np.asarray(v) for k, v in arrays.items()})
            return self
        n = len(next(iter(arrays.values())))
        D = self.n_lanes
        bounds = [(i * n) // D for i in range(D + 1)]
        L = max(1, max(bounds[d + 1] - bounds[d] for d in range(D)))

        def slab(src: np.ndarray) -> np.ndarray:
            out = np.zeros((D, L) + src.shape[1:], src.dtype)
            for d in range(D):
                lo, hi = bounds[d], bounds[d + 1]
                out[d, : hi - lo] = src[lo:hi]
            return out

        self._put({k: slab(np.asarray(v)) for k, v in arrays.items()})
        self.lane_starts = np.asarray(bounds[:-1], np.int64)
        return self

    def _lane_ranges(self, plan: EpochPlan, W: int
                     ) -> Tuple[List[int], List[int]]:
        """Per-lane [lo, hi) GLOBAL sample ranges covering every chunk the
        plan hands the lane's workers, read off the plan itself. Lanes
        whose workers are all inactive (N < D padding) get an empty
        range."""
        ss = self.handle.subset_size
        n = self.handle.train_samples
        wpl = max(1, W // self.n_lanes)
        doc_lo: Dict[int, int] = {}
        doc_hi: Dict[int, int] = {}
        for rp in plan.rounds:
            for c in rp.chunks:
                if not c.active:
                    continue
                doc_lo[c.worker] = min(doc_lo.get(c.worker, c.doc_start),
                                       c.doc_start)
                doc_hi[c.worker] = max(doc_hi.get(c.worker, c.doc_end),
                                       c.doc_end)
        lane_lo, lane_hi = [], []
        for d in range(self.n_lanes):
            workers = [w for w in range(d * wpl, min((d + 1) * wpl, W))
                       if w in doc_lo]
            if not workers:
                lane_lo.append(0)
                lane_hi.append(0)
                continue
            lane_lo.append(min(doc_lo[w] for w in workers) * ss)
            lane_hi.append(min(max(doc_hi[w] for w in workers) * ss, n))
        return lane_lo, lane_hi

    def ensure(self, plan: Optional[EpochPlan] = None, W: int = 0) -> bool:
        """Make the device arrays serve this epoch's plan; True when an
        upload happened (the first epoch, or, sharded only, a parallelism
        change that moved the lane boundaries). The replicated layout
        uploads once: the permutation lives in the index plan."""
        x_mm, y_mm = self.handle.train_arrays()
        if self.layout == "replicated":
            key = ("rep", int(len(x_mm)))
            if self.arrays is not None and key == self._plan_key:
                return False
            self._put({"x": x_mm, "y": y_mm})
            self._plan_key = key
            return True
        if plan is None or W <= 0:
            raise ValueError("sharded layout needs (plan, W) to lay out "
                             "the lane slabs")
        lane_lo, lane_hi = self._lane_ranges(plan, W)
        key = (tuple(lane_lo), tuple(lane_hi),
               int(self.handle.train_samples))
        if key == self._plan_key:
            return False
        L = max(1, max(h - l for l, h in zip(lane_lo, lane_hi)))

        def slab(src: np.ndarray) -> np.ndarray:
            out = np.zeros((self.n_lanes, L) + src.shape[1:], src.dtype)
            for d, (lo, hi) in enumerate(zip(lane_lo, lane_hi)):
                out[d, : hi - lo] = src[lo:hi]
            return out

        self._put({"x": slab(x_mm), "y": slab(y_mm)})
        self.lane_starts = np.asarray(lane_lo, np.int64)
        self._plan_key = key
        return True

    # ------------------------------------------------------------------ keys

    @property
    def signature(self) -> tuple:
        """The layout and slab shapes/dtypes the rounds are fed from (the
        reference keys its compiled rounds on it)."""
        if self.arrays is None:
            raise ValueError("cache not uploaded yet: call ensure() first")
        return (self.layout,
                tuple(sorted((k, tuple(v.shape), str(v.dtype).replace(
                    "torch.", "")) for k, v in self.arrays.items())),
                self.device_transform is not None)
