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

The continual mode refreshes the cache as its window slides
(``refresh(handle)``, then ``ensure``): the cache keys its layout on the
handle's absolute window (``train_base``, ``train_samples``), and an
``incremental`` cache re-lays out lane by lane on ABSOLUTE sample ranges.
Appends never rewrite a retained sample, so a lane's overlap with its
previous absolute range is bit-identical content: it is copied from the
previous device slab on the device, and only the samples that slid in are
read from the mmap and sent host to device (a grown lane sends its tail,
an unchanged lane nothing). The JAX package keeps a host copy of the
slabs for that overlap and re-sends the whole slab; on one card the old
slab is already on the device, so the port keeps no host copy and sends
only what is new. ``grow_quantum`` rounds the slab width up, so growth
within the quantum keeps ``signature``.
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
                 device_transform: Optional[Callable] = None,
                 incremental: bool = False, grow_quantum: int = 0):
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
        #: reuse each lane's overlap with its previous absolute range
        #: (the continual refresh)
        self.incremental = bool(incremental)
        #: round each lane's slab width up to this many samples, so
        #: window growth within the quantum keeps ``signature`` (0: exact)
        self.grow_quantum = int(grow_quantum)
        #: per lane, the absolute [lo, hi) sample range of the last layout
        self._lane_abs: List[Tuple[int, int]] = []
        #: cumulative layout accounting (the continual freshness figures);
        #: h2d_bytes counts the bytes sent host to device
        self.stats: Dict[str, int] = {
            "uploads": 0, "lanes_reused": 0, "lanes_refreshed": 0,
            "h2d_bytes": 0}

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        a = np.asarray(a)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a)              # a read-only mmap: one host copy
        self.stats["h2d_bytes"] += int(a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def _set_arrays(self, arrays: Dict[str, torch.Tensor]) -> None:
        self.arrays = arrays
        per_lane = 1 if self.layout == "replicated" else self.n_lanes
        self.device_bytes = sum(
            a.numel() * a.element_size() for a in self.arrays.values()
        ) // per_lane
        self.stats["uploads"] += 1

    def _put(self, host: Dict[str, np.ndarray]) -> None:
        self._set_arrays({k: self._to_device(v) for k, v in host.items()})

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
        upload happened: the first epoch, a refresh that moved the
        handle's absolute window, or (sharded only) a parallelism change
        that moved the lane boundaries. The replicated layout is
        plan-independent: the permutation lives in the index plan."""
        x_mm, y_mm = self.handle.train_arrays()
        base = int(self.handle.train_base)
        if self.layout == "replicated":
            key = ("rep", base, int(len(x_mm)))
            if self.arrays is not None and key == self._plan_key:
                return False
            self._put({"x": x_mm, "y": y_mm})
            self._plan_key = key
            return True
        if plan is None or W <= 0:
            raise ValueError("sharded layout needs (plan, W) to lay out "
                             "the lane slabs")
        lane_lo, lane_hi = self._lane_ranges(plan, W)
        key = (tuple(lane_lo), tuple(lane_hi), base,
               int(self.handle.train_samples))
        if key == self._plan_key:
            return False
        L = max(1, max(h - l for l, h in zip(lane_lo, lane_hi)))
        if self.grow_quantum > 1:
            L = -(-L // self.grow_quantum) * self.grow_quantum
        abs_ranges = [(base + lo, base + hi)
                      for lo, hi in zip(lane_lo, lane_hi)]
        prev = self.arrays if self.incremental else None
        prev_abs = self._lane_abs if prev is not None else []
        # per lane, the absolute overlap with its previous range: copied
        # on the device; the rest of the lane comes from the mmap
        overlap = []
        for d, (alo, ahi) in enumerate(abs_ranges):
            olo = ohi = alo
            if d < len(prev_abs):
                olo = max(alo, prev_abs[d][0])
                ohi = min(ahi, prev_abs[d][1])
            overlap.append((olo, ohi) if olo < ohi else None)

        def slab(name: str, src: np.ndarray) -> torch.Tensor:
            dtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
            out = torch.zeros((self.n_lanes, L) + src.shape[1:],
                              dtype=dtype, device=self.device)
            for d, (lo, hi) in enumerate(zip(lane_lo, lane_hi)):
                alo = abs_ranges[d][0]
                if overlap[d] is None:
                    pieces = [(lo, hi)]
                else:
                    olo, ohi = overlap[d]
                    plo = prev_abs[d][0]
                    out[d, olo - alo: ohi - alo] = \
                        prev[name][d, olo - plo: ohi - plo]
                    pieces = [(lo, lo + (olo - alo)),
                              (lo + (ohi - alo), hi)]
                for a, b in pieces:
                    if a < b:
                        out[d, a - lo: b - lo] = self._to_device(src[a:b])
            return out

        self._set_arrays({"x": slab("x", x_mm), "y": slab("y", y_mm)})
        self.lane_starts = np.asarray(lane_lo, np.int64)
        self._plan_key = key
        # a live lane counts as reused when its whole range came from the
        # previous slab
        live = [d for d in range(self.n_lanes) if lane_hi[d] > lane_lo[d]]
        reused = sum(1 for d in live if overlap[d] == abs_ranges[d])
        self._lane_abs = abs_ranges
        self.stats["lanes_reused"] += reused
        self.stats["lanes_refreshed"] += len(live) - reused
        return True

    def refresh(self, handle: DatasetHandle) -> None:
        """Point the cache at a fresh registry handle (the continual
        refresh between epochs). Invalidation is lazy: the next
        ``ensure`` compares the new handle's absolute window with the last
        layout and re-lays out only what moved (per lane for sharded
        slabs, the whole split for replicated)."""
        self.handle = handle

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
