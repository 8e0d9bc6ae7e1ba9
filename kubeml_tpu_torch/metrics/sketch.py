"""Mergeable windowed latency sketches (DDSketch-style, fixed gamma); a
copy of kubeml_tpu/metrics/sketch.py, since the port imports nothing of
the JAX package, held to the same quantiles and merges by
tests/test_torch_sketch.py.

The serving fleet needs percentiles that (a) merge *exactly* across
replicas — so fleet p99 is the p99 of the pooled samples, not the
worst replica's — and (b) age out, so an idle fleet's window empties
instead of pinning a stale p99 forever.

Two pieces:

``QuantileSketch``
    Fixed-gamma log-bucket histogram (Masson et al., VLDB 2019).  A
    value ``v > 0`` lands in bucket ``ceil(log_gamma(v))``; the bucket
    midpoint ``2·gamma^k/(gamma+1)`` answers any quantile within
    relative error ``alpha`` where ``gamma = (1+alpha)/(1-alpha)``.
    Because the bucket boundaries are a pure function of ``alpha``,
    merging two sketches is bucket-count addition — associative,
    commutative, and *exactly* equal to sketching the pooled samples.
    ``state()``/``from_state()`` round-trip through plain JSON so a
    replica snapshot can carry its buckets to the fleet merge.

``WindowedSketch``
    A ring of sub-window sketches keyed by a tick counter derived from
    an injectable clock.  Samples land in the current sub-window;
    queries merge the live sub-windows and expired ticks are dropped
    deterministically — no wall-clock reads, so tests drive it with a
    fake clock tick by tick.

Everything here is host-side pure Python: no numpy, no hidden time
source.  ``QuantileSketch`` is single-threaded (callers serialize);
``WindowedSketch`` takes a small per-instance lock because it is the
object shared across threads in practice — the replica loop adds
samples while fleet snapshot threads merge the window.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

__all__ = ["QuantileSketch", "WindowedSketch"]

DEFAULT_ALPHA = 0.01


class QuantileSketch:
    """Fixed-gamma log-bucket quantile sketch with exact merge."""

    __slots__ = ("alpha", "_gamma", "_log_gamma", "_buckets", "_zero")

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # values <= 0 (clamped; latencies only)

    # ------------------------------------------------------------ insert

    def add(self, value: float, count: int = 1) -> None:
        if count <= 0:
            return
        if value <= 0.0:
            self._zero += count
            return
        key = math.ceil(math.log(value) / self._log_gamma)
        self._buckets[key] = self._buckets.get(key, 0) + count

    # ------------------------------------------------------------- merge

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (bucket-count addition; exact)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha "
                f"({self.alpha} vs {other.alpha})")
        self._zero += other._zero
        for key, n in other._buckets.items():
            self._buckets[key] = self._buckets.get(key, 0) + n
        return self

    # ------------------------------------------------------------ query

    @property
    def count(self) -> int:
        return self._zero + sum(self._buckets.values())

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]; 0.0 on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        total = self.count
        if total == 0:
            return 0.0
        rank = q * (total - 1)
        seen = self._zero
        if rank < seen:
            return 0.0
        for key in sorted(self._buckets):
            seen += self._buckets[key]
            if rank < seen:
                # midpoint of (gamma^(k-1), gamma^k]
                return 2.0 * self._gamma ** key / (self._gamma + 1.0)
        # unreachable unless float slop at q == 1.0
        key = max(self._buckets)
        return 2.0 * self._gamma ** key / (self._gamma + 1.0)

    # ------------------------------------------------------- state (JSON)

    def state(self) -> dict:
        """Plain-JSON snapshot: merge-able via ``from_state`` + ``merge``."""
        return {
            "alpha": self.alpha,
            "zero": self._zero,
            "buckets": {str(k): n for k, n in self._buckets.items()},
        }

    @classmethod
    def from_state(cls, st: dict) -> "QuantileSketch":
        sk = cls(alpha=float(st.get("alpha", DEFAULT_ALPHA)))
        sk._zero = int(st.get("zero", 0))
        sk._buckets = {int(k): int(n)
                       for k, n in dict(st.get("buckets", {})).items()}
        return sk

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"QuantileSketch(alpha={self.alpha}, count={self.count}, "
                f"buckets={len(self._buckets)})")


class WindowedSketch:
    """Ring of sub-window sketches over an injectable clock.

    The window of ``window_s`` seconds is cut into ``subwindows`` equal
    ticks.  A sample lands in the sketch for the clock's current tick;
    queries merge every live tick and drop ticks older than the window.
    Expiry is a pure function of the clock reading — deterministic
    under a fake clock, and an idle window drains to empty (count 0)
    after ``window_s`` seconds with no samples.

    Thread-safe: ``add`` and the query paths hold a per-instance lock,
    since the replica loop inserts while fleet snapshot threads merge.
    """

    __slots__ = ("window_s", "subwindows", "alpha", "_clock", "_tick_s",
                 "_ring", "_lock")

    def __init__(self, window_s: float = 60.0, subwindows: int = 6,
                 alpha: float = DEFAULT_ALPHA, clock=None):
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if subwindows < 1:
            raise ValueError(f"subwindows must be >= 1, got {subwindows}")
        import time as _time
        self.window_s = float(window_s)
        self.subwindows = int(subwindows)
        self.alpha = float(alpha)
        self._clock = clock if clock is not None else _time.perf_counter
        self._tick_s = self.window_s / self.subwindows
        self._ring: Dict[int, QuantileSketch] = {}
        self._lock = threading.Lock()

    def _tick(self) -> int:
        return int(self._clock() // self._tick_s)

    def _expire(self, now_tick: int) -> None:
        floor = now_tick - self.subwindows
        for key in [k for k in self._ring if k <= floor]:
            del self._ring[key]

    # ------------------------------------------------------------ insert

    def add(self, value: float) -> None:
        with self._lock:
            tick = self._tick()
            self._expire(tick)
            sk = self._ring.get(tick)
            if sk is None:
                sk = self._ring[tick] = QuantileSketch(alpha=self.alpha)
            sk.add(value)

    # ------------------------------------------------------------- query

    def merged(self) -> QuantileSketch:
        """Exact merge of the live sub-windows (a fresh sketch)."""
        with self._lock:
            tick = self._tick()
            self._expire(tick)
            out = QuantileSketch(alpha=self.alpha)
            for sk in self._ring.values():
                out.merge(sk)
            return out

    def quantile(self, q: float) -> float:
        return self.merged().quantile(q)

    @property
    def count(self) -> int:
        return self.merged().count

    def state(self) -> dict:
        """JSON state of the merged live window (for fleet-side merge)."""
        return self.merged().state()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"WindowedSketch(window_s={self.window_s}, "
                f"subwindows={self.subwindows}, count={self.count})")
