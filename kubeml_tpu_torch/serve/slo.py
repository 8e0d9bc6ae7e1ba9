"""Per-model SLO objectives and multi-window burn-rate alerting (copy of
kubeml_tpu/serve/slo.py, held to the same burn rates by
tests/test_torch_sketch.py).

The serving SLO is availability-style: a finished request is *good*
when it met its latency objectives (TTFT and per-output-token time),
*bad* otherwise (including errors and deadline misses).  With a target
of ``target`` (say 0.99), the error budget is ``1 - target``; the
**burn rate** over a window is::

    burn = bad_fraction / (1 - target)

so burn 1.0 exactly exhausts the budget at the window's pace, and
burn 10 eats a month of budget in ~3 days.  Following the multi-window
pattern (Google SRE workbook), an alert requires BOTH a fast window
(recent pain, quick to clear) and a slow window (sustained pain, no
flapping on a single bad tick) to burn above 1.0.

``SLOEngine`` is fed per-autoscale-tick good/bad deltas by the fleet
(which diffs the replicas' cumulative counters) and keeps a bounded
history of ticks.  Windows shorter than the history-so-far compute
over what exists — a bench that burns hard from tick 0 alerts as soon
as both windows have signal, without waiting 60 ticks.

Pure host-side bookkeeping: no clock, no locks (the fleet's autoscale
loop is the single writer).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Tuple

__all__ = ["SLOEngine", "DEFAULT_SLO_TARGET"]

DEFAULT_SLO_TARGET = 0.99
FAST_WINDOW_TICKS = 5
SLOW_WINDOW_TICKS = 60


class SLOEngine:
    """Windowed good/bad counting and fast/slow burn-rate alerts."""

    def __init__(self, ttft_s: float, tpot_s: float,
                 target: float = DEFAULT_SLO_TARGET,
                 fast_ticks: int = FAST_WINDOW_TICKS,
                 slow_ticks: int = SLOW_WINDOW_TICKS):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if fast_ticks < 1 or slow_ticks < fast_ticks:
            raise ValueError("need 1 <= fast_ticks <= slow_ticks")
        self.ttft_s = float(ttft_s)
        self.tpot_s = float(tpot_s)
        self.target = float(target)
        self.fast_ticks = int(fast_ticks)
        self.slow_ticks = int(slow_ticks)
        # (good_delta, bad_delta) per tick, newest last
        self._ticks: Deque[Tuple[int, int]] = deque(maxlen=slow_ticks)
        self.good_total = 0
        self.bad_total = 0
        self.alerts_total = 0
        self._alerting = False

    # ------------------------------------------------------------- feed

    def tick(self, good_delta: int, bad_delta: int) -> bool:
        """Record one window tick; returns True on alert ONSET."""
        self._ticks.append((max(0, int(good_delta)), max(0, int(bad_delta))))
        self.good_total += max(0, int(good_delta))
        self.bad_total += max(0, int(bad_delta))
        now = self.alerting
        onset = now and not self._alerting
        self._alerting = now
        if onset:
            self.alerts_total += 1
        return onset

    # ------------------------------------------------------------ query

    def _window(self, ticks: int) -> Tuple[int, int]:
        n = min(ticks, len(self._ticks))
        good = bad = 0
        if n:
            for g, b in list(self._ticks)[-n:]:
                good += g
                bad += b
        return good, bad

    def _burn(self, ticks: int) -> float:
        good, bad = self._window(ticks)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - self.target)

    @property
    def burn_fast(self) -> float:
        return self._burn(self.fast_ticks)

    @property
    def burn_slow(self) -> float:
        return self._burn(self.slow_ticks)

    @property
    def alerting(self) -> bool:
        """Both windows burning above 1.0 (multi-window rule)."""
        return self.burn_fast > 1.0 and self.burn_slow > 1.0

    @property
    def attainment(self) -> float:
        """Good fraction over the slow window; 1.0 with no traffic."""
        good, bad = self._window(self.slow_ticks)
        total = good + bad
        if total == 0:
            return 1.0
        return good / total

    def classify(self, outcome: str, ttft: float, tpot: float) -> bool:
        """True when a finished request met its objectives ("good")."""
        if outcome != "ok":
            return False
        if self.ttft_s > 0.0 and ttft > self.ttft_s:
            return False
        if self.tpot_s > 0.0 and tpot > self.tpot_s:
            return False
        return True

    def snapshot_fields(self) -> dict:
        """The serve_slo_* fields the fleet folds into its snapshot."""
        return {
            "serve_slo_target": self.target,
            "serve_slo_attainment": round(self.attainment, 6),
            "serve_slo_burn_fast": round(self.burn_fast, 6),
            "serve_slo_burn_slow": round(self.burn_slow, 6),
            "serve_slo_good_total": self.good_total,
            "serve_slo_bad_total": self.bad_total,
            "serve_slo_alerts_total": self.alerts_total,
        }
