"""Device-runtime introspection: compile tracking and device-memory
watermarks (twin of kubeml_tpu/metrics/runtime.py).

Two perf regressions are invisible in loss curves: RECOMPILE STORMS (a
drifting batch/round shape makes every dispatch build a new program)
and memory creep (a leaked reference walks peak memory up until
allocation fails). The engines know when a dispatch is a program's
first at its shape (`RoundStats.compiled`, the serve engine's first
decode/prefill); this module turns that signal plus the CUDA caching
allocator's statistics into the counters and gauges the job publishes
per epoch (`kubeml_jit_compiles_total`, `kubeml_device_hbm_bytes`).

Everything here is host-side bookkeeping: nothing touches the dispatch
path, and the allocator's statistics are host counters (no device sync).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger("kubeml_tpu_torch.metrics.runtime")

# a storm is many compiles CLOSE TOGETHER: this many compiles within the
# trailing window of notes flags it (tunable per tracker)
STORM_COMPILES = 3
STORM_WINDOW = 8


class JitCompileTracker:
    """Counts program compiles and flags recompile storms (a copy of the
    reference's).

    The job calls `note(compiled, duration_s, program=...)` once per
    dispatch with the engine's compile flag and the wall time of that
    dispatch. The port builds no XLA program: a dispatch is "compiled"
    when the reference's program cache would miss for it (a new round
    key, a serve program's first dispatch), so the counts equal the
    reference's for the same plan, and a compiled dispatch's duration is
    its wall time, kernel builds at first use included. A healthy job
    compiles a handful of programs up front and never again; `storm`
    goes True when >= `storm_compiles` of the trailing `storm_window`
    dispatches of one program compiled — the signature of shape drift.

    Storm windows are PER PROGRAM, keyed on the cost ledger's registry
    names (metrics/ledger.py: "kavg.train", "serve.decode", …), so
    healthy one-time compiles of several programs never read as a storm
    and the storm log names the guilty program. Un-named notes share
    the "" window.
    """

    def __init__(self, storm_compiles: int = STORM_COMPILES,
                 storm_window: int = STORM_WINDOW):
        self.storm_compiles = storm_compiles
        self.storm_window = storm_window
        self.compiles = 0
        self.dispatches = 0
        self.compile_seconds = 0.0
        self.storms = 0
        self.storm = False          # any program currently in storm
        self._recent: Dict[str, List[bool]] = {}
        self._storming: Dict[str, bool] = {}
        self.storms_by_program: Dict[str, int] = {}

    def note(self, compiled: bool, duration_s: float = 0.0,
             program: str = "") -> None:
        """Record one dispatch of `program`; duration only accumulates
        on compiles."""
        self.dispatches += 1
        recent = self._recent.setdefault(program, [])
        recent.append(bool(compiled))
        if len(recent) > self.storm_window:
            recent.pop(0)
        if compiled:
            self.compiles += 1
            self.compile_seconds += float(duration_s)
        in_storm = sum(recent) >= self.storm_compiles
        if in_storm and not self._storming.get(program, False):
            self.storms += 1
            self.storms_by_program[program] = \
                self.storms_by_program.get(program, 0) + 1
            logger.warning(
                "recompile storm in program %r: %d of the last %d "
                "dispatches compiled (%d compiles total) — check for "
                "round-shape drift", program or "<unattributed>",
                sum(recent), len(recent), self.compiles)
        self._storming[program] = in_storm
        self.storm = any(self._storming.values())

    def snapshot(self) -> Dict[str, float]:
        return {
            "jit_compiles": self.compiles,
            "jit_dispatches": self.dispatches,
            "jit_compile_seconds": round(self.compile_seconds, 6),
            "jit_storms": self.storms,
        }


def device_memory_stats(device=None) -> Optional[Tuple[int, int]]:
    """(peak_bytes, in_use_bytes) from the CUDA caching allocator
    (`torch.cuda.max_memory_allocated`, `torch.cuda.memory_allocated`),
    or None on the CPU, which has no allocator watermark. A CUDA query
    that fails raises: it never falls back to a host figure that would
    hide the card."""
    import torch        # here, so that the CLI's client verbs never load it

    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return None
    return (int(torch.cuda.max_memory_allocated(dev)),
            int(torch.cuda.memory_allocated(dev)))


def tensors_bytes(tensors: Iterable) -> int:
    """Sum of nbytes over the given tensors (each counted once): the CPU
    stand-in for bytes in use."""
    seen, total = set(), 0
    for t in tensors:
        if t is None or id(t) in seen:
            continue
        seen.add(id(t))
        total += int(t.numel()) * int(t.element_size())
    return total


class HbmWatermark:
    """Peak / in-use device-memory sampler.

    `sample()` is called at natural sync points (epoch end); on the card
    it reads the caching allocator's own watermark. On the CPU it sums
    the nbytes of the tensors the caller registered (`track`: the job
    registers its state and its optimizer state) and keeps the max seen
    across samples as the peak. The reference's CPU figure sums every
    live JAX array instead; the port has no such registry, so its CPU
    figure is its own and is not held equal to the reference's. Either
    way the result feeds `kubeml_device_hbm_bytes{kind=peak|in_use}`.
    """

    def __init__(self, device=None):
        self.device = device
        self.peak_bytes = 0
        self.in_use_bytes = 0
        self.samples = 0
        self._sources: List = []

    def track(self, source) -> None:
        """Register a callable returning the tensors that count on the
        CPU (read at each sample, so replaced tensors are seen)."""
        self._sources.append(source)

    def sample(self) -> Tuple[int, int]:
        stats = device_memory_stats(self.device)
        if stats is not None:
            peak, in_use = stats
            self.peak_bytes = max(self.peak_bytes, peak)
        else:
            in_use = tensors_bytes(t for src in self._sources
                                   for t in src())
            self.peak_bytes = max(self.peak_bytes, in_use)
        self.in_use_bytes = in_use
        self.samples += 1
        return self.peak_bytes, self.in_use_bytes

    def snapshot(self) -> Dict[str, int]:
        return {
            "hbm_peak_bytes": self.peak_bytes,
            "hbm_in_use_bytes": self.in_use_bytes,
        }
