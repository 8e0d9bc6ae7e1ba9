"""Analytic cost ledger: per-program FLOP and byte attribution (twin of
kubeml_tpu/metrics/ledger.py).

Every program the port runs — the K-avg round programs, the serve
programs {decode, prefill}, and the closed-form kernel proxies (the
fused merge's wire plan, paged-attention KV traffic) — gets one
deterministic `ProgramCost` record: flops, HBM bytes, transcendentals,
peak temp memory. The reference reads these from XLA's cost model,
captured ahead of time at a program's first compile. Eager PyTorch has
no compiled program to analyse, so `capture()` here always installs the
caller's closed-form `fallback` with source="fallback": exactly the
record the reference writes when KUBEML_COST_LEDGER=0 or on a backend
without cost analysis. Every number the port publishes (snapshots,
`GET /cost`, `kubeml cost`, the kubeml_cost_* counters) is therefore
the reference's own under that setting, bit for bit. The one
difference: the port never writes source="xla" records.

The ledger then counts dispatches so cost is *attributed*, not just
cataloged: flops/sample and bytes/sample on the train plane (samples
merged across lanes by the engines), flops/token and bytes/token on the
serve plane.

Reconciliation is the anti-drift contract: the hand-derived proxies
(merge.py `comm_proxy`, pager.py `decode_bytes_per_token`) are
cross-checked against ledger records via `reconcile()` — exact for
pure-counter fields — and a mismatch raises `CostReconciliationError`
instead of silently drifting.

Totals accumulate incrementally (`note_dispatch` adds the CURRENT
record's per-dispatch cost), so with stable shapes the invariant
`totals == dispatches x per-dispatch cost` replays exactly; a
mid-run recapture (shape change) bumps `recaptures` so the replay
check knows when the invariant is per-segment rather than global.

Everything here is host-side bookkeeping: `note_dispatch` is a few dict
adds on the host, and nothing touches the device.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional

PLANES = ("train", "serve", "kernel")

# cost sources, strongest first: "xla" = the reference's HLO cost model
# (kept for the wire: the port never writes it), "analytic" = exact
# closed-form counter (pure host arithmetic over shapes), "fallback" =
# closed-form estimate standing in for a compiler's analysis
SOURCES = ("xla", "analytic", "fallback")

# the reference's tolerance for reconciling an XLA-derived byte count
# against a closed-form proxy; kept for the wire and for callers that
# hold both packages' records. Pure-counter reconciliations pass tol=0.0
# and must match exactly.
XLA_PROXY_TOLERANCE = 0.50


def _enabled() -> bool:
    return os.environ.get("KUBEML_COST_LEDGER", "1") != "0"


class CostReconciliationError(AssertionError):
    """A ledger record disagrees with the proxy it must reconcile with.

    Raised loudly (not logged-and-ignored): the closed-form proxies and
    the ledger can never drift apart silently."""


@dataclass(frozen=True)
class ProgramCost:
    """One program's deterministic per-dispatch cost record."""

    program: str            # registry name, e.g. "kavg.train"
    plane: str              # "train" | "serve" | "kernel"
    flops: float            # flop count per dispatch
    hbm_bytes: float        # total bytes accessed per dispatch
    transcendentals: float  # exp/log/tanh… op count per dispatch
    peak_temp_bytes: int    # temp allocation high-water mark
    argument_bytes: int = 0
    output_bytes: int = 0
    source: str = "xla"

    def __post_init__(self):
        if self.plane not in PLANES:
            raise ValueError(f"unknown plane {self.plane!r}")
        if self.source not in SOURCES:
            raise ValueError(f"unknown source {self.source!r}")

    @property
    def arithmetic_intensity(self) -> float:
        """Roofline x-coordinate: flops per HBM byte accessed."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ProgramCost":
        return cls(program=str(d["program"]), plane=str(d["plane"]),
                   flops=float(d["flops"]),
                   hbm_bytes=float(d["hbm_bytes"]),
                   transcendentals=float(d.get("transcendentals", 0.0)),
                   peak_temp_bytes=int(d.get("peak_temp_bytes", 0)),
                   argument_bytes=int(d.get("argument_bytes", 0)),
                   output_bytes=int(d.get("output_bytes", 0)),
                   source=str(d.get("source", "xla")))


def _zero_totals() -> dict:
    return {"dispatches": 0, "flops_total": 0.0, "hbm_bytes_total": 0.0,
            "transcendentals_total": 0.0, "samples": 0, "tokens": 0,
            "recaptures": 0}


class CostLedger:
    """Per-process program registry + dispatch-attributed cost totals.

    Thread-safe: serve engines note dispatches from their loop thread
    while the PS snapshots from HTTP handlers."""

    def __init__(self, capture_enabled: Optional[bool] = None):
        # the reference's switch between XLA capture and the fallback;
        # kept so call sites read alike. It changes nothing here: the
        # port has no compiler analysis, so capture() always installs
        # the fallback (what the reference does with capture off)
        self._lock = threading.Lock()
        self._capture_enabled = capture_enabled
        self._programs: Dict[str, ProgramCost] = {}
        self._totals: Dict[str, dict] = {}

    @property
    def capture_enabled(self) -> bool:
        """The reference's capture decision for this ledger (pinned, or
        KUBEML_COST_LEDGER): informational in the port."""
        return self._capture_enabled \
            if self._capture_enabled is not None else _enabled()

    # ------------------------------------------------------------ capture

    def capture(self, program: str, plane: str, fn, *args,
                fallback: Optional[dict] = None, **kwargs) -> ProgramCost:
        """Record `program`'s per-dispatch cost at its first dispatch
        (`fn` and its arguments keep the reference's signature and are
        not called). The closed-form `fallback` dict ({"flops":,
        "hbm_bytes":, "transcendentals":, ...}) is the record, with
        source="fallback". Re-capturing an already-known program
        replaces the record and bumps `recaptures` so replay checks can
        tell."""
        fb = fallback or {}
        rec = ProgramCost(
            program=program, plane=plane,
            flops=float(fb.get("flops", 0.0)),
            hbm_bytes=float(fb.get("hbm_bytes", 0.0)),
            transcendentals=float(fb.get("transcendentals", 0.0)),
            peak_temp_bytes=int(fb.get("peak_temp_bytes", 0)),
            argument_bytes=int(fb.get("argument_bytes", 0)),
            output_bytes=int(fb.get("output_bytes", 0)),
            source="fallback")
        self._install(rec)
        return rec

    def capture_analytic(self, program: str, plane: str, *,
                         flops: float = 0.0, hbm_bytes: float = 0.0,
                         transcendentals: float = 0.0,
                         peak_temp_bytes: int = 0,
                         argument_bytes: int = 0,
                         output_bytes: int = 0) -> ProgramCost:
        """Record a pure-counter program: exact closed-form host
        arithmetic over shapes (merge wire plans, KV page traffic).
        These reconcile exactly (tol=0) and budget exactly."""
        rec = ProgramCost(program=program, plane=plane, flops=flops,
                          hbm_bytes=hbm_bytes,
                          transcendentals=transcendentals,
                          peak_temp_bytes=peak_temp_bytes,
                          argument_bytes=argument_bytes,
                          output_bytes=output_bytes, source="analytic")
        self._install(rec)
        return rec

    def _install(self, rec: ProgramCost) -> None:
        with self._lock:
            known = rec.program in self._programs
            self._programs[rec.program] = rec
            tot = self._totals.setdefault(rec.program, _zero_totals())
            if known:
                tot["recaptures"] += 1

    # ----------------------------------------------------------- dispatch

    def note_dispatch(self, program: str, n: int = 1, *,
                      samples: int = 0, tokens: int = 0) -> None:
        """Attribute `n` dispatches of `program` (and the samples /
        tokens they produced) at the program's CURRENT per-dispatch
        cost.  Unknown programs accumulate dispatch counts only — the
        record may arrive later."""
        if n <= 0 and samples <= 0 and tokens <= 0:
            return
        with self._lock:
            rec = self._programs.get(program)
            tot = self._totals.setdefault(program, _zero_totals())
            tot["dispatches"] += int(n)
            tot["samples"] += int(samples)
            tot["tokens"] += int(tokens)
            if rec is not None and n > 0:
                tot["flops_total"] += n * rec.flops
                tot["hbm_bytes_total"] += n * rec.hbm_bytes
                tot["transcendentals_total"] += n * rec.transcendentals

    # ------------------------------------------------------------- access

    def programs(self) -> List[str]:
        """Registry of known program names (JitCompileTracker keys its
        per-program recompile windows on these)."""
        with self._lock:
            return sorted(self._programs)

    def record(self, program: str) -> Optional[ProgramCost]:
        with self._lock:
            return self._programs.get(program)

    def totals(self, program: str) -> dict:
        with self._lock:
            return dict(self._totals.get(program, _zero_totals()))

    # -------------------------------------------------------- reconcile

    def reconcile(self, program: str, field: str, expected: float,
                  tolerance: float = 0.0) -> None:
        """Assert a record field against an independent proxy value.
        tol=0.0 → exact equality (pure-counter fields); tol>0 →
        relative |rec - expected| <= tol * max(|expected|, 1).  A miss
        raises CostReconciliationError — loud by design."""
        rec = self.record(program)
        if rec is None:
            raise CostReconciliationError(
                f"cost ledger has no record for {program!r} "
                f"(reconciling {field})")
        got = float(getattr(rec, field))
        expected = float(expected)
        if tolerance <= 0.0:
            ok = got == expected
        else:
            ok = abs(got - expected) <= tolerance * max(abs(expected), 1.0)
        if not ok:
            raise CostReconciliationError(
                f"cost ledger {program}.{field}={got!r} does not "
                f"reconcile with proxy value {expected!r} "
                f"(tolerance {tolerance:g}, source={rec.source})")

    # ------------------------------------------------------ attribution

    def attributed(self) -> dict:
        """Per-plane attributed cost: train flops/sample + bytes/sample
        (lanes already merged into `samples` by the callers), serve
        flops/token + bytes/token."""
        with self._lock:
            planes: Dict[str, dict] = {}
            for name, rec in self._programs.items():
                tot = self._totals.get(name, _zero_totals())
                agg = planes.setdefault(rec.plane, {
                    "flops_total": 0.0, "hbm_bytes_total": 0.0,
                    "dispatches": 0, "samples": 0, "tokens": 0})
                agg["flops_total"] += tot["flops_total"]
                agg["hbm_bytes_total"] += tot["hbm_bytes_total"]
                agg["dispatches"] += tot["dispatches"]
                agg["samples"] += tot["samples"]
                agg["tokens"] += tot["tokens"]
        out = {}
        for plane, agg in planes.items():
            entry = dict(agg)
            if agg["samples"]:
                entry["flops_per_sample"] = agg["flops_total"] / agg["samples"]
                entry["bytes_per_sample"] = (
                    agg["hbm_bytes_total"] / agg["samples"])
            if agg["tokens"]:
                entry["flops_per_token"] = agg["flops_total"] / agg["tokens"]
                entry["bytes_per_token"] = (
                    agg["hbm_bytes_total"] / agg["tokens"])
            out[plane] = entry
        return out

    # --------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """JSON-safe mergeable state: one entry per program carrying
        the record AND the attributed totals. This is what rides the
        MetricUpdate wire, the serve snapshot, and `GET /cost`."""
        with self._lock:
            return {name: {**rec.to_dict(),
                           **self._totals.get(name, _zero_totals())}
                    for name, rec in self._programs.items()}

    def replay_check(self) -> None:
        """Assert the ledger invariant `totals == dispatches x
        per-dispatch cost` for every stable (recapture-free) program."""
        snap = self.snapshot()
        for name, e in snap.items():
            if e["recaptures"]:
                continue
            for total_f, per_f in (("flops_total", "flops"),
                                   ("hbm_bytes_total", "hbm_bytes")):
                want = e["dispatches"] * e[per_f]
                if e[total_f] != want:
                    raise CostReconciliationError(
                        f"cost ledger replay mismatch for {name}: "
                        f"{total_f}={e[total_f]!r} != dispatches "
                        f"({e['dispatches']}) x {per_f} ({e[per_f]!r})")


def merge_cost_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge per-process/per-replica ledger snapshots the way the fleet
    merges serve counters: totals SUM (a busy replica weighs more), the
    per-dispatch record comes from the first snapshot that has one (one
    engine config per fleet, so records agree across replicas)."""
    merged: Dict[str, dict] = {}
    for snap in snaps:
        for name, entry in (snap or {}).items():
            if name not in merged:
                merged[name] = dict(entry)
                continue
            m = merged[name]
            for k in ("dispatches", "samples", "tokens", "recaptures",
                      "flops_total", "hbm_bytes_total",
                      "transcendentals_total"):
                m[k] = m.get(k, 0) + entry.get(k, 0)
    return merged


def attributed_from_snapshot(snap: dict) -> dict:
    """Per-plane attribution over a (possibly merged) snapshot dict —
    the endpoint/CLI-side twin of CostLedger.attributed()."""
    planes: Dict[str, dict] = {}
    for entry in (snap or {}).values():
        agg = planes.setdefault(entry.get("plane", "kernel"), {
            "flops_total": 0.0, "hbm_bytes_total": 0.0,
            "dispatches": 0, "samples": 0, "tokens": 0})
        agg["flops_total"] += float(entry.get("flops_total", 0.0))
        agg["hbm_bytes_total"] += float(entry.get("hbm_bytes_total", 0.0))
        agg["dispatches"] += int(entry.get("dispatches", 0))
        agg["samples"] += int(entry.get("samples", 0))
        agg["tokens"] += int(entry.get("tokens", 0))
    out = {}
    for plane, agg in planes.items():
        entry = dict(agg)
        if agg["samples"]:
            entry["flops_per_sample"] = agg["flops_total"] / agg["samples"]
            entry["bytes_per_sample"] = agg["hbm_bytes_total"] / agg["samples"]
        if agg["tokens"]:
            entry["flops_per_token"] = agg["flops_total"] / agg["tokens"]
            entry["bytes_per_token"] = agg["hbm_bytes_total"] / agg["tokens"]
        out[plane] = entry
    return out


def snapshot_to_json(snap: dict) -> str:
    """Canonical serialization (sorted keys): two processes that
    recorded the same programs produce byte-identical documents."""
    return json.dumps(snap, sort_keys=True)
