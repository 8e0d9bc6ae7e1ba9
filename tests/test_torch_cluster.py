"""Port parity: the cluster allocator of kubeml_tpu_torch (control/
cluster.py, a copy) against the JAX package's, and the port scheduler's
cluster mode against the JAX scheduler's.

- every allocator scenario of the reference's tests/test_cluster.py, as
  an op script under a fake clock, fed to both allocators: equal
  ``Decision`` lists, equal ``snapshot()``s and equal exceptions, op by
  op; each of the five decision paths is asserted by name;
- the scheduler's handlers (never started: they run inline): /finish in
  cluster mode, the seeded backoff, GET /cluster and POST /serve/resize
  with its never-park policy for serving gangs, against a JAX scheduler
  over the same allocator ops;
- the cluster Prometheus families, the queue-starvation rule and the
  ``kubeml top`` cluster pane over the same snapshots;
- a threaded CPU deployment in cluster mode: a serving gang placed by a
  cold start and preempted by a priority-1 arrival (the fleet drains to
  zero and cold-starts again), and a threaded training victim, which has
  no process to drain (503, as in the JAX PS), running to its end before
  the arrival places.

The allocator and scheduler cases run under a fake clock.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

import pytest

pytestmark = pytest.mark.torch_port


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _cluster_mod(pkg: str):
    if pkg == "ref":
        from kubeml_tpu.control import cluster
    else:
        from kubeml_tpu_torch.control import cluster
    return cluster


def _scheduler_mod(pkg: str):
    if pkg == "ref":
        from kubeml_tpu.control import scheduler
    else:
        from kubeml_tpu_torch.control import scheduler
    return scheduler


def _trace_mod(pkg: str):
    if pkg == "ref":
        from kubeml_tpu.utils import trace
    else:
        from kubeml_tpu_torch.utils import trace
    return trace


def _request(pkg: str, path: str, params=None, body=None):
    if pkg == "ref":
        from kubeml_tpu.control.httpd import Request
    else:
        from kubeml_tpu_torch.control.httpd import Request
    return Request(path, params or {}, {}, body, b"")


# ------------------------------------------------------ allocator scripts
#
# An op is ("submit", job, kwargs) | ("release", job) | ("resize", job, n)
# | ("tick", seconds) | ("snap",). Each scenario is one reference test of
# tests/test_cluster.py; "paths" lists the decision paths it must reach.

SCENARIOS = {
    "gang_places_atomically_or_not_at_all": dict(
        pool=4, ops=[("submit", "j1", {"lanes": 3}),
                     ("submit", "j2", {"lanes": 3}), ("snap",),
                     ("release", "j1"), ("snap",)],
        paths={"gang-atomicity"}),
    "wide_gang_holds_the_line_against_backfill": dict(
        pool=6, ops=[("submit", "j1", {"lanes": 2}),
                     ("submit", "j2", {"lanes": 2}), ("tick", 1.0),
                     ("submit", "wide", {"lanes": 5}), ("tick", 1.0),
                     ("submit", "narrow", {"lanes": 2}), ("snap",),
                     ("release", "j1"), ("release", "j2"), ("snap",)],
        paths={"gang-atomicity"}),
    "duplicate_submit_rejected": dict(
        pool=2, ops=[("submit", "j1", {"lanes": 1}),
                     ("submit", "j1", {"lanes": 1}), ("snap",)],
        paths={"gang-atomicity"}),
    "aging_lifts_parked_job_over_sustained_high_priority": dict(
        pool=2, aging_s=10.0,
        ops=[("submit", "hi-0", {"priority": 5, "lanes": 2}),
             ("submit", "low", {"priority": 0, "lanes": 2}), ("tick", 60.0),
             ("submit", "hi-1", {"priority": 5, "lanes": 2}),
             ("release", "hi-0"), ("snap",)],
        paths={"gang-atomicity", "no-starvation"}),
    "without_aging_high_priority_always_wins": dict(
        pool=2, ops=[("submit", "hi-0", {"priority": 5, "lanes": 2}),
                     ("submit", "low", {"priority": 0, "lanes": 2}),
                     ("submit", "hi-1", {"priority": 5, "lanes": 2}),
                     ("tick", 3600.0), ("release", "hi-0"), ("snap",)],
        paths={"gang-atomicity"}),
    "quota_clamps_gang_and_blocks_tenant_at_cap": dict(
        pool=8, quotas={"teamA": 2},
        ops=[("submit", "a1", {"tenant": "teamA", "lanes": 4}),
             ("submit", "a2", {"tenant": "teamA", "lanes": 2}), ("snap",)],
        paths={"quota-clamp"}),
    "over_quota_tenant_clamped_before_under_quota_held_back": dict(
        pool=8, quotas={"teamA": 2},
        ops=[("submit", "a1", {"tenant": "teamA", "lanes": 2}),
             ("submit", "a2", {"tenant": "teamA", "lanes": 2}),
             ("submit", "b1", {"tenant": "teamB", "lanes": 4}), ("snap",),
             ("release", "a1"), ("snap",)],
        paths={"gang-atomicity"}),
    "weighted_fair_deficit_breaks_ties_toward_heavier_tenant": dict(
        pool=2, weights={"heavy": 3.0, "light": 1.0},
        ops=[("submit", "running", {"lanes": 2}), ("tick", 1.0),
             ("submit", "light-1", {"tenant": "light", "lanes": 2}),
             ("tick", 1.0),
             ("submit", "heavy-1", {"tenant": "heavy", "lanes": 2}),
             ("release", "running"), ("snap",)],
        paths={"gang-atomicity"}),
    "preempts_cheapest_victim_only_for_strictly_higher_priority": dict(
        pool=4, ops=[("submit", "v-big", {"priority": 0, "lanes": 3}),
                     ("submit", "v-small", {"priority": 0, "lanes": 1}),
                     ("submit", "peer", {"priority": 0, "lanes": 1}),
                     ("release", "peer"),
                     ("submit", "hi", {"priority": 2, "lanes": 1}),
                     ("release", "v-small"), ("snap",)],
        paths={"gang-atomicity", "preempt-cheapest"}),
    "preemption_selects_multiple_victims_but_never_overshoots": dict(
        pool=4, ops=[("submit", "v1", {"priority": 0, "lanes": 2}),
                     ("submit", "v2", {"priority": 0, "lanes": 2}),
                     ("submit", "hi", {"priority": 1, "lanes": 4}),
                     ("submit", "hi2", {"priority": 1, "lanes": 2}),
                     ("snap",)],
        paths={"gang-atomicity", "preempt-cheapest"}),
    "no_preemption_when_even_all_victims_would_not_fit": dict(
        pool=4, ops=[("submit", "v1", {"priority": 0, "lanes": 1}),
                     ("submit", "keep", {"priority": 9, "lanes": 3}),
                     ("submit", "hi", {"priority": 1, "lanes": 3}),
                     ("snap",)],
        paths={"gang-atomicity"}),
    "resize_grow_clamped_by_quota": dict(
        pool=8, quotas={"teamA": 3},
        ops=[("submit", "a1", {"tenant": "teamA", "lanes": 2}),
             ("resize", "a1", 6), ("snap",)],
        paths={"gang-atomicity", "quota-clamp"}),
    "resize_grow_clamped_by_parked_work": dict(
        pool=4, ops=[("submit", "j1", {"lanes": 2}),
                     ("submit", "wide", {"lanes": 4}),
                     ("resize", "j1", 4), ("snap",)],
        paths={"gang-atomicity"}),
    "resize_shrink_frees_lanes_and_grants_parked_work": dict(
        pool=4, ops=[("submit", "j1", {"lanes": 4}),
                     ("submit", "waiting", {"lanes": 2}),
                     ("resize", "j1", 2), ("snap",)],
        paths={"gang-atomicity"}),
    "resize_of_unmanaged_job_passes_through": dict(
        pool=4, ops=[("resize", "ghost", 3), ("snap",)], paths=set()),
    "snapshot_shape_and_counters": dict(
        pool=4, weights={"t1": 2.0}, quotas={"t1": 2},
        ops=[("submit", "j1", {"tenant": "t1", "lanes": 2}), ("tick", 5.0),
             ("submit", "j2", {"tenant": "t2", "priority": 3, "lanes": 4}),
             ("snap",), ("tick", 7.0), ("snap",)],
        paths={"gang-atomicity", "preempt-cheapest"}),
    "serving_gang_grows_and_shrinks_elastically": dict(
        pool=4, ops=[("submit", "serve:m", {"lanes": 1, "kind": "serving"}),
                     ("resize", "serve:m", 2), ("submit", "t1", {"lanes": 2}),
                     ("resize", "serve:m", 3), ("resize", "serve:m", 1),
                     ("snap",), ("release", "serve:m"), ("snap",)],
        paths={"gang-atomicity", "serve-elastic"}),
    "training_arrival_preempts_a_serving_gang": dict(
        pool=4, ops=[("submit", "t1", {"lanes": 2, "tenant": "batch"}),
                     ("submit", "serve:m", {"lanes": 2, "kind": "serving"}),
                     ("submit", "hi", {"priority": 1, "lanes": 2,
                                       "tenant": "batch"}),
                     ("release", "serve:m"), ("snap",)],
        paths={"gang-atomicity", "preempt-cheapest"}),
}


def _run_script(pkg: str, sc: dict) -> list:
    """Every op's outcome, in order: decision dicts, snapshots, or the
    exception's type name."""
    cluster = _cluster_mod(pkg)
    clock = FakeClock()
    alloc = cluster.ClusterAllocator(sc["pool"],
                                     tenant_weights=sc.get("weights"),
                                     tenant_quotas=sc.get("quotas"),
                                     clock=clock,
                                     aging_s=sc.get("aging_s", 0.0))
    out = []
    for op in sc["ops"]:
        try:
            if op[0] == "submit":
                got = alloc.submit(op[1], **op[2])
            elif op[0] == "release":
                got = alloc.release(op[1])
            elif op[0] == "resize":
                got = alloc.resize(op[1], op[2])
            elif op[0] == "tick":
                clock.advance(op[1])
                continue
            else:
                out.append(alloc.snapshot())
                continue
            out.append([dataclasses.asdict(d) for d in got])
        except ValueError as e:
            out.append(type(e).__name__)
    return out


def _paths(outcomes: list) -> set:
    return {d["path"] for o in outcomes if isinstance(o, list)
            for d in o if d["path"]}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocator_scenario_equals_the_references(name):
    sc = SCENARIOS[name]
    port = _run_script("port", sc)
    ref = _run_script("ref", sc)
    assert port == ref
    assert _paths(port) == sc["paths"]


def test_every_decision_path_is_driven_by_name():
    from kubeml_tpu.control.cluster import DECISION_PATHS as REF_PATHS
    from kubeml_tpu_torch.control.cluster import DECISION_PATHS

    assert DECISION_PATHS == REF_PATHS
    seen = set()
    for sc in SCENARIOS.values():
        seen |= _paths(_run_script("port", sc))
    assert "gang-atomicity" in seen
    assert "no-starvation" in seen
    assert "quota-clamp" in seen
    assert "preempt-cheapest" in seen
    assert "serve-elastic" in seen
    assert seen == set(DECISION_PATHS)


def test_named_decisions_carry_the_references_details():
    """Spot checks of the scripts above, on the port alone: the wide gang
    places whole, the cheapest victim is the one-lane job, aging names
    its effective priority."""
    out = _run_script("port",
                      SCENARIOS["wide_gang_holds_the_line_against_backfill"])
    assert [(d["job_id"], d["lanes"]) for d in out[-2]
            if d["action"] == "place"] == [("wide", 5)]
    out = _run_script("port", SCENARIOS[
        "preempts_cheapest_victim_only_for_strictly_higher_priority"])
    (pre,) = [d for d in out[4] if d["action"] == "preempt"]
    assert (pre["victim"], pre["path"]) == ("v-small", "preempt-cheapest")
    out = _run_script("port", SCENARIOS[
        "aging_lifts_parked_job_over_sustained_high_priority"])
    (place,) = [d for d in out[3] if d["action"] == "place"]
    assert (place["job_id"], place["path"]) == ("low", "no-starvation")
    assert "effective priority 6" in place["detail"]
    assert out[-1]["cluster_aged_grants_total"] == 1


@pytest.mark.parametrize("spec", ["prod=3:6", "batch=1", "noweight", "x=",
                                  "x=0", "x=1:0", " a = 2.5 :3"])
def test_parse_tenant_spec_equals_the_references(spec):
    outs = []
    for pkg in ("port", "ref"):
        try:
            outs.append(_cluster_mod(pkg).parse_tenant_spec(spec))
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


def test_bad_pool_is_refused_alike():
    for pkg in ("port", "ref"):
        with pytest.raises(ValueError, match="at least one lane"):
            _cluster_mod(pkg).ClusterAllocator(0)


# ------------------------------------------------------------- scheduler

def _task(pkg: str, job_id: str):
    if pkg == "ref":
        from kubeml_tpu.api.types import TrainOptions, TrainRequest, TrainTask
    else:
        from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                                TrainTask)
    req = TrainRequest(model_type="mlp", batch_size=16, epochs=1,
                       dataset="blobs", lr=0.1,
                       options=TrainOptions(default_parallelism=2))
    return TrainTask(job_id=job_id, parameters=req)


def _finish(pkg, sched, job_id):
    return sched._h_finish(_request(pkg, f"/finish/{job_id}",
                                    {"taskId": job_id}))


def test_finish_drops_defer_state_and_parked_deferred_task(tmp_home):
    for pkg in ("port", "ref"):
        sched = _scheduler_mod(pkg).Scheduler(ps_url=None)
        task = _task(pkg, "deadbeef")
        sched._defer_counts[task.job_id] = 3
        sched._deferred.append((time.monotonic() + 3600.0, task))
        sched._deferred.append((time.monotonic() + 3600.0,
                                _task(pkg, "other001")))
        assert _finish(pkg, sched, task.job_id) == {"ok": True}
        assert task.job_id not in sched._defer_counts
        assert [t.job_id for _nb, t in sched._deferred] == ["other001"]


def test_finish_in_cluster_mode_releases_parked_lanes(tmp_home):
    snaps = []
    for pkg in ("port", "ref"):
        alloc = _cluster_mod(pkg).ClusterAllocator(4, clock=FakeClock(),
                                                   aging_s=0.0)
        sched = _scheduler_mod(pkg).Scheduler(ps_url=None, allocator=alloc)
        alloc.submit("gone0001", lanes=4)
        alloc.submit("next0002", lanes=2)
        sched._parked["gone0001"] = _task(pkg, "gone0001")
        sched._parked["next0002"] = _task(pkg, "next0002")
        _finish(pkg, sched, "gone0001")
        assert list(sched._parked) == []
        # the freed lanes granted the parked job, re-pushed to the queue
        assert sched._granted == {"next0002": (2, 1)}
        assert sched.queue.pop(timeout=0).job_id == "next0002"
        snaps.append(alloc.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["cluster_lanes_in_use"] == 2


def test_defer_delay_is_deterministic_with_seeded_rng():
    seqs = []
    for pkg in ("port", "ref"):
        mod = _scheduler_mod(pkg)
        a = mod.Scheduler(ps_url=None, rng=random.Random(7))
        seqs.append([a._defer_delay(n) for n in range(8)])
        for n, delay in enumerate(seqs[-1]):
            base = min(mod.DEFER_CAP_S, mod.DEFER_BASE_S * (2 ** n))
            assert 0.75 * base <= delay <= 1.25 * base
    assert seqs[0] == seqs[1]


def test_scheduler_cluster_endpoint_equals_the_references():
    outs = []
    for pkg in ("port", "ref"):
        alloc = _cluster_mod(pkg).ClusterAllocator(2, clock=FakeClock(3.0))
        alloc.submit("j1", lanes=1)
        sched = _scheduler_mod(pkg).Scheduler(ps_url=None, allocator=alloc)
        outs.append(sched._h_cluster(_request(pkg, "/cluster")))
        bare = _scheduler_mod(pkg).Scheduler(ps_url=None)
        with pytest.raises(Exception) as ei:
            bare._h_cluster(_request(pkg, "/cluster"))
        assert ei.value.status_code == 503
    assert outs[0] == outs[1]
    assert outs[0]["cluster_pool_lanes"] == 2


SERVE_RESIZE = [
    # (body, what the script does first)
    ({"model_id": "m", "replicas": 1}, []),
    ({"model_id": "m", "replicas": 3}, [("submit", "t1", 2)]),
    ({"model_id": "m", "replicas": 2, "lanes_per_replica": 2}, []),
    ({"model_id": "m", "replicas": 0}, [("serve", 2)]),
    ({"model_id": "m", "replicas": 4}, [("serve", 1)]),
    ({"model_id": "m", "replicas": 2, "priority": 1},
     [("submit", "t1", 4)]),
    ({"model": "m", "replicas": 1, "tenant": "prod"}, []),
]


@pytest.mark.parametrize("body,before", SERVE_RESIZE,
                         ids=[f"#{i}" for i in range(len(SERVE_RESIZE))])
def test_serve_resize_equals_the_references(tmp_home, body, before):
    """POST /serve/resize: a serving gang places, resizes, drains to zero
    and never parks (a fleet that cannot grow now is granted 0 and its
    reservation is given back); the answer, the allocator's snapshot and
    the gang's lanes equal the JAX scheduler's."""
    outs = []
    for pkg in ("port", "ref"):
        alloc = _cluster_mod(pkg).ClusterAllocator(4, clock=FakeClock(),
                                                   aging_s=0.0)
        sched = _scheduler_mod(pkg).Scheduler(ps_url=None, allocator=alloc)
        for op in before:
            if op[0] == "submit":
                alloc.submit(op[1], lanes=op[2])
            else:
                sched._h_serve_resize(_request(
                    pkg, "/serve/resize", body={"model_id": "m",
                                                "replicas": op[1]}))
        got = sched._h_serve_resize(_request(pkg, "/serve/resize",
                                             body=dict(body)))
        outs.append((got, alloc.snapshot(), alloc.pending_jobs()))
    assert outs[0] == outs[1]
    assert outs[0][2] == []            # a serving gang never parks


def test_serve_resize_is_serve_elastic_and_fails_open_without_pool(tmp_home):
    from kubeml_tpu_torch.control.scheduler import Scheduler
    from kubeml_tpu_torch.control.cluster import ClusterAllocator

    alloc = ClusterAllocator(4, clock=FakeClock(), aging_s=0.0)
    sched = Scheduler(ps_url=None, allocator=alloc)
    for n in (1, 3):
        sched._h_serve_resize(_request("port", "/serve/resize",
                                       body={"model_id": "m",
                                             "replicas": n}))
    d = alloc.resize("serve:m", 2)[0]
    assert d.path == "serve-elastic"
    assert alloc.snapshot()["cluster_serving_lanes"] == 2
    bare = Scheduler(ps_url=None)
    assert bare._h_serve_resize(_request(
        "port", "/serve/resize", body={"model_id": "m", "replicas": 5})) \
        == {"granted": 5}


def test_schedule_cluster_parks_then_dispatches_the_grant(tmp_home):
    """The scheduling loop's cluster pass: a fresh arrival the pool
    cannot hold parks (trace instants cluster_queue), and the release
    that frees its lanes pushes it back with its gang width and epoch —
    the same state as the JAX scheduler's after the same calls."""
    states = []
    for pkg in ("port", "ref"):
        alloc = _cluster_mod(pkg).ClusterAllocator(4, clock=FakeClock(),
                                                   aging_s=0.0)
        sched = _scheduler_mod(pkg).Scheduler(ps_url=None, allocator=alloc)
        t1, t2 = _task(pkg, "aaaa0001"), _task(pkg, "bbbb0002")
        t2.parameters.options.default_parallelism = 3
        sched._schedule(t1)            # places: 2 lanes, re-pushed
        sched._schedule(sched.queue.pop(timeout=0))   # dispatch (no PS)
        sched._schedule(t2)            # parks: 3 > 2 free
        parked = sorted(sched._parked)
        _finish(pkg, sched, "aaaa0001")
        regrant = sched.queue.pop(timeout=0)
        trace = _trace_mod(pkg).merge_job_trace("bbbb0002")
        instants = [(e["name"], e["args"]["lanes"], e["args"]["path"])
                    for e in trace["traceEvents"]
                    if e["name"].startswith("cluster_")]
        states.append((parked, regrant.job_id, dict(sched._granted),
                       alloc.snapshot(), instants))
    assert states[0] == states[1]
    assert states[0][4] == [("cluster_queue", 3, ""),
                            ("cluster_place", 3, "gang-atomicity")]
    assert states[0][0] == ["bbbb0002"]
    assert states[0][2] == {"bbbb0002": (3, 1)}


# ------------------------------------------------- telemetry plumbing

def _flatten(text: str) -> dict:
    from tools.check_metrics import parse_exposition

    return {(n, tuple(sorted(lab.items()))): v
            for f in parse_exposition(text).values()
            for n, lab, v in f["samples"]}


def _cluster_text(pkg: str, snaps) -> str:
    if pkg == "ref":
        from kubeml_tpu.metrics.prom import MetricsRegistry
    else:
        from kubeml_tpu_torch.metrics.prom import MetricsRegistry
    reg = MetricsRegistry()
    for s in snaps:
        reg.update_cluster(dict(s))
    return "\n".join(f.collect() for f in reg._cluster_gauges
                     + reg._cluster_counters
                     + [reg.control_recovery_seconds])


def test_cluster_metrics_families_equal_the_references():
    from tools.check_metrics import validate_exposition

    from kubeml_tpu_torch.control.cluster import ClusterAllocator
    from kubeml_tpu_torch.metrics.prom import MetricsRegistry

    alloc = ClusterAllocator(4, tenant_quotas={"t1": 2}, clock=FakeClock(),
                             aging_s=0.0)
    alloc.submit("j1", tenant="t1", lanes=2)
    alloc.submit("j2", tenant="t1", priority=2, lanes=2)   # at quota
    first = alloc.snapshot()
    alloc.release("j1")
    second = alloc.snapshot()
    snaps = [first, second, second]                        # a replay
    text = _cluster_text("port", snaps)
    assert text == _cluster_text("ref", snaps)
    reg = MetricsRegistry()
    for s in snaps:
        reg.update_cluster(dict(s))
    assert validate_exposition(reg.exposition()) == []
    samples = _flatten(reg.exposition())
    assert samples[("kubeml_cluster_pool_lanes", (("pool", "shared"),))] \
        == 4.0
    assert samples[("kubeml_cluster_queue_depth",
                    (("priority", "2"),))] == 0.0
    assert samples[("kubeml_cluster_gang_placements_total",
                    (("pool", "shared"),))] == 2.0
    assert samples[("kubeml_cluster_tenant_share",
                    (("tenant", "t1"),))] == 0.5


def test_queue_starvation_rule_fires_alike():
    from kubeml_tpu.control.health import HealthEvaluator as RefEval
    from kubeml_tpu.control.health import default_rules as ref_rules
    from kubeml_tpu_torch.control.health import (HealthEvaluator,
                                                 default_rules)

    verdicts = []
    for ev in (HealthEvaluator(clock=FakeClock(1000.0),
                               rules=default_rules(queue_starvation_s=30.0)),
               RefEval(clock=FakeClock(1000.0),
                       rules=ref_rules(queue_starvation_s=30.0))):
        snap = {"job_id": "cluster", "cluster_pool_lanes": 4,
                "cluster_lanes_in_use": 4, "cluster_queue_depth": 1,
                "cluster_oldest_wait_s": 10.0}
        assert ev.observe(dict(snap)) == []
        fired = ev.observe(dict(snap, cluster_oldest_wait_s=45.0))
        assert [r["rule"] for r in fired] == ["queue_starvation"]
        verdicts.append(ev.verdict("cluster"))
        ev.observe(dict(snap, cluster_queue_depth=0,
                        cluster_oldest_wait_s=0.0))
        assert ev.verdict("cluster")["state"] == "healthy"
    assert verdicts[0] == verdicts[1]
    assert verdicts[0]["state"] == "warning"


def test_top_renders_a_live_allocator_snapshot_alike():
    from kubeml_tpu.cli.main import _render_top as ref_render
    from kubeml_tpu_torch.cli.main import _render_top
    from kubeml_tpu_torch.control.cluster import ClusterAllocator

    clock = FakeClock()
    alloc = ClusterAllocator(8, tenant_weights={"prod": 3.0},
                             tenant_quotas={"prod": 6}, clock=clock)
    alloc.submit("p1", tenant="prod", lanes=4)
    alloc.submit("b1", tenant="batch", lanes=2)
    alloc.submit("b2", tenant="batch", lanes=4)
    clock.advance(45.0)
    doc = {"id": "cluster", "state": "healthy", "reasons": [],
           "latest": alloc.snapshot()}
    out = _render_top(doc)
    assert out == ref_render(doc)
    assert "cluster: lanes 6/8 (75%)" in out
    assert "queue by priority: p0:1" in out


# -------------------------------------- a cluster-mode deployment (CPU)

def _blobs(tmp_path):
    import numpy as np

    rng = np.random.default_rng(0)
    paths = []
    for name, n in (("xtr", 128), ("ytr", 128), ("xte", 32), ("yte", 32)):
        arr = (rng.normal(size=(n, 8)).astype(np.float32) if name[0] == "x"
               else rng.integers(0, 3, n).astype(np.int32))
        paths.append(str(tmp_path / f"{name}.npy"))
        np.save(paths[-1], arr)
    return paths


def _job(client, epochs, n, priority=0, tenant=""):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return client.networks().train(TrainRequest(
        model_type="mlp", batch_size=32, epochs=epochs, dataset="blobs",
        lr=0.1, priority=priority, tenant=tenant,
        options=TrainOptions(default_parallelism=n, k=2,
                             static_parallelism=True)))


def _poll(pred, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_a_priority_arrival_waits_out_a_training_victim(tmp_path, tmp_home,
                                                        monkeypatch):
    """The allocator picks a training victim that runs as a thread of
    the PS: with no process of its own to drain, the PS answers the
    preempt 503, as the JAX PS does, and the victim runs to its end
    unpreempted: the arrival places only then, and the pool never holds
    more lanes than it has. (A standalone victim's drain, requeue and
    resume are held in tests/test_torch_elastic.py.)

    Each job's first round waits in a round hook until the test opens
    its gate: the victim's once the arrival is queued in /cluster (its
    submit decided the preemption in the same step), so the victim never
    finishes before the arrival exists; the arrival's once the test has
    seen its gang placed, so the arrival never finishes unseen."""
    from kubeml_tpu_torch.control import ps as ps_mod
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json

    entered, gates = {}, {}

    def gated_job(task, *a, **kw):
        came = entered.setdefault(task.job_id, threading.Event())
        gate = gates.setdefault(task.job_id, threading.Event())

        def hold(rb):
            came.set()
            gate.wait(240)
            return rb
        return real_job(task, *a, round_hook=hold, **kw)

    def cluster():
        return http_json("GET", f"{dep.controller_url}/cluster")

    real_job = ps_mod.TrainJob
    monkeypatch.setattr(ps_mod, "TrainJob", gated_job)
    dep = start_deployment(device="cpu", cluster_lanes=2)
    try:
        client = KubemlClient(dep.controller_url).v1()
        client.datasets().create("blobs", *_blobs(tmp_path))
        victim = _job(client, 40, 2)
        assert entered.setdefault(victim, threading.Event()).wait(120), \
            "the victim never reached its first round"
        arrival = _job(client, 1, 2, priority=1)
        _poll(lambda: cluster()["cluster_queue_by_priority"] == {"1": 1},
              "the arrival's queueing")
        gates.setdefault(victim, threading.Event()).set()
        seen = []

        def placed():
            snap = cluster()
            seen.append(snap["cluster_lanes_in_use"])
            return arrival in {g["job_id"]
                               for g in snap["cluster_running_gangs"]}
        _poll(placed, "the arrival's gang", 240)
        assert victim not in dep.ps.jobs      # it ran to its end first
        gates.setdefault(arrival, threading.Event()).set()
        assert dep.ps.wait_for_job(arrival, timeout=120)
        snap = cluster()
        assert snap["cluster_preemptions_total"] == 1
        assert snap["cluster_gang_placements_total"] == 2
        assert max(seen) <= 2
        hist = client.histories().get(victim).data
        assert len(hist.train_loss) == 40     # not cut short
        assert (hist.restarts, hist.preemptions) == (0, 0)
    finally:
        for gate in list(gates.values()):
            gate.set()
        dep.stop()


def test_a_priority_arrival_preempts_a_serving_gang(tmp_path, tmp_home):
    """serve-elastic through a deployment: the first /generate of a fleet
    with no replica floor places a serving gang through /serve/resize; a
    priority-1 arrival that needs every lane preempts it, the fleet
    drains to zero, the arrival places, and the next /generate
    cold-starts with the same tokens."""
    import json
    import urllib.request

    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint("gangnano", {"params": random_flax_params(
        vocab_size=512, max_len=64, hidden=32, layers=2, heads=2, ffn=64,
        seed=9)}, {"model": "gpt-nano", "function": "gpt-nano",
                   "parallelism": 1, "epoch": 0})
    dep = start_deployment(device="cpu", cluster_lanes=2, serve_slots=2,
                           serve_replicas_min=0)

    def generate():
        req = urllib.request.Request(
            f"{dep.ps.url}/generate", method="POST",
            data=json.dumps({"model_id": "gangnano", "prompt": [3, 1, 4],
                             "max_new_tokens": 4,
                             "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["tokens"]

    def cluster():
        return http_json("GET", f"{dep.controller_url}/cluster")
    try:
        client = KubemlClient(dep.controller_url).v1()
        client.datasets().create("blobs", *_blobs(tmp_path))
        before = generate()
        gangs = {g["job_id"]: g for g in cluster()["cluster_running_gangs"]}
        assert gangs["serve:gangnano"]["kind"] == "serving"
        arrival = _job(client, 1, 2, priority=1)
        _poll(lambda: arrival in {g["job_id"] for g in
                                  cluster()["cluster_running_gangs"]},
              "the arrival's gang")
        snap = cluster()
        assert snap["cluster_preemptions_total"] == 1
        assert snap["cluster_serving_jobs"] == 0
        fleet = dep.ps._serve["gangnano"][1]
        _poll(lambda: fleet.replica_count == 0, "the fleet to drain")
        assert generate() == before           # a cold start, same tokens
        assert fleet.cold_starts_total == 2
        assert dep.ps.wait_for_job(arrival, timeout=120)
    finally:
        dep.stop()
