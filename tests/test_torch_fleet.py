"""Port parity: the serving fleet (router, autoscaler, supervisor) against
the JAX package's (twin of tests/test_fleet.py and
tests/test_fleet_faults.py).

Each scenario runs once through the JAX fleet and once through the
port's, over gpt-nano replicas (2 slots, pages of 4 tokens, float32),
with the same requests, the same fault plans and one fake clock for the
autoscaler; tests then compare the two records exactly:

  * routing — the replica index and path of every request (consistent
    hash over the first page's digest, session stickiness), and the
    greedy tokens;
  * shed — the surfaced 429's Retry-After (the fleet minimum over the
    replicas' prefill backlogs) and the router's retry count;
  * autoscale — the actions of successive ticks under the fake clock
    (burn-rate grow, idle shrink, scale to zero, cold start) and the
    SLO fields of the merged snapshot;
  * supervise — a crashed replica's ejection, the migration of its
    streams (same tokens), probation and rejoin; a crash-looping
    replica's ejection;
  * telemetry — the Prometheus serve and fleet text and the health
    verdicts over the same snapshots.

The ticks are driven by hand (autoscale_interval_s=0), never by sleeps.
"""

import time

import pytest
import torch

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)
PAGE = 4
# a slow step on every replica keeps streams in flight long enough for a
# kill to land on live work and for a held stream to hold its slot
SLOW = [{"kind": "serve_slow_step", "duration_s": 0.02}]
# the crashed replica's streams: 16 tokens at >= 20 ms a step keep all
# three in flight for a third of a second after the kill is armed
FAILOVER_TOKENS = 16
# a TTFT objective every request meets, so the SLO classification does
# not depend on how long a JAX engine's first compile took
LENIENT = 600.0


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Pkg:
    """One package's serving classes and the shared gpt-nano weights."""

    def __init__(self, key, params):
        self.key = key
        if key == "ref":
            import jax.numpy as jnp

            from kubeml_tpu import faults
            from kubeml_tpu.models.gpt import GPTModule
            from kubeml_tpu.serve import fleet, slots
            from kubeml_tpu.serve.engine import DecodeEngine
            from kubeml_tpu.serve.service import ServeService
            module = GPTModule(**NANO, dropout=0.0, dtype=jnp.float32)

            def engine(**kw):
                return DecodeEngine(module, {"params": params}, **kw)
        else:
            from kubeml_tpu_torch import faults
            from kubeml_tpu_torch.convert import params_from_flax
            from kubeml_tpu_torch.models.gpt import GPTModule
            from kubeml_tpu_torch.serve import fleet, slots
            from kubeml_tpu_torch.serve.engine import DecodeEngine
            from kubeml_tpu_torch.serve.service import ServeService
            module = GPTModule(**NANO, dtype=torch.float32, device="cpu")
            module.load_state_dict(params_from_flax(params))

            def engine(**kw):
                return DecodeEngine(module, device="cpu", **kw)
        self.faults, self.fleet_mod, self.slots = faults, fleet, slots
        self.engine, self.service = engine, ServeService

    def fleet(self, *, slots=2, max_queue=2, plan=None, **kw):
        """A ServeFleet whose replicas each get a fresh copy of the serve
        fault plan ``plan``."""
        def make(index):
            fp = None if plan is None else self.faults.ServeFaultPlan.parse(
                plan)
            eng = self.engine(slots=slots, page=PAGE, fault_plan=fp)
            return self.service("fleet-m", eng, max_queue=max_queue,
                                supervise=False)
        kw.setdefault("autoscale_interval_s", 0.0)
        kw.setdefault("page_tokens", PAGE)
        return self.fleet_mod.ServeFleet("fleet-m", make, **kw)


def _wait(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _quiesce(fleet):
    assert _wait(lambda: not any(s.inflight for s in fleet.replicas()))


def _owned_prompts(fleet, owner, count, n_tokens=5):
    """Prompts whose routing digest lands on replica ``owner``."""
    from kubeml_tpu_torch.serve.pager import routing_digest

    out = []
    for base in range(3, 4000):
        p = [(base + j) % 97 + 1 for j in range(n_tokens)]
        with fleet._lock:
            if fleet._ring_owner(routing_digest(p, PAGE)) == owner:
                out.append(p)
        if len(out) == count:
            return out
    raise AssertionError(f"no {count} prompts owned by {owner}")


SNAP_COUNTS = ("serve_slot_cap", "serve_queue_cap", "serve_rejected_total",
               "serve_prefix_hit_pct", "serve_weight_generation",
               "serve_engine_restarts", "serve_poisoned_total",
               "serve_slo_target", "serve_slo_attainment",
               "serve_slo_burn_fast", "serve_slo_burn_slow",
               "serve_slo_good_total", "serve_slo_bad_total",
               "serve_slo_alerts_total", "fleet_replicas",
               "fleet_replicas_min", "fleet_replicas_max", "fleet_draining",
               "fleet_cold_starts_total", "fleet_spills_total",
               "fleet_router_retries_total", "fleet_grows_total",
               "fleet_shrinks_total", "fleet_scale_to_zero_total",
               "fleet_probation", "fleet_ejections_total",
               "fleet_failovers_total", "fleet_migrated_streams_total",
               "fleet_probes_total", "fleet_hedges_total")


def _counts(snap):
    return {k: snap[k] for k in SNAP_COUNTS}


# ----------------------------------------------------------------- scenarios

# three prompts with one first page, then two owned by each replica
SHARED = [[5, 6, 7, 8, 9], [5, 6, 7, 8, 10, 11], [5, 6, 7, 8, 9]]


def _routing(pkg):
    """Sequential requests through a two-replica fleet, then a session
    pinned to the other replica and a fresh session."""
    fleet = pkg.fleet(replicas_min=2, replicas_max=2, slo_ttft_s=LENIENT)
    fleet.start()
    try:
        prompts = SHARED + _owned_prompts(fleet, 0, 2) \
            + _owned_prompts(fleet, 1, 2)
        out = []
        for p in prompts:
            r = fleet.submit(p, max_new_tokens=4)
            assert r.wait(120) and r.outcome == "ok"
            out.append((r.fleet_replica, r.tokens))
        other = 1 - out[0][0]
        fleet._sessions["s1"] = other
        r = fleet.submit(SHARED[0], max_new_tokens=4, session="s1")
        r2 = fleet.submit(prompts[3], max_new_tokens=4, session="s2")
        assert r.wait(120) and r2.wait(120)
        sessions = (r.fleet_replica, r.tokens, r2.fleet_replica,
                    dict(fleet._sessions))
        _quiesce(fleet)
        return {"routed": out, "sessions": sessions,
                "paths": dict(fleet.path_counts),
                "snap": _counts(fleet.snapshot())}
    finally:
        fleet.stop(grace_s=0.0)


def _shed(pkg):
    """Both replicas full (1 slot + 1 queued each), held by slow
    streams: replica 0 owes a 40-token prompt, replica 1 a 3-token one.
    The surfaced shed carries the fleet minimum."""
    fleet = pkg.fleet(replicas_min=2, replicas_max=2, slots=1, max_queue=1,
                      plan=SLOW)
    fleet.start()
    try:
        held = [fleet._replicas[0].submit([9], max_new_tokens=60),
                fleet._replicas[0].submit(list(range(1, 41)),
                                          max_new_tokens=8),
                fleet._replicas[1].submit([5], max_new_tokens=60),
                fleet._replicas[1].submit([5, 6, 7], max_new_tokens=8)]
        with pytest.raises(pkg.slots.ServeSaturated) as ei:
            fleet.submit([5, 6, 7, 8, 9], max_new_tokens=4)
        assert all(r.outcome is None for r in held)
        return {"retry_after_s": ei.value.retry_after_s,
                "status": ei.value.status_code,
                "message": ei.value.message,
                "retries": fleet.router_retries_total,
                "estimates": [s.estimated_retry_after_s()
                              for s in fleet.replicas()]}
    finally:
        fleet.stop(grace_s=0.0)


def _autoscale(pkg):
    """Cold start from zero, an SLO-bad request, then ticks under the
    fake clock: burn grow, hold, idle shrink, scale to zero, cold start
    again."""
    clock = FakeClock()
    fleet = pkg.fleet(replicas_min=0, replicas_max=2, scale_to_zero_s=5.0,
                      slo_ttft_s=1e-9, clock=clock)
    fleet.start()
    snaps = []
    try:
        assert fleet.replica_count == 0
        r = fleet.submit([5, 6, 7, 8], max_new_tokens=3)
        assert r.wait(120) and r.outcome == "ok"
        _quiesce(fleet)
        actions = []
        for _ in range(6):
            actions.append(fleet.autoscale_once(now=clock()))
            snaps.append(fleet.snapshot())
        clock.advance(10.0)
        actions.append(fleet.autoscale_once(now=clock()))
        snaps.append(fleet.snapshot())
        r2 = fleet.submit([5, 6, 7, 8], max_new_tokens=3)
        assert r2.wait(120) and r2.outcome == "ok"
        _quiesce(fleet)
        snaps.append(fleet.snapshot())
        return {"actions": actions, "tokens": [r.tokens, r2.tokens],
                "decisions": [d["action"] for d in fleet.decisions],
                "paths": dict(fleet.path_counts),
                "snaps": [_counts(s) for s in snaps], "raw": snaps}
    finally:
        fleet.stop(grace_s=0.0)


def _failover(pkg):
    """A fleet_replica_crash on replica 0 with three of its streams in
    flight: eject, migrate, probation, a probe, rejoin."""
    fleet = pkg.fleet(replicas_min=2, replicas_max=2, probe_requests=1,
                      slots=2, max_queue=4, plan=SLOW, slo_ttft_s=LENIENT,
                      fault_plan=[{"kind": "fleet_replica_crash",
                                   "replica": 0}])
    fleet.start()
    try:
        # warm both replicas first (the JAX engines compile on their
        # first step), so the kill lands on decoding streams
        for idx in (0, 1):
            w = fleet._replicas[idx].submit([3, 4], max_new_tokens=2)
            assert w.wait(120) and w.outcome == "ok"
        _quiesce(fleet)
        victim = fleet._replicas[0]
        prompts = _owned_prompts(fleet, 0, 3)
        reqs = [fleet.submit(p, max_new_tokens=FAILOVER_TOKENS)
                for p in prompts]
        homes = [r.fleet_replica for r in reqs]
        assert _wait(lambda: victim.engine.active() >= 1)
        first = fleet.supervise_once(now=1.0)
        for r in reqs:
            assert r.wait(120)
        streams = [(r.outcome, r.tokens, r.migrations, r.fleet_replica)
                   for r in reqs]
        _quiesce(fleet)
        after_eject = _counts(fleet.snapshot())
        probe = fleet.submit(prompts[0], max_new_tokens=4)
        assert probe.wait(120) and probe.outcome == "ok"
        probe_home = probe.fleet_replica
        second = fleet.supervise_once(now=2.0)
        _quiesce(fleet)
        return {"homes": homes, "first": first, "second": second,
                "streams": streams, "probe": (probe_home, probe.tokens),
                "after_eject": after_eject,
                "end": _counts(fleet.snapshot()),
                "paths": dict(fleet.path_counts),
                "injected": dict(fleet.fault_plan.injected),
                "raw": fleet.snapshot(), "prompts": prompts}
    finally:
        fleet.stop(grace_s=0.0)


def _wedge(pkg):
    """fleet_replica_wedge drives real restarts of replica 1 past a
    budget of 1: the supervisor ejects it as crash-looping."""
    fleet = pkg.fleet(replicas_min=2, replicas_max=2,
                      replica_restart_budget=1, probe_requests=1,
                      fault_plan=[{"kind": "fleet_replica_wedge",
                                   "replica": 1}])
    fleet.start()
    try:
        actions = fleet.supervise_once(now=1.0)
        return {"actions": actions, "snap": _counts(fleet.snapshot()),
                "injected": dict(fleet.fault_plan.injected),
                "probation": sorted(fleet._probation)}
    finally:
        fleet.stop(grace_s=0.0)


SCENARIOS = {"routing": _routing, "shed": _shed, "autoscale": _autoscale,
             "failover": _failover, "wedge": _wedge}


@pytest.fixture(scope="module")
def runs():
    """Every scenario through both packages: {name: {"ref"|"port": ...}}."""
    from kubeml_tpu_torch.convert import random_flax_params

    params = random_flax_params(**NANO, seed=21)
    pkgs = [Pkg("ref", params), Pkg("port", params)]
    return {name: {p.key: fn(p) for p in pkgs}
            for name, fn in SCENARIOS.items()}


def _solo_port_tokens(prompt, n):
    """The same request alone on a fresh port engine."""
    from kubeml_tpu_torch.convert import random_flax_params

    pkg = Pkg("port", random_flax_params(**NANO, seed=21))
    eng = pkg.engine(slots=2, page=PAGE)
    r = pkg.slots.GenerateRequest(list(prompt), max_new_tokens=n)
    eng.attach(r)
    while eng.active():
        eng.step()
    return r.tokens


# -------------------------------------------------------------------- tests

def test_routing_decisions_and_tokens_equal_reference(runs):
    """"affine_hit": prompts sharing a first page land on one replica; the
    replica of every request, the session pins and the tokens are the
    JAX fleet's."""
    ref, port = runs["routing"]["ref"], runs["routing"]["port"]
    assert port == ref
    homes = [h for h, _ in port["routed"]]
    assert homes[0] == homes[1] == homes[2]      # one first page
    assert homes[3:] == [0, 0, 1, 1]
    assert port["sessions"][0] == 1 - homes[0]   # the pin wins over the ring
    assert port["sessions"][1] == port["routed"][0][1]
    assert port["sessions"][2] == 0              # s2 follows the ring
    assert port["paths"]["affine_hit"] == len(homes) + 2
    assert port["routed"][0][1] == _solo_port_tokens(SHARED[0], 4)


def test_surfaced_shed_carries_fleet_minimum_retry_after(runs):
    ref, port = runs["shed"]["ref"], runs["shed"]["port"]
    assert port == ref
    assert port["status"] == 429 and port["retries"] == 1
    assert "fleet at capacity" in port["message"]
    # replica 0 owes 39 prompt tokens, replica 1 owes 2: the minimum
    assert port["retry_after_s"] == 1.0 + 2 / 256.0
    assert sorted(port["estimates"]) == [1.0 + 2 / 256.0, 1.0 + 39 / 256.0]


def test_autoscale_decisions_under_one_fake_clock(runs):
    """"cold_start", burn-rate "grow", four holds inside the fast window,
    "shrink_drain" once it expired, "scale_to_zero" past the idle budget,
    and a second cold start with the same tokens."""
    ref, port = (runs["autoscale"][k] for k in ("ref", "port"))
    for key in ("actions", "tokens", "decisions", "paths", "snaps"):
        assert port[key] == ref[key], key
    assert port["actions"] == ["grow", None, None, None, None, "shrink",
                               "scale_to_zero"]
    assert port["decisions"] == ["cold_start", "slo_burn", "grow",
                                 "shrink", "scale_to_zero", "cold_start"]
    assert port["tokens"][0] == port["tokens"][1]
    first = port["snaps"][0]
    assert first["serve_slo_bad_total"] == 1
    assert first["serve_slo_alerts_total"] == 1
    assert first["serve_slo_burn_fast"] > 1.0 and first["fleet_replicas"] == 2
    assert port["snaps"][-1]["fleet_cold_starts_total"] == 2


def test_crash_failover_migrates_streams_and_probation_rejoins(runs):
    """"eject" + "failover_migrate": the killed replica's three streams
    finish on the survivor with the tokens of a solo run; the replacement
    serves one "probe" and "probe_rejoin"s the ring."""
    ref, port = (runs["failover"][k] for k in ("ref", "port"))
    for key in ("homes", "first", "second", "streams", "probe",
                "after_eject", "end", "paths", "injected"):
        assert port[key] == ref[key], key
    assert port["homes"] == [0, 0, 0]
    assert port["first"] == ["eject", "failover_migrate"]
    assert port["second"] == ["probe_rejoin"]
    for (outcome, tokens, migrations, home), p in zip(port["streams"],
                                                      port["prompts"]):
        assert outcome == "ok" and migrations == 1 and home != 0
        assert tokens == _solo_port_tokens(p, FAILOVER_TOKENS)
    assert port["after_eject"]["fleet_ejections_total"] == 1
    assert port["after_eject"]["fleet_migrated_streams_total"] == 3
    assert port["after_eject"]["fleet_probation"] == 1
    assert port["end"]["fleet_probation"] == 0
    assert port["end"]["fleet_replicas"] == 2
    assert port["injected"]["fleet_replica_crash"] == 1


def test_wedge_blows_restart_budget_and_ejects(runs):
    ref, port = runs["wedge"]["ref"], runs["wedge"]["port"]
    assert port == ref
    assert port["actions"] == ["eject"]
    assert port["injected"]["fleet_replica_wedge"] == 1
    assert port["snap"]["fleet_ejections_total"] == 1
    assert port["snap"]["fleet_failovers_total"] == 0
    assert port["snap"]["serve_engine_restarts"] == 2


def test_slow_replica_straggler_is_hedged():
    """"hedge": fleet_replica_slow turns replica 0 into a straggler; a
    stream queued there past hedge_after_s is re-issued on the peer and
    finishes with the tokens of a solo run."""
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.utils.trace import Tracer

    pkg = Pkg("port", random_flax_params(**NANO, seed=21))
    tracer = Tracer()
    fleet = pkg.fleet(replicas_min=2, replicas_max=2, hedge_after_s=0.05,
                      slots=2, max_queue=4, tracer=tracer,
                      fault_plan=[{"kind": "fleet_replica_slow",
                                   "replica": 0, "duration_s": 0.2}])
    fleet.start()
    try:
        fleet.supervise_once(now=0.0)       # plants the slow step
        assert fleet.fault_plan.injected["fleet_replica_slow"] == 1
        prompts = _owned_prompts(fleet, 0, 5)
        reqs = [fleet.submit(p, max_new_tokens=6) for p in prompts]
        assert all(r.fleet_replica == 0 for r in reqs)
        assert _wait(lambda: "hedge" in fleet.supervise_once(
            now=time.perf_counter()), timeout_s=60.0), "no hedge fired"
        for p, r in zip(prompts, reqs):
            assert r.wait(180) and r.outcome == "ok", (r.outcome, r.error)
            assert r.tokens == _solo_port_tokens(p, 6)
        assert sum(r.fleet_replica != 0 for r in reqs) >= 1
        hedge = [e for e in tracer.events() if e["name"] == "hedge"]
        assert hedge and hedge[0]["args"]["resumed_from"] == 0
        assert fleet.snapshot()["fleet_hedges_total"] >= 1
    finally:
        fleet.stop(grace_s=0.0)


def test_fleet_prometheus_text_equals_reference(runs):
    """The same merged snapshots and serve observations give the same
    exposition text for every serve and fleet family."""
    from kubeml_tpu.metrics.prom import MetricsRegistry as Ref
    from kubeml_tpu_torch.metrics.prom import MetricsRegistry

    regs = [Ref(), MetricsRegistry()]
    snaps = runs["autoscale"]["ref"]["raw"] + [runs["failover"]["ref"]["raw"]]
    for reg in regs:
        for snap in snaps:
            reg.update_fleet("m", snap)
        reg.observe_serve_request("m", "ok")
        reg.observe_serve_request("m", "rejected")
        reg.observe_serve_latency("m", ttft=0.02, tpot=0.004, e2e=0.3)
        reg.observe_serve_ttft_breakdown("m", queue=0.001, prefill=0.015,
                                         interleave=0.004)
        reg.observe_serve_stream("m", 0.31)
        reg.set_serve_state("m", 3, 1, 0.25, 40)
        reg.set_serve_weight_generation("m", 2)
        for note in ("tokens", "prefill", "decode", "prefix_hits",
                     "prefix_misses", "page_leaks", "kv_bytes"):
            getattr(reg, f"note_serve_{note}")("m", 7)
        reg.note_serve_engine_restart("m")
        reg.note_serve_poisoned("m")
        reg.note_serve_trace_dropped("m", 4)
    ref, port = regs
    families = [name for name in vars(port) if name.startswith("serve_")]
    assert len(families) >= 30
    for name in families:
        assert getattr(port, name).collect() == \
            getattr(ref, name).collect(), name
    text = port.exposition()
    assert 'kubeml_serve_fleet_replicas{model="m"}' in text
    assert 'kubeml_serve_slo_burn_rate{model="m",window="fast"}' in text
    for reg in regs:
        reg.clear_serve("m")
    for name in families:
        assert getattr(port, name).collect() == \
            getattr(ref, name).collect(), name
    assert 'model="m"' not in port.exposition()


def test_health_verdicts_over_fleet_snapshots_equal_reference(runs):
    """The JAX and the port's health evaluators give the same verdict
    after each of the same serve:<model> snapshots."""
    from kubeml_tpu.control.health import HealthEvaluator as Ref
    from kubeml_tpu_torch.control.health import HealthEvaluator

    clock = FakeClock()
    evs = [Ref(clock=clock), HealthEvaluator(clock=clock)]
    snaps = runs["autoscale"]["port"]["raw"] + \
        [runs["failover"]["port"]["raw"]]
    seen = set()
    for snap in snaps:
        clock.advance(1.0)
        fired = [ev.observe(dict(snap, job_id="serve:m")) for ev in evs]
        assert fired[1] == fired[0]
        verdicts = [ev.verdict("serve:m") for ev in evs]
        assert verdicts[1] == verdicts[0]
        seen.add(verdicts[1]["state"])
        seen.update(r["rule"] for r in verdicts[1]["reasons"])
    assert "slo_burn" in seen
