"""Port parity: the serving plane's fault tolerance against the JAX
package's (twin of tests/test_serve_faults.py).

The same ServeFaultPlan (one plan string, parsed by each package's own
faults module) drives the JAX service and the port's over the same
requests at gpt-nano widths in float32; outcomes per request and greedy
tokens compare exactly:

  * step bisection — a rid-sticky step crash quarantines only the
    poisoning request; the survivors finish with the same tokens;
  * the non-finite guard — a poisoned lane terminates one stream;
  * wedge recovery — the watchdog rebuilds the engine and resumes the
    streams in flight with the tokens of an uninterrupted run;
  * deadlines, drain (503 + Retry-After from the same backlog) and a
    client cancel, which frees the stream's slot and pages;
  * hot-swap — streams attached before a weight install finish on the
    old generation, later ones decode the new one, the old generation
    retires, and the prefix cache is partitioned by generation.

Sampled tokens are compared within the port only.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)
# four greedy streams: (prompt, max_new_tokens)
SPECS = [([5, 6, 7], 6), ([9, 10, 11, 12], 6), ([3, 4], 6),
         ([20, 21, 22, 23, 24, 25], 5)]


def _modules(seed=11):
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule

    params = random_flax_params(**NANO, seed=seed)
    jm = JaxGPT(**NANO, dropout=0.0, dtype=jnp.float32)
    tm = GPTModule(**NANO, dtype=torch.float32, device="cpu")
    sd = params_from_flax(params)
    tm.load_state_dict(sd)
    return jm, {"params": params}, tm, sd


@pytest.fixture(scope="module")
def nano():
    return _modules()


def _drive(engine, limit=10_000):
    while engine.active():
        engine.step()
        limit -= 1
        assert limit > 0, "engine failed to drain"


def _port_engine(nano, **kw):
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    kw.setdefault("slots", 4)
    kw.setdefault("page", 4)
    return DecodeEngine(nano[2], nano[3], device="cpu", **kw)


def _jax_engine(nano, **kw):
    from kubeml_tpu.serve.engine import DecodeEngine
    kw.setdefault("slots", 4)
    kw.setdefault("page", 4)
    return DecodeEngine(nano[0], nano[1], **kw)


@pytest.fixture(scope="module")
def clean(nano):
    """Fault-free greedy tokens of SPECS on the port's engine."""
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    eng = _port_engine(nano)
    reqs = [GenerateRequest(list(p), max_new_tokens=n) for p, n in SPECS]
    for r in reqs:
        eng.attach(r)
    _drive(eng)
    assert all(r.outcome == "ok" for r in reqs)
    return [r.tokens for r in reqs]


def _serve_all(svc, specs=SPECS, timeout=120):
    reqs = [svc.submit(list(p), max_new_tokens=n) for p, n in specs]
    for r in reqs:
        assert r.wait(timeout), "request never reached a terminal state"
    return reqs


# ------------------------------------------------------ poisoned streams

def test_bisection_quarantines_step_poisoning_request(nano, clean):
    """A serve_step_crash bound to the stream in slot 0 crashes every step
    that schedules it. Both services bisect the failed step, quarantine
    that one request and finish the other three with the same tokens —
    no engine restart."""
    from kubeml_tpu.faults import ServeFaultPlan as JaxPlan
    from kubeml_tpu.serve.service import ServeService as JaxService
    from kubeml_tpu_torch.faults import ServeFaultPlan
    from kubeml_tpu_torch.serve.service import ServeService

    plan_spec = '[{"kind": "serve_step_crash", "slot": 0}]'
    runs = {}
    for key, service, engine, plan_cls in (
            ("ref", JaxService, _jax_engine, JaxPlan),
            ("port", ServeService, _port_engine, ServeFaultPlan)):
        plan = plan_cls.parse(plan_spec)
        eng = engine(nano, fault_plan=plan)
        svc = service("crash-m", eng, supervise=False).start()
        try:
            reqs = _serve_all(svc)
        finally:
            svc.stop()
        assert plan.injected["serve_step_crash"] >= 1
        assert svc.engine is eng and svc.restarts_total == 0
        assert svc.poisoned_total == 1
        runs[key] = [(r.outcome, r.tokens if r.outcome == "ok" else None,
                      "quarantined" in (r.error or "")
                      and "serve_step_crash" in (r.error or ""))
                     for r in reqs]
    assert runs["port"] == runs["ref"]
    # the first submission binds slot 0 and is the quarantined poisoner
    assert runs["port"][0] == ("error", None, True)
    assert [t for _, t, _ in runs["port"][1:]] == clean[1:]


def test_nan_guard_isolates_poisoned_stream(nano, clean):
    from kubeml_tpu.faults import ServeFaultPlan as JaxPlan
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.faults import ServeFaultPlan
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    runs = {}
    for key, engine, plan_cls, req_cls in (
            ("ref", _jax_engine, JaxPlan, JaxRequest),
            ("port", _port_engine, ServeFaultPlan, GenerateRequest)):
        plan = plan_cls.parse([{"kind": "serve_nan_logits", "slot": 1}])
        eng = engine(nano, fault_plan=plan)
        reqs = [req_cls(list(p), max_new_tokens=n) for p, n in SPECS]
        for r in reqs:
            eng.attach(r)
        _drive(eng)
        assert plan.injected["serve_nan_logits"] == 1
        assert eng.stats["poisoned"] == 1
        runs[key] = [(r.outcome, r.tokens, r.error) for r in reqs]
    assert runs["port"] == runs["ref"]
    assert runs["port"][1][0] == "error"
    assert "poisoned and isolated" in runs["port"][1][2]
    assert [runs["port"][i][1] for i in (0, 2, 3)] == \
        [clean[i] for i in (0, 2, 3)]


def test_fault_plans_parse_and_fire_like_reference():
    """One plan string, two packages: the same kinds accepted, the same
    coordinates fired, the same rid-sticky crash and once-only nan and
    fleet events."""
    from kubeml_tpu import faults as ref
    from kubeml_tpu_torch import faults

    assert faults.SERVE_KINDS == ref.SERVE_KINDS
    assert faults.FLEET_KINDS == ref.FLEET_KINDS
    spec = ('{"events": [{"kind": "serve_nan_logits", "step": 3, '
            '"slot": 1}, {"kind": "serve_step_crash", "step": 5, '
            '"slot": 2}]}')
    a, b = ref.ServeFaultPlan.parse(spec), faults.ServeFaultPlan.parse(spec)
    for step, members in ((2, [0, 1]), (3, [0]), (3, [0, 1]), (3, [0, 1])):
        assert b.nan_hits(step, members) == a.nan_hits(step, members)
    for step, occ in ((4, [(2, "aaaa")]), (5, [(2, "aaaa"), (0, "bbbb")]),
                      (7, [(0, "bbbb")]), (9, [(1, "aaaa")])):
        outs = []
        for plan in (a, b):
            try:
                plan.check_crash(step, occ)
                outs.append(None)
            except RuntimeError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
    assert b.injected == a.injected
    assert b.injected["serve_step_crash"] == 2
    fspec = [{"kind": "fleet_replica_crash", "replica": 1},
             {"kind": "fleet_replica_slow", "tick": 2, "duration_s": 0.1},
             {"kind": "fleet_replica_wedge"}]
    fa = ref.FleetFaultPlan.parse(fspec)
    fb = faults.FleetFaultPlan.parse(fspec)
    for tick, live in ((1, [0]), (2, [0, 1]), (3, [0, 1]), (4, [2])):
        got = [(k, i, ev.duration_s) for k, i, ev in fb.fire(tick, live)]
        want = [(k, i, ev.duration_s) for k, i, ev in fa.fire(tick, live)]
        assert got == want
    assert fb.injected == fa.injected
    for bad in ([{"kind": "bogus"}], {"events": 3}):
        with pytest.raises(ValueError):
            faults.ServeFaultPlan.parse(bad)
        with pytest.raises(ValueError):
            faults.FleetFaultPlan.parse(bad)


# ------------------------------------------------------------ supervision

def test_wedge_recovery_resumes_streams_with_the_same_tokens(nano, clean):
    """serve_loop_wedge freezes the loop after step 2 with every stream
    mid-generation; the watchdog abandons the engine, builds a fresh one
    and resumes each stream (prompt + emitted tokens re-prefilled): the
    tokens equal the uninterrupted run, the recovered pager audits clean
    and the abandoned engine's slab is freed once its thread left."""
    from kubeml_tpu_torch.faults import ServeFaultPlan
    from kubeml_tpu_torch.serve.service import ServeService

    plan = ServeFaultPlan.parse([{"kind": "serve_loop_wedge", "step": 2}])
    eng = _port_engine(nano, fault_plan=plan)
    svc = ServeService("wedge-m", eng, supervise=True, wedge_timeout_s=0.2,
                       watchdog_interval_s=0.05).start()
    try:
        reqs = _serve_all(svc)
    finally:
        svc.stop()
    assert plan.injected["serve_loop_wedge"] == 1
    assert svc.restarts_total == 1 and svc.engine is not eng
    assert [r.outcome for r in reqs] == ["ok"] * len(SPECS)
    assert [r.tokens for r in reqs] == clean
    svc.engine.check_pager()
    deadline = time.monotonic() + 10
    while eng.slab is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.slab is None


def test_deadline_reaps_slot_and_restores_free_list(nano):
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    runs = {}
    for key, engine, req_cls in (("ref", _jax_engine, JaxRequest),
                                 ("port", _port_engine, GenerateRequest)):
        clk = {"t": 0.0}
        eng = engine(nano, slots=2, page=8, prefix_cache=False,
                     clock=lambda clk=clk: clk["t"])
        req = req_cls([5, 6, 7], max_new_tokens=32, deadline_ms=50)
        req.deadline_at = 0.05
        free0 = eng.pager.free_pages
        eng.attach(req)
        eng.step()
        clk["t"] = 0.2
        finished = eng.step()
        assert finished == [req]
        runs[key] = (req.outcome, req.tokens, req.error,
                     eng.pager.free_pages == free0,
                     eng.stats["deadline_expired"])
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == "deadline" and runs["port"][3]


def test_drain_closes_admission_and_lets_streams_finish(nano, clean):
    """drain(): the next submit answers 503 with the Retry-After of the
    same backlog in both packages, and the streams in flight finish with
    their tokens."""
    from kubeml_tpu.serve.service import ServeService as JaxService
    from kubeml_tpu.serve.slots import ServeDraining as JaxDraining
    from kubeml_tpu_torch.serve.service import ServeService
    from kubeml_tpu_torch.serve.slots import ServeDraining

    runs = {}
    for key, service, engine, draining in (
            ("ref", JaxService, _jax_engine, JaxDraining),
            ("port", ServeService, _port_engine, ServeDraining)):
        svc = service("drain-m", engine(nano), supervise=False).start()
        try:
            reqs = [svc.submit(list(p), max_new_tokens=n) for p, n in SPECS]
            assert svc.drain(120.0) is True
            with pytest.raises(draining) as ei:
                svc.submit([5, 6], max_new_tokens=2)
        finally:
            svc.stop()
        runs[key] = ([(r.outcome, r.tokens) for r in reqs],
                     ei.value.status_code, ei.value.retry_after_s)
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == [("ok", t) for t in clean]
    assert runs["port"][1:] == (503, 1.0)


def test_client_cancel_frees_slot_and_pages(nano):
    """A cancelled stream (what a client disconnect does through the
    /generate producer) ends "cancelled", and its slot and KV pages go
    back to the pool."""
    from kubeml_tpu_torch.serve.service import ServeService

    eng = _port_engine(nano, slots=2, prefix_cache=False)
    free0 = eng.pager.free_pages
    svc = ServeService("cancel-m", eng, supervise=False).start()
    try:
        r = svc.submit(list(range(5, 25)), max_new_tokens=40)
        first = r.events.get(timeout=60)
        assert "token" in first
        svc.cancel(r)
        assert r.wait(60) and r.outcome == "cancelled"
        deadline = time.monotonic() + 10
        while svc.inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.inflight == 0 and eng.active() == 0
        assert eng.pager.free_pages == free0
    finally:
        svc.stop()


# ----------------------------------------------------------------- hot-swap

def _swap_run(engine, req_cls, v2, install):
    """A attaches under generation 1 and decodes a few steps; the swap
    lands between two of its steps ("swap_mid_stream"); B (A's prompt)
    and C attach after it. Returns the requests and the engine."""
    shared = list(range(5, 17))              # three full pages of 4
    a = req_cls(list(shared), max_new_tokens=8)
    engine.attach(a)
    for _ in range(4):
        engine.step()
    assert engine.install_weights(install(v2)) == 2
    b = req_cls(list(shared), max_new_tokens=6)
    c = req_cls([30, 31, 32], max_new_tokens=5)
    engine.attach(b)
    engine.attach(c)
    _drive(engine)
    return [a, b, c]


def test_hot_swap_pins_generations_like_reference(nano):
    """"swap_attach_old": A, attached before the install, finishes on
    generation 1 with the tokens of a run that never swapped;
    "swap_attach_new": B and C decode generation 2, as an engine that
    only ever held it; "swap_cache_partition": B never hits A's pages;
    "swap_drain_free": generation 1 retires when A releases."""
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    _, jv2, tm2, sd2 = _modules(seed=12)
    runs = {}
    for key, engine, req_cls, v2, install in (
            ("ref", _jax_engine, JaxRequest, jv2, lambda v: v),
            ("port", _port_engine, GenerateRequest, sd2, lambda v: v)):
        eng = engine(nano)
        reqs = _swap_run(eng, req_cls, v2, install)
        assert all(r.outcome == "ok" for r in reqs)
        runs[key] = ([r.tokens for r in reqs],
                     {k: eng.stats[k] for k in (
                         "weight_swaps", "generations_retired",
                         "prefix_hits", "prefix_misses")},
                     eng.active_generations(), eng.weight_generation)
    assert runs["port"] == runs["ref"]
    tokens, stats, gens, gen = runs["port"]
    assert stats["weight_swaps"] == 1 and stats["generations_retired"] == 1
    assert stats["prefix_hits"] == 0          # B missed A's generation
    assert gens == [2] and gen == 2

    def alone(sd, prompt, n):
        from kubeml_tpu_torch.serve.slots import GenerateRequest as R
        eng = DecodeEngine(nano[2], sd, slots=4, page=4, device="cpu")
        r = R(list(prompt), max_new_tokens=n)
        eng.attach(r)
        _drive(eng)
        return r.tokens
    shared = list(range(5, 17))
    assert tokens[0] == alone(nano[3], shared, 8)
    assert tokens[1] == alone(sd2, shared, 6)
    assert tokens[2] == alone(sd2, [30, 31, 32], 5)


def test_a_retired_generation_is_counted_before_it_leaves(nano):
    """Another thread that sees generation 1 gone from
    active_generations() (a test waiting for the retirement, the fleet's
    snapshot) also sees it in stats["generations_retired"]: the engine
    counts the retirement before it drops the params."""
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    class Watched(dict):
        def __delitem__(self, gen):
            counted.append((gen, eng.stats["generations_retired"]))
            super().__delitem__(gen)

        def pop(self, gen, *default):
            counted.append((gen, eng.stats["generations_retired"]))
            return super().pop(gen, *default)

    counted = []
    _, _, _, sd2 = _modules(seed=12)
    eng = _port_engine(nano)
    eng._params_by_gen = Watched(eng._params_by_gen)
    reqs = _swap_run(eng, GenerateRequest, sd2, lambda v: v)
    assert all(r.outcome == "ok" for r in reqs)
    assert counted == [(1, 1)] and eng.active_generations() == [2]


def test_service_installs_weights_in_the_loop_thread(nano):
    """install_weights() from another thread only queues the swap: the
    engine installs it on the serving loop's thread, before the next
    admission, which then decodes generation 2."""
    from kubeml_tpu_torch.serve.service import ServeService

    _, _, _, sd2 = _modules(seed=12)
    eng = _port_engine(nano)
    seen = []
    real = eng.install_weights
    eng.install_weights = lambda v: seen.append(
        threading.current_thread().name) or real(v)
    svc = ServeService("swap-m", eng, supervise=False).start()
    try:
        first = svc.submit([5, 6, 7], max_new_tokens=3)
        assert first.wait(60)
        svc.install_weights(sd2, stamp=2.0)
        second = svc.submit([5, 6, 7], max_new_tokens=3)
        assert second.wait(60) and second.outcome == "ok"
    finally:
        svc.stop()
    assert seen == ["serve-swap-m"]
    assert svc.weight_stamp == 2.0 and eng.weight_generation == 2
    assert svc.snapshot()["serve_weight_generation"] == 2


@pytest.mark.gpu
def test_spawn_recovered_allocates_on_the_card():
    """A CUDA engine's replacement (supervisor recovery) builds its slab
    on the card and adopts the resident generations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with python -m "
                    "pytest -m gpu tests/test_torch_*.py)")
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    tm = GPTModule(**NANO, dtype=torch.float32, device="cuda")
    tm.load_state_dict(params_from_flax(random_flax_params(**NANO, seed=11)))
    eng = DecodeEngine(tm, slots=4, page=8, prefill_chunk=8)
    fresh = eng.spawn_recovered()
    assert fresh.slab.k.device.type == "cuda"
    assert fresh.slab.k.data_ptr() != eng.slab.k.data_ptr()
    assert fresh.active_generations() == eng.active_generations() == [1]
    r = GenerateRequest([5, 6, 7, 8, 9], max_new_tokens=4)
    fresh.attach(r)
    _drive(fresh)
    assert r.outcome == "ok" and len(r.tokens) == 4
    assert np.all(np.asarray(r.tokens) > 0)
