"""Port parity: the serving plane's numbers — quantile sketches, SLO burn
rates and the engine flight recorder — against the JAX package's.

The sketch, SLO engine and flight recorder are copies (the port imports
nothing of the JAX package), so the same inputs must give the same
outputs exactly: quantiles, merged bucket states, burn rates, alert
onsets, attainment and ring contents compare with ``==``, no tolerance.
The engine's flight records over one staggered serving run equal the
JAX engine's field for field, except the two wall-clock fields (``ts``,
``dispatch_s``), which only have to be present and non-negative.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _samples(seed, n):
    rng = np.random.default_rng(seed)
    # latencies over four decades plus exact zeros (the clamp bucket)
    x = np.exp(rng.uniform(np.log(1e-4), np.log(10.0), n))
    x[::17] = 0.0
    return [float(v) for v in x]


QS = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]


@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_sketch_quantiles_and_merge_equal_reference(alpha):
    from kubeml_tpu.metrics.sketch import QuantileSketch as Ref
    from kubeml_tpu_torch.metrics.sketch import QuantileSketch

    xs = _samples(1, 1000)
    parts = [xs[:300], xs[300:650], xs[650:]]
    pooled_ref, pooled = Ref(alpha), QuantileSketch(alpha)
    for v in xs:
        pooled_ref.add(v)
        pooled.add(v)
    assert pooled.state() == pooled_ref.state()
    assert [pooled.quantile(q) for q in QS] == \
        [pooled_ref.quantile(q) for q in QS]
    merged = QuantileSketch(alpha)
    for part in parts:
        sk = QuantileSketch(alpha)
        for v in part:
            sk.add(v)
        # through JSON state, as a replica snapshot carries it
        merged.merge(QuantileSketch.from_state(sk.state()))
    assert merged.state() == pooled.state()
    assert merged.count == len(xs)
    with pytest.raises(ValueError):
        QuantileSketch(0.01).merge(QuantileSketch(0.02))
    assert QuantileSketch().quantile(0.5) == Ref().quantile(0.5) == 0.0


def test_windowed_sketch_expires_like_reference():
    from kubeml_tpu.metrics.sketch import WindowedSketch as Ref
    from kubeml_tpu_torch.metrics.sketch import WindowedSketch

    ca, cb = FakeClock(), FakeClock()
    a = Ref(window_s=60.0, subwindows=6, clock=ca)
    b = WindowedSketch(window_s=60.0, subwindows=6, clock=cb)
    xs = _samples(2, 120)
    for i, v in enumerate(xs):
        ca.t = cb.t = 2.5 * i
        a.add(v)
        b.add(v)
        if i % 7 == 0:
            assert b.state() == a.state()
            assert b.quantile(0.99) == a.quantile(0.99)
            assert b.count == a.count
    ca.t = cb.t = 2.5 * len(xs) + 61.0     # an idle window drains
    assert a.count == b.count == 0


def test_slo_engine_burn_rates_equal_reference():
    from kubeml_tpu.serve.slo import SLOEngine as Ref
    from kubeml_tpu_torch.serve.slo import SLOEngine

    rng = np.random.default_rng(3)
    a = Ref(0.5, 0.05, target=0.95, fast_ticks=5, slow_ticks=30)
    b = SLOEngine(0.5, 0.05, target=0.95, fast_ticks=5, slow_ticks=30)
    onsets = []
    for t in range(120):
        # quiet, then a burst of bad ticks, then recovery
        good = int(rng.integers(0, 20))
        bad = int(rng.integers(3, 12)) if 40 <= t < 55 else \
            int(rng.integers(0, 2))
        oa, ob = a.tick(good, bad), b.tick(good, bad)
        assert oa == ob
        onsets.append(ob)
        assert (b.burn_fast, b.burn_slow, b.attainment, b.alerting) == \
            (a.burn_fast, a.burn_slow, a.attainment, a.alerting)
        assert b.snapshot_fields() == a.snapshot_fields()
    assert any(onsets) and b.alerts_total == a.alerts_total >= 1
    for outcome, ttft, tpot in (("ok", 0.1, 0.01), ("ok", 0.6, 0.01),
                                ("ok", 0.1, 0.2), ("error", 0.1, 0.01),
                                ("deadline", 0.0, 0.0)):
        assert b.classify(outcome, ttft, tpot) == \
            a.classify(outcome, ttft, tpot)
    for bad_args in ((0.5, 0.0, 1.0), (0.5, 0.0, 0.0)):
        with pytest.raises(ValueError):
            SLOEngine(*bad_args)


def test_flight_recorder_ring_equals_reference():
    from kubeml_tpu.serve import flight as ref
    from kubeml_tpu_torch.serve import flight

    assert flight.FLIGHT_FIELDS == ref.FLIGHT_FIELDS
    assert flight.FLIGHT_SCHEMA_VERSION == ref.FLIGHT_SCHEMA_VERSION
    a, b = ref.FlightRecorder(5), flight.FlightRecorder(5)
    for i in range(12):
        a.record({"step": i, "tokens": i * 3})
        b.record({"step": i, "tokens": i * 3})
        assert b.snapshot() == a.snapshot()
        assert (b.total, len(b)) == (a.total, len(a))
    with pytest.raises(ValueError):
        flight.FlightRecorder(0)


def _engines():
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule
    from kubeml_tpu_torch.serve.engine import DecodeEngine

    params = random_flax_params(**NANO, seed=8)
    jm = JaxGPT(**NANO, dropout=0.0, dtype=jnp.float32)
    tm = GPTModule(**NANO, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    kw = dict(slots=3, page=4, prefill_chunk=4, flight_steps=10)
    return (JaxEngine(jm, {"params": params}, **kw),
            DecodeEngine(tm, device="cpu", **kw))


def test_engine_flight_records_equal_reference():
    """One staggered run (a join mid-flight, a prefix hit and a KV
    exhaustion-free drain) through both engines: the ring holds the same
    per-step records — kind, slots, backlog, pages, dispatch and token
    counts — once the wall-clock fields are set aside."""
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    records = {}
    for (key, eng), cls in zip(zip(("ref", "port"), _engines()),
                               (JaxRequest, GenerateRequest)):
        shared = list(range(5, 17))
        eng.attach(cls(list(shared), max_new_tokens=5))
        eng.attach(cls([40, 41, 42], max_new_tokens=9))
        for _ in range(3):
            eng.step()
        eng.attach(cls(list(shared), max_new_tokens=4))
        while eng.active():
            eng.step()
        eng.step()                       # one idle step
        recs = eng.flight.snapshot()
        for r in recs:
            assert r.pop("ts") >= 0 and r.pop("dispatch_s") >= 0
        records[key] = (recs, eng.flight.total)
    assert records["port"] == records["ref"]
    recs, total = records["port"]
    assert {"mixed", "decode", "idle"} <= {r["kind"] for r in recs}
    assert total > len(recs) == 10     # the ring wrapped
