"""Port parity: the cost ledger and the runtime metrics of kubeml_tpu_torch
(metrics/ledger.py, metrics/runtime.py and everything they feed) against
the JAX package's, all EXACTLY equal: no tolerance anywhere.

The reference runs with KUBEML_COST_LEDGER=0, so it records the
closed-form fallbacks the port always records (the port never writes
source="xla"; ROADMAP C.8). Groups:
  - the copied ledger and compile tracker, case for case against
    tests/test_cost_ledger.py's non-XLA cases: fallback capture, the env
    gate, replay with tamper and recapture, reconcile, merge and
    attribution, storm naming, update_cost deltas, the MetricUpdate round
    trip, and snapshot_to_json byte for byte;
  - the analytic records (merge.<strategy>, pager.decode_kv(_int8)) at
    the canonical geometry of tools/check_cost_budgets.py, equal to the
    "analytic" entries of tools/cost_budgets.json (both read only);
  - gpt-nano KAvgEngine ledgers over train_round, train_rounds (R=2), the
    indexed pair and eval_round, under all four merge strategies, with
    the compile flags; a narrow ResNet job (batch_stats bytes) per epoch;
    a DecodeEngine batch with bf16 and int8 pages;
  - the deployments: /cost (PS and controller), ``kubeml cost --json``
    and the kubeml_cost_* and kubeml_jit_compiles_total lines of a
    threaded job, a job-server child's /cost (the POST /metrics path),
    and serve:<model> through both packages' PS.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reference_capture_off(monkeypatch):
    """The reference's closed-form records: what the port records."""
    monkeypatch.setenv("KUBEML_COST_LEDGER", "0")


def _mods(key):
    if key == "ref":
        from kubeml_tpu.metrics import ledger, runtime
    else:
        from kubeml_tpu_torch.metrics import ledger, runtime
    return ledger, runtime


def _err(fn):
    """(exception class name, message) of a call, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — each package's own class
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------ ledger, case for case

def _fallback(ledger, runtime):
    led = ledger.CostLedger(capture_enabled=True)
    rec = led.capture("fb.prog", "train", None,
                      fallback={"flops": 12.0, "hbm_bytes": 34.0,
                                "transcendentals": 5.0})
    led.note_dispatch("fb.prog", 4, samples=16)
    return [rec.to_dict(), led.totals("fb.prog"), _err(led.replay_check),
            ledger.snapshot_to_json(led.snapshot())]


def _env_gate(ledger, runtime):
    led = ledger.CostLedger()
    rec = led.capture("gated.prog", "serve", None,
                      fallback={"hbm_bytes": 7.0})
    return [rec.to_dict(), rec.arithmetic_intensity, led.programs()]


def _replay(ledger, runtime):
    led = ledger.CostLedger()
    led.capture_analytic("a", "kernel", flops=10.0, hbm_bytes=100.0)
    led.note_dispatch("a", 7)
    out = [_err(led.replay_check)]
    led._totals["a"]["flops_total"] += 1.0
    out.append(_err(led.replay_check))
    led._totals["a"]["flops_total"] -= 1.0
    out.append(_err(led.replay_check))
    led.capture_analytic("a", "kernel", flops=20.0, hbm_bytes=100.0)
    led.note_dispatch("a", 1)
    out += [led.totals("a"), _err(led.replay_check),
            ledger.snapshot_to_json(led.snapshot())]
    return out


def _reconcile(ledger, runtime):
    led = ledger.CostLedger()
    led.capture_analytic("p", "serve", hbm_bytes=1000.0)
    return [_err(lambda: led.reconcile("p", "hbm_bytes", e, tolerance=t))
            for e, t in ((1000.0, 0.0), (1001.0, 0.0), (1100.0, 0.2),
                         (2000.0, 0.2))] + \
        [_err(lambda: led.reconcile("missing", "hbm_bytes", 1.0))]


def _merge_attribution(ledger, runtime):
    a = {"p": {"program": "p", "plane": "serve", "flops": 2.0,
               "hbm_bytes": 10.0, "source": "analytic", "dispatches": 3,
               "flops_total": 6.0, "hbm_bytes_total": 30.0,
               "transcendentals_total": 0.0, "samples": 0, "tokens": 12,
               "recaptures": 0}}
    b = json.loads(json.dumps(a))
    b["p"].update(dispatches=1, flops_total=2.0, hbm_bytes_total=10.0,
                  tokens=4)
    b["q"] = dict(a["p"], program="q", plane="train", samples=64, tokens=0)
    merged = ledger.merge_cost_snapshots([a, b, {}, None])
    return [json.dumps(merged), ledger.attributed_from_snapshot(merged),
            ledger.attributed_from_snapshot({})]


def _ledger_attributed(ledger, runtime):
    led = ledger.CostLedger()
    led.note_dispatch("late", 2, samples=8)       # before its record
    led.capture("late", "train", None, fallback={"flops": 3.0,
                                                 "hbm_bytes": 4.0})
    led.note_dispatch("late", 1, samples=4)
    led.capture_analytic("kv", "serve", hbm_bytes=9.0)
    led.note_dispatch("kv", 3, tokens=6)
    led.note_dispatch("kv", 0)                    # a no-op
    return [led.attributed(), led.programs(), led.totals("nothing"),
            json.dumps(led.snapshot())]


def _program_cost(ledger, runtime):
    pc = ledger.ProgramCost(program="x", plane="kernel", flops=1.0,
                            hbm_bytes=4.0, transcendentals=0.0,
                            peak_temp_bytes=2, source="analytic")
    back = ledger.ProgramCost.from_dict(pc.to_dict())
    return [back.to_dict(), back.arithmetic_intensity, ledger.PLANES,
            ledger.SOURCES, ledger.XLA_PROXY_TOLERANCE,
            _err(lambda: ledger.ProgramCost("x", "bogus", 0, 0, 0, 0)),
            _err(lambda: ledger.ProgramCost("x", "train", 0, 0, 0, 0,
                                            source="bogus"))]


def _storms(ledger, runtime):
    t = runtime.JitCompileTracker()
    for _ in range(20):
        t.note(False, program="healthy")
    out = []
    for _ in range(3):
        t.note(True, 0.1, program="churny")
        out.append((t.storm, dict(t.storms_by_program)))
    for _ in range(8):                            # the window heals
        t.note(False, program="churny")
    t.note(True, 0.25)                            # unattributed
    out += [t.storm, t.storms, t.snapshot(), runtime.STORM_COMPILES,
            runtime.STORM_WINDOW]
    return out


def _random_ops(ledger, runtime):
    rng = np.random.default_rng(3)
    led = ledger.CostLedger()
    names = ["kavg.train", "kavg.eval", "serve.decode", "merge.bucketed"]
    for _ in range(200):
        op, name = int(rng.integers(0, 4)), names[rng.integers(0, 4)]
        plane = ("serve" if name.startswith("serve") else "kernel"
                 if name.startswith("merge") else "train")
        if op == 0:
            led.capture(name, plane, None, fallback={
                "flops": float(rng.integers(1, 10 ** 9)) / 7.0,
                "hbm_bytes": float(rng.integers(1, 10 ** 9)) / 3.0})
        elif op == 1:
            led.capture_analytic(name, plane,
                                 hbm_bytes=float(rng.integers(1, 99999)),
                                 argument_bytes=int(rng.integers(0, 9)))
        else:
            led.note_dispatch(name, int(rng.integers(0, 4)),
                              samples=int(rng.integers(0, 64)),
                              tokens=int(rng.integers(0, 8)))
    return [ledger.snapshot_to_json(led.snapshot()),
            json.dumps(led.attributed())]


LEDGER_CASES = {f.__name__[1:]: f for f in (
    _fallback, _env_gate, _replay, _reconcile, _merge_attribution,
    _ledger_attributed, _program_cost, _storms, _random_ops)}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_ledger_and_tracker_behave_as_the_references(case):
    """The same operations on both packages' ledgers and trackers give
    the same records, totals, snapshots (byte for byte), attributions,
    storm flags and errors."""
    got = LEDGER_CASES[case](*_mods("port"))
    want = LEDGER_CASES[case](*_mods("ref"))
    assert got == want


def test_update_cost_advances_the_references_counters():
    """kubeml_cost_* advance by snapshot deltas per owner in both
    registries: repeats, dips, a second owner, clear_job; the exposed
    lines are equal."""
    from kubeml_tpu.metrics.prom import MetricsRegistry as RefRegistry
    from kubeml_tpu_torch.metrics.prom import MetricsRegistry

    def snap(flops, disp):
        return {"p": {"plane": "serve", "flops_total": flops,
                      "hbm_bytes_total": 2 * flops, "dispatches": disp},
                "m": {"plane": "kernel", "flops_total": 0.0,
                      "hbm_bytes_total": 5.0 * disp, "dispatches": 0}}

    lines = []
    for reg in (MetricsRegistry(), RefRegistry()):
        for owner, f, d in (("job-1", 100.0, 2), ("job-1", 100.0, 2),
                            ("job-1", 150.0, 3), ("job-1", 40.0, 1),
                            ("serve:m", 60.0, 1)):
            reg.update_cost(owner, snap(f, d))
        reg.clear_job("job-1")
        reg.update_cost("job-1", snap(10.0, 1))
        lines.append(sorted(ln for ln in reg.exposition().splitlines()
                            if "kubeml_cost_" in ln))
        assert reg.cost_flops_total.value(("p", "serve")) == 220.0
    assert lines[0] == lines[1]


def test_metric_update_cost_fields_cross_the_wire_both_ways():
    from kubeml_tpu.api.types import MetricUpdate as RefUpdate
    from kubeml_tpu_torch.api.types import MetricUpdate

    snap = {"kavg.train": {"program": "kavg.train", "plane": "train",
                           "flops": 5.0, "hbm_bytes": 9.0,
                           "dispatches": 2, "flops_total": 10.0,
                           "hbm_bytes_total": 18.0, "samples": 64,
                           "tokens": 0, "recaptures": 0,
                           "transcendentals": 0.0,
                           "transcendentals_total": 0.0,
                           "source": "fallback"}}
    kw = dict(job_id="j", validation_loss=0.1, accuracy=0.9,
              train_loss=0.2, parallelism=2, epoch_duration=1.0,
              cost_programs=snap, jit_compiles=3, hbm_peak_bytes=1 << 20,
              hbm_in_use_bytes=1 << 19)
    for src, dst in ((MetricUpdate, RefUpdate), (RefUpdate, MetricUpdate)):
        d = json.loads(json.dumps(src(**kw).to_dict()))
        back = dst.from_dict(d)
        assert back.cost_programs == snap
        assert (back.jit_compiles, back.hbm_peak_bytes,
                back.hbm_in_use_bytes) == (3, 1 << 20, 1 << 19)
        assert back.to_dict() == d
        del d["cost_programs"]
        assert dst.from_dict(d).cost_programs == {}


def test_watermark_reads_the_allocator_or_the_tracked_tensors():
    """On the CPU the watermark sums the tracked tensors (each once) and
    keeps the running peak; a CUDA device reads the caching allocator and
    never falls back (the card's twin runs in the gpu tests)."""
    from kubeml_tpu_torch.metrics.runtime import (HbmWatermark,
                                                  device_memory_stats)

    assert device_memory_stats("cpu") is None
    held = {"a": torch.zeros(256), "b": torch.zeros(64, dtype=torch.int8)}
    wm = HbmWatermark("cpu")
    # a tensor listed twice counts once
    wm.track(lambda: list(held.values()) + list(held.values())[:1])
    assert wm.sample() == (1088, 1088)
    held.pop("a")
    assert wm.sample() == (1088, 64)
    assert wm.snapshot() == {"hbm_peak_bytes": 1088,
                             "hbm_in_use_bytes": 64}


# -------------------------------------- analytic records vs the budgets

def _canonical_records():
    """The port's analytic records at tools/check_cost_budgets.py's
    canonical geometry: the two-layer tree's four merge levers and the
    KV traffic of each storage mode."""
    from kubeml_tpu_torch.metrics.ledger import CostLedger
    from kubeml_tpu_torch.parallel import merge
    from kubeml_tpu_torch.serve.pager import KVPageSlab, PageGeometry

    led = CostLedger()
    variables = {"dense.weight": torch.zeros(64, 64),
                 "dense.bias": torch.zeros(64),
                 "head.weight": torch.zeros(10, 64),
                 "head.bias": torch.zeros(10)}
    for kw in ({}, dict(bucket_mb=4.0), dict(compress="bf16"),
               dict(compress="int8")):
        merge.register_merge_cost(led, variables, **kw)
    geom = PageGeometry(slots=4, page=16, pages=33, pages_per_slot=8)
    for kv_dtype, program in (("f32", "pager.decode_kv"),
                              ("int8", "pager.decode_kv_int8")):
        slab = KVPageSlab(geom, 2, 4, 8, torch.float32,
                          torch.device("cpu"), kv_dtype=kv_dtype)
        led.capture_analytic(program, "serve",
                             hbm_bytes=float(slab.decode_bytes_per_token))
        led.reconcile(program, "hbm_bytes", slab.decode_bytes_per_token,
                      tolerance=0.0)
    return led


def _budgets():
    with open(os.path.join(REPO, "tools", "cost_budgets.json")) as f:
        return json.load(f)["programs"]


ANALYTIC = sorted(k for k, v in _budgets().items()
                  if v["source"] == "analytic")


@pytest.mark.parametrize("program", ANALYTIC)
def test_analytic_records_equal_the_committed_budgets(program):
    rec = _canonical_records().record(program)
    want = _budgets()[program]
    assert rec is not None
    assert (rec.plane, rec.source, rec.flops, rec.hbm_bytes,
            rec.transcendentals) == (want["plane"], want["source"],
                                     want["flops"], want["hbm_bytes"],
                                     want["transcendentals"])


def test_merge_cost_records_equal_the_references_at_gpt_nano():
    """register_merge_cost over gpt-nano's variables equals the
    reference's record for every lever (argument_bytes = buckets per
    round, output_bytes = the payload)."""
    from kubeml_tpu.metrics.ledger import CostLedger as RefLedger
    from kubeml_tpu.parallel import merge as ref_merge
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.metrics.ledger import CostLedger
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.parallel import merge

    params = random_flax_params(**GPT_CONFIGS["gpt-nano"], seed=0)
    ref, port = RefLedger(), CostLedger()
    for kw in ({}, dict(bucket_mb=0.02), dict(compress="bf16"),
               dict(compress="int8"), dict(bucket_mb=0.02,
                                           compress="int8")):
        p = merge.register_merge_cost(port, params_from_flax(params), **kw)
        r = ref_merge.register_merge_cost(ref, {"params": params}, **kw)
        assert p == r
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    assert port.totals("merge.ef_int8")["recaptures"] == 1


# ------------------------------------------------------- engine ledgers

LR = 1e-3
W, S, B, T = 4, 2, 4, 16
LANES = 2
STRATEGIES = [("monolithic", 0.0, "none"), ("bucketed", 0.02, "none"),
              ("ef_bf16", 0.02, "bf16"), ("ef_int8", 0.02, "int8")]


def _round(seed, steps=S):
    rng = np.random.default_rng(seed)
    start = rng.integers(1, 500, (W, steps, B, 1))
    x = ((start + np.arange(T) - 1) % 511 + 1).astype(np.int32)
    x[:, :, 0, 11:] = 0
    smask = np.ones((W, steps, B), np.float32)
    smask[0, -1, 3] = 0.0
    stmask = np.ones((W, steps), np.float32)
    stmask[2, -1] = 0.0
    wmask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    rngs = rng.integers(0, 2 ** 32, (W, steps, 2), dtype=np.uint32)
    return x, smask, stmask, wmask, rngs


class _Cache:
    """A replicated dataset cache of token windows in either package's
    arrays: the layout, slabs, transform and signature the engines read."""
    layout = "replicated"
    device_transform = None
    n_lanes = 1

    def __init__(self, pool, to_array):
        self.arrays = {"x": to_array(pool)}
        self.signature = ("replicated", (("x", pool.shape, "int32"),),
                          False)


def _engines(bucket_mb, compress):
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.models.gpt import GPTNano as JaxNano
    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS, GPTNano
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    jm = JaxNano()
    jm._module = JaxGPT(**GPT_CONFIGS["gpt-nano"], dropout=0.0,
                        dtype=jnp.float32, attn_impl="reference")
    jeng = JaxEngine(make_mesh(n_data=LANES), jm.loss, jm.metrics,
                     jm.configure_optimizers, donate=False,
                     merge_bucket_mb=bucket_mb, merge_compress=compress)
    model = GPTNano()
    module = model.build(dtype=torch.float32, device="cpu")
    teng = KAvgEngine(module, model.loss, model.metrics,
                      model.configure_optimizers, n_lanes=LANES,
                      merge_bucket_mb=bucket_mb, merge_compress=compress)
    return jeng, teng


@pytest.mark.parametrize("name,bucket_mb,compress", STRATEGIES,
                         ids=[s[0] for s in STRATEGIES])
def test_engine_ledger_equals_the_references(name, bucket_mb, compress):
    """gpt-nano at n_lanes = 2: the same dispatches give the same ledger
    snapshot (records, dispatches, samples, recaptures, insertion order)
    and the same compile flags. Monolithic drives every entry point:
    train_round twice at one shape and once at another (a recapture),
    train_rounds at R = 2, the indexed pair, eval_round twice; the other
    strategies a round, its repeat and an evaluation."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    params = random_flax_params(**GPT_CONFIGS["gpt-nano"], seed=4)
    jeng, teng = _engines(bucket_mb, compress)
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tvars = params_from_flax(params)
    flags = {"ref": [], "port": []}

    def both(method, *args, jbatch, tbatch):
        _, jst = getattr(jeng, method)(jvars, *jbatch, *args, LR, 0)
        _, tst = getattr(teng, method)(tvars, *tbatch, *args, LR, 0)
        flags["ref"].append(jst.compiled)
        flags["port"].append(tst.compiled)

    def train(seed, steps=S):
        x, *masks = _round(seed, steps)
        both("train_round", *masks, jbatch=({"x": jnp.asarray(x)},),
             tbatch=({"x": x},))

    def evaluate(seed):
        x, smask, *_ = _round(seed)
        jeng.eval_round(jvars, {"x": jnp.asarray(x)}, smask)
        teng.eval_round(tvars, {"x": x}, smask)

    train(1)
    train(2)
    if name == "monolithic":
        train(3, steps=1)                          # a new shape
        rounds = [_round(s) for s in (4, 5)]
        x = np.stack([r[0] for r in rounds])
        masks = [np.stack([r[i] for r in rounds]) for i in range(1, 5)]
        both("train_rounds", *masks, jbatch=({"x": jnp.asarray(x)},),
             tbatch=({"x": x},))
        pool = np.concatenate([r[0].reshape(-1, T) for r in rounds])
        jcache = _Cache(pool, jnp.asarray)
        tcache = _Cache(pool, torch.as_tensor)
        rng = np.random.default_rng(6)
        idx = rng.integers(0, len(pool), (2, W, S, B)).astype(np.int32)
        both("train_round_indexed", *[m[0] for m in masks],
             jbatch=(jcache, idx[0]), tbatch=(tcache, idx[0]))
        both("train_rounds_indexed", *masks, jbatch=(jcache, idx),
             tbatch=(tcache, idx))
        evaluate(7)
    evaluate(8)
    want, got = jeng.ledger.snapshot(), teng.ledger.snapshot()
    assert json.dumps(got) == json.dumps(want)
    assert flags["port"] == flags["ref"]
    assert teng.programs_compiled == jeng.programs_compiled
    assert got[f"merge.{name}"]["recaptures"] == \
        teng.programs_compiled - 1
    assert all(e["source"] == "fallback" for k, e in got.items()
               if k.startswith("kavg."))


# --------------------------------------------------- a narrow ResNet job

def _resnet_models():
    import jax.numpy as jnp

    from kubeml_tpu.models import resnet as ref
    from kubeml_tpu_torch.models import resnet as port

    class JaxNarrow(ref._ResNetBase):
        name = "resnet-narrow"

        def build(self):
            return ref.ResNetModule(stage_sizes=(1, 1), width=8,
                                    dtype=jnp.float32)

    class PortNarrow(port._ResNetBase):
        name = "resnet-narrow"
        stage_sizes, width = (1, 1), 8

        def build(self, dtype=torch.float32, device=None):
            return super().build(dtype=dtype, device=device)

    return JaxNarrow(), PortNarrow()


def _images(key):
    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu_torch.models.base import KubeDataset

    def host(self, data, labels):
        return {"x": np.asarray(data).astype(np.float32) / 255.0,
                "y": np.asarray(labels)}

    base = RefDataset if key == "ref" else KubeDataset
    return type("Images", (base,), {"transform_train": host,
                                    "transform_test": host})("images")


def test_resnet_job_publishes_the_references_cost(tmp_home):
    """A narrow ResNet job (params and batch_stats, host-staged rounds)
    over two epochs, warm-started from one JAX checkpoint: every
    MetricUpdate carries the reference's jit_compiles and cost_programs,
    the batch_stats bytes inside the records."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train import job as ref_job
    from kubeml_tpu.train.checkpoint import save_checkpoint as ref_save
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.train import job as port_job

    rng = np.random.default_rng(0)

    def split(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = rng.integers(0, 160, (n, 16, 16, 3))
        x[..., 0] += 9 * y[:, None, None]
        return x.astype(np.uint8), y
    DatasetRegistry().create("images", *split(48), *split(16))
    jmodel, tmodel = _resnet_models()
    variables = jax.jit(lambda k: jmodel.module.init(
        k, jnp.zeros((1, 16, 16, 3)), train=False))(jax.random.PRNGKey(1))
    ref_save("seed", jax.tree_util.tree_map(np.asarray, variables),
             {"model": "resnet-narrow", "function": "resnet-narrow"})
    pubs = {"ref": [], "port": []}
    for key, pkg, run in (("ref", "kubeml_tpu", lambda t, cb: ref_job.TrainJob(
            t, jmodel, _images("ref"), make_mesh(n_data=1),
            callbacks=cb).train()),
            ("port", "kubeml_tpu_torch", lambda t, cb: port_job.TrainJob(
                t, tmodel, _images("port"), device="cpu",
                callbacks=cb).train())):
        types = __import__(f"{pkg}.api.types", fromlist=["TrainTask"])
        job = __import__(f"{pkg}.train.job", fromlist=["JobCallbacks"])
        req = types.TrainRequest(
            model_type="resnet-narrow", batch_size=8, epochs=2,
            dataset="images", lr=0.1, resume_from="seed",
            options=types.TrainOptions(default_parallelism=2,
                                       static_parallelism=True, k=2,
                                       device_cache="off"))
        run(types.TrainTask(job_id=f"{key}-r", parameters=req,
                            parallelism=2),
            job.JobCallbacks(publish_metrics=pubs[key].append))
    assert len(pubs["port"]) == len(pubs["ref"]) == 2
    for m, rm in zip(pubs["port"], pubs["ref"]):
        assert m.jit_compiles == rm.jit_compiles
        assert json.dumps(m.cost_programs) == json.dumps(rm.cost_programs)
        assert m.hbm_peak_bytes > 0 and m.hbm_in_use_bytes > 0
    train = pubs["port"][-1].cost_programs["kavg.train"]
    nbytes = sum(int(np.asarray(v).nbytes)
                 for v in jax.tree_util.tree_leaves(variables))
    assert train["hbm_bytes"] == float(3 * nbytes) + \
        pubs["port"][-1].cost_programs["merge.monolithic"]["hbm_bytes"]
    assert "batch_stats" in variables


# ----------------------------------------------------- the serve engine

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)


@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_decode_engine_ledger_equals_the_references(pages):
    """One staggered batch (a prefix hit, chunked prefill, decode): the
    engines' ledgers are equal (pager.decode_kv reconciled exactly, the
    serve.prefill and serve.decode fallbacks, dispatches and tokens), and
    so are the compile trackers."""
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    params = random_flax_params(**NANO, seed=4)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if pages == "bf16"
                else (jnp.float32, torch.float32))
    kv = "f32" if pages == "bf16" else "int8"
    jm = JaxGPT(**NANO, dropout=0.0, dtype=jdt)
    tm = GPTModule(**NANO, dtype=tdt, device="cpu")
    sd = params_from_flax(params)
    kw = dict(slots=4, page=8, prefill_chunk=8, kv_dtype=kv)
    engines = {"ref": (JaxEngine(jm, {"params": params}, **kw), JaxRequest),
               "port": (DecodeEngine(tm, sd, device="cpu", **kw),
                        GenerateRequest)}
    for eng, req in engines.values():
        shared = list(range(5, 21))
        for p, n in ((shared, 6), ([40, 41, 42], 10),
                     (list(range(100, 127)), 9)):
            eng.attach(req(list(p), max_new_tokens=n))
        for _ in range(4):
            eng.step()
        eng.attach(req(list(shared), max_new_tokens=6))
        while eng.active():
            eng.step()
    (jeng, _), (teng, _) = engines["ref"], engines["port"]
    want, got = jeng.ledger.snapshot(), teng.ledger.snapshot()
    assert json.dumps(got) == json.dumps(want)
    assert got["pager.decode_kv"]["hbm_bytes"] == \
        float(teng.slab.decode_bytes_per_token)
    assert got["serve.decode"]["tokens"] == teng.stats["generated_tokens"]
    assert (got["serve.decode"]["dispatches"],
            got["serve.prefill"]["dispatches"]) == \
        (teng.stats["dispatches"], teng.stats["prefill_dispatches"])
    t, j = teng.compile_tracker, jeng.compile_tracker
    assert (t.compiles, t.dispatches, t.storms) == \
        (j.compiles, j.dispatches, j.storms) == (2, t.dispatches, 0)
    teng.ledger.replay_check()
    # a recovered engine starts a fresh ledger, as the reference's restart
    fresh = teng.spawn_recovered().ledger.snapshot()
    assert list(fresh) == ["pager.decode_kv"]


# ----------------------------------------------------------- deployments

JOB = dict(model_type="mlp", batch_size=32, epochs=2, dataset="blobs",
           lr=0.1)
OPTS = dict(default_parallelism=2, static_parallelism=True, k=2,
            device_cache="off", rounds_per_dispatch=2)


def _blobs(tmp):
    rng = np.random.RandomState(0)
    paths = []
    for name, n in (("xtr", 320), ("xte", 64)):
        y = rng.randint(0, 3, n).astype(np.int32)
        x = rng.randn(n, 8).astype(np.float32) * 1.5
        x[np.arange(n), y * 2] += 3.0
        for suffix, arr in ((name, x), ("y" + name[1:], y)):
            paths.append(os.path.join(tmp, f"{suffix}.npy"))
            np.save(paths[-1], arr)
    return [paths[0], paths[1], paths[2], paths[3]]


def _wait_cost(url, job_id, dep, timeout=180):
    """The job's cost document once its history is written."""
    from kubeml_tpu_torch.control.httpd import http_json

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if dep.ps.wait_for_job(job_id, timeout=0.5):
            try:
                http_json("GET", f"{url}/history/{job_id}")
                return http_json("GET", f"{url}/cost/{job_id}")
            except Exception as e:  # noqa: BLE001 — either package's error
                if getattr(e, "status_code", None) != 404:
                    raise
    raise TimeoutError(job_id)


def _series(lines, family, program):
    """The value of one kubeml_cost_* series (0 when it is absent)."""
    for ln in lines:
        if ln.startswith(family + "{") and f'program="{program}"' in ln:
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def _prom_lines(url):
    text = urllib.request.urlopen(f"{url}/metrics").read().decode()
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(("kubeml_cost_",
                                    "kubeml_jit_compiles_total")))


@pytest.fixture(scope="module")
def deployments(tmp_path_factory):
    """One mlp job (grouped dispatch, 2 epochs) through a JAX deployment,
    a threaded port deployment and a port deployment whose PS runs it in
    a job-server child: {key: (deployment, job id, /cost document)}."""
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu.control.client import KubemlClient as RefClient
    from kubeml_tpu.control.deployment import start_deployment as ref_start
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.api import types
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    tmp = str(tmp_path_factory.mktemp("ledger"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEML_TPU_HOME", os.path.join(tmp, "home"))
        mp.setenv("KUBEML_COST_LEDGER", "0")
        deps = {"ref": ref_start(mesh=make_mesh(n_data=1)),
                "port": start_deployment(device="cpu"),
                "child": start_deployment(device="cpu",
                                          standalone_jobs=True)}
        try:
            KubemlClient(deps["port"].controller_url).v1().datasets() \
                .create("blobs", *_blobs(tmp))
            out = {}
            for key, dep in deps.items():
                t, C = (ref_types, RefClient) if key == "ref" \
                    else (types, KubemlClient)
                job_id = C(dep.controller_url).v1().networks().train(
                    t.TrainRequest(**JOB, options=t.TrainOptions(**OPTS)))
                out[key] = (dep, job_id,
                            _wait_cost(dep.controller_url, job_id, dep))
            yield out
        finally:
            for dep in deps.values():
                dep.stop()


def test_cost_documents_equal_the_references(deployments):
    """The controller's /cost/{jobId} and the PS's /cost?id= give the
    reference's document (but the id) for a threaded job, and a
    job-server child's (posted through POST /metrics) equals the threaded
    job's."""
    from kubeml_tpu_torch.control.httpd import http_json

    docs = {}
    for key, (dep, job_id, doc) in deployments.items():
        assert http_json("GET", f"{dep.ps.url}/cost?id={job_id}") == doc
        assert doc.pop("id") == job_id
        docs[key] = doc
    assert docs["port"] == docs["ref"]
    assert docs["child"] == docs["port"]
    progs = docs["port"]["programs"]
    # grouped dispatches, an epoch's tail round on its own, every sample
    # once an epoch
    assert {"kavg.train_multi", "kavg.train", "kavg.eval",
            "merge.monolithic"} <= set(progs)
    assert sum(e["samples"] for p, e in progs.items()
               if p.startswith("kavg.train")) == 2 * 320
    assert progs["kavg.eval"]["dispatches"] == 2


def test_cost_and_compile_lines_equal_the_references(deployments):
    """One job per PS: the kubeml_cost_* and kubeml_jit_compiles_total
    lines of the port's /metrics equal the reference's, and agree with
    the cost document."""
    lines = {k: [ln.replace(v[1], "J") for ln in _prom_lines(v[0].ps.url)]
             for k, v in deployments.items() if k != "child"}
    assert lines["port"] == lines["ref"]
    doc = deployments["port"][2]["programs"]
    for program, e in doc.items():
        assert _series(lines["port"], "kubeml_cost_dispatches_total",
                       program) == e["dispatches"]
        assert _series(lines["port"], "kubeml_cost_hbm_bytes_total",
                       program) == e["hbm_bytes_total"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_cost_verb_json_equals_across_packages(deployments, capsys, pkg):
    """``kubeml cost --id J --json`` of either package's CLI prints the
    same document for the port's job as for the reference's job."""
    import importlib

    main = importlib.import_module(
        "kubeml_tpu.cli.main" if pkg == "ref"
        else "kubeml_tpu_torch.cli.main").main
    outs = []
    for key in ("ref", "port"):
        dep, job_id, _ = deployments[key]
        capsys.readouterr()
        main(["--controller", dep.controller_url, "cost", "--id", job_id,
              "--json"])
        outs.append(capsys.readouterr().out.replace(job_id, "J"))
    assert outs[0] == outs[1]
    assert json.loads(outs[1])["programs"]["merge.monolithic"]["source"] \
        == "analytic"


def test_serving_cost_equals_the_references(tmp_path, monkeypatch):
    """The same gpt-nano requests through both packages' PS: /cost?id=
    serve:<model> is the reference's document and the kubeml_cost_*
    serve lines agree once the fleets have published their last step."""
    from kubeml_tpu.control.ps import ParameterServer as RefPS
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.control.ps import ParameterServer
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    monkeypatch.setenv("KUBEML_TPU_HOME", str(tmp_path / "home"))
    save_checkpoint("costnano", {"params": random_flax_params(**NANO,
                                                              seed=5)},
                    {"model": "gpt-nano", "function": "gpt-nano"})
    pss = {"ref": RefPS(serve_slots=2, serve_queue_depth=4),
           "port": ParameterServer(device="cpu", serve_slots=2,
                                   serve_queue_depth=4)}
    docs, lines = {}, {}
    try:
        for key, ps in pss.items():
            ps.start()
            for prompt in ([5, 6, 7, 8, 9], list(range(20, 41)), [3]):
                http_json("POST", f"{ps.url}/generate",
                          {"model_id": "costnano", "prompt": prompt,
                           "max_new_tokens": 5, "stream": False})
            doc = http_json("GET", f"{ps.url}/cost?id=serve:costnano")
            want = doc["programs"]["serve.decode"]["dispatches"]
            deadline = time.monotonic() + 30
            while True:      # the fleet publishes after its last step
                got = _prom_lines(ps.url)
                if _series(got, "kubeml_cost_dispatches_total",
                           "serve.decode") == want \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            docs[key], lines[key] = doc, got
    finally:
        for ps in pss.values():
            ps.stop()
    assert docs["port"] == docs["ref"]
    progs = docs["port"]["programs"]
    assert list(progs)[0] == "pager.decode_kv"
    assert progs["serve.decode"]["tokens"] == 15
    assert lines["port"] == lines["ref"]
    assert any('program="serve.decode"' in ln for ln in lines["port"])
