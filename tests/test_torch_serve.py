"""Port parity: kubeml_tpu_torch's serving plane against the JAX package's.

A whole-engine lifecycle (joins, leaves, a prefix-cache hit and a
copy-on-write split, mirroring tests/test_decode_bw.py's staggered run)
must give the JAX DecodeEngine's greedy tokens token for token and the
same scheduler counters, at gpt-nano widths in float32. The page
allocator is a copy of the reference's and must replay the same
decisions; the service answers requests on the CPU; and no module of the
port (nor chip_smoke.py) may import JAX or the JAX package.

Sampled decoding is compared within the port only: jax.random's
threefry stream cannot be reproduced in torch.
"""

import ast
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent
NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)


def _models(seed=4):
    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule

    params = random_flax_params(**NANO, seed=seed)
    jm = JaxGPT(**NANO, dropout=0.0, dtype=jnp.float32)
    tm = GPTModule(**NANO, dtype=torch.float32, device="cpu")
    sd = params_from_flax(params)
    tm.load_state_dict(sd)
    return jm, tm, params, sd


def _drive(engine, limit=10_000):
    while engine.active():
        engine.step()
        limit -= 1
        assert limit > 0, "engine failed to drain"


def _staggered_run(engine, request_cls):
    """Joins, leaves, mixed prompt lengths, a prefix-cache hit over two
    shared pages, and a CoW split when the hit's first token writes into
    a shared page. Greedy only (cross-framework comparable)."""
    shared = list(range(5, 21))                    # 16 tokens = 2 pages
    a = request_cls(list(shared), max_new_tokens=6, temperature=0.0)
    b = request_cls(list(range(40, 43)), max_new_tokens=10, temperature=0.0)
    d = request_cls(list(range(100, 127)), max_new_tokens=9,
                    temperature=0.0)
    engine.attach(a)
    engine.attach(b)
    engine.attach(d)
    for _ in range(4):                              # join mid-flight
        engine.step()
    c = request_cls(list(shared), max_new_tokens=6, temperature=0.0)
    engine.attach(c)
    _drive(engine)
    return [a, b, d, c]


def test_engine_lifecycle_matches_jax_engine():
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    jm, tm, params, sd = _models()
    kw = dict(slots=4, page=8, prefill_chunk=8)
    j_eng = JaxEngine(jm, {"params": params}, **kw)
    t_eng = DecodeEngine(tm, sd, device="cpu", **kw)
    j_reqs = _staggered_run(j_eng, JaxRequest)
    t_reqs = _staggered_run(t_eng, GenerateRequest)
    assert all(r.outcome == "ok" for r in j_reqs + t_reqs)
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.tokens == jr.tokens
        assert len(tr.tokens) == tr.max_new_tokens
    assert t_eng.stats["prefix_hits"] > 0
    assert t_eng.stats["cow_splits"] >= 1
    for stat in ("prefix_hits", "prefix_misses", "cow_splits",
                 "prefill_dispatches", "prefill_tokens", "dispatches",
                 "generated_tokens", "decode_tokens", "kv_bytes"):
        assert t_eng.stats[stat] == j_eng.stats[stat], stat
    assert t_eng.pager.in_use == j_eng.pager.in_use == 0
    assert t_eng.pager.cached_pages == j_eng.pager.cached_pages
    t_eng.check_pager()


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_decode_bytes_per_token_equals_jax(kv_dtype):
    from kubeml_tpu.serve.pager import KVPageSlab as JaxSlab
    from kubeml_tpu.serve.pager import PageGeometry as JaxGeom
    from kubeml_tpu_torch.serve.pager import KVPageSlab, PageGeometry

    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        for slots, page, max_len in ((4, 8, 64), (8, 16, 512)):
            js = JaxSlab(JaxGeom.for_module(slots, page, max_len), 2, 2, 16,
                         dt_j, kv_dtype=kv_dtype)
            ts = KVPageSlab(PageGeometry.for_module(slots, page, max_len),
                            2, 2, 16, dt_t, torch.device("cpu"),
                            kv_dtype=kv_dtype)
            assert ts.decode_bytes_per_token == js.decode_bytes_per_token
            assert ts.device_bytes == js.device_bytes


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_solo_equals_batched_tokens(kv_dtype):
    """Row independence within the port: greedy and sampled streams get
    the same tokens alone as packed with neighbours (per-(seed, position)
    sampling generators, disjoint writable pages, per-page scales)."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    _, tm, _, sd = _models(seed=6)
    specs = [([5, 6, 7, 8, 9], 6, 0.0, 0), ([9, 10, 11, 12], 8, 0.7, 1),
             ([3, 4], 4, 1.3, 7), (list(range(30, 52)), 5, 0.0, 2)]

    def make():
        return [GenerateRequest(list(p), max_new_tokens=n, temperature=t,
                                seed=s) for p, n, t, s in specs]

    packed = DecodeEngine(tm, sd, slots=4, page=8, prefill_chunk=8,
                          kv_dtype=kv_dtype, device="cpu")
    reqs_packed = make()
    for r in reqs_packed:
        packed.attach(r)
    _drive(packed)
    alone = DecodeEngine(tm, sd, slots=4, page=8, prefill_chunk=8,
                         kv_dtype=kv_dtype, device="cpu")
    reqs_alone = make()
    for r in reqs_alone:
        alone.attach(r)
        _drive(alone)
    assert all(r.outcome == "ok" for r in reqs_packed + reqs_alone)
    for a, b in zip(reqs_packed, reqs_alone):
        assert a.tokens == b.tokens
        assert 0 not in a.tokens            # never emits PAD


def test_page_allocator_replays_reference_decisions():
    """The port's allocator is a copy of the reference's: the same
    sequence of alloc/free/register/lookup/evict operations gives the
    same page ids, refcounts, free list and audit results."""
    from kubeml_tpu.serve.pager import PageAllocator as JaxAllocator
    from kubeml_tpu.serve.pager import PageGeometry as JaxGeom
    from kubeml_tpu_torch.serve.pager import (PageAllocator, PageGeometry,
                                              chain_hash, routing_digest)
    from kubeml_tpu.serve import pager as jax_pager

    assert chain_hash(b"", [1, 2, 3]) == jax_pager.chain_hash(b"", [1, 2, 3])
    assert routing_digest([4, 5, 6, 7, 8], 4) == \
        jax_pager.routing_digest([4, 5, 6, 7, 8], 4)
    geom = dict(slots=2, page=4, pages=9, pages_per_slot=4)
    ja, ta = JaxAllocator(JaxGeom(**geom)), PageAllocator(PageGeometry(**geom))
    rng = np.random.default_rng(0)
    held = []
    for _ in range(300):
        op = rng.integers(0, 5)
        if op == 0:
            pj, pt = ja.alloc(), ta.alloc()
            assert pj == pt
            if pt is not None:
                held.append(pt)
        elif op == 1 and held:
            pid = held.pop(int(rng.integers(0, len(held))))
            ja.free([pid])
            ta.free([pid])
        elif op == 2 and held:
            pid = held[int(rng.integers(0, len(held)))]
            digest = chain_hash(b"", [int(rng.integers(0, 3))])
            assert ja.register_prefix(pid, digest) == \
                ta.register_prefix(pid, digest)
        elif op == 3:
            digest = chain_hash(b"", [int(rng.integers(0, 3))])
            pj, pt = ja.lookup_prefix(digest), ta.lookup_prefix(digest)
            assert pj == pt
            if pt is not None:
                held.append(pt)
        elif op == 4 and rng.integers(0, 10) == 0:
            assert ja.drop_generation(0) == ta.drop_generation(0)
        assert ta._free == ja._free and ta._refs == ja._refs
        assert list(ta._lru) == list(ja._lru)
        assert ta.check_invariants() == ja.check_invariants() == []
    assert ta.evictions == ja.evictions
    with pytest.raises(ValueError, match="double free"):
        ta.free([held[0]] * (ta.refcount(held[0]) + 1))


def test_service_answers_requests_on_cpu():
    from kubeml_tpu_torch.models.base import InferenceInputError
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.service import ServeService
    from kubeml_tpu_torch.serve.slots import ServeSaturated

    _, tm, _, sd = _models()
    engine = DecodeEngine(tm, sd, slots=2, page=8, prefill_chunk=8,
                          device="cpu")
    svc = ServeService("gpt-nano", engine, max_queue=2).start()
    try:
        reqs = [svc.submit(list(range(3, 3 + n)), max_new_tokens=5)
                for n in (1, 9, 20, 17)]
        with pytest.raises(ServeSaturated):
            svc.submit([5, 6], max_new_tokens=5)   # 2 slots + 2 queued
        with pytest.raises(InferenceInputError):
            svc.submit([0, 0], max_new_tokens=5)   # all-pad prompt
        with pytest.raises(InferenceInputError):
            svc.submit([5], max_new_tokens=5, deadline_ms=-1)
        for r in reqs:
            assert r.wait(60), "request never finished"
        assert [r.outcome for r in reqs] == ["ok"] * 4
        assert all(len(r.tokens) == 5 for r in reqs)
        assert all(r.first_token_at >= r.submitted_at for r in reqs)
        events = list(reqs[0].events_iter(timeout=1))
        assert events[-1] == {"done": True, "tokens": reqs[0].tokens}
        # r.wait() returns when the engine finishes the request; the loop
        # thread accounts it just after, so wait for the counter
        deadline = time.monotonic() + 5.0
        while svc.inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.rejected_total == 1 and svc.inflight == 0
        # the service's answer is the engine's answer for the same request
        solo = DecodeEngine(tm, sd, slots=2, page=8, prefill_chunk=8,
                            device="cpu")
        from kubeml_tpu_torch.serve.slots import GenerateRequest
        ref = GenerateRequest(list(range(3, 23)), max_new_tokens=5)
        solo.attach(ref)
        _drive(solo)
        assert ref.tokens == reqs[2].tokens
    finally:
        svc.stop()
    with pytest.raises(ServeSaturated, match="stopped"):
        svc.submit([5], max_new_tokens=2)


def test_engine_defaults_to_cuda():
    """DecodeEngine(device=None) means CUDA: where none exists it raises
    rather than running on the CPU; asking for the kernel on the CPU and
    an unknown attn_impl are refused."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine

    _, tm, _, sd = _models()
    with pytest.raises(ValueError, match="attn_impl"):
        DecodeEngine(tm, sd, device="cpu", attn_impl="gather")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        DecodeEngine(tm, sd, device="cpu", attn_impl="kernel")
    DecodeEngine(tm, sd, device="cpu", attn_impl="plain")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="module lives on"):
            DecodeEngine(tm, sd)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(tm, sd)


def _port_sources():
    pkg = REPO / "kubeml_tpu_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts)
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX, flax, optax
    or the JAX package — checked on the source text, then by importing
    every port module in a fresh interpreter."""
    banned = ("jax", "jaxlib", "flax", "optax", "kubeml_tpu")
    files = _port_sources()
    assert len(files) > 10
    # the kubeml CLI is checked with the rest
    assert {"main.py", "__main__.py", "__init__.py"} <= {
        p.name for p in files if p.parent.name == "cli"}
    # and the allocator and the journal, the port's own copies
    assert {"cluster.py", "journal.py", "scheduler.py", "ps.py"} <= {
        p.name for p in files if p.parent.name == "control"}
    # and the text classifiers, vgg11 and the MoE routing
    assert {"bert.py", "lstm.py", "vgg.py"} <= {
        p.name for p in files if p.parent.name == "models"}
    # and the process-group runtime, its ring, sequence parallelism, the
    # tensor-parallel rule table and layers, and the pipeline
    assert {"ep.py", "distributed.py", "collectives.py", "ring_attention.py",
            "ulysses.py", "tp.py", "manual.py", "pp.py"} <= {
        p.name for p in files if p.parent.name == "parallel"}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, \
                    f"{path.relative_to(REPO)} imports {name}"
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in files if p.parent.name != "" and p.name != "chip_smoke.py"]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{banned!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
