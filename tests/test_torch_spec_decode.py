"""Port parity: multi-step and speculative decode (kubeml_tpu_torch's
twins of tests/test_spec_decode.py).

  * 'multi_step' — K decode steps per call give the tokens of K single
    calls bit for bit, and the same KV bytes, inside the port; greedy
    tokens and the scheduler's counters equal the JAX engine's.
  * 'spec_verify' — a draft's proposals, verified by the target in one
    call, change no token: greedy streams and the verify counters equal
    the JAX engine's, sampled streams equal the port's single step.
  * 'spec_rollback' — rejected proposals leave the pager (free-list order,
    refcounts) and the held pages' int8 bytes and scales exactly where a
    run that never proposed leaves them, and where the JAX engine does.

Both packages run gpt-nano widths in float32 from one seeded flax
parameter tree. Tokens, counters, pager state and bytes are compared
exactly; no float crosses the frameworks in these tests except through
greedy argmax picks. Sampled decoding is compared within the port only:
jax.random's threefry stream cannot be reproduced in torch.
"""

import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)
MINI = dict(vocab_size=8192, max_len=512, hidden=256, layers=4, heads=4,
            ffn=1024)

# greedy + two sampled lanes; 7 new tokens is not a multiple of any
# tested K, so the budget mask trims the last window
SPECS = [([5, 6, 7], 6, 0.0, 0),
         ([9, 10, 11, 12], 8, 0.7, 1),
         ([3], 7, 1.3, 7)]
GREEDY = [([5, 6, 7], 6, 0.0, 0),
          ([9, 10, 11, 12], 8, 0.0, 1),
          (list(range(20, 31)), 9, 0.0, 7)]


def _port(seed, dims=NANO, dtype=torch.float32, device="cpu"):
    """(module, state dict) of the port's GPT from the seeded flax tree."""
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule

    sd = params_from_flax(random_flax_params(**dims, seed=seed))
    module = GPTModule(**dims, dtype=dtype, device=device)
    module.load_state_dict(sd)
    return module, module.state_dict()


def _ref(seed):
    """(module, variables) of the JAX package's GPT from the same tree."""
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.convert import random_flax_params

    return (JaxGPT(**NANO, dropout=0.0, dtype=jnp.float32),
            {"params": random_flax_params(**NANO, seed=seed)})


def _drive(engine, limit=10_000):
    while engine.active():
        engine.step()
        limit -= 1
        assert limit > 0, "engine failed to drain"


def _requests(request_cls, specs=SPECS, eos=None):
    return [request_cls(list(p), max_new_tokens=n, temperature=t, seed=s,
                        eos_id=eos) for p, n, t, s in specs]


def _contexts(engine):
    """Capture every request's KV context as its slot is freed: per
    written position the K/V rows of every layer and the validity, and
    the per-page int8 scales — the slab as the request saw it, whatever
    page ids the allocator handed out."""
    got = {}
    free_slot = engine._free_slot

    def capture(s):
        slot = engine._slots[s]
        G = engine.geom.page
        pos = torch.arange(slot.pos)
        pages = torch.from_numpy(engine._tables[s].astype(np.int64))
        pid, off = pages[pos // G], pos % G
        held = pages[:-(-slot.pos // G)]
        slab = engine.slab
        got[slot.req.rid] = [slab.k[:, pid, off].clone(),
                             slab.v[:, pid, off].clone(),
                             slab.valid[pid, off].clone(),
                             slab.k_scale[:, held].clone(),
                             slab.v_scale[:, held].clone()]
        return free_slot(s)

    engine._free_slot = capture
    return got


def _run_port(module, sd, specs=SPECS, eos=None, engine_kw=None, **kw):
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    eng = DecodeEngine(module, sd, device=module.device,
                       **dict(dict(slots=4, page=8, prefill_chunk=8),
                              **(engine_kw or {})), **kw)
    ctx = _contexts(eng)
    reqs = _requests(GenerateRequest, specs, eos)
    for r in reqs:
        eng.attach(r)
    _drive(eng)
    eng.check_pager()
    return eng, [r.tokens for r in reqs], [ctx[r.rid] for r in reqs]


def _run_ref(module, variables, specs=GREEDY, eos=None, **kw):
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest

    eng = JaxEngine(module, variables, slots=4, page=8, prefill_chunk=8,
                    **kw)
    reqs = _requests(JaxRequest, specs, eos)
    for r in reqs:
        eng.attach(r)
    _drive(eng)
    return eng, [list(map(int, r.tokens)) for r in reqs]


def _same_slabs(a, b):
    for ra, rb in zip(a, b):
        for ta, tb in zip(ra, rb):
            assert torch.equal(ta, tb)


# ------------------------------------------------------------- multi-step
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_multi_step_equals_single_step_bit_for_bit(K, kv_dtype):
    """'multi_step': greedy and sampled lanes, concurrent slots, budgets
    not divisible by K — the same tokens and the same KV bytes (and int8
    scales) as K single calls, in fewer calls."""
    module, sd = _port(0)
    base, base_toks, base_ctx = _run_port(module, sd, kv_dtype=kv_dtype)
    eng, toks, ctx = _run_port(module, sd, kv_dtype=kv_dtype,
                               decode_steps=K)
    assert toks == base_toks
    _same_slabs(ctx, base_ctx)
    assert eng.stats["multi_step_dispatches"] > 0
    assert eng.stats["multi_step_compiles"] == 1
    assert eng.stats["generated_tokens"] == base.stats["generated_tokens"]
    assert eng.stats["dispatches"] < base.stats["dispatches"]
    assert eng.stats["kv_bytes"] == \
        eng.stats["decode_tokens"] * eng.kv_bytes_per_token


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_multi_step_mid_stream_eos_and_budget(kv_dtype):
    """A lane that hits EOS inside a call goes dead as data, a lane whose
    budget ends inside a call stops there: tokens and KV bytes still
    equal the single step's, and no page of the unused window leaks."""
    module, sd = _port(0)
    _, probe, _ = _run_port(module, sd, specs=GREEDY, kv_dtype=kv_dtype)
    eos = probe[0][2]
    base, base_toks, base_ctx = _run_port(module, sd, specs=SPECS, eos=eos,
                                          kv_dtype=kv_dtype)
    # the greedy lane stops at the EOS mid-stream
    assert len(base_toks[0]) < SPECS[0][1]
    for K in (3, 4):
        eng, toks, ctx = _run_port(module, sd, specs=SPECS, eos=eos,
                                   kv_dtype=kv_dtype, decode_steps=K)
        assert toks == base_toks
        _same_slabs(ctx, base_ctx)
        assert eng.pager.in_use == base.pager.in_use == 0


def test_multi_step_matches_the_reference_engine():
    """The port's multi-step engine against the JAX engine's on the same
    converted weights and greedy requests: tokens, scheduler counters and
    dispatches per token, exactly."""
    module, sd = _port(0)
    jm, jv = _ref(0)
    for K in (2, 4):
        jeng, jtoks = _run_ref(jm, jv, decode_steps=K)
        teng, ttoks, _ = _run_port(module, sd, specs=GREEDY,
                                   decode_steps=K)
        assert ttoks == jtoks
        for stat in ("dispatches", "multi_step_dispatches",
                     "generated_tokens", "decode_tokens", "kv_bytes",
                     "prefill_dispatches"):
            assert teng.stats[stat] == jeng.stats[stat], stat
        assert teng.dispatches_per_token == jeng.dispatches_per_token


def test_multi_step_hot_swap_falls_back_like_the_reference():
    """A hot swap mid-stream leaves two weight generations resident: the
    engine takes the single step until the old one drains, with the
    reference's tokens and counters."""
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    module, sd = _port(0)
    _, sd2 = _port(1)
    jm, jv = _ref(0)
    _, jv2 = _ref(1)

    def lifecycle(eng, req_cls, new_weights):
        a = req_cls([5, 6, 7, 8], max_new_tokens=12, temperature=0.0)
        eng.attach(a)
        for _ in range(3):
            eng.step()
        eng.install_weights(new_weights)
        b = req_cls([9, 10, 11], max_new_tokens=8, temperature=0.0)
        eng.attach(b)
        _drive(eng)
        return [list(map(int, a.tokens)), list(map(int, b.tokens))]

    kw = dict(slots=4, page=8, prefill_chunk=8, decode_steps=4)
    teng = DecodeEngine(module, sd, device="cpu", **kw)
    jeng = JaxEngine(jm, jv, **kw)
    assert lifecycle(teng, GenerateRequest, sd2) == \
        lifecycle(jeng, JaxRequest, jv2)
    base = DecodeEngine(module, sd, device="cpu", slots=4, page=8,
                        prefill_chunk=8)
    assert lifecycle(base, GenerateRequest, sd2) == \
        lifecycle(DecodeEngine(module, sd, device="cpu", **kw),
                  GenerateRequest, sd2)
    assert teng.stats["generations_retired"] >= 1
    assert teng.stats["dispatches"] > teng.stats["multi_step_dispatches"]
    for stat in ("dispatches", "multi_step_dispatches", "generated_tokens",
                 "generations_retired"):
        assert teng.stats[stat] == jeng.stats[stat], stat
    assert teng.stats["multi_step_compiles"] == 1
    teng.check_pager()


# ------------------------------------------------------ speculative decode
@pytest.mark.parametrize("draft", ["self", "disagreeing"])
def test_spec_greedy_matches_the_reference_engine(draft):
    """'spec_verify' greedy: a self-draft and a draft of another seed both
    leave the tokens of the single step; the verify counters (draft,
    accepted, rejected) equal the JAX engine's on the same weights."""
    module, sd = _port(0)
    jm, jv = _ref(0)
    seed = 0 if draft == "self" else 3
    dm, dsd = _port(seed)
    jdm, jdv = _ref(seed)
    _, base_toks, _ = _run_port(module, sd, specs=GREEDY)
    teng, toks, _ = _run_port(module, sd, specs=GREEDY, draft_module=dm,
                              draft_variables=dsd)
    jeng, jtoks = _run_ref(jm, jv, draft_module=jdm, draft_variables=jdv)
    assert toks == base_toks == jtoks
    for stat in ("dispatches", "verify_dispatches", "draft_tokens",
                 "accepted_tokens", "rejected_tokens", "generated_tokens",
                 "decode_tokens", "kv_bytes"):
        assert teng.stats[stat] == jeng.stats[stat], stat
    assert teng.stats["verify_dispatches"] > 0
    assert teng.accepted_per_dispatch == jeng.accepted_per_dispatch
    if draft == "self":
        assert teng.accepted_per_dispatch > 1.0
        assert teng.dispatches_per_token < 1.0
    else:
        assert teng.stats["rejected_tokens"] > 0


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("draft", ["self", "disagreeing"])
def test_spec_sampled_concurrent_equals_single_step(draft, kv_dtype):
    """Sampled lanes at three temperatures, packed: the emitted tokens
    are the target's picks under the (seed, position) keys, so they equal
    the single step's bit for bit at any acceptance, and so do the KV
    bytes the replay pass leaves."""
    module, sd = _port(0)
    dm, dsd = _port(0 if draft == "self" else 3)
    _, base_toks, base_ctx = _run_port(module, sd, kv_dtype=kv_dtype)
    eng, toks, ctx = _run_port(module, sd, kv_dtype=kv_dtype,
                               draft_module=dm, draft_variables=dsd)
    assert toks == base_toks
    _same_slabs(ctx, base_ctx)
    assert eng.stats["verify_dispatches"] > 0
    assert eng.stats["rejected_tokens"] <= eng.stats["draft_tokens"]
    assert eng.stats["accepted_tokens"] + eng.stats["rejected_tokens"] \
        >= eng.stats["draft_tokens"]


def test_spec_rollback_restores_pager_state_exactly():
    """'spec_rollback' with int8 pages and a disagreeing draft: after the
    drain, the free list (order included), the refcounts and the held
    pages' int8 bytes and scales equal the never-proposing engine's, and
    the pager equals the JAX engine's; a follow-up sampled stream decodes
    the same tokens from that state."""
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu.serve.slots import GenerateRequest as JaxRequest
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    module, sd = _port(0)
    dm, dsd = _port(9)
    jm, jv = _ref(0)
    jdm, jdv = _ref(9)

    def run_one(eng, req_cls):
        # 10 prompt tokens = one FULL page (prefix-cached after release)
        # and a partial one: held pages survive the drain
        req = req_cls(list(range(5, 15)), max_new_tokens=14,
                      temperature=0.0, seed=0)
        eng.attach(req)
        _drive(eng)
        return list(map(int, req.tokens))

    kw = dict(slots=2, page=8, prefill_chunk=8, kv_dtype="int8")
    base = DecodeEngine(module, sd, device="cpu", **kw)
    spec = DecodeEngine(module, sd, device="cpu", draft_module=dm,
                        draft_variables=dsd, **kw)
    ref = JaxEngine(jm, jv, draft_module=jdm, draft_variables=jdv, **kw)
    assert run_one(base, GenerateRequest) == run_one(
        spec, GenerateRequest) == run_one(ref, JaxRequest)
    assert spec.stats["rejected_tokens"] > 0     # rollback was exercised
    for stat in ("verify_dispatches", "accepted_tokens", "rejected_tokens"):
        assert spec.stats[stat] == ref.stats[stat], stat
    assert spec.pager._free == base.pager._free == ref.pager._free
    assert spec.pager._refs == base.pager._refs == ref.pager._refs
    assert np.array_equal(spec._tables, base._tables)
    assert np.array_equal(spec._tables, np.asarray(ref._tables))
    held = sorted(set(range(1, base.geom.pages)) - set(base.pager._free))
    assert held
    assert spec.slab.k.dtype == torch.int8
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(spec.slab, name)[:, held],
                           getattr(base.slab, name)[:, held]), name
    assert torch.equal(spec.slab.valid[held], base.slab.valid[held])
    # every page but the null one, free pages included: pass 1's writes
    # into pages the verify trim handed back are undone too
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(spec.slab, name)[:, 1:],
                           getattr(base.slab, name)[:, 1:]), name
    assert torch.equal(spec.slab.valid[1:], base.slab.valid[1:])
    nxt = [GenerateRequest([20, 21, 22], max_new_tokens=6, temperature=0.9,
                           seed=4) for _ in range(2)]
    for eng, r in zip((base, spec), nxt):
        eng.attach(r)
        _drive(eng)
        eng.check_pager()
    assert nxt[0].tokens == nxt[1].tokens


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("draft", ["self", "disagreeing"])
def test_spec_verify_call_leaves_the_slab_of_a_run_that_never_proposed(
        draft, kv_dtype):
    """One verify call on a filled slab, against the single step run on a
    copy of it for steps j <= accepted of each live lane (the tokens a
    run that never proposed feeds): every page but the null page 0 — K,
    V, scales and validity — is equal byte for byte. Pass 1 writes into
    the live slab, so this holds only if it restores each page it could
    write."""
    from kubeml_tpu_torch.models.gpt import (build_paged_decode_step,
                                             build_paged_prefill_step,
                                             build_paged_spec_verify_step,
                                             compute_params)
    from kubeml_tpu_torch.serve.pager import KVPageSlab, PageGeometry

    K, S, W = 4, 4, 64
    module, sd = _port(0)
    dm, dsd = (module, sd) if draft == "self" else _port(9)
    geom = PageGeometry.for_module(slots=S, page=8, max_len=W)
    slab = KVPageSlab(geom, module.layers, module.heads, module.head_dim,
                      module.dtype, torch.device("cpu"), kv_dtype)
    gen = torch.Generator().manual_seed(3)
    if kv_dtype == "int8":
        for t in (slab.k, slab.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        for t in (slab.k_scale, slab.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen) / 50)
    else:
        for t in (slab.k, slab.v):
            t.copy_(torch.randn(t.shape, generator=gen))
    slab.valid.copy_(torch.ones_like(slab.valid))
    rng = np.random.default_rng(3)
    Pmax = geom.pages_per_slot
    tables = (1 + np.arange(S * Pmax, dtype=np.int32)).reshape(S, Pmax)
    pos = np.array([5, 12, 7, 30])  # lanes 0, 1 reach a new page at j = 3, 4
    live = np.array([1, 1, 0, 1])
    window = rng.integers(1, module.vocab_size, (S, W))
    wlen = np.array([K + 1, K + 1, K + 1, 2])
    temps = np.zeros(S, np.float32)
    seeds = np.arange(S, dtype=np.uint32)
    params = compute_params(module, sd)
    # each lane's context before pos is its window's prefill; the rows
    # past it stay random (what pass 1 overwrites)
    prefill = build_paged_prefill_step(module, 8, kv_dtype)
    for s_ in range(S):
        for c in range(0, pos[s_], 8):
            p = np.arange(c, c + 8)
            inside = p < pos[s_]
            as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
            prefill(params, slab, as_t(np.where(inside, window[s_, p % W],
                                                0)),
                    as_t(np.where(inside, p, 0)),
                    torch.from_numpy(tables[s_]),
                    as_t(np.where(inside, tables[s_, p // 8 % Pmax], 0)),
                    as_t(np.where(inside, p % 8, 0)),
                    torch.from_numpy(inside.astype(np.float32)))
    verify = build_paged_spec_verify_step(module, dm, K, W, kv_dtype)
    step = build_paged_decode_step(module, kv_dtype)
    before = [t.clone() for t in (slab.k, slab.v, slab.k_scale,
                                  slab.v_scale, slab.valid)]
    picks, _, acc = verify(params, compute_params(dm, dsd), slab, window,
                           pos, tables, live, temps, seeds, wlen)
    acc = acc.numpy()
    got = [t.clone() for t in (slab.k, slab.v, slab.k_scale, slab.v_scale,
                               slab.valid)]
    for t, b in zip((slab.k, slab.v, slab.k_scale, slab.v_scale,
                     slab.valid), before):
        t.copy_(b)
    tables_t = torch.from_numpy(tables)
    zero = np.zeros(S, np.int64)
    for j in range(int(acc.max()) + 1):
        on = (live > 0) & (j <= acc)
        toks = window[np.arange(S), pos] if j == 0 else \
            picks[j - 1].numpy()
        p = pos + j
        page = np.where(on, tables[np.arange(S), p // 8], 0)
        as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
        step(params, slab, as_t(np.where(on, toks, 0)),
             as_t(np.where(on, p, 0)), tables_t, as_t(page),
             as_t(np.where(on, p % 8, 0)), torch.from_numpy(
                 on.astype(np.float32)), temps,
             np.stack([seeds, p.astype(np.uint32)], 1), as_t(zero),
             as_t(zero), torch.zeros(S))
    # a self-draft keeps every proposal up to each lane's wlen - 1; the
    # masked lane keeps none
    assert acc.tolist() == ([K, K, 0, 1] if draft == "self" else
                            [0, 0, 0, 0])
    want = (slab.k, slab.v, slab.k_scale, slab.v_scale, slab.valid)
    for name, g, w, b in zip(("k", "v", "k_scale", "v_scale", "valid"),
                             got, want, before):
        lead = g[1:] if name == "valid" else g[:, 1:]
        ref = w[1:] if name == "valid" else w[:, 1:]
        assert torch.equal(lead, ref), name
    assert not torch.equal(got[0], before[0])   # the call did write


def test_spec_window_bound_declines_to_multi_and_single_step():
    """A lane with pos + K + 1 > W makes verify decline: the multi-step
    program (or the single step) takes the round, tokens unchanged."""
    module, sd = _port(0)
    dm, dsd = _port(0, dims=dict(NANO, max_len=16))   # window 16
    specs = [(list(range(5, 15)), 12, 0.0, 0)]
    _, base_toks, _ = _run_port(module, sd, specs=specs)
    eng, toks, _ = _run_port(module, sd, specs=specs, draft_module=dm,
                             draft_variables=dsd, decode_steps=3)
    assert eng.spec_window == 16 and eng.spec_steps == 3
    assert toks == base_toks
    assert eng.stats["verify_dispatches"] > 0
    assert eng.stats["multi_step_dispatches"] > 0


# --------------------------------------------------------------- validation
@pytest.mark.parametrize("case", ["multi_steps", "decode_steps",
                                  "draft_variables", "vocab",
                                  "window_low", "window_high",
                                  "spec_steps"])
def test_programs_raise_the_references_errors(case):
    """The builders' and the engine's ValueErrors: same conditions, same
    words as the JAX package's."""
    import jax.numpy as jnp

    from kubeml_tpu.models import gpt as ref_gpt
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu_torch.models import gpt as port_gpt
    from kubeml_tpu_torch.serve.engine import DecodeEngine

    module, sd = _port(0)
    jm, jv = _ref(0)
    other, _ = _port(0, dims=dict(NANO, vocab_size=256))
    jother = ref_gpt.GPTModule(**dict(NANO, vocab_size=256), dropout=0.0,
                               dtype=jnp.float32)
    calls = {
        "multi_steps": (
            lambda: port_gpt.build_paged_multi_step_decode(module, 1),
            lambda: ref_gpt.build_paged_multi_step_decode(jm, 1)),
        "decode_steps": (
            lambda: DecodeEngine(module, sd, device="cpu", decode_steps=0),
            lambda: JaxEngine(jm, jv, decode_steps=0)),
        "draft_variables": (
            lambda: DecodeEngine(module, sd, device="cpu",
                                 draft_module=module),
            lambda: JaxEngine(jm, jv, draft_module=jm)),
        "vocab": (
            lambda: port_gpt.build_paged_spec_verify_step(module, other, 4,
                                                          16),
            lambda: ref_gpt.build_paged_spec_verify_step(jm, jother, 4, 16)),
        "window_low": (
            lambda: port_gpt.build_paged_spec_verify_step(module, module, 4,
                                                          1),
            lambda: ref_gpt.build_paged_spec_verify_step(jm, jm, 4, 1)),
        "window_high": (
            lambda: port_gpt.build_paged_spec_verify_step(
                module, module, 4, NANO["max_len"] + 1),
            lambda: ref_gpt.build_paged_spec_verify_step(
                jm, jm, 4, NANO["max_len"] + 1)),
        "spec_steps": (
            lambda: port_gpt.build_paged_spec_verify_step(module, module, 0,
                                                          16),
            lambda: ref_gpt.build_paged_spec_verify_step(jm, jm, 0, 16)),
    }
    port_call, ref_call = calls[case]
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_draft_must_be_a_gpt_module():
    from kubeml_tpu_torch.models.gpt import build_paged_spec_verify_step
    from kubeml_tpu_torch.models.mlp import MLPModule

    module, _ = _port(0)
    with pytest.raises(ValueError, match="dense GPT module"):
        build_paged_spec_verify_step(module, MLPModule(4, 8, 2,
                                                       device="cpu"), 4, 16)


# ------------------------------------------- ledger, flight, compile counts
@pytest.mark.parametrize("mode", ["multi", "spec"])
def test_ledger_and_flight_records_equal_the_references(mode):
    """With the closed-form records (KUBEML_COST_LEDGER=0), the
    serve.multi_step / serve.spec_verify records, their dispatch counts
    and tokens equal the JAX engine's; so do the flight records (kind,
    both dispatch lanes, tokens) and the compile trackers."""
    module, sd = _port(0)
    jm, jv = _ref(0)
    if mode == "multi":
        tkw = jkw = dict(decode_steps=4)
        program = "serve.multi_step"
    else:
        tkw = dict(draft_module=module, draft_variables=sd)
        jkw = dict(draft_module=jm, draft_variables=jv)
        program = "serve.spec_verify"
    teng, _, _ = _run_port(module, sd, specs=GREEDY, **tkw)
    jeng, _ = _run_ref(jm, jv, **jkw)
    want, got = jeng.ledger.snapshot(), teng.ledger.snapshot()
    assert json.dumps(got) == json.dumps(want)
    assert got[program]["dispatches"] == teng.stats[
        "multi_step_dispatches" if mode == "multi" else "verify_dispatches"]
    keys = ("kind", "prefill_dispatches", "decode_dispatches", "tokens",
            "active_slots", "kv_pages")
    assert [{k: r[k] for k in keys} for r in teng.flight.snapshot()] == \
        [{k: r[k] for k in keys} for r in jeng.flight.snapshot()]
    t, j = teng.compile_tracker, jeng.compile_tracker
    assert (t.compiles, t.dispatches) == (j.compiles, j.dispatches) == \
        (3, teng.stats["dispatches"] + teng.stats["prefill_dispatches"])


@pytest.mark.parametrize("mode", ["multi", "spec"])
def test_program_compile_counts_stay_pinned(mode):
    """A second wave of joins and leaves and a hot swap add dispatches
    but no compile: each accelerated program counts one."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    module, sd = _port(0)
    _, sd2 = _port(1)
    kw = dict(decode_steps=4) if mode == "multi" else dict(
        draft_module=module, draft_variables=sd)
    extra = "multi_step_compiles" if mode == "multi" else "verify_compiles"
    eng = DecodeEngine(module, sd, slots=4, page=8, prefill_chunk=8,
                       device="cpu", **kw)
    for wave in range(3):
        if wave == 2:
            eng.install_weights(sd2)
        for r in _requests(GenerateRequest):
            eng.attach(r)
        _drive(eng)
        assert eng.stats[extra] == 1
        assert eng.compile_tracker.compiles == 3
    assert eng.compile_tracker.dispatches == \
        eng.stats["dispatches"] + eng.stats["prefill_dispatches"]
    # a recovered engine keeps the programs (and recompiles, as the
    # reference's replacement does)
    rec = eng.spawn_recovered()
    assert (rec.decode_steps, rec.spec_steps, rec.spec_window,
            rec.draft_module) == (eng.decode_steps, eng.spec_steps,
                                  eng.spec_window, eng.draft_module)
    for r in _requests(GenerateRequest):
        rec.attach(r)
    _drive(rec)
    assert rec.stats[extra] == 1


# --------------------------------------------------- metrics and snapshots
def test_spec_counters_and_snapshot_equal_the_references():
    """The service publishes the draft, accepted and rejected deltas (no
    double count on a second publish): the three families' text equals
    the JAX package's service on the same engine counters, and so do the
    snapshot's two amortization ratios."""
    from kubeml_tpu.metrics.prom import MetricsRegistry as RefRegistry
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu.serve.service import ServeService as RefService
    from kubeml_tpu_torch.metrics.prom import MetricsRegistry
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.service import ServeService

    from test_torch_prom import _families

    module, sd = _port(0)
    jm, jv = _ref(0)
    out = []
    for svc_cls, reg_cls, eng in (
            (RefService, RefRegistry,
             JaxEngine(jm, jv, slots=2, page=8, draft_module=jm,
                       draft_variables=jv)),
            (ServeService, MetricsRegistry,
             DecodeEngine(module, sd, slots=2, page=8, device="cpu",
                          draft_module=module, draft_variables=sd))):
        reg = reg_cls()
        svc = svc_cls("m2", eng, max_queue=1, metrics=reg, supervise=False)
        eng.stats.update(draft_tokens=40, accepted_tokens=25,
                         rejected_tokens=15, generated_tokens=40,
                         dispatches=10, verify_dispatches=10)
        svc._publish()
        svc._publish()
        fams = _families(reg.exposition())
        snap = svc.snapshot()
        out.append(([fams[n] for n in (
            "kubeml_serve_draft_tokens_total",
            "kubeml_serve_accepted_tokens_total",
            "kubeml_serve_rejected_tokens_total")],
            snap["serve_dispatches_per_token"],
            snap["serve_accepted_per_dispatch"]))
    assert out[1] == out[0]
    assert out[1][2] == 2.5 and out[1][1] == 0.25
    assert 'kubeml_serve_accepted_tokens_total{model="m2"} 25' in \
        out[1][0][1]


def test_fleet_merges_amortization_from_counters():
    """The fleet's ratios come from the summed engine counters across
    replicas (the reference's formula), not from averaged ratios."""
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.fleet import ServeFleet
    from kubeml_tpu_torch.serve.service import ServeService

    module, sd = _port(0)

    def factory(index):
        engine = DecodeEngine(module, sd, slots=2, page=8, device="cpu")
        return ServeService("m1", engine, max_queue=2, supervise=False)

    fleet = ServeFleet("m1", factory, replicas_min=2, replicas_max=2,
                       autoscale_interval_s=0.0)
    fleet.start()
    try:
        engines = [svc.engine for svc in fleet._replicas.values()]
        engines[0].stats.update(dispatches=4, generated_tokens=16,
                                accepted_tokens=12, verify_dispatches=4)
        engines[1].stats.update(dispatches=6, generated_tokens=4,
                                accepted_tokens=0, verify_dispatches=0)
        snap = fleet.snapshot()
        assert snap["serve_dispatches_per_token"] == 0.5
        assert snap["serve_accepted_per_dispatch"] == 3.0
    finally:
        fleet.stop()


# ------------------------------------------------------------ knob threading
def _save(model_id, seed, tmp_home):
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(model_id, {"params": random_flax_params(**NANO,
                                                            seed=seed)},
                    {"model": "gpt-nano", "function": "gpt-nano"})


def _engines_of(ps, model_id):
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    fleet = ps._serve_service(model_id)
    # a request through the fleet runs the accelerated programs
    req = fleet.submit([5, 6, 7], max_new_tokens=6)
    assert req.wait(60) and req.outcome == "ok", req.error
    assert sum(e.stats["verify_dispatches"]
               for _, e in fleet.engines()) > 0
    return [(e.decode_steps, e.spec_steps, e.spec_window,
             e.draft_module is not None) for _, e in fleet.engines()]


@pytest.mark.parametrize("route", ["ps_kwargs", "env", "deployment",
                                   "cli_all", "cli_ps"])
def test_decode_knobs_reach_every_replica_engine(route, tmp_home,
                                                 monkeypatch):
    """--serve-decode-steps / --serve-draft-model, their
    KUBEML_SERVE_DECODE_STEPS / KUBEML_SERVE_DRAFT_MODEL twins, the PS's
    kwargs and start_deployment's all reach every replica's engine (two
    replicas here), which serves with them."""
    from kubeml_tpu_torch.cli import main as cli
    from kubeml_tpu_torch.control import deployment, ps as ps_mod

    _save("target", 0, tmp_home)
    _save("draft", 3, tmp_home)
    fleet_kw = dict(serve_slots=2, serve_replicas_min=2,
                    serve_replicas_max=2)
    want = [(3, 3, 64, True)] * 2
    if route in ("ps_kwargs", "env"):
        if route == "env":
            monkeypatch.setenv("KUBEML_SERVE_DECODE_STEPS", "3")
            monkeypatch.setenv("KUBEML_SERVE_DRAFT_MODEL", "draft")
            knobs = {}
        else:
            knobs = dict(serve_decode_steps=3, serve_draft_model="draft")
        ps = ps_mod.ParameterServer(device="cpu", port=0, **knobs,
                                    **fleet_kw)
        try:
            assert _engines_of(ps, "target") == want
        finally:
            ps.stop()
        return
    if route == "deployment":
        dep = deployment.start_deployment(
            device="cpu", serve_decode_steps=3, serve_draft_model="draft",
            **fleet_kw)
        try:
            assert _engines_of(dep.ps, "target") == want
        finally:
            dep.stop()
        return
    made, served = [], []
    real_deploy, real_ps = deployment.start_deployment, \
        ps_mod.ParameterServer

    def deploy(**kw):
        dep = real_deploy(**dict(kw, device="cpu", **fleet_kw))
        made.append((kw, dep.ps))
        return dep

    class PS(real_ps):
        def __init__(self, **kw):
            made.append((kw, self))
            super().__init__(**dict(kw, device="cpu", port=0, **fleet_kw))

    sleep = cli.time.sleep

    def interrupt(seconds):
        if seconds != 3600:     # the serving threads' own waits
            return sleep(seconds)
        served.append(_engines_of(made[-1][1], "target"))
        raise KeyboardInterrupt

    monkeypatch.setattr(deployment, "start_deployment", deploy)
    monkeypatch.setattr(ps_mod, "ParameterServer", PS)
    monkeypatch.setattr(cli.time, "sleep", interrupt)
    cli.main(["serve", "--role", "all" if route == "cli_all" else "ps",
              "--device", "cpu", "--free-ports", "--serve-decode-steps",
              "3", "--serve-draft-model", "draft"])
    kw = made[0][0]
    assert (kw["serve_decode_steps"], kw["serve_draft_model"]) == \
        (3, "draft")
    assert served == [want]


@pytest.mark.parametrize("knobs,status", [
    (dict(serve_decode_steps=0), 400),
    (dict(serve_draft_model="no-such-draft"), 404),
])
def test_bad_decode_knobs_answer_as_the_reference(knobs, status, tmp_home):
    """decode_steps 0 is the engine's ValueError (the reference's words),
    answered 400 at the replica build; a missing draft checkpoint is the
    reference's not-found."""
    from kubeml_tpu.serve.engine import DecodeEngine as JaxEngine
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.control.ps import ParameterServer

    _save("target", 0, tmp_home)
    ps = ParameterServer(device="cpu", port=0, serve_slots=2, **knobs)
    try:
        with pytest.raises(KubeMLException) as e:
            ps._serve_service("target")
        assert e.value.status_code == status
        if "serve_decode_steps" in knobs:
            jm, jv = _ref(0)
            with pytest.raises(ValueError) as want:
                JaxEngine(jm, jv, decode_steps=0)
            assert str(want.value) in str(e.value)
    finally:
        ps.stop()


# ----------------------------------------------- the paged kernel's geometry
@pytest.mark.parametrize("G", [4, 8, 12, 16])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_cuda_refusal_follows_the_references_gate(G, kv_dtype, monkeypatch):
    """A bf16 CUDA engine takes, at construction, every page size the
    reference serves — those its paged_eligible gate sends to its kernel
    and those it gathers: the paged kernel pads a ragged page to whole
    8-token slices, so no page size is refused. (The shared-memory rule
    needs the built library and is held on the card: here it is asked of
    a stub that fits.)"""
    from kubeml_tpu.ops.pallas.paged_attention import paged_eligible
    from kubeml_tpu_torch.ops import paged_attention as pa
    from kubeml_tpu_torch.serve import engine as engine_mod
    from kubeml_tpu_torch.serve.pager import PageGeometry

    for mod in (pa, engine_mod):
        monkeypatch.setattr(mod, "kernel_smem_bytes", lambda *a: 0)
    module, _ = _port(0, dims=dict(NANO, hidden=128, heads=2),
                      dtype=torch.bfloat16)
    geom = PageGeometry.for_module(slots=4, page=G, max_len=64)
    assert paged_eligible(G) == (G % 8 == 0)
    engine_mod.check_kernel_geometry(module, geom, kv_dtype, 16)
    assert pa.kernel_geometry_refusal(16, module.head_dim, G,
                                      geom.pages_per_slot, torch.bfloat16,
                                      kv_dtype == "int8") is None


def test_multi_and_spec_serve_a_geometry_the_kernel_refuses_on_cpu():
    """The CPU's plain version takes any geometry: at 12-token pages the
    multi-step and speculative programs give the single step's tokens and
    KV bytes bit for bit, sampled lanes included."""
    module, sd = _port(0)
    dm, dsd = _port(9)
    kw = dict(engine_kw=dict(page=12, prefill_chunk=12), kv_dtype="int8")
    _, base_toks, base_ctx = _run_port(module, sd, **kw)
    for extra in (dict(decode_steps=3),
                  dict(draft_module=dm, draft_variables=dsd)):
        eng, toks, ctx = _run_port(module, sd, **kw, **extra)
        assert toks == base_toks
        _same_slabs(ctx, base_ctx)
        assert eng.stats["multi_step_dispatches"] \
            + eng.stats["verify_dispatches"] > 0


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_multi_and_spec_equal_single_step_on_card(cuda_device, kv_dtype):
    """gpt-mini's widths in bf16 on the card: multi-step and speculative
    decode (self-draft and a draft of another seed) give the single
    step's tokens and KV bytes bit for bit, greedy and sampled."""
    from kubeml_tpu_torch.ops.flash_attention import fa_fwd_kernel
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    module, sd = _port(0, dims=MINI, dtype=torch.bfloat16,
                       device=cuda_device)
    other, osd = _port(5, dims=MINI, dtype=torch.bfloat16,
                       device=cuda_device)
    specs = [(list(range(3, 40)), 12, 0.0, 0), ([7, 8], 9, 0.8, 3),
             (list(range(100, 117)), 10, 0.0, 1)]
    kw = dict(engine_kw=dict(page=16), kv_dtype=kv_dtype)
    _, base_toks, base_ctx = _run_port(module, sd, specs=specs, **kw)
    for extra in (dict(decode_steps=4),
                  dict(draft_module=module, draft_variables=sd),
                  dict(draft_module=other, draft_variables=osd)):
        fa0, pa0 = fa_fwd_kernel.launches, paged_attention.launches
        eng, toks, ctx = _run_port(module, sd, specs=specs, **kw, **extra)
        torch.cuda.synchronize()
        assert toks == base_toks
        _same_slabs(ctx, base_ctx)
        assert paged_attention.launches > pa0
        if "draft_module" in extra:
            assert eng.stats["verify_dispatches"] > 0
            assert fa_fwd_kernel.launches - fa0 == \
                MINI["layers"] * 4 * eng.stats["verify_dispatches"]
        else:
            assert eng.stats["multi_step_dispatches"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("G", [4, 12, 20])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_cuda_engine_serves_ragged_pages_on_card(cuda_device, G, kv_dtype,
                                                 monkeypatch):
    """gpt-mini's widths in bf16 on the card at page sizes that are not
    multiples of the kernel's 8-token slices: the engine builds, every
    paged call of single steps, multi-step and self-draft runs launches
    the kernel, and each call's output is held against the plain version
    on the same CUDA operands (2e-2); multi-step gives the single step's
    tokens and KV bytes bit for bit."""
    from kubeml_tpu_torch.models import gpt as gpt_mod
    from kubeml_tpu_torch.ops.paged_attention import (_pa_plain,
                                                      paged_attention)

    diffs = []

    def held(*args, quantized=False, compute_dtype=None):
        out = paged_attention(*args, quantized=quantized,
                              compute_dtype=compute_dtype)
        ref = _pa_plain(*args, quantized=quantized,
                        compute_dtype=compute_dtype or args[0].dtype)
        diffs.append(float((out.float() - ref.float()).abs().max()))
        return out

    monkeypatch.setattr(gpt_mod, "paged_attention", held)
    module, sd = _port(0, dims=MINI, dtype=torch.bfloat16,
                       device=cuda_device)
    specs = [(list(range(3, 40)), 12, 0.0, 0), ([7, 8], 9, 0.8, 3),
             (list(range(100, 117)), 10, 0.0, 1)]
    kw = dict(engine_kw=dict(page=G, prefill_chunk=16), kv_dtype=kv_dtype)
    pa0 = paged_attention.launches
    _, base_toks, base_ctx = _run_port(module, sd, specs=specs, **kw)
    _, toks, ctx = _run_port(module, sd, specs=specs, decode_steps=4, **kw)
    _run_port(module, sd, specs=specs, draft_module=module,
              draft_variables=sd, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches - pa0 == len(diffs) > 0
    assert max(diffs) <= 2e-2, max(diffs)
    assert toks == base_toks
    _same_slabs(ctx, base_ctx)
