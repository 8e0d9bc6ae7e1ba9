"""Port parity: kubeml_tpu_torch paged attention vs the JAX package's.

The same numpy inputs (made from a seed) go through the JAX
``paged_attention`` — its Pallas kernel in interpret mode and its gather
path — and through the port's plain version ``_pa_plain``, which is what
the port's wrapper runs on CPU tensors and what the Hopper kernel is held
against on the card.

Tolerances: f32 rtol = atol = 1e-5 (the two frameworks sum the QK and PV
products in different orders); bf16 2e-2 (bf16 rounds at different
places in the two frameworks).

The card's kernel splits each (head, slot) over a cluster of up to 8
blocks and skips dead pages; ``_cluster_schedule`` below replays that
schedule in torch (interleaved page ranks, per-rank scores, the global
max and sum, P.V partials added in rank order) so the CPU holds the
algorithm, not only the plain version, against the JAX package.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

S, PMAX, G, H, D = 3, 3, 8, 2, 16


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


def _operands(seed, T, quantized):
    """numpy operands with realistic masking: page 0 reserved (tails),
    per-slot valid prefix, NEG_INF bias (as tests/test_decode_bw.py)."""
    from kubeml_tpu_torch.ops.attention import NEG_INF

    rng = np.random.default_rng(seed)
    P = S * PMAX + 1
    C = PMAX * G
    q = rng.standard_normal((S, T, H, D)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (P, G, H, D)).astype(np.int8)
        v = rng.integers(-127, 128, (P, G, H, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.1, P).astype(np.float32)
        vs = rng.uniform(0.001, 0.1, P).astype(np.float32)
    else:
        k = rng.standard_normal((P, G, H, D)).astype(np.float32)
        v = rng.standard_normal((P, G, H, D)).astype(np.float32)
        ks = np.zeros(P, np.float32)
        vs = np.zeros(P, np.float32)
    tables = np.zeros((S, PMAX), np.int32)
    for s in range(S):
        for j in range(min(s + 1, PMAX)):
            tables[s, j] = 1 + s * PMAX + j
    n_valid = np.minimum(np.arange(1, S + 1) * G - 3, C)
    keep = (np.arange(C)[None, :] < n_valid[:, None]).astype(np.float32)
    bias = np.broadcast_to(((1.0 - keep) * NEG_INF)[:, None, None, :],
                           (S, 1, T, C)).copy()
    return q, k, v, ks, vs, tables, bias


CASES = [  # (compute dtype, T, quantized)
    ("f32", 1, False), ("f32", 16, False),
    ("bf16", 1, False), ("bf16", 16, False),
    ("f32", 1, True), ("bf16", 16, True),
]


@pytest.mark.parametrize("jax_impl", ["pallas", "gather"])
@pytest.mark.parametrize("dtype,T,quantized", CASES)
def test_plain_matches_jax_paged_attention(dtype, T, quantized, jax_impl):
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas.paged_attention import \
        paged_attention as jax_pa
    from kubeml_tpu_torch.ops.paged_attention import (_pa_plain,
                                                      paged_attention)

    q, k, v, ks, vs, tables, bias = _operands(
        len(CASES) * T + quantized, T, quantized)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    page_j = (lambda a: jnp.asarray(a)) if quantized \
        else (lambda a: jnp.asarray(a).astype(jdt))
    page_t = (lambda a: torch.from_numpy(a)) if quantized \
        else (lambda a: torch.from_numpy(a).to(tdt))
    args = (torch.from_numpy(q).to(tdt), page_t(k), page_t(v),
            torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(tables), torch.from_numpy(bias))
    ref = jax_pa(jnp.asarray(q).astype(jdt), page_j(k), page_j(v),
                 jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(tables),
                 jnp.asarray(bias), quantized=quantized, compute_dtype=jdt,
                 impl=jax_impl, interpret=jax_impl == "pallas")
    out = _pa_plain(*args, quantized=quantized, compute_dtype=tdt)
    assert out.dtype == tdt and out.shape == (S, T, H, D)
    tol = 1e-5 if dtype == "f32" else 2e-2
    ref_t = torch.tensor(np.asarray(ref.astype(jnp.float32)))
    torch.testing.assert_close(out.float(), ref_t, rtol=tol, atol=tol)
    # the public wrapper takes the plain version on CPU tensors
    wrapped = paged_attention(*args, quantized=quantized, compute_dtype=tdt)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)


def test_wrapper_routes_by_device_and_never_falls_back():
    """CPU tensors run the plain version; a tensor on any device other
    than the CPU or CUDA raises (there is no other kernel), and the launch
    counter only moves for kernel launches."""
    from kubeml_tpu_torch.ops.paged_attention import _pa_plain, paged_attention

    args = [torch.from_numpy(a) for a in _operands(0, 1, False)]
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.testing.assert_close(
        out, _pa_plain(*args, quantized=False, compute_dtype=torch.float32),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*(a.to("meta") for a in args))
    assert paged_attention.launches == before


def test_kernel_argument_checks():
    """The kernel wrapper's checks run before any launch, so they are
    testable on the CPU: shape, dtype, contiguity and row alignment
    raise (the shared-memory limit is the kernel library's, checked on
    the card)."""
    from kubeml_tpu_torch.ops.paged_attention import _check_kernel_args

    q, k, v, ks, vs, tables, bias = (torch.from_numpy(a) for a in
                                     _operands(1, 1, False))
    _check_kernel_args(q, k, v, ks, vs, tables, bias, False, torch.float32)
    with pytest.raises(ValueError, match="bias"):
        _check_kernel_args(q, k, v, ks, vs, tables, bias[:, :, :, :-1],
                           False, torch.float32)
    with pytest.raises(TypeError, match="int8"):
        _check_kernel_args(q, k, v, ks, vs, tables, bias, True,
                           torch.float32)
    with pytest.raises(TypeError, match="int32"):
        _check_kernel_args(q, k, v, ks, vs, tables.long(), bias, False,
                           torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        _check_kernel_args(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v, ks, vs, tables, bias, False, torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        _check_kernel_args(q[..., :2].contiguous().to(torch.bfloat16),
                           k[..., :2].contiguous().to(torch.bfloat16),
                           v[..., :2].contiguous().to(torch.bfloat16), ks, vs,
                           tables, bias, False, torch.bfloat16)
    with pytest.raises(ValueError, match="span devices"):
        _check_kernel_args(q, k, v, ks, vs, tables, bias.to("meta"), False,
                           torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        half = (torch.zeros((2, 4, H, D), dtype=torch.bfloat16),) * 2
        _check_kernel_args(q.to(torch.bfloat16), *half, torch.zeros(2),
                           torch.zeros(2), torch.zeros((S, 2), dtype=torch.int32),
                           torch.zeros((S, 1, 1, 8)), False, torch.bfloat16)
    with pytest.raises(TypeError, match="computes in"):
        _check_kernel_args(q, k, v, ks, vs, tables, bias, False,
                           torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,T,quantized", CASES)
def test_kernel_matches_plain_on_card(cuda_device, dtype, T, quantized):
    """On the card: the Hopper kernel against the plain version on the
    same CUDA inputs (f32 1e-5, bf16 2e-2)."""
    from kubeml_tpu_torch.ops.paged_attention import (_pa_plain,
                                                      paged_attention)

    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v, ks, vs, tables, bias = _operands(7, T, quantized)
    pages = (lambda a: torch.from_numpy(a)) if quantized \
        else (lambda a: torch.from_numpy(a).to(tdt))
    args = [torch.from_numpy(q).to(tdt), pages(k), pages(v),
            torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(tables), torch.from_numpy(bias)]
    args = [a.to(cuda_device) for a in args]
    before = paged_attention.launches
    out = paged_attention(*args, quantized=quantized, compute_dtype=tdt)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = _pa_plain(*args, quantized=quantized, compute_dtype=tdt)
    tol = 1e-5 if dtype == "f32" else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_kernel_refuses_oversized_context_on_card(cuda_device):
    """A [T, C] score block past a Hopper block's shared memory raises
    before any launch; the counter does not move."""
    from kubeml_tpu_torch.ops.paged_attention import paged_attention

    q, k, v, ks, vs, _, _ = (torch.from_numpy(a).to(cuda_device)
                             for a in _operands(3, 16, False))
    big_tables = torch.zeros((S, 1000), dtype=torch.int32,
                             device=cuda_device)
    big_bias = torch.zeros((S, 1, 16, 1000 * G), device=cuda_device)
    before = paged_attention.launches
    with pytest.raises(ValueError, match="shared memory"):
        paged_attention(q, k, v, ks, vs, big_tables, big_bias)
    assert paged_attention.launches == before


# ------------------------------------------------ the card kernel's schedule
CLUSTER_MAX = 8      # the kernel's cluster size: min(8, Pmax) ranks


def _ctx_operands(seed, S_, T_, G_, pmax, dtype, quantized, dead_slot=None):
    """numpy operands at the serving path's masking: slot s holds a
    context of n_s tokens on its first pages (tails on the null page 0),
    query t sits at position n_s - T + t and sees the keys at or before
    it; slot ``dead_slot`` (if any) has no valid key at all, as an
    inactive decode slot."""
    from kubeml_tpu_torch.ops.attention import NEG_INF

    rng = np.random.default_rng(seed)
    C = pmax * G_
    P = S_ * pmax + 1
    q = rng.standard_normal((S_, T_, H, D)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (P, G_, H, D)).astype(np.int8)
        v = rng.integers(-127, 128, (P, G_, H, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.1, P).astype(np.float32)
        vs = rng.uniform(0.001, 0.1, P).astype(np.float32)
    else:
        k = rng.standard_normal((P, G_, H, D)).astype(np.float32)
        v = rng.standard_normal((P, G_, H, D)).astype(np.float32)
        ks = np.zeros(P, np.float32)
        vs = np.zeros(P, np.float32)
    n_ctx = np.linspace(T_ + 2, C - 3, S_).astype(np.int64)
    tables = np.zeros((S_, pmax), np.int32)
    keep = np.zeros((S_, 1, T_, C), np.float32)
    for s in range(S_):
        used = -(-int(n_ctx[s]) // G_)
        tables[s, :used] = 1 + s * pmax + np.arange(used)
        for t in range(T_):
            keep[s, 0, t] = np.arange(C) <= n_ctx[s] - T_ + t
    if dead_slot is not None:
        keep[dead_slot] = 0.0
    bias = (1.0 - keep) * NEG_INF
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    pages = (lambda a: torch.from_numpy(a)) if quantized \
        else (lambda a: torch.from_numpy(a).to(tdt))
    return (torch.from_numpy(q).to(tdt), pages(k), pages(v),
            torch.from_numpy(ks), torch.from_numpy(vs),
            torch.from_numpy(tables), torch.from_numpy(bias)), tdt


def _live(bias_s):
    """The kernel's skip rule for one slot's [T, C] bias: (may dead pages
    be skipped, which columns are live). Skipping is exact only when every
    row has a live column somewhere in the context."""
    from kubeml_tpu_torch.ops.attention import NEG_INF

    live = bias_s > 0.5 * NEG_INF
    return bool(live.any(dim=1).all()), live


def _cluster_schedule(q, k_pages, v_pages, k_scale, v_scale, tables, bias,
                      quantized, cdt):
    """The card kernel's schedule replayed in torch: rank r of a cluster
    of nr = min(8, Pmax) takes pages r, r + nr, ...; pages whose bias is
    dead in every row are skipped when every row is live; each rank forms
    its scores (scaled product, then the bias) and its row max; the max
    over the ranks; exp, the rank's row sum; the sum over the ranks in
    rank order; bf16(e / sum) (the compute dtype); each rank's f32 P.V
    partial; the partials added in rank order."""
    from kubeml_tpu_torch.ops.attention import score_scale
    from kubeml_tpu_torch.ops.paged_attention import _dequant

    S_, T_, H_, D_ = q.shape
    G_ = k_pages.shape[1]
    pmax = tables.shape[1]
    nr = min(CLUSTER_MAX, pmax)
    if quantized:
        k_pages = _dequant(k_pages, k_scale, cdt)
        v_pages = _dequant(v_pages, v_scale, cdt)
    scale = score_scale(D_)
    out = torch.empty_like(q)
    for s in range(S_):
        b = bias[s, 0]
        skip, live = _live(b)
        for h in range(H_):
            ranks = []
            for r in range(nr):
                pages = [j for j in range(r, pmax, nr)
                         if not skip or bool(live[:, j * G_:(j + 1) * G_]
                                             .any())]
                cols = [j * G_ + g for j in pages for g in range(G_)]
                kr = k_pages[tables[s, pages], :, h].reshape(-1, D_)
                vr = v_pages[tables[s, pages], :, h].reshape(-1, D_)
                sr = (q[s, :, h].float() @ kr.float().T) * scale + b[:, cols]
                ranks.append((sr, vr))
            m = torch.stack([sr.amax(dim=1) if sr.shape[1] else
                             torch.full((T_,), -torch.inf)
                             for sr, _ in ranks]).amax(dim=0)
            es = [torch.exp(sr - m[:, None]) for sr, _ in ranks]
            total = torch.zeros(T_)
            for e in es:
                total = total + e.sum(dim=1)
            acc = torch.zeros(T_, D_)
            for e, (_, vr) in zip(es, ranks):
                w = (e / total[:, None]).to(cdt).float()
                acc = acc + w @ vr.float()
            out[s, :, h] = acc.to(q.dtype)
    return out


SPLIT_CASES = [  # (compute dtype, T, quantized) at Pmax = 11: 3 ranks of 8
    ("f32", 1, False), ("f32", 16, False),        # hold 2 pages, 5 hold 1
    ("bf16", 1, False), ("bf16", 16, False),
    ("bf16", 1, True), ("bf16", 16, True),
]


@pytest.mark.parametrize("jax_impl", ["pallas", "gather"])
@pytest.mark.parametrize("dtype,T,quantized", SPLIT_CASES)
def test_cluster_schedule_matches_jax(dtype, T, quantized, jax_impl):
    """The kernel's split over a cluster (interleaved ranks, exchanged max
    and sum, partials in rank order, dead pages skipped) against the JAX
    package's paged_attention, at a Pmax (11) that is not a multiple of
    the cluster size (8)."""
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas.paged_attention import \
        paged_attention as jax_pa

    args, tdt = _ctx_operands(20 + T + quantized, 3, T, 8, 11, dtype,
                              quantized)
    got = _cluster_schedule(*args, quantized, tdt)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    q, k, v, ks, vs, tables, bias = (a.float().numpy() if a.dtype ==
                                     torch.bfloat16 else a.numpy()
                                     for a in args)
    page = (lambda a: jnp.asarray(a)) if quantized \
        else (lambda a: jnp.asarray(a).astype(jdt))
    ref = jax_pa(jnp.asarray(q).astype(jdt), page(k), page(v),
                 jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(tables),
                 jnp.asarray(bias), quantized=quantized, compute_dtype=jdt,
                 impl=jax_impl, interpret=jax_impl == "pallas")
    tol = 1e-5 if dtype == "f32" else 2e-2
    torch.testing.assert_close(
        got.float(), torch.tensor(np.asarray(ref.astype(jnp.float32))),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("T", [1, 3, 16])
@pytest.mark.parametrize("dead_slot", [None, 1])
def test_dead_page_skip_is_exact(T, dead_slot):
    """Skipping a page whose bias is dead in every row changes nothing,
    bit for bit, for a slot whose every row has a live column: the plain
    chain run with the skipped pages never loaded (zero K and V) and their
    scores never formed (-inf, absent from the max and the sum) equals
    _pa_plain exactly in f32. A slot with a fully masked row takes no skip
    (its uniform row is not uniform in the reference: -1e9 + q.k.scale
    rounds per column) and equals _pa_plain too; skipping there would
    leave the row with no score at all."""
    from kubeml_tpu_torch.ops.attention import multi_head_attention
    from kubeml_tpu_torch.ops.paged_attention import _pa_plain

    args, tdt = _ctx_operands(40 + T, 3, T, 8, 6, "f32", False, dead_slot)
    q, k_pages, v_pages, ks, vs, tables, bias = args
    S_, G_, pmax = q.shape[0], k_pages.shape[1], tables.shape[1]
    C = pmax * G_
    ck = k_pages[tables].reshape(S_, C, H, D).clone()
    cv = v_pages[tables].reshape(S_, C, H, D).clone()
    eb = bias.clone()
    skipped = 0
    for s in range(S_):
        skip, live = _live(bias[s, 0])
        assert skip == (s != dead_slot)
        for j in range(pmax):
            cols = slice(j * G_, (j + 1) * G_)
            if skip and not bool(live[:, cols].any()):
                ck[s, cols] = 0.0
                cv[s, cols] = 0.0
                eb[s, 0, :, cols] = -torch.inf
                skipped += 1
    assert skipped > 0
    got = multi_head_attention(q, ck, cv, eb)
    assert torch.equal(got, _pa_plain(*args, quantized=False,
                                      compute_dtype=tdt))
    assert bool(_cluster_schedule(*args, False, tdt).isfinite().all())
    if dead_slot is not None:
        forced = bias.clone()
        live = bias[dead_slot, 0] > -5e8
        forced[dead_slot, 0][:, ~live.any(dim=0)] = -torch.inf
        bad = multi_head_attention(q, k_pages[tables].reshape(S_, C, H, D),
                                   v_pages[tables].reshape(S_, C, H, D),
                                   forced)
        assert not bool(bad[dead_slot].isfinite().any())


def _to(args, device):
    return [a.to(device) for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("G_", [8, 16, 32])
@pytest.mark.parametrize("T", [1, 3, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_cluster_kernel_on_card(cuda_device, G_, T, quantized):
    """On the card, bf16 queries (the cluster kernel): contexts with dead
    pages and one slot whose rows are all masked, against the plain
    version at 2e-2; two launches equal bit for bit; each slot of an S=8
    call equals the same slot launched alone, bit for bit."""
    from kubeml_tpu_torch.ops.paged_attention import (_pa_plain,
                                                      paged_attention)

    args, tdt = _ctx_operands(60 + G_ + T, 8, T, G_, 11, "bf16", quantized,
                              dead_slot=5)
    args = _to(args, cuda_device)
    out = paged_attention(*args, quantized=quantized, compute_dtype=tdt)
    again = paged_attention(*args, quantized=quantized, compute_dtype=tdt)
    torch.cuda.synchronize()
    ref = _pa_plain(*args, quantized=quantized, compute_dtype=tdt)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(out, again)
    q, kp, vp, ks, vs, tables, bias = args
    for s in range(q.shape[0]):
        alone = paged_attention(q[s:s + 1], kp, vp, ks, vs, tables[s:s + 1],
                                bias[s:s + 1], quantized=quantized,
                                compute_dtype=tdt)
        assert torch.equal(alone, out[s:s + 1]), s


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 16])
def test_f32_kernel_on_card_with_dead_pages(cuda_device, T):
    """The f32 instantiation (the first version's body) on the same
    contexts: within 1e-5 of the plain version."""
    from kubeml_tpu_torch.ops.paged_attention import (_pa_plain,
                                                      paged_attention)

    args, tdt = _ctx_operands(80 + T, 8, T, 16, 11, "f32", False,
                              dead_slot=2)
    args = _to(args, cuda_device)
    out = paged_attention(*args)
    torch.cuda.synchronize()
    ref = _pa_plain(*args, quantized=False, compute_dtype=tdt)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------- geometry refused at construction
@pytest.mark.parametrize("G,D,dtype,quantized,refused", [
    (12, 64, torch.bfloat16, False, "page size 12"),   # bf16: G % 8
    (16, 64, torch.bfloat16, False, None),
    (8, 8, torch.bfloat16, True, "head_dim 8 x 1 bytes"),  # int8 rows
    (16, 8, torch.bfloat16, False, None),               # 8 x 2 = 16 bytes
    (12, 4, torch.float32, False, None),                # f32: any page
    (12, 2, torch.float32, False, "head_dim 2 x 4 bytes"),
])
def test_kernel_geometry_rules_on_cpu(G, D, dtype, quantized, refused):
    """The kernel's pure geometry rules (page size and row width), asked
    without the shared-memory query the library answers on the card."""
    from kubeml_tpu_torch.ops.paged_attention import kernel_geometry_refusal

    why = kernel_geometry_refusal(1, D, G, 32, dtype, quantized, smem=False)
    if refused is None:
        assert why is None
    else:
        assert refused in why


def test_cpu_engine_serves_geometry_the_kernel_refuses():
    """The plain version takes any geometry: a bf16 engine with 12-token
    pages serves on the CPU as the JAX package's gather path does."""
    from kubeml_tpu_torch.models.gpt import GPTModule
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest

    torch.manual_seed(0)
    module = GPTModule(vocab_size=64, max_len=48, hidden=32, layers=1,
                       heads=2, ffn=64, device="cpu")
    engine = DecodeEngine(module, slots=2, page=12, prefill_chunk=12,
                          device="cpu")
    req = GenerateRequest(list(range(3, 20)), max_new_tokens=4)
    engine.attach(req)
    while engine.active():
        engine.step()
    assert len(req.tokens) == 4


@pytest.mark.gpu
def test_cuda_engine_refuses_unservable_geometry_at_construction(
        cuda_device):
    """DecodeEngine(page=12) on a bf16 gpt-mini raises before any slab is
    allocated, naming the geometry, so a service over it never admits a
    request; page=16 builds."""
    from kubeml_tpu_torch.models import get_builtin
    from kubeml_tpu_torch.serve.engine import DecodeEngine

    module = get_builtin("gpt-mini")(device=cuda_device)
    before = torch.cuda.memory_allocated(cuda_device)
    with pytest.raises(ValueError) as e:
        DecodeEngine(module, slots=2, page=12, device=cuda_device)
    msg = str(e.value)
    assert "page size 12" in msg and "head_dim 64" in msg
    assert "bfloat16 pages" in msg and "bytes of shared memory" in msg
    assert torch.cuda.memory_allocated(cuda_device) == before
    with pytest.raises(ValueError, match="int8 pages"):
        DecodeEngine(module, slots=2, page=12, kv_dtype="int8",
                     device=cuda_device)
    DecodeEngine(module, slots=2, page=16, device=cuda_device)
