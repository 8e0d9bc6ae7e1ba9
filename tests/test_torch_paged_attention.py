"""Port parity: kubeml_tpu_torch paged attention vs the JAX package's.

The same numpy inputs (made from a seed) go through the JAX
``paged_attention`` — its Pallas kernel in interpret mode and its gather
path — and through the port's plain version ``_pa_plain``, which is what
the port's wrapper runs on CPU tensors and what the Hopper kernel is held
against on the card.

Tolerances: f32 rtol = atol = 1e-5 (the two frameworks sum the QK and PV
products in different orders); bf16 2e-2 (bf16 rounds at different
places in the two frameworks).
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
