"""Port parity: kubeml_tpu_torch flash attention vs the JAX package's.

The same numpy inputs (made from a seed) go through the JAX flash
attention — its Pallas kernels in interpret mode, with 16-row blocks so
the online softmax really walks several blocks — and through the port's
plain versions, which are what the port's wrappers run on CPU tensors and
what the Hopper kernels are held against on the card.

Cases: causal and not, a padded tail, interior pads, and one row whose
keys are all padding (uniform softmax, l = T or the causal prefix length).

Tolerances: f32 2e-5 for the forward (the JAX package's own flash
tolerance, tests/test_pallas_flash.py; the online and the full-row
softmax sum in different orders), f32 1e-4 for gradients (the JAX
package's own flash-gradient tolerance: the backward's sums over T rows
meet two exp/divide roundings); bf16 2e-2 (bf16 rounds at different
places in the two frameworks). m compares relatively: an all-pad row's
m sits at NEG_INF scale, -1e9.
"""

import numpy as np
import pytest
import torch

# JAX is imported inside the parity tests only: the `gpu` tests run on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

B, T, H, D = 3, 48, 2, 16
BLOCK = 16          # the JAX kernels' block: three blocks along T


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


def _inputs(seed, T=T, B=B):
    """q, k, v, g (normal) and a keep-mask: row 0 padded from 2T/3, row 1
    with interior pads, row 2 (when B > 2) all padding."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    pad = np.ones((B, T), np.float32)
    pad[0, 2 * T // 3:] = 0.0
    pad[1, T // 7:T // 4] = 0.0
    if B > 2:
        pad[2] = 0.0
    return q, k, v, g, pad


def _tol(dtype, grad=False):
    return 2e-2 if dtype == "bf16" else (1e-4 if grad else 2e-5)


def _types(dtype):
    import jax.numpy as jnp

    return ((jnp.float32, torch.float32) if dtype == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _close(got, ref, tol):
    import jax.numpy as jnp

    ref = torch.tensor(np.asarray(jnp.asarray(ref).astype(jnp.float32)))
    torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_jax(causal, dtype):
    """(out, m, l) of the plain forward against the JAX kernel's, and out
    against the JAX flash_attention's."""
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas.flash_attention import _fa_forward as jax_fwd
    from kubeml_tpu.ops.pallas.flash_attention import \
        flash_attention as jax_flash
    from kubeml_tpu_torch.ops.flash_attention import (_fa_forward,
                                                      _fa_forward_plain)

    q, k, v, _, pad = _inputs(1 + causal)
    jdt, tdt = _types(dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    r_out, r_m, r_l = jax_fwd(jq, jk, jv, jnp.asarray(pad), causal, BLOCK,
                              BLOCK, True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out, m, l = _fa_forward_plain(tq, tk, tv, torch.from_numpy(pad), causal)
    assert out.dtype == tdt and out.shape == (B, T, H, D)
    assert m.shape == l.shape == (B * H, 1, T)
    tol = _tol(dtype)
    _close(out, r_out, tol)
    torch.testing.assert_close(m, torch.tensor(np.asarray(r_m)), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(l, torch.tensor(np.asarray(r_l)), rtol=tol,
                               atol=tol)
    # the all-pad row is uniform: l counts its keys, never NaN
    want = np.arange(1, T + 1) if causal else np.full(T, T)
    np.testing.assert_allclose(l.reshape(B, H, T)[2].numpy(),
                               np.broadcast_to(want, (H, T)), rtol=1e-6)
    _close(out, jax_flash(jq, jk, jv, jnp.asarray(pad), causal, BLOCK, BLOCK,
                          True), tol)
    # the routed contract takes the plain version on CPU tensors
    routed = _fa_forward(tq, tk, tv, torch.from_numpy(pad), causal)
    for a, b in zip(routed, (out, m, l)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax(causal, dtype):
    """(dq, dk, dv) of the plain backward against the JAX kernels' on the
    same (out, m, l) — the JAX forward's — and the same output gradient."""
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas.flash_attention import _fa_backward as jax_bwd
    from kubeml_tpu.ops.pallas.flash_attention import _fa_forward as jax_fwd
    from kubeml_tpu_torch.ops.flash_attention import _fa_backward

    q, k, v, g, pad = _inputs(3 + causal)
    jdt, tdt = _types(dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    jpad = jnp.asarray(pad)
    out, m, l = jax_fwd(jq, jk, jv, jpad, causal, BLOCK, BLOCK, True)
    ref = jax_bwd(jq, jk, jv, jpad, out, m, l, jg, causal, BLOCK, BLOCK,
                  True)
    t = (lambda a: torch.tensor(np.asarray(jnp.asarray(a).astype(
        jnp.float32))).to(tdt))
    got = _fa_backward(t(jq), t(jk), t(jv), torch.from_numpy(pad), t(out),
                       torch.tensor(np.asarray(m)), torch.tensor(np.asarray(l)),
                       t(jg), causal)
    for a, r in zip(got, ref):
        assert a.dtype == tdt and a.shape == (B, T, H, D)
        _close(a, r, _tol(dtype, grad=True))


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_grads_match_jax_grad(causal):
    """The autograd.Function's gradients (through the plain versions on
    CPU) against jax.grad of the JAX flash_attention, f32; the mask gets a
    zero gradient."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas.flash_attention import \
        flash_attention as jax_flash
    from kubeml_tpu_torch.ops.attention import masked_attention

    q, k, v, g, pad = _inputs(5 + causal)
    jpad = jnp.asarray(pad)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, jpad, causal, BLOCK, BLOCK, True)
        return (out * jnp.asarray(g)).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpad = torch.from_numpy(pad).requires_grad_()
    out = masked_attention(tq, tk, tv, tpad, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    for a, r in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(a, r, 1e-4)
    assert torch.count_nonzero(tpad.grad) == 0


# tile edges of the card's backward schedule (64-row tiles): one row, one
# whole tile, one row past it, an odd tile count (5) and an even one (8)
EDGE_T = (1, 64, 65, 320, 512)


def _right_padded(seed, T):
    """q, k, v, g (normal) and a right-padding keep-mask: sequence 0 full,
    1 ending in padding after ceil(T/2) tokens, 2 fully padded."""
    q, k, v, g, _ = _inputs(seed, T=T)
    lengths = np.array([T, -(-T // 2), 0])
    pad = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, g, pad


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_len", EDGE_T)
def test_plain_backward_matches_jax_at_tile_edges(t_len, causal):
    """The plain dK/dV and dQ — what the card's kernels are held to —
    against the JAX package at the backward schedule's tile edges, f32,
    right padding. Where the JAX kernels tile T (64, 320, 512: 64-row
    blocks) its _fa_backward runs in interpret mode on its own forward's
    (out, m, l); they refuse T = 1 and 65 (no 8-aligned block divides T),
    so there the reference is jax.vjp of the JAX package's attention chain
    (multi_head_attention with composed_bias), the path its masked
    attention takes for such T."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.ops import attention as jatt
    from kubeml_tpu.ops.pallas.flash_attention import (_fa_backward,
                                                       _fa_forward,
                                                       _fit_block)
    from kubeml_tpu_torch.ops import flash_attention as fa

    q, k, v, g, pad = _right_padded(13 + t_len + causal, t_len)
    jq, jk, jv, jg, jpad = (jnp.asarray(a) for a in (q, k, v, g, pad))
    tq, tk, tv, tg, tpad = (torch.from_numpy(a) for a in (q, k, v, g, pad))
    if t_len % 64 == 0:
        out, m, l = _fa_forward(jq, jk, jv, jpad, causal, 64, 64, True)
        ref = _fa_backward(jq, jk, jv, jpad, out, m, l, jg, causal, 64, 64,
                           True)
        t_out = torch.tensor(np.asarray(out))
        t_m, t_l = torch.tensor(np.asarray(m)), torch.tensor(np.asarray(l))
    else:
        with pytest.raises(ValueError, match="block-aligned"):
            _fit_block(64, t_len)
        bias = jatt.composed_bias(jpad, causal, t_len)
        _, vjp = jax.vjp(
            lambda a, b, c: jatt.multi_head_attention(a, b, c, bias),
            jq, jk, jv)
        ref = vjp(jg)
        t_out, t_m, t_l = fa._fa_forward_plain(tq, tk, tv, tpad, causal)
    delta = fa._delta(tg, t_out)
    args = (tq, tk, tv, tpad, tg, t_m, t_l, delta, causal)
    dk, dv = fa._fa_bwd_dkv_plain(*args)
    dq = fa._fa_bwd_dq_plain(*args)
    for a, r in zip((dq, dk, dv), ref):
        assert a.shape == (3, t_len, H, D)
        _close(a, r, _tol("f32", grad=True))


def test_ragged_t_plain_matches_reference_chain():
    """Any T >= 1 works (no tiling gate): at T = 37 the plain forward
    equals the shared attention chain with the composed bias."""
    from kubeml_tpu_torch.ops.attention import (composed_bias,
                                                multi_head_attention)
    from kubeml_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, _, pad = (torch.from_numpy(a) for a in _inputs(7, T=37))
    for causal in (False, True):
        ref = multi_head_attention(q, k, v, composed_bias(pad, causal, 37))
        torch.testing.assert_close(flash_attention(q, k, v, pad, causal),
                                   ref, rtol=2e-5, atol=2e-5)


def test_wrapper_routes_by_device_and_never_falls_back():
    """CPU tensors run the plain versions; a tensor on any device other
    than the CPU or CUDA raises, and no launch counter moves."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    q, k, v, g, pad = (torch.from_numpy(a) for a in _inputs(8))
    before = (fa.fa_fwd_kernel.launches, fa.fa_bwd_dkv_kernel.launches,
              fa.fa_bwd_dq_kernel.launches)
    out, m, l = fa._fa_forward(q, k, v, pad, True)
    for a, b in zip((out, m, l), fa._fa_forward_plain(q, k, v, pad, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    meta = [t.to("meta") for t in (q, k, v, pad)]
    with pytest.raises(ValueError, match="CUDA"):
        fa._fa_forward(*meta, True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*meta, False)
    with pytest.raises(ValueError, match="CUDA"):
        fa._fa_backward(*meta, out.to("meta"), m.to("meta"), l.to("meta"),
                        g.to("meta"), True)
    assert (fa.fa_fwd_kernel.launches, fa.fa_bwd_dkv_kernel.launches,
            fa.fa_bwd_dq_kernel.launches) == before


def test_kernel_argument_checks():
    """The kernel wrappers' checks run before any launch, so they are
    testable on the CPU: shape, dtype, layout, alignment and head_dim."""
    from kubeml_tpu_torch.ops.flash_attention import _check_kernel_args

    q, k, v, g, pad = (torch.from_numpy(a) for a in _inputs(9))
    rows = torch.zeros((B * H, 1, T))
    _check_kernel_args(q, k, v, pad, g, (rows, rows, rows))
    with pytest.raises(ValueError, match="shapes differ"):
        _check_kernel_args(q, k[:, :-1].contiguous(), v, pad)
    with pytest.raises(TypeError, match="share one dtype"):
        _check_kernel_args(q, k.to(torch.bfloat16), v, pad)
    with pytest.raises(TypeError, match="f32 or bf16"):
        _check_kernel_args(q.half(), k.half(), v.half(), pad)
    with pytest.raises(ValueError, match="pad_mask"):
        _check_kernel_args(q, k, v, pad.double())
    with pytest.raises(ValueError, match="row statistics"):
        _check_kernel_args(q, k, v, pad, g, (rows[:, :, :-1], rows, rows))
    with pytest.raises(ValueError, match="contiguous"):
        _check_kernel_args(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, pad)
    with pytest.raises(ValueError, match="span devices"):
        _check_kernel_args(q, k, v, pad.to("meta"))
    odd = torch.zeros((B, T, H, 6))
    with pytest.raises(ValueError, match="16-byte"):
        _check_kernel_args(odd, odd, odd, pad)
    wide = torch.zeros((1, 4, 1, 256))
    with pytest.raises(ValueError, match="head_dim 256"):
        _check_kernel_args(wide, wide, wide, torch.ones((1, 4)))


# ------------------------------------------------------------------- card
GPU_CASES = [  # (dtype, T, causal, head_dim)
    ("bf16", 192, True, 16), ("bf16", 192, False, 16), ("f32", 192, True, 16),
    ("bf16", 100, True, 16), ("f32", 37, False, 16),
    # the other tensor-core head dims, and one bf16 head_dim (24) that
    # only the FMA kernels take
    ("bf16", 130, True, 32), ("bf16", 130, True, 64), ("bf16", 130, True, 128),
    ("bf16", 77, False, 24),
    # tile edges of the backward's schedule (EDGE_T): causal blocks own a
    # pair of tiles, an odd tile count leaves the middle tile alone
    *[("bf16", t_len, causal, head_dim) for t_len in EDGE_T
      for causal in (True, False) for head_dim in (64, 128)],
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,t_len,causal,head_dim", GPU_CASES)
def test_kernels_match_plain_on_card(cuda_device, dtype, t_len, causal,
                                     head_dim):
    """On the card: each of the three kernels against its plain version on
    the same CUDA inputs (f32 2e-5, bf16 2e-2), one launch each."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(head_dim)
    q, k, v, g, pad = (torch.from_numpy(a).to(cuda_device)
                       for a in _inputs(11, T=t_len))
    if head_dim != D:
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (B, t_len, H, head_dim)).astype(np.float32)).to(cuda_device)
            for _ in range(4))
    q, k, v, g = (a.to(tdt) for a in (q, k, v, g))
    tol = 2e-2 if dtype == "bf16" else 2e-5
    before = fa.fa_fwd_kernel.launches
    out, m, l = fa.fa_fwd_kernel(q, k, v, pad, causal)
    torch.cuda.synchronize()
    assert fa.fa_fwd_kernel.launches == before + 1
    for a, b in zip((out, m, l), fa._fa_forward_plain(q, k, v, pad, causal)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    delta = fa._delta(g, out)
    dk, dv = fa.fa_bwd_dkv_kernel(q, k, v, pad, g, m, l, delta, causal)
    dq = fa.fa_bwd_dq_kernel(q, k, v, pad, g, m, l, delta, causal)
    torch.cuda.synchronize()
    ref_dk, ref_dv = fa._fa_bwd_dkv_plain(q, k, v, pad, g, m, l, delta,
                                          causal)
    ref_dq = fa._fa_bwd_dq_plain(q, k, v, pad, g, m, l, delta, causal)
    for a, b in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("t_len,causal,head_dim",
                         [(320, True, 64), (512, True, 128), (65, False, 64),
                          (200, True, 32)])
def test_backward_kernels_deterministic_on_card(cuda_device, t_len, causal,
                                                head_dim):
    """No atomics: two launches of each backward kernel on the same inputs
    are equal bit for bit."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(t_len + head_dim)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, t_len, H, head_dim)).astype(np.float32)).to(cuda_device,
                                                        torch.bfloat16)
        for _ in range(4))
    pad = torch.from_numpy(_right_padded(0, t_len)[4]).to(cuda_device)
    out, m, l = fa.fa_fwd_kernel(q, k, v, pad, causal)
    args = (q, k, v, pad, g, m, l, fa._delta(g, out), causal)
    first = (*fa.fa_bwd_dkv_kernel(*args), fa.fa_bwd_dq_kernel(*args))
    second = (*fa.fa_bwd_dkv_kernel(*args), fa.fa_bwd_dq_kernel(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# --------------------------------- the card forward's two-warpgroup schedule
KV_TILE = 64         # the card kernels' tile


def _walk(n, causal):
    """The card's blocks as make_walk builds them for a Q-tile owner:
    causal block p owns (p, n - 1 - p) (the middle tile of an odd count
    alone); each owned tile walks its KV tiles 0 .. (own if causal else
    n - 1) in order, one flat run of steps."""
    blocks = []
    for p in range((n + 1) // 2 if causal else n):
        own = [p] if not causal or n - 1 - p == p else [p, n - 1 - p]
        blocks.append([(o, j) for o in own
                       for j in range(o + 1 if causal else n)])
    return blocks


def _two_warpgroup_forward(q, k, v, pad, causal):
    """The card forward's schedule replayed in torch on the plain version's
    f32 scores: warpgroup w takes steps w, w + 2, ... of its block's walk
    with its own (acc, m, l) from (0, NEG_INF, 0) — m_new = max(m, tile
    max), alpha = exp(m - m_new), p = exp(s - m_new) (keys past T: none),
    l = l alpha + rowsum(p), acc = acc alpha + bf16(p) v — and when an
    owned tile is done the two states merge in a fixed order (warpgroup
    0's, then 1's): m = max(m0, m1), l and acc rescaled and summed, out =
    acc / max(l, 1e-30)."""
    from kubeml_tpu_torch.ops.attention import NEG_INF
    from kubeml_tpu_torch.ops.flash_attention import _scores_plain

    B_, T_, H_, D_ = q.shape
    s = _scores_plain(q, k, pad, causal)              # [B, H, T, T]
    out = torch.empty_like(q)
    m_rows = torch.empty((B_, H_, T_))
    l_rows = torch.empty((B_, H_, T_))
    n = -(-T_ // KV_TILE)
    for walk in _walk(n, causal):
        for o in dict.fromkeys(own for own, _ in walk):
            rows = slice(o * KV_TILE, min((o + 1) * KV_TILE, T_))
            nr = rows.stop - rows.start
            state = [[torch.full((B_, H_, nr), NEG_INF),
                      torch.zeros((B_, H_, nr)),
                      torch.zeros((B_, H_, nr, D_))] for _ in range(2)]
            for step, (own, j) in enumerate(walk):
                if own != o:
                    continue
                cols = slice(j * KV_TILE, min((j + 1) * KV_TILE, T_))
                st = state[step % 2]
                x = s[:, :, rows, cols]
                m_new = torch.maximum(st[0], x.amax(-1))
                alpha = torch.exp(st[0] - m_new)
                p = torch.exp(x - m_new[..., None])
                st[1] = st[1] * alpha + p.sum(-1)
                vt = v[:, cols].permute(0, 2, 1, 3).float()
                st[2] = st[2] * alpha[..., None] \
                    + p.to(v.dtype).float() @ vt
                st[0] = m_new
            (m0, l0, a0), (m1, l1, a1) = state
            m = torch.maximum(m0, m1)
            f0, f1 = torch.exp(m0 - m), torch.exp(m1 - m)
            l = (l0 * f0 + l1 * f1).clamp_min(1e-30)
            acc = a0 * f0[..., None] + a1 * f1[..., None]
            out[:, rows] = (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
            m_rows[:, :, rows], l_rows[:, :, rows] = m, l
    return (out, m_rows.reshape(B_ * H_, 1, T_),
            l_rows.reshape(B_ * H_, 1, T_))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_len", [1, 63, 64, 65, 200])
def test_two_warpgroup_forward_matches_jax(t_len, causal, dtype):
    """The card forward's schedule (alternate KV tiles per warpgroup, a
    fixed-order merge) against the JAX forward: its Pallas kernel in
    interpret mode where it tiles T (64, 200), else (T = 1, 63, 65, which
    it refuses) the JAX package's attention chain with the composed bias.
    m equals the plain version's exactly (a max is order-free), and the
    fully padded sequence's l counts its keys exactly."""
    import jax.numpy as jnp

    from kubeml_tpu.ops import attention as jatt
    from kubeml_tpu.ops.pallas.flash_attention import _fa_forward as jax_fwd
    from kubeml_tpu.ops.pallas.flash_attention import _fit_block
    from kubeml_tpu_torch.ops.flash_attention import _fa_forward_plain

    q, k, v, _, pad = _inputs(30 + t_len + causal, T=t_len)
    jdt, tdt = _types(dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tpad = torch.from_numpy(pad)
    out, m, l = _two_warpgroup_forward(tq, tk, tv, tpad, causal)
    tol = _tol(dtype)
    block = 64 if t_len % 64 == 0 else 40
    if t_len in (64, 200):
        r_out, r_m, r_l = jax_fwd(jq, jk, jv, jnp.asarray(pad), causal,
                                  block, block, True)
        torch.testing.assert_close(m, torch.tensor(np.asarray(r_m)),
                                   rtol=tol, atol=tol)
        torch.testing.assert_close(l, torch.tensor(np.asarray(r_l)),
                                   rtol=tol, atol=tol)
    else:
        with pytest.raises(ValueError, match="block-aligned"):
            _fit_block(64, t_len)
        r_out = jatt.multi_head_attention(
            jq, jk, jv, jatt.composed_bias(jnp.asarray(pad), causal, t_len))
    _close(out, r_out, tol)
    _, p_m, p_l = _fa_forward_plain(tq, tk, tv, tpad, causal)
    assert torch.equal(m, p_m)
    torch.testing.assert_close(l, p_l, rtol=tol, atol=tol)
    want = np.arange(1, t_len + 1) if causal else np.full(t_len, t_len)
    np.testing.assert_array_equal(l.reshape(B, H, t_len)[2].numpy(),
                                  np.broadcast_to(want, (H, t_len)))


FWD_T = (1, 63, 64, 65, 130, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_len", FWD_T)
def test_forward_kernel_on_card(cuda_device, t_len, causal, head_dim):
    """On the card, the bf16 forward (two warpgroups, a fixed-order merge)
    against its plain version at 2e-2, right padding with a fully padded
    sequence (l counts its keys exactly) and left padding; two launches
    equal bit for bit."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(t_len + head_dim + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (4, t_len, H, head_dim)).astype(np.float32)).to(cuda_device,
                                                        torch.bfloat16)
        for _ in range(3))
    lengths = np.array([t_len, -(-t_len // 2), 0, t_len])
    keep = (np.arange(t_len)[None, :] < lengths[:, None]).astype(np.float32)
    keep[3, :t_len // 3] = 0.0                      # left padding
    pad = torch.from_numpy(keep).to(cuda_device)
    got = fa.fa_fwd_kernel(q, k, v, pad, causal)
    again = fa.fa_fwd_kernel(q, k, v, pad, causal)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    out, m, l = got
    ref_out, ref_m, ref_l = fa._fa_forward_plain(q, k, v, pad, causal)
    # causal rows of the left-padded sequence with no kept key of their own
    # drop the keys of skipped tiles (the header's left-padding rule): such
    # a row is uniform over the keys at or before it and the kept keys after
    # it in its own diagonal tile
    rows = torch.ones((4, t_len), dtype=torch.bool)
    if causal:
        rows[3, :t_len // 3] = False
        l3 = l.reshape(4, H, t_len)[3].cpu()
        for r in range(t_len // 3):
            end = min(t_len, (r // 64 + 1) * 64)
            assert bool((l3[:, r] == r + 1 + keep[3, r + 1:end].sum()).all())
    torch.testing.assert_close(out.float()[rows], ref_out.float()[rows],
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(m, ref_m, rtol=2e-2, atol=2e-2)
    stat_rows = rows[:, None].expand(4, H, t_len).reshape(4 * H, 1, t_len)
    torch.testing.assert_close(l[stat_rows.to(l.device)],
                               ref_l[stat_rows.to(l.device)], rtol=2e-2,
                               atol=2e-2)
    want = (torch.arange(1, t_len + 1) if causal
            else torch.full((t_len,), t_len)).float().to(cuda_device)
    assert torch.equal(l.reshape(4, H, t_len)[2], want.expand(H, t_len))
