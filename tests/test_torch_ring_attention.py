"""Port parity: ring attention and Ulysses over ``torch.distributed`` seq
ranks (``kubeml_tpu_torch/parallel/ring_attention.py``, ``ulysses.py``)
against the JAX package's on a virtual CPU mesh.

The port's ranks are 2 or 4 processes of ``tools/launch_distributed``
(``--emulate-cpu 1``) joined over gloo, each running this file's
``__main__`` block with a rank grid of one lane group (``make_grid(n)``);
the JAX package's ``ring_self_attention``/``ulysses_self_attention`` run
in the test process on ``make_mesh(n_data=1, n_seq=n)`` meanwhile. One
launch per n, started together by the module fixture.

What is held, and how tightly (f32 1e-5, bf16 2e-2):
  - the flash ring (the kernels' plain versions on the CPU, one forward a
    visiting block, the backward ring fed the global row statistics)
    against the reference's interpret-mode flash ring, and the dense ring
    against the reference's dense ring: outputs and the q/k/v gradients
    of a weighted sum, at n = 2 and 4, causal with padding that crosses
    the blocks and a fully padded row (its dropped blocks merge at
    NEG_INF scale, as the reference's do), and non-causal with padding;
  - Ulysses at n = 2 against the reference's;
  - a causal flash call on a non-contiguous layout: RingLayoutError at
    the host from ring_self_attention, NaN from the raw body on every
    rank; Ulysses refuses H % n != 0 with the reference's message.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, D = 2, 32, 4, 8
NS = (2, 4)
CASES = ("causal", "noncausal")
TOL = {"f32": 1e-5, "bf16": 2e-2}
# (n, impl, dtype) runs; Ulysses at n = 2
RUNS = [(n, impl, dt) for n in NS for impl in ("flash", "dense")
        for dt in ("f32", "bf16")] + [(2, "ulysses", dt)
                                      for dt in ("f32", "bf16")]


def _inputs(case):
    """(q, k, v, cotangent w, keep-mask) as f32 numpy: padding that ends
    inside the third of four blocks in row 0, and row 1 fully padded
    (causal), or interior padding (non-causal)."""
    rng = np.random.RandomState(7 if case == "causal" else 8)
    q, k, v, w = (rng.randn(B, T, H, D).astype(np.float32)
                  for _ in range(4))
    pad = np.ones((B, T), np.float32)
    pad[0, 20:] = 0.0
    if case == "causal":
        pad[1, :] = 0.0
    else:
        pad[1, 5:9] = 0.0
    return q, k, v, w, pad


# ------------------------------------------------------------- the ranks

def attn_worker(outdir, n):
    """Every run of RUNS at this world's n, gradients summed over the
    ranks (each rank's backward fills its own blocks); rank 0 writes."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.ring_attention import (
        RingLayoutError, ring_attention, ring_self_attention)
    from kubeml_tpu_torch.parallel.ulysses import ulysses_self_attention

    grid = dl.make_grid(n)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = {}
    for case in CASES:
        q, k, v, w, pad = _inputs(case)
        causal = case == "causal"
        mask = torch.from_numpy(pad)
        for rn, impl, dt in RUNS:
            if rn != n:
                continue
            qkv = [torch.from_numpy(t).to(dtypes[dt]).requires_grad_()
                   for t in (q, k, v)]
            if impl == "ulysses":
                o = ulysses_self_attention(*qkv, mask, grid, causal=causal)
            else:
                o = ring_self_attention(*qkv, mask, grid, causal=causal,
                                        use_flash=impl == "flash")
            (o.float() * torch.from_numpy(w)).sum().backward()
            key = f"{case}/{impl}/{dt}"
            out[f"{key}/out"] = o.detach().float().numpy()
            for name, t in zip("qkv", qkv):
                out[f"{key}/d{name}"] = dl.all_reduce(
                    t.grad.float()).numpy()
    # a causal flash call on a strided layout: refused at the host, NaN
    # from the raw body
    q, k, v, _, pad = _inputs("causal")
    strided = np.arange(T).reshape(T // n, n).T.reshape(-1)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    try:
        ring_self_attention(tq, tk, tv, torch.ones(B, T), grid, causal=True,
                            use_flash=True, positions=strided)
        out["layout_error"] = np.array("")
    except RingLayoutError as e:
        out["layout_error"] = np.array(str(e))
    Tl, i = T // n, grid.seq_index
    mine = slice(i * Tl, (i + 1) * Tl)
    pos = torch.from_numpy(strided[mine])
    raw = ring_attention(tq[:, mine], tk[:, mine], tv[:, mine], pos, pos,
                         torch.ones(B, Tl), causal=True, use_flash=True)
    out["raw_nan"] = np.array(bool(dl.all_reduce(
        torch.isnan(raw).all().float()) == n))
    try:
        ulysses_self_attention(*(t[:, :, :3].contiguous()
                                 for t in (tq, tk, tv)),
                               torch.ones(B, T), grid)
        out["heads_error"] = np.array("")
    except ValueError as e:
        out["heads_error"] = np.array(str(e))
    if dl.rank() == 0:
        np.savez(os.path.join(outdir, f"attn_{n}.npz"), **out)


# -------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both launches (2 and 4 ranks) started together; their rows."""
    outdir = str(tmp_path_factory.mktemp("ringattn"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tools.launch_distributed", "--processes",
         str(n), "--emulate-cpu", "1", "--", sys.executable,
         os.path.abspath(__file__), str(n), outdir],
        cwd=REPO, env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in NS]
    texts = []
    for p in procs:
        try:
            texts.append(p.communicate(timeout=600)[0])
        finally:
            if p.poll() is None:
                p.kill()
    for n, p, text in zip(NS, procs, texts):
        assert p.returncode == 0, f"{n} ranks failed:\n{text[-8000:]}"
    return {n: dict(np.load(os.path.join(outdir, f"attn_{n}.npz")))
            for n in NS}


def _reference(case, n, impl, dt):
    """The JAX package's output and q/k/v gradients of the same run."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.parallel.ring_attention import ring_self_attention
    from kubeml_tpu.parallel.ulysses import ulysses_self_attention

    q, k, v, w, pad = _inputs(case)
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    mesh = make_mesh(n_data=1, n_seq=n, devices=jax.devices()[:n])
    causal = case == "causal"

    def f(q, k, v):
        if impl == "ulysses":
            return ulysses_self_attention(q, k, v, jnp.asarray(pad), mesh,
                                          causal=causal)
        return ring_self_attention(q, k, v, jnp.asarray(pad), mesh,
                                   causal=causal,
                                   use_flash=impl == "flash",
                                   interpret=impl == "flash")

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(w.astype(out.dtype)))

    return [np.asarray(t, np.float32) for t in run(
        *(jnp.asarray(t, dtype) for t in (q, k, v)), jnp.asarray(w))]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,impl,dt", RUNS,
                         ids=[f"{n}-{i}-{d}" for n, i, d in RUNS])
def test_ring_matches_reference(ranks, case, n, impl, dt):
    """The port's output and q/k/v gradients equal the JAX package's
    within f32 1e-5 / bf16 2e-2, finite everywhere (the fully padded
    row included)."""
    got = ranks[n]
    want = _reference(case, n, impl, dt)
    tol = TOL[dt]
    for name, ref in zip(("out", "dq", "dk", "dv"), want):
        have = got[f"{case}/{impl}/{dt}/{name}"]
        assert np.isfinite(have).all(), name
        np.testing.assert_allclose(have, ref, rtol=tol, atol=tol,
                                   err_msg=f"{case} {impl} {dt} {name}")


@pytest.mark.parametrize("n", NS)
def test_noncontiguous_causal_flash_is_refused(ranks, n):
    """RingLayoutError at the host (the reference's message), NaN from
    the raw body on every rank."""
    got = ranks[n]
    assert "requires the contiguous shard layout" in str(got["layout_error"])
    assert bool(got["raw_nan"])


def test_ulysses_refuses_heads_not_divisible(ranks):
    """H % n != 0: the reference's ValueError."""
    assert str(ranks[2]["heads_error"]) == \
        "head count 3 not divisible by seq=2"


def test_layout_error_at_the_host_without_a_group():
    """One process (n = 1): a strided causal flash call raises at the
    host, shape errors are typed, contiguous positions equal the
    default, and the dense ring takes the strided layout."""
    import torch

    from kubeml_tpu_torch.parallel.ring_attention import (RingLayoutError,
                                                          ring_self_attention)

    q, k, v, _, _ = (torch.from_numpy(t) for t in _inputs("causal"))
    pad = torch.ones(B, T)
    strided = np.arange(T).reshape(T // 4, 4).T.reshape(-1)
    with pytest.raises(RingLayoutError, match="contiguous"):
        ring_self_attention(q, k, v, pad, causal=True, use_flash=True,
                            positions=strided)
    with pytest.raises(RingLayoutError, match="global ids"):
        ring_self_attention(q, k, v, pad, positions=strided[:8])
    out = ring_self_attention(q, k, v, pad, causal=True, use_flash=True,
                              positions=np.arange(T))
    ref = ring_self_attention(q, k, v, pad, causal=True, use_flash=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    dense = ring_self_attention(q, k, v, pad, causal=True,
                                positions=strided)
    assert torch.isfinite(dense).all()


if __name__ == "__main__":
    import faulthandler

    faulthandler.dump_traceback_later(120, repeat=True)
    sys.path.insert(0, REPO)
    import torch

    from kubeml_tpu_torch.parallel import distributed as dist_lib

    torch.set_num_threads(1)
    n, outdir = int(sys.argv[1]), sys.argv[2]
    dist_lib.initialize(device="cpu", timeout=120)
    attn_worker(outdir, n)
    print(f"attn rank {dist_lib.rank()} OK", flush=True)
