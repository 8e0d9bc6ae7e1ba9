"""Port parity: ``kubeml_tpu_torch.parallel.collectives.ring_psum`` over
four gloo ranks against the JAX package's ``ring_psum`` on a 4-lane CPU
mesh (the cases of tests/test_collectives.py).

The ranks are processes of ``tools/launch_distributed`` (``--emulate-cpu
1``) running this file's ``__main__`` block; rank r reduces lane r of the
same seeded inputs. The ring's hop schedule, its f32 accumulation and the
owner's wire rounding are the reference's, so every output is held to the
reference's bit for bit, in f32 and with a bf16 wire, and every rank's
output to rank 0's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
# name: (seed, shape of one lane's leaf, wire)
CASES = {
    "f32-n37": (0, (37,), "f32"),
    "f32-n64": (0, (64,), "f32"),
    "f32-n1": (0, (1,), "f32"),
    "bf16-n37": (1, (37,), "bf16"),
    "bf16-n64": (1, (64,), "bf16"),
    "bf16-n1": (1, (1,), "bf16"),
    "bf16-n257": (1, (257,), "bf16"),
    "identity-bf16": (5, (193,), "bf16"),
    "identity-f32": (5, (193,), "f32"),
    "multidim": (4, (3, 5, 2), "f32"),
}


def _lanes(seed, shape):
    """Every lane's input: [RANKS, *shape] f32 from the seed."""
    return np.random.RandomState(seed).randn(RANKS, *shape).astype(
        np.float32)


def _launch(mode, outdir, ranks, timeout):
    """Run this file's worker ``mode`` in ``ranks`` processes through the
    product launcher; returns its stdout."""
    proc = subprocess.run(
        [sys.executable, "-m", "tools.launch_distributed", "--processes",
         str(ranks), "--emulate-cpu", "1", "--", sys.executable,
         os.path.abspath(__file__), mode, outdir],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, \
        f"launcher failed:\n{proc.stdout[-6000:]}\n{proc.stderr[-3000:]}"
    return proc.stdout


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ring"))
    stdout = _launch("ring", outdir, RANKS, 300)
    return {r: np.load(os.path.join(outdir, f"ring_p{r}.npz"))
            for r in range(RANKS)}, stdout


def _reference_ring(x, wire):
    """The JAX package's ring over a 4-lane CPU mesh: every lane's output,
    [RANKS, *shape]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.collectives import ring_psum
    from kubeml_tpu.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(n_data=RANKS, devices=jax.devices()[:RANKS])
    dt = jnp.bfloat16 if wire == "bf16" else jnp.float32
    out = jax.jit(compat.shard_map(
        lambda v: ring_psum(v, DATA_AXIS, dt), mesh=mesh,
        in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS),
        check_vma=False))(jnp.asarray(x))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_psum_matches_reference_ring(ring_run, case):
    """Every rank's output equals the reference lane's bit for bit; a
    bf16 wire is really lossy, and within the reference's tolerance."""
    outs, stdout = ring_run
    seed, shape, wire = CASES[case]
    x = _lanes(seed, shape)
    want = _reference_ring(x, wire)           # [RANKS, *shape]
    for r in range(RANKS):
        got = outs[r][case]
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want[r], err_msg=f"rank {r}")
    if wire == "bf16" and x[0].size > 1:
        total = x.sum(axis=0)
        np.testing.assert_allclose(outs[0][case], total, rtol=5e-2,
                                   atol=5e-2)
        assert not np.allclose(outs[0][case], total, rtol=1e-6, atol=0)


@pytest.mark.parametrize("wire", ["bf16", "f32"])
def test_ring_lane_identity_across_ranks(ring_run, wire):
    """Every rank holds the same reduced value, the chunk it owns
    included (the owner rounds it through the wire as the others
    receive it)."""
    outs, _ = ring_run
    case = f"identity-{wire}"
    for r in range(1, RANKS):
        np.testing.assert_array_equal(outs[r][case], outs[0][case])


def test_ring_multidim_leaves(ring_run):
    """A weight-shaped leaf keeps its shape through the flatten/pad path
    and sums within f32 round-off."""
    outs, _ = ring_run
    seed, shape, _ = CASES["multidim"]
    np.testing.assert_allclose(outs[0]["multidim"],
                               _lanes(seed, shape).sum(axis=0),
                               rtol=1e-5, atol=1e-6)


def test_ring_without_group_is_passthrough():
    """Without a process group (world size 1) the ring returns its input
    as it is, as the reference's D == 1 ring."""
    import torch

    from kubeml_tpu_torch.parallel.collectives import ring_psum

    x = torch.from_numpy(_lanes(3, (16,))[0])
    assert ring_psum(x, None, torch.bfloat16) is x


# ------------------------------------------------------------- the ranks

def _worker_ring(outdir):
    import torch

    from kubeml_tpu_torch.parallel import distributed as dist_lib
    from kubeml_tpu_torch.parallel.collectives import ring_psum

    dist_lib.initialize(device="cpu", timeout=120)
    rank = dist_lib.rank()
    assert dist_lib.world_size() == RANKS
    out = {}
    for case, (seed, shape, wire) in CASES.items():
        x = torch.from_numpy(_lanes(seed, shape)[rank])
        dt = torch.bfloat16 if wire == "bf16" else torch.float32
        out[case] = ring_psum(x, None, dt).numpy()
    np.savez(os.path.join(outdir, f"ring_p{rank}.npz"), **out)
    print(f"ringproc {rank} OK", flush=True)


if __name__ == "__main__":
    import faulthandler

    # a cross-process hang shows where each rank is stuck
    faulthandler.dump_traceback_later(120, repeat=True)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    {"ring": _worker_ring}[mode](outdir)
