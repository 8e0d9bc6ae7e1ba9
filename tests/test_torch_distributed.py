"""Port parity: data lanes as ``torch.distributed`` ranks
(``kubeml_tpu_torch/parallel/distributed.py``) against the JAX package's
multi-process runtime and against the port in one process.

The ranks are processes of ``tools/launch_distributed`` (``--processes 2
--emulate-cpu 1``) joined over gloo through the ``KUBEML_*`` environment,
each running this file's ``__main__`` block; the one-process runs are the
same block without the launcher. Every process runs torch on one thread,
so two processes sum alike. Module-scoped fixtures share one launch per
mode.

What is held, and how tightly:
  - two ranks of one lane each against one process of two lanes: every
    cross-rank sum has two terms, so weights, loss sums, drops and EF
    residuals (each rank's the matching slice of the one process's) are
    equal bit for bit under the monolithic, bucketed, ef_bf16 and ef_int8
    merges; two lanes on each rank (a sum in another order) within f32
    1e-5;
  - the two-rank round against the JAX package's 2-lane round within f32
    1e-5 (as the JAX package holds its own two-process round against its
    one-process round, tests/test_distributed_multiprocess.py);
  - a two-rank TrainJob (3 epochs, N 2 -> 4 -> 4): both ranks' histories
    equal, and equal to the one-process port job's; the checkpoint loads
    in both packages; a rank killed after epoch 1's checkpoint is
    restarted by the launcher's supervisor and the resumed histories are
    continuous and equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, S, B, DIM, CLASSES, LR = 8, 2, 4, 8, 4, 0.1
BUCKET_MB = 0.0004          # ~100 f32 elements: the mlp in 3 buckets
# name: (lanes, engine knobs); every name but the last runs 1 lane a rank
STRATEGIES = {
    "monolithic": (2, {}),
    "bucketed": (2, dict(merge_bucket_mb=BUCKET_MB)),
    "ef_bf16": (2, dict(merge_compress="bf16", merge_bucket_mb=BUCKET_MB)),
    "ef_int8": (2, dict(merge_compress="int8", merge_bucket_mb=BUCKET_MB)),
    "bucketed-4lanes": (4, dict(merge_bucket_mb=BUCKET_MB)),
}
TWO_LANES = [k for k, (lanes, _) in STRATEGIES.items() if lanes == 2]
ROUNDS = 2
JOB_ID = "distjob"
CHAOS_JOB = "distjobc"


def _round_inputs(r):
    """Round r's inputs; round 1 masks workers 4-7 out (lane 1 of two,
    and so rank 1, contributes nothing)."""
    rng = np.random.RandomState(100 + r)
    x = rng.randn(W, S, B, DIM).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(W, S, B)).astype(np.int32)
    rngs = rng.randint(0, 2 ** 31, size=(W, S, 2)).astype(np.uint32)
    wmask = np.ones(W, np.float32)
    if r == 1:
        wmask[W // 2:] = 0.0
    return ({"x": x, "y": y}, np.ones((W, S, B), np.float32),
            np.ones((W, S), np.float32), wmask, rngs)


def _launch(mode, outdir, ranks=2, timeout=600, extra=()):
    """This file's worker ``mode`` in ``ranks`` processes through the
    product launcher (``extra``: launcher flags); returns the run."""
    return subprocess.run(
        [sys.executable, "-m", "tools.launch_distributed", "--processes",
         str(ranks), "--emulate-cpu", "1", *extra, "--", sys.executable,
         os.path.abspath(__file__), mode, outdir],
        cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
        timeout=timeout)


def _single(mode, outdir):
    """The worker ``mode`` in one process without a group (started, not
    waited for)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBEML_")}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             mode, outdir], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _both(mode, outdir, timeout):
    """The two-rank launch and the one-process run of ``mode``, side by
    side; both must exit 0."""
    single = _single(f"{mode}-single", outdir)
    try:
        run = _launch(mode, outdir, timeout=timeout)
        out, _ = single.communicate(timeout=timeout)
    finally:
        if single.poll() is None:
            single.kill()
    assert run.returncode == 0, \
        f"launcher failed:\n{run.stdout[-6000:]}\n{run.stderr[-3000:]}"
    assert single.returncode == 0, out[-6000:]
    return run.stdout


def _mlp_flax_params():
    """A JAX-initialised mlp (hidden 16, 4 classes): the common start."""
    import jax

    from kubeml_tpu.models import get_builtin

    ref = get_builtin("mlp")(hidden=16, num_classes=CLASSES)
    x = _round_inputs(0)[0]["x"]
    variables = ref.init_variables(jax.random.PRNGKey(0), {"x": x[0, 0]})
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def round_run(tmp_path_factory):
    from kubeml_tpu_torch.models import get_model

    outdir = str(tmp_path_factory.mktemp("distround"))
    start = get_model("mlp")(hidden=16, num_classes=CLASSES) \
        .params_from_flax(_mlp_flax_params())
    np.savez(os.path.join(outdir, "init.npz"),
             **{k: v.numpy() for k, v in start.items()})
    stdout = _both("round", outdir, timeout=600)
    load = lambda name: dict(np.load(os.path.join(outdir, name)))  # noqa
    return ({r: load(f"round_p{r}.npz") for r in range(2)},
            load("round_single.npz"), outdir, stdout)


def _keys(out, name, r, kind):
    pre = f"{name}/r{r}/{kind}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_rank_round_ranks_equal(round_run, name):
    """Both ranks hold the same merged weights and the same gathered
    per-worker loss sums and drops after every round."""
    ranks, _, _, _ = round_run
    for k in ranks[0]:
        if (k.startswith(name + "/") and "/res/" not in k
                and not k.endswith("/copied")):
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k],
                                          err_msg=k)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_rank_round_copies_own_workers(round_run, name):
    """A rank copies to its device only its own lanes' workers' rows of
    the round's batch (rank r: workers [r * W / 2, (r + 1) * W / 2));
    one process copies all W."""
    ranks, single, _, _ = round_run
    for r in range(ROUNDS):
        x = _round_inputs(r)[0]["x"]
        np.testing.assert_array_equal(single[f"{name}/r{r}/copied"], x)
        for rank in range(2):
            np.testing.assert_array_equal(
                ranks[rank][f"{name}/r{r}/copied"],
                x[rank * W // 2:(rank + 1) * W // 2], err_msg=(r, rank))


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_two_rank_round_equals_one_process(round_run, name):
    """Two ranks of one lane each ≡ one process of two lanes bit for bit
    (weights, loss sums, drops); two lanes a rank ≡ one process of four
    lanes within f32 1e-5."""
    ranks, single, _, _ = round_run
    keys = [k for k in single if k.startswith(name + "/")
            and "/res/" not in k and not k.endswith("/copied")]
    assert keys
    for k in keys:
        if STRATEGIES[name][0] == 2:
            np.testing.assert_array_equal(ranks[0][k], single[k],
                                          err_msg=k)
        else:
            np.testing.assert_allclose(ranks[0][k], single[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["ef_bf16", "ef_int8"])
def test_two_rank_residuals_are_slices(round_run, name):
    """Each rank keeps its own lane's EF residual, [1 * L], equal bit for
    bit to its slice of the one process's [2 * L]; after round 1 (lane 1
    dead) rank 1's is zero."""
    ranks, single, _, _ = round_run
    for r in range(ROUNDS):
        whole = _keys(single, name, r, "res")
        assert whole
        for bucket, full in whole.items():
            lanes = full.reshape(2, -1)
            for rank in range(2):
                got = _keys(ranks[rank], name, r, "res")[bucket]
                np.testing.assert_array_equal(got, lanes[rank],
                                              err_msg=(r, bucket, rank))
            if r == 1:
                assert not lanes[1].any() and lanes[0].any()


@pytest.mark.parametrize("name", TWO_LANES)
def test_two_rank_round_matches_reference(round_run, name):
    """The two-rank round against the JAX package's round on a 2-lane CPU
    mesh from the same parameters and inputs: merged weights within f32
    1e-5 after each round, loss sums within 1e-5, drops equal."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.models import get_model

    ranks, _, _, _ = round_run
    ref = get_builtin("mlp")(hidden=16, num_classes=CLASSES)
    port = get_model("mlp")(hidden=16, num_classes=CLASSES)
    eng = JaxEngine(make_mesh(n_data=2, devices=jax.devices()[:2]),
                    ref.loss, ref.metrics, ref.configure_optimizers,
                    donate=False, **STRATEGIES[name][1])
    assert eng.merge_strategy == name
    variables = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                  _mlp_flax_params())}
    for r in range(ROUNDS):
        batch, *masks = _round_inputs(r)
        variables, st = eng.train_round(
            variables, {k: jnp.asarray(v) for k, v in batch.items()},
            *masks, LR, 0)
        want = port.params_from_flax(jax.tree_util.tree_map(
            np.asarray, variables["params"]))
        got = _keys(ranks[0], name, r, "w")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=(r, k))
        np.testing.assert_allclose(ranks[0][f"{name}/r{r}/loss"],
                                   np.asarray(st.loss_sum), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(ranks[0][f"{name}/r{r}/dropped"],
                                      np.asarray(st.dropped))


def test_syncdp_builds_and_uneven_lanes_refused_over_ranks(round_run):
    """Over two ranks a SyncDP engine builds over the mlp, its implicit
    path refuses a BatchNorm model with a 400 naming ROADMAP A.21, and
    three lanes (not a multiple of the world size) are refused at
    construction."""
    _, _, outdir, _ = round_run
    for r in range(2):
        with open(os.path.join(outdir, f"refusals_p{r}.json")) as f:
            got = json.load(f)
        assert got["syncdp"] == "built", got
        assert "ROADMAP A.21" in got["syncdp_bn"], got
        assert got["syncdp_bn_status"] == 400
        assert "cannot be laid out over 2 ranks" in got["lanes3"], got


# ------------------------------------------------ the merge over 4 ranks
MERGE_RANKS = 4
MERGE_EFF = (2.0, 1.0, 0.0, 3.0)      # lane 2 (rank 2) dead
# the cross-rank sum that equals the reference's bit for bit: the ring
# (hop for hop the reference's), and integer sums (ef_int8); the other
# cross-rank sums add four terms in gloo's order, not in lane order. The
# port's merges take no ring (``use_ring`` is not ported); the ring cases
# put ``collectives.ring_psum`` in a strategy's wire sum, as the
# reference's ``use_ring`` does, and hold it against the reference's ring
RING_WIRED = ("monolithic-bf16", "bucketed-bf16", "ef_bf16")


@pytest.fixture(scope="module")
def merge_run(tmp_path_factory):
    """Every lane_merge strategy of tests/test_torch_merge.py, with its
    wire sum and with ``ring_psum`` in its place, over 4 gloo ranks of one lane each: the inputs are
    written here, each rank merges its lane's."""
    from test_torch_merge import STRATEGIES, _nest, _strategies, _tree_inputs

    outdir = str(tmp_path_factory.mktemp("distmerge"))
    arrays = {}
    for name in STRATEGIES:
        j_s, _ = _strategies(name)
        contrib, ref, rng = _tree_inputs(MERGE_RANKS, MERGE_EFF,
                                         seed=len(name))
        residual = {k: (rng.standard_normal(MERGE_RANKS * n) * 0.01
                        ).astype(np.float32)
                    for k, n in j_s.residual_sizes(_nest(ref)).items()}
        for kind, tree in (("c", contrib), ("ref", ref), ("res", residual)):
            for k, v in tree.items():
                arrays[f"{name}/{kind}/{k}"] = v
    np.savez(os.path.join(outdir, "merge_inputs.npz"), **arrays)
    run = _launch("merge", outdir, ranks=MERGE_RANKS, timeout=600)
    assert run.returncode == 0, \
        f"launcher failed:\n{run.stdout[-6000:]}\n{run.stderr[-3000:]}"
    return arrays, {r: dict(np.load(os.path.join(outdir,
                                                  f"merge_p{r}.npz")))
                    for r in range(MERGE_RANKS)}


def _split(arrays, name, kind):
    pre = f"{name}/{kind}/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


@pytest.mark.parametrize("ring", [False, True], ids=["allreduce", "ring"])
@pytest.mark.parametrize("name", ["monolithic", "monolithic-bf16",
                                  "bucketed", "bucketed-bf16", "ef_bf16",
                                  "ef_int8"])
def test_four_rank_lane_merge_matches_reference(merge_run, name, ring):
    """lane_merge over 4 ranks against the reference's lane_merge on a
    4-lane CPU mesh (with its ring where asked; the port's side then sums
    its wire through ``ring_psum``): every rank holds the same merged
    values; through the ring (a wire dtype) and under
    ef_int8 (integer sums) they equal the reference's bit for bit, an
    f32 all-reduce within 1e-5 and a bf16 one within atol = rtol = 2e-2
    (four terms in gloo's order, rounded at its hops); each rank's EF
    residual is its slice of the reference's bit for bit, zero on the
    dead lane."""
    import jax.numpy as jnp

    from kubeml_tpu.parallel import merge as ref_merge
    from test_torch_merge import CAP_MB, _reference_lane_merge

    arrays, ranks = merge_run
    base, _, wire = name.partition("-")
    strategy = ref_merge.strategy_by_name(
        base, wire_dtype=jnp.bfloat16 if wire else None,
        bucket_mb=0.0 if base == "monolithic" else CAP_MB, use_ring=ring)
    contrib, ref = _split(arrays, name, "c"), _split(arrays, name, "ref")
    residual = _split(arrays, name, "res")
    want, want_res = _reference_lane_merge(strategy, contrib, ref,
                                           list(MERGE_EFF), residual)
    tag = f"{name}/{'ring' if ring else 'allreduce'}"
    got = {r: (_split(out, tag, "avg"), _split(out, tag, "res"))
           for r, out in ranks.items()}
    exact = (ring and name in RING_WIRED) or name == "ef_int8"
    # the repo's pinned tolerances: bf16 atol = rtol = 2e-2, f32 1e-5
    rtol, atol = (2e-2, 2e-2) if (wire or name == "ef_bf16") else (1e-5,
                                                                  1e-6)
    for r in range(MERGE_RANKS):
        avg, res = got[r]
        assert set(avg) == set(want)
        for k in want:
            np.testing.assert_array_equal(avg[k], got[0][0][k], err_msg=k)
            assert avg[k].dtype == want[k].dtype, k
            if exact:
                np.testing.assert_array_equal(avg[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(avg[k], want[k], rtol=rtol,
                                           atol=atol, err_msg=k)
        assert set(res) == set(want_res or {})
        for k, v in (want_res or {}).items():
            lane = v.reshape(MERGE_RANKS, -1)[r]
            np.testing.assert_array_equal(res[k], lane, err_msg=(k, r))
            assert (lane == 0).all() == (MERGE_EFF[r] == 0), (k, r)


# ------------------------------------------------------------ the runtime

def test_cluster_env_vars_equal_reference():
    from kubeml_tpu.parallel import distributed as ref
    from kubeml_tpu_torch.parallel import distributed as port

    assert port.CLUSTER_ENV_VARS == ref.CLUSTER_ENV_VARS


ENV_TABLE = [
    {},
    {"KUBEML_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"TPU_WORKER_HOSTNAMES": "host-a,host-b"},
    {"TPU_WORKER_HOSTNAMES": "localhost"},
    {"TPU_WORKER_HOSTNAMES": "a, ,"},
    {"SLURM_NTASKS": "4"},
    {"SLURM_NTASKS": "1"},
    {"SLURM_NTASKS": "many"},
    {"OMPI_COMM_WORLD_SIZE": "2"},
    {"OMPI_COMM_WORLD_SIZE": "1", "SLURM_PROCID": "3"},
    {"KUBEML_NUM_PROCESSES": "2", "KUBEML_PROCESS_ID": "1"},
]


@pytest.mark.parametrize("env", ENV_TABLE,
                         ids=[",".join(e) or "empty" for e in ENV_TABLE])
def test_cluster_env_present_agrees_with_reference(monkeypatch, env):
    from kubeml_tpu.parallel import distributed as ref
    from kubeml_tpu_torch.parallel import distributed as port

    for var in port.CLUSTER_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port._cluster_env_present() == ref._cluster_env_present()


def test_initialize_single_process_is_a_quiet_noop(monkeypatch):
    """No arguments and no cluster environment: nothing joined, world
    size 1, this process the coordinator; a declared cluster without the
    KUBEML_* contract raises instead of training alone."""
    import torch.distributed as dist

    from kubeml_tpu_torch.parallel import distributed as port

    for var in port.CLUSTER_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    port.initialize(device="cpu")
    assert not dist.is_initialized()
    assert (port.world_size(), port.rank(), port.is_coordinator()) == \
        (1, 0, True)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="refusing to train alone"):
        port.initialize(device="cpu")
    with pytest.raises(ValueError, match="process count"):
        port.initialize("localhost:1", device="cpu")
    assert not dist.is_initialized()


def test_initialize_without_cuda_raises_and_never_falls_back():
    """Joining with the default device (CUDA, NCCL) on a machine without
    a card raises before any connection; the CPU (gloo) is reachable
    only by asking for it."""
    import torch
    import torch.distributed as dist

    from kubeml_tpu_torch.parallel import distributed as port

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.initialize("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.rank_device(None, 0)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA"):
        port.initialize("localhost:1", 2, 0, backend="nccl", device="cpu")
    assert not dist.is_initialized()
    assert port.rank_device("cpu", 3) == torch.device("cpu")


def test_initialize_unreachable_coordinator_raises_fast():
    """An explicit join to a coordinator nobody serves raises within its
    timeout (plus the store's retries), never quietly runs alone."""
    import socket
    import time

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("from kubeml_tpu_torch.parallel.distributed import initialize\n"
            "try:\n"
            f"    initialize('localhost:{port}', 2, 1, device='cpu', "
            "timeout=2)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__)\n"
            "    raise SystemExit(3)\n")
    t0 = time.monotonic()
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 3, (run.stdout, run.stderr[-2000:])
    assert "raised" in run.stdout
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("lanes,world", [(1, 1), (2, 2), (4, 2), (8, 4),
                                         (8, 2), (6, 3)])
def test_lane_layout_matches_multislice_mesh(lanes, world):
    """Lane d sits on the rank whose slice holds the d-th device of the
    JAX package's slice-major data axis."""
    import jax

    from kubeml_tpu.parallel.distributed import make_multislice_mesh
    from kubeml_tpu.parallel.mesh import DATA_AXIS
    from kubeml_tpu_torch.parallel.distributed import lane_layout

    devices = jax.devices()[:lanes]
    mesh = make_multislice_mesh(devices=devices, n_slices=world)
    order = [d.id for d in np.asarray(mesh.devices).reshape(
        mesh.shape[DATA_AXIS], -1)[:, 0]]
    per_slice = lanes // world
    slice_of = {d.id: i // per_slice for i, d in enumerate(devices)}
    for r in range(world):
        lay = lane_layout(lanes, world, r)
        assert list(lay.local_lanes) == [
            d for d in range(lanes) if slice_of[order[d]] == r]
        assert [lay.rank_of(d) for d in range(lanes)] == [
            slice_of[order[d]] for d in range(lanes)]
    with pytest.raises(ValueError):
        lane_layout(lanes + 1, world + 1, 0) if (lanes + 1) % (world + 1) \
            else lane_layout(3, 2, 0)


# ---------------------------------------------------------------- the job

@pytest.fixture(scope="module")
def job_run(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("distjob"))
    stdout = _both("job", outdir, timeout=900)
    return outdir, stdout


def _history(outdir, who):
    with open(os.path.join(outdir, f"history_{who}.json")) as f:
        return json.load(f)


def test_two_rank_job_histories_equal_one_process(job_run):
    """Both ranks' histories are equal, and equal to the one-process
    port job's (2 lanes, the same scripted N 2 -> 4 -> 4), as are their
    final weights; the ranks staged their rounds from the host."""
    outdir, stdout = job_run
    assert "[p0] jobproc 0 OK" in stdout and "[p1] jobproc 1 OK" in stdout
    h0, h1, hs = (_history(outdir, who) for who in ("p0", "p1", "single"))
    # the ranks stage from the host, one process reads the device cache
    assert h0.pop("cache") is None and h1.pop("cache") is None
    assert hs.pop("cache") == "sharded"
    assert h0 == h1 == hs
    assert h0["parallelism"] == [2, 4, 4]
    assert len(h0["train_loss"]) == 3
    a = np.load(os.path.join(outdir, "final_p0.npz"))
    for who in ("p1", "single"):
        b = np.load(os.path.join(outdir, f"final_{who}.npz"))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(who, k))


def test_two_rank_job_checkpoint_loads_in_both_packages(job_run):
    """Each rank wrote the job's checkpoint under its own home; both
    packages load it, and it holds the final weights."""
    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint

    outdir, _ = job_run
    final = np.load(os.path.join(outdir, "final_p0.npz"))
    for r in range(2):
        root = os.path.join(outdir, f"p{r}", "models")
        port_tree, manifest = load_checkpoint(JOB_ID, root=root)
        ref_tree, ref_manifest = ref_load(JOB_ID, root=root)
        assert manifest["model"] == ref_manifest["model"] == "mlp"
        assert manifest.get("completed")
        state = get_model("mlp")(hidden=16, num_classes=CLASSES) \
            .params_from_flax(port_tree["params"])
        ref_state = get_model("mlp")(hidden=16, num_classes=CLASSES) \
            .params_from_flax({k: {n: np.asarray(a) for n, a in v.items()}
                               for k, v in ref_tree["params"].items()})
        for k in final.files:
            np.testing.assert_array_equal(state[k].numpy(), final[k])
            np.testing.assert_array_equal(ref_state[k].numpy(), final[k])


def test_device_cache_on_refused_over_ranks(job_run):
    """device_cache='on' over two ranks is the JAX package's 400."""
    outdir, _ = job_run
    for r in range(2):
        with open(os.path.join(outdir, f"cache_on_p{r}.json")) as f:
            got = json.load(f)
        assert got["status"] == 400
        assert "requires a single-process job" in got["error"]


def test_job_survives_rank_death_via_supervisor_restart(tmp_path):
    """Rank 1 SIGKILLs itself after epoch 1's checkpoint is durable; the
    --fail-fast launcher tears the cluster down and its supervisor
    relaunches it (gated on the checkpoint on every rank); the restarted
    ranks resume from the job's own checkpoint at the same epoch, and
    their histories are continuous and equal, each epoch the crashed run
    published at the loss it published."""
    outdir = str(tmp_path)
    run = _launch("chaos", outdir, timeout=900, extra=(
        "--fail-fast", "--max-restarts", "1", "--restart-job", CHAOS_JOB,
        "--checkpoint-root", os.path.join(outdir, "p0", "models"),
        "--checkpoint-root", os.path.join(outdir, "p1", "models")))
    assert run.returncode == 0, \
        f"supervised run failed:\n{run.stdout[-6000:]}\n{run.stderr[-3000:]}"
    assert "chaos: SIGKILL self" in run.stdout, run.stdout[-4000:]
    assert "supervisor: cluster died" in run.stderr, run.stderr[-2000:]
    assert "[p0] chaosproc 0 OK" in run.stdout
    assert "[p1] chaosproc 1 OK" in run.stdout
    h0 = _history(outdir, "resume_p0")
    assert h0 == _history(outdir, "resume_p1")
    assert h0["parallelism"] == [2, 4, 4]
    assert len(h0["train_loss"]) == 3
    crashed = {}
    for r in range(2):
        with open(os.path.join(outdir, f"crash_metrics_p{r}.jsonl")) as f:
            crashed[r] = [json.loads(line) for line in f]
    # rank 1 died after publishing epoch 1; rank 0 may have published
    # epoch 2 too (its validation runs no collective) but held at the
    # barrier before checkpointing it, so the resumed run trains epoch 2
    # again, to the same numbers
    assert len(crashed[1]) == 1 and len(crashed[0]) in (1, 2)
    for e, m in enumerate(crashed[0]):
        assert h0["train_loss"][e] == m["train_loss"]
        assert h0["parallelism"][e] == m["parallelism"]


def test_ps_standalone_child_env_has_no_cluster_vars(monkeypatch, tmp_home):
    """The PS strips every CLUSTER_ENV_VARS family from a standalone job
    child's environment (a child with its parent's rank would join the
    parent's group and hang it); the lanes ride --mesh-data."""
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)
    from kubeml_tpu_torch.control import ps as ps_mod
    from kubeml_tpu_torch.parallel.distributed import CLUSTER_ENV_VARS

    assert ps_mod.CLUSTER_ENV_VARS is CLUSTER_ENV_VARS
    for var in CLUSTER_ENV_VARS:
        monkeypatch.setenv(var, "2")
    seen = {}

    class Refused(Exception):
        pass

    def fake_popen(cmd, env=None, **kw):
        seen["cmd"], seen["env"] = cmd, env
        raise Refused

    monkeypatch.setattr(ps_mod.subprocess, "Popen", fake_popen)
    ps = ps_mod.ParameterServer(device="cpu", standalone_jobs=True,
                                n_lanes=2)
    task = TrainTask(job_id="envjob", parameters=TrainRequest(
        model_type="mlp", batch_size=32, epochs=1, dataset="blobs", lr=0.1,
        options=TrainOptions(default_parallelism=2)), parallelism=2)
    with pytest.raises(Refused):
        ps._spawn_standalone(ps_mod._JobRecord(task))
    assert not set(CLUSTER_ENV_VARS) & set(seen["env"])
    cmd = seen["cmd"]
    assert cmd[cmd.index("--mesh-data") + 1] == "2"


# ------------------------------------------------------------- the ranks

def _mlp_engine(model, lanes, knobs):
    import torch

    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    module = model.init_module({"x": _round_inputs(0)[0]["x"][0, 0]},
                               torch.Generator().manual_seed(0), "cpu")
    return KAvgEngine(module, model.loss, model.metrics,
                      model.configure_optimizers, n_lanes=lanes,
                      collect_stats=True, **knobs)


def _worker_round(outdir, single):
    import torch

    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel import distributed as dist_lib
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    if not single:
        dist_lib.initialize(device="cpu", timeout=120)
        assert dist_lib.world_size() == 2
    rank = dist_lib.rank()
    init = np.load(os.path.join(outdir, "init.npz"))
    model = get_model("mlp")(hidden=16, num_classes=CLASSES)
    out = {}
    for name, (lanes, knobs) in STRATEGIES.items():
        engine = _mlp_engine(model, lanes, knobs)
        to_device = engine._to_device
        copied = []

        def record(batch):
            # what the round copies to the rank's device
            copied.append(batch["x"].copy())
            return to_device(batch)

        engine._to_device = record
        state = {k: torch.from_numpy(init[k].copy()) for k in init.files}
        for r in range(ROUNDS):
            batch, *masks = _round_inputs(r)
            state, st = engine.train_round(state, batch, *masks, LR, 0)
            out[f"{name}/r{r}/copied"] = copied.pop()
            for k, v in state.items():
                out[f"{name}/r{r}/w/{k}"] = v.numpy().copy()
            for k, v in (engine._ef_state or {}).items():
                out[f"{name}/r{r}/res/{k}"] = v.numpy().copy()
            out[f"{name}/r{r}/loss"] = st.loss_sum
            out[f"{name}/r{r}/dropped"] = st.dropped
            out[f"{name}/r{r}/stats"] = st.stat_device.numpy()
            out[f"{name}/r{r}/spread"] = st.spread_device.numpy()
    tag = "single" if single else f"p{rank}"
    np.savez(os.path.join(outdir, f"round_{tag}.npz"), **out)
    if not single:
        from kubeml_tpu_torch.models.layers import BatchNorm, Dense

        SyncDPEngine(engine.module, model.loss, model.configure_optimizers,
                     n_lanes=2)
        refusals = {"syncdp": "built"}
        try:
            SyncDPEngine(torch.nn.Sequential(Dense(4, 4, device="cpu"),
                                             BatchNorm(4, device="cpu")),
                         model.loss, model.configure_optimizers, n_lanes=2)
        except KubeMLException as e:
            refusals["syncdp_bn"] = str(e)
            refusals["syncdp_bn_status"] = e.status_code
        try:
            _mlp_engine(model, 3, {})
        except ValueError as e:
            refusals["lanes3"] = str(e)
        with open(os.path.join(outdir, f"refusals_p{rank}.json"), "w") as f:
            json.dump(refusals, f)
    print(f"roundproc {tag} OK", flush=True)


def _blobs_home(home):
    """This process's KUBEML_TPU_HOME with the blobs dataset (the same
    seed everywhere)."""
    from test_torch_job import _blobs

    os.environ["KUBEML_TPU_HOME"] = home
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    reg = DatasetRegistry()
    if not reg.exists("blobs"):    # a restarted rank reuses its home
        reg.create("blobs", *_blobs())
    return reg


def _job_task(job_id, epochs=3, **opts):
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)

    req = TrainRequest(model_type="mlp", batch_size=32, epochs=epochs,
                       dataset="blobs", lr=LR, options=TrainOptions(
                           default_parallelism=2, static_parallelism=False,
                           validate_every=1, k=2, **opts))
    return TrainTask(job_id=job_id, parameters=req, parallelism=2)


def _job(task, reg, callbacks):
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.history import HistoryStore
    from kubeml_tpu_torch.train.job import TrainJob

    return TrainJob(task, get_model("mlp")(hidden=16, num_classes=CLASSES),
                    KubeDataset("blobs"), "cpu", n_lanes=2, registry=reg,
                    history_store=HistoryStore(), callbacks=callbacks)


def _record(record) -> dict:
    return {"train_loss": [float(v) for v in record.data.train_loss],
            "accuracy": [float(v) for v in record.data.accuracy],
            "validation_loss": [float(v) for v in
                                record.data.validation_loss],
            "parallelism": list(record.data.parallelism)}


def _worker_job(outdir, single):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.parallel import distributed as dist_lib
    from kubeml_tpu_torch.train.job import JobCallbacks

    if not single:
        dist_lib.initialize(device="cpu", timeout=120)
    rank = dist_lib.rank()
    tag = "single" if single else f"p{rank}"
    reg = _blobs_home(os.path.join(outdir, tag))
    if not single:
        try:
            _job(_job_task("cacheon", device_cache="on"), reg,
                 JobCallbacks()).train()
            refused = {"status": None, "error": "trained"}
        except KubeMLException as e:
            refused = {"status": e.status_code, "error": str(e)}
        with open(os.path.join(outdir, f"cache_on_p{rank}.json"), "w") as f:
            json.dump(refused, f)
    schedule = iter([4, 4])
    job = _job(_job_task(JOB_ID), reg, JobCallbacks(
        request_parallelism=lambda t: next(schedule, None)))
    record = job.train()
    cache = job._device_cache
    with open(os.path.join(outdir, f"history_{tag}.json"), "w") as f:
        json.dump(dict(_record(record), cache=cache and cache.layout), f)
    np.savez(os.path.join(outdir, f"final_{tag}.npz"),
             **{k: v.numpy() for k, v in job.state.items()})
    print(f"jobproc {tag if single else rank} OK", flush=True)


def _worker_chaos(outdir, single):
    """The port's twin of tests/helpers/dist_job_chaos_main.py: the
    incarnation comes from $KUBEML_RESTART_COUNT; incarnation 0 kills
    rank 1 at its second between-epoch callback, once epoch 1's
    checkpoint is durable; incarnation 1 resumes and finishes."""
    import signal
    import time

    from kubeml_tpu_torch.parallel import distributed as dist_lib
    from kubeml_tpu_torch.train.job import JobCallbacks

    dist_lib.initialize(device="cpu", timeout=120)
    rank = dist_lib.rank()
    incarnation = int(os.environ.get("KUBEML_RESTART_COUNT", "0"))
    home = os.path.join(outdir, f"p{rank}")
    reg = _blobs_home(home)
    manifest = os.path.join(home, "models", CHAOS_JOB, "manifest.json")

    def manifest_epoch() -> int:
        try:
            with open(manifest) as f:
                return int(json.load(f).get("epoch") or 0)
        except (OSError, ValueError):
            return 0

    trajectory = [2, 4, 4]
    start = 0 if incarnation == 0 else manifest_epoch()
    schedule = iter(trajectory[start + 1:])
    task = _job_task(CHAOS_JOB)
    if incarnation > 0:
        assert start >= 1, "no durable checkpoint to resume from"
        task.parameters.resume_from = CHAOS_JOB
        record = _job(task, reg, JobCallbacks(
            request_parallelism=lambda t: next(schedule, None))).train()
        assert record.data.parallelism == trajectory, record.data
        with open(os.path.join(outdir, f"history_resume_p{rank}.json"),
                  "w") as f:
            json.dump(_record(record), f)
        print(f"chaosproc {rank} OK", flush=True)
        return
    calls = {"n": 0}

    def request(task):
        calls["n"] += 1
        if calls["n"] == 2:
            deadline = time.monotonic() + 120
            while manifest_epoch() < 1:
                assert time.monotonic() < deadline, \
                    "epoch 1's checkpoint never became durable"
                time.sleep(0.05)
            if rank == 1:
                print(f"[rank {rank}] chaos: SIGKILL self", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
        return next(schedule, None)

    def published(m):
        with open(os.path.join(outdir, f"crash_metrics_p{rank}.jsonl"),
                  "a") as f:
            f.write(json.dumps({"train_loss": float(m.train_loss),
                                "parallelism": m.parallelism}) + "\n")

    _job(task, reg, JobCallbacks(request_parallelism=request,
                                 publish_metrics=published)).train()
    raise AssertionError("incarnation 0 finished without its crash")


def _worker_merge(outdir, single):
    """Rank r merges lane r of every strategy's inputs, with the
    strategy's wire sum and with ``ring_psum`` in its place."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dist_lib
    from kubeml_tpu_torch.parallel import merge
    from kubeml_tpu_torch.parallel.collectives import ring_psum
    from test_torch_merge import CAP_MB, STRATEGIES

    wire_sum = merge._wire_sum

    def ring_wire_sum(x, wire_dtype):
        # the reference's use_ring: the rank's f32 lane sum, uncast,
        # through the ring's wire-dtype hops
        return ring_psum(merge._local_sum(x.float()), None,
                         wire_dtype).float()

    dist_lib.initialize(device="cpu", timeout=120)
    rank = dist_lib.rank()
    arrays = dict(np.load(os.path.join(outdir, "merge_inputs.npz")))
    raw = torch.tensor(float(sum(MERGE_EFF)))
    out = {}
    for name in STRATEGIES:
        base, _, wire = name.partition("-")
        contrib = {k: torch.from_numpy(v[rank:rank + 1].copy())
                   for k, v in _split(arrays, name, "c").items()}
        ref = {k: torch.from_numpy(v.copy())
               for k, v in _split(arrays, name, "ref").items()}
        residual = {k: torch.from_numpy(
            v.reshape(MERGE_RANKS, -1)[rank].copy())
            for k, v in _split(arrays, name, "res").items()}
        for ring in (False, True):
            merge._wire_sum = ring_wire_sum if ring else wire_sum
            strategy = merge.strategy_by_name(
                base, wire_dtype=torch.bfloat16 if wire else None,
                bucket_mb=0.0 if base == "monolithic" else CAP_MB)
            avg, res = strategy.lane_merge(
                contrib, ref, raw, raw.clamp_min(1.0),
                lane_alive=torch.tensor([MERGE_EFF[rank] > 0]),
                residual=residual or None)
            tag = f"{name}/{'ring' if ring else 'allreduce'}"
            for k, v in avg.items():
                out[f"{tag}/avg/{k}"] = v.numpy()
            for k, v in (res or {}).items():
                out[f"{tag}/res/{k}"] = v.numpy()
    np.savez(os.path.join(outdir, f"merge_p{rank}.npz"), **out)
    print(f"mergeproc {rank} OK", flush=True)


WORKERS = {"round": _worker_round, "job": _worker_job,
           "chaos": _worker_chaos, "merge": _worker_merge}


if __name__ == "__main__":
    import faulthandler

    # a cross-process hang shows where each rank is stuck
    faulthandler.dump_traceback_later(120, repeat=True)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    single = mode.endswith("-single")
    WORKERS[mode.replace("-single", "")](outdir, single)
