"""Port parity: the SyncDP engine over ``torch.distributed`` ranks
(``kubeml_tpu_torch/parallel/syncdp.py`` under a process group), with
physical ZeRO-1 and FSDP shards, against the port in one process and
against the JAX package's SyncDPEngine on a D-lane CPU mesh.

The ranks are two processes of ``tools/launch_distributed`` (``--processes
2 --emulate-cpu 1``) joined over gloo through the ``KUBEML_*``
environment, each running this file's ``__main__`` block; the one-process
runs are the same functions in the test process, without a group. Every
process runs torch on one thread. Two launches in all, one after the
other in one module-scoped fixture: the engine cases and the jobs.

What is held, and how tightly:
  - the mlp of tests/test_torch_distributed.py (Adam, the learning rate
    changing between two dispatches of two steps) at D = 2 (one lane a
    rank) and D = 8 (four a rank), on the implicit path with zero1 on and
    off and with fsdp, and under the bucketed, ef_bf16 and ef_int8 merges:
    the two ranks' weights equal each other bit for bit; at one lane a
    rank the explicit paths equal one process bit for bit (weights, the
    gathered moments, each rank's EF residuals its lane's slice), as do
    ef_int8's weights at four (integer lane sums); the implicit paths (a
    sum over two ranks in another order than one backward's) and the
    bucketed merge at four lanes a rank within f32 1e-5 of one process,
    and the f32 paths within 1e-5 of the reference's D-lane run; ef_bf16
    at four lanes a rank (a bf16 sum rounded per rank, then across ranks)
    within the EF-bf16 bound steps x lr x 2^-7 of one process;
  - the per-step squared grad, update and parameter norms
    (``collect_stats``: shards summed over the ranks, a replicated leaf
    counted once) on the implicit path (zero1, fsdp) and under the
    bucketed merge: equal on both ranks, within f32 1e-5 of one process;
  - each rank's optimizer-state elements, and under fsdp its parameter
    elements, equal the plan of the reference's opt_specs/param_specs
    (1/world of every leaf the rule shards) exactly;
  - a 2-layer narrow GPTModule with dropout 0.1 (AdamW) over two ranks:
    the ranks equal each other, and one process within AdamW's
    2 x steps x lr with 99.5 % of the elements within 1e-5 (the global
    dropout draw: a rank drawing only its own rows would miss on most
    elements);
  - a NaN in rank 1's slice skips the step on both ranks; a step masked on
    rank 1 only runs on both; a globally masked step runs on neither;
    the implicit path refuses a BatchNorm or MoE model naming ROADMAP
    A.21 (400);
  - a two-rank syncdp TrainJob (ef_bf16, and fsdp) against the one-process
    job: both ranks' histories and weights equal; ef_bf16 equals one
    process bit for bit, fsdp within 1e-5; the checkpoint loads in both
    packages.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, G, DIM, CLASSES, HIDDEN = 2, 16, 8, 4, 16
LRS = (1e-2, 5e-3)
CAP_MB = 40 * 4 / (1024 * 1024)        # ~40 f32 elements: several buckets
# name: engine knobs (n_lanes aside)
MODES = {
    "zero1": dict(collect_stats=True),
    "replicated": dict(zero1=False),
    "fsdp": dict(fsdp=True, collect_stats=True),
    "bucketed": dict(merge_strategy="bucketed", merge_bucket_mb=CAP_MB,
                     collect_stats=True),
    "ef_bf16": dict(merge_strategy="ef_bf16", merge_bucket_mb=CAP_MB),
    "ef_int8": dict(merge_strategy="ef_int8", merge_bucket_mb=CAP_MB),
}
LANES = (2, 8)
# the modes whose engines collect the per-step norms
STATS_MODES = tuple(m for m, k in MODES.items() if k.get("collect_stats"))
GPT = dict(vocab_size=64, max_len=16, hidden=32, layers=2, heads=2, ffn=64)
GPT_T, GPT_G, GPT_LR = 16, 8, 1e-3
GPT_MODES = ("zero1", "fsdp", "ef_bf16")
JOB_ID = {"ef_bf16": "syncrk-ef", "fsdp": "syncrk-fsdp"}
JOB_OPTS = {"ef_bf16": dict(merge_compress="bf16"), "fsdp": dict(fsdp=True)}


# -------------------------------------------------------------- the inputs

def _dispatch(r, nan=False, mask=None):
    """Dispatch r's (batch [S, G, DIM], sample mask [S, G], keys [S, 2],
    lr): a NaN in the last sample (rank 1's slice) of step 1, or one of
    the named masks."""
    rng = np.random.RandomState(200 + r)
    centers = np.random.RandomState(7).randn(CLASSES, DIM) * 3
    y = rng.randint(0, CLASSES, size=(S, G)).astype(np.int32)
    x = (centers[y] + rng.randn(S, G, DIM)).astype(np.float32)
    keys = rng.randint(0, 2 ** 31, size=(S, 2)).astype(np.uint32)
    m = np.ones((S, G), np.float32)
    if nan:
        x[1, G - 1, 0] = np.nan
    if mask == "rank1":            # step 0: every sample of rank 1 masked
        m[0, G // 2:] = 0.0
    elif mask == "all":            # step 1: no real sample anywhere
        m[1] = 0.0
    return {"x": x, "y": y}, m, keys, LRS[r % 2]


def _gpt_dispatch(r):
    rng = np.random.RandomState(300 + r)
    x = rng.randint(1, GPT["vocab_size"], size=(S, GPT_G, GPT_T))
    x[:, ::3, GPT_T - 4:] = 0                      # some padded tails
    keys = rng.randint(0, 2 ** 31, size=(S, 2)).astype(np.uint32)
    return {"x": x.astype(np.int32)}, np.ones((S, GPT_G), np.float32), keys


def _adam(lr, epoch):
    import torch

    return functools.partial(torch.optim.Adam, lr=lr)


def _mlp_engine(init, D, **knobs):
    import torch

    from kubeml_tpu_torch.convert import flax_layout_shapes
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    model = get_model("mlp")(hidden=HIDDEN, num_classes=CLASSES)
    module = model.init_module({"x": np.zeros((1, DIM), np.float32)},
                               torch.Generator().manual_seed(0), "cpu")
    state = {k: torch.from_numpy(init[k].copy()) for k in init}
    module.load_state_dict(state)
    shapes = flax_layout_shapes(state, {"params": model.params_to_flax(state)})
    return SyncDPEngine(module, model.loss, _adam, n_lanes=D,
                        layout_shapes=shapes, **knobs), state


def _gpt_engine(mode):
    import torch

    from kubeml_tpu_torch.convert import (flax_layout_shapes,
                                          params_from_flax,
                                          random_flax_params)
    from kubeml_tpu_torch.models.gpt import GPTMini, GPTModule
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    model = GPTMini()
    module = GPTModule(**GPT, dropout=0.1, dtype=torch.float32, device="cpu")
    params = random_flax_params(**GPT, seed=5)
    module.load_state_dict(params_from_flax(params))
    state = {n: p.detach().clone() for n, p in module.named_parameters()}
    return SyncDPEngine(module, model.loss, model.configure_optimizers,
                        n_lanes=2, layout_shapes=flax_layout_shapes(
                            state, {"params": params}), **MODES[mode]), state


def _moments(engine, state):
    """This process's Adam moments by name, flat (shards under a group),
    and the optimizer's step counts."""
    opt = state["opt_state"]
    tensors = [t for g in opt.param_groups for t in g["params"]]
    out = {}
    for n, t in zip(engine._params, tensors):
        st = opt.state[t]
        out[f"mu/{n}"] = st["exp_avg"].reshape(-1).numpy().copy()
        out[f"nu/{n}"] = st["exp_avg_sq"].reshape(-1).numpy().copy()
    steps = sorted({int(opt.state[t]["step"]) for t in tensors})
    return out, steps


def _run(engine, state, dispatches):
    """The dispatches through the engine: {weights, moments, residuals,
    losses, skipped flags, shard counts, copied rows}."""
    st = engine.init_state(state)
    to_device, copied = engine._to_device, []

    def record(batch):
        copied.append(np.asarray(batch[sorted(batch)[0]]).copy())
        return to_device(batch)

    engine._to_device = record
    out = {}
    for i, (batch, mask, keys, lr) in enumerate(dispatches):
        st, loss = engine.train_steps(st, batch, mask, keys, lr, 0)
        out[f"loss/{i}"] = loss.numpy().copy()
        out[f"skipped/{i}"] = engine.last_skipped_device.numpy().copy()
        if engine.last_stats_device is not None:
            out[f"stats/{i}"] = engine.last_stats_device.numpy().copy()
    for k, v in engine.variables(st).items():
        out[f"w/{k}"] = v.detach().numpy().copy()
    moments, steps = _moments(engine, st)
    out.update(moments)
    out["steps"] = np.asarray(steps)
    for k, v in (st.get("merge_resid") or {}).items():
        out[f"res/{k}"] = v.numpy().copy()
    for n, c in engine.shard_elements().items():
        out[f"opt_elems/{n}"] = np.asarray(c)
        out[f"param_elems/{n}"] = np.asarray(st["params"][n].numel())
    out["readbacks"] = np.asarray(engine.readbacks)
    out["copied"] = copied[0]
    return out


def engine_cases(outdir, tag):
    """Every engine case in this process (a rank, or one process without
    a group): writes ``engine_<tag>.npz`` and ``refusals_<tag>.json``."""
    import torch

    from kubeml_tpu_torch.api.errors import KubeMLException

    init = dict(np.load(os.path.join(outdir, "init.npz")))
    out = {}
    for D in LANES:
        for mode, knobs in MODES.items():
            engine, state = _mlp_engine(init, D, **knobs)
            got = _run(engine, state, [_dispatch(r) for r in range(2)])
            out.update({f"mlp/{D}/{mode}/{k}": v for k, v in got.items()})
    for mode in GPT_MODES:
        engine, state = _gpt_engine(mode)
        got = _run(engine, state, [(*_gpt_dispatch(r), GPT_LR)
                                   for r in range(2)])
        out.update({f"gpt/{mode}/{k}": v for k, v in got.items()})
    for mode in ("zero1", "ef_bf16"):
        for case, kw in (("nan", dict(nan=True)), ("rank1", dict(
                mask="rank1")), ("all", dict(mask="all"))):
            engine, state = _mlp_engine(init, 2, **MODES[mode])
            got = _run(engine, state, [_dispatch(0, **kw)])
            out.update({f"branch/{mode}/{case}/{k}": v
                        for k, v in got.items()})
    np.savez(os.path.join(outdir, f"engine_{tag}.npz"), **out)
    refusals = {}
    from kubeml_tpu_torch.models.gpt import GPTModule
    from kubeml_tpu_torch.models.layers import BatchNorm, Dense
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    bn = torch.nn.Sequential(Dense(4, 4, device="cpu"),
                             BatchNorm(4, device="cpu"))
    moe = GPTModule(**GPT, n_experts=2, device="cpu")
    for name, module, strategy in (("bn", bn, None), ("moe", moe, None),
                                   ("bn_explicit", bn, "bucketed")):
        try:
            SyncDPEngine(module, None, _adam, n_lanes=2,
                         merge_strategy=strategy)
            refusals[name] = {"status": None, "error": "built"}
        except KubeMLException as e:
            refusals[name] = {"status": e.status_code, "error": str(e)}
    with open(os.path.join(outdir, f"refusals_{tag}.json"), "w") as f:
        json.dump(refusals, f)


def job_cases(outdir, tag):
    """The two syncdp jobs in this process, each from a home of its own;
    writes their histories and final weights."""
    from test_torch_distributed import _blobs_home, _job_task, _record

    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.history import HistoryStore
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    before = os.environ.get("KUBEML_TPU_HOME")
    try:
        reg = _blobs_home(os.path.join(outdir, tag))
        for name, opts in JOB_OPTS.items():
            task = _job_task(JOB_ID[name], epochs=2, engine="syncdp",
                             **opts)
            job = TrainJob(task, get_model("mlp")(hidden=HIDDEN,
                                                  num_classes=CLASSES),
                           KubeDataset("blobs"), "cpu", n_lanes=2,
                           registry=reg, history_store=HistoryStore(),
                           callbacks=JobCallbacks())
            record = job.train()
            with open(os.path.join(outdir, f"history_{name}_{tag}.json"),
                      "w") as f:
                json.dump(_record(record), f)
            np.savez(os.path.join(outdir, f"final_{name}_{tag}.npz"),
                     **{k: v.numpy() for k, v in job.state.items()})
    finally:
        if before is None:
            os.environ.pop("KUBEML_TPU_HOME", None)
        else:
            os.environ["KUBEML_TPU_HOME"] = before


# --------------------------------------------------------------- fixtures

def _mlp_flax_params():
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models import get_builtin

    ref = get_builtin("mlp")(hidden=HIDDEN, num_classes=CLASSES)
    variables = ref.init_variables(jax.random.PRNGKey(0), {
        "x": jnp.zeros((1, DIM), jnp.float32)})
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _launch(mode, outdir, single):
    """This file's worker ``mode`` in two ranks of the product launcher,
    and meanwhile in this process without a group (torch on one thread,
    as in the ranks); the launch must exit 0."""
    import torch

    proc = subprocess.Popen(
        [sys.executable, "-m", "tools.launch_distributed", "--processes",
         "2", "--emulate-cpu", "1", "--", sys.executable,
         os.path.abspath(__file__), mode, outdir],
        cwd=REPO, env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single(outdir, "single")
    finally:
        torch.set_num_threads(threads)
        try:
            text = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == 0, f"launcher failed:\n{text[-8000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two launches of two ranks, one after the other (three busy
    processes at most), each beside its one-process run here."""
    from kubeml_tpu_torch.models import get_model

    outdir = str(tmp_path_factory.mktemp("syncranks"))
    flax = _mlp_flax_params()
    start = get_model("mlp")(hidden=HIDDEN, num_classes=CLASSES) \
        .params_from_flax(flax)
    np.savez(os.path.join(outdir, "init.npz"),
             **{k: v.numpy() for k, v in start.items()})
    _launch("engine", outdir, engine_cases)
    _launch("job", outdir, job_cases)
    load = lambda name: dict(np.load(os.path.join(outdir, name)))  # noqa
    return ({r: load(f"engine_p{r}.npz") for r in range(2)},
            load("engine_single.npz"), flax, outdir)


def _sub(out, pre):
    pre += "/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _gathered(ranks, pre, kind):
    """A value every rank holds a flat shard of, whole: the ranks' shards
    concatenated in rank order (a replicated leaf: rank 0's)."""
    r0, r1 = (_sub(ranks[r], pre) for r in range(2))
    out = {}
    for k in r0:
        if not k.startswith(kind + "/"):
            continue
        n = k[len(kind) + 1:]
        elems = int(r0[f"opt_elems/{n}"])
        whole = int(np.prod(r0[f"w/{n}"].shape))
        out[n] = (np.concatenate([r0[k], r1[k]]) if elems < whole
                  else r0[k])
    return out


# ---------------------------------------------------------------- the mlp

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("D", LANES)
def test_ranks_equal_each_other(runs, D, mode):
    """Both ranks hold the same weights, losses and skip flags after both
    dispatches, bit for bit."""
    ranks, _, _, _ = runs
    a, b = (_sub(ranks[r], f"mlp/{D}/{mode}") for r in range(2))
    for k in a:
        if k.startswith(("w/", "loss/", "skipped/", "steps")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("D", LANES)
def test_ranks_against_one_process(runs, D, mode):
    """Two ranks against one process of D lanes: the explicit paths at
    one lane a rank (and ef_int8's weights at four) bit for bit, weights,
    gathered moments and each rank's residuals its slice; the f32 paths
    otherwise within 1e-5; ef_bf16 at four lanes a rank within the
    EF-bf16 bound."""
    ranks, single, _, _ = runs
    pre = f"mlp/{D}/{mode}"
    one = _sub(single, pre)
    r0 = _sub(ranks[0], pre)
    exact = MODES[mode].get("merge_strategy") and (D == 2
                                                   or mode == "ef_int8")
    steps = 2 * S
    tol = steps * max(LRS) * 2.0 ** -7 if mode == "ef_bf16" else 1e-5
    for kind in ("mu", "nu"):
        got = _gathered(ranks, pre, kind)
        for n, v in got.items():
            want = one[f"{kind}/{n}"]
            if exact:
                np.testing.assert_array_equal(v, want, err_msg=(kind, n))
            elif mode != "ef_bf16":
                np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-6,
                                           err_msg=(kind, n))
    for k, want in one.items():
        if not k.startswith(("w/", "loss/")):
            continue
        # four lanes a rank sum the lanes' f32 losses in another order
        if exact and (D == 2 or k.startswith("w/")):
            np.testing.assert_array_equal(r0[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(r0[k], want, rtol=0, atol=tol,
                                       err_msg=k)
    np.testing.assert_array_equal(r0["steps"], one["steps"])
    assert list(r0["steps"]) == [steps]
    for k, want in one.items():
        if k.startswith("res/"):
            for r in range(2):
                got = _sub(ranks[r], pre)[k]
                lanes = want.reshape(2, -1)[r]
                if exact:
                    np.testing.assert_array_equal(got, lanes, err_msg=k)
                else:
                    assert got.shape == lanes.shape, k


def _plan(model, flax, specs):
    """{port name: (elements a rank holds, whole elements)} from a
    reference spec tree shaped like the flax params: a leaf laid out over
    ``data`` splits over the two ranks."""
    import jax

    from kubeml_tpu_torch.convert import flax_leaf_order

    names = flax_leaf_order(model.params_from_flax(flax))
    leaves = jax.tree_util.tree_leaves(flax)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(names) == len(leaves) == len(spec_leaves)
    return {n: (int(np.size(v)) // (2 if tuple(sp) else 1),
                int(np.size(v)))
            for n, v, sp in zip(names, leaves, spec_leaves)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("D", LANES)
def test_shard_elements_equal_reference_plan(runs, D, mode):
    """Each rank's optimizer-state elements (and under fsdp its parameter
    shard) equal the plan from the reference's layout decisions on a
    D-lane mesh: 1/2 of every leaf it shards, the rest whole. A rank
    copies only its lanes' half of each global batch."""
    import jax
    import optax

    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.parallel.syncdp import SyncDPEngine as RefEngine
    from kubeml_tpu_torch.models import get_model

    ranks, single, flax, _ = runs
    model = get_model("mlp")(hidden=HIDDEN, num_classes=CLASSES)
    knobs = {k: v for k, v in MODES[mode].items()
             if k in ("zero1", "fsdp")}
    ref = RefEngine(make_mesh(n_data=D, devices=jax.devices()[:D]), None,
                    lambda lr, e: optax.adam(lr), donate=False,
                    **knobs)
    ref.init_state({"params": flax})

    opt_plan = _plan(model, flax, ref._opt_specs[0].mu)
    param_plan = _plan(model, flax, ref._param_specs)
    assert any(c < w for c, w in opt_plan.values()) == (mode != "replicated")
    for r in range(2):
        got = _sub(ranks[r], f"mlp/{D}/{mode}")
        for n, (half, whole) in opt_plan.items():
            assert int(got[f"opt_elems/{n}"]) == half, (r, n)
            assert got[f"mu/{n}"].size == half, (r, n)
            want = param_plan[n][0] if mode == "fsdp" else whole
            assert int(got[f"param_elems/{n}"]) == want, (r, n)
        rows = G // 2
        np.testing.assert_array_equal(
            got["copied"], _dispatch(0)[0]["x"][:, r * rows:(r + 1) * rows])
    np.testing.assert_array_equal(_sub(single, f"mlp/{D}/{mode}")["copied"],
                                  _dispatch(0)[0]["x"])


@pytest.mark.parametrize("strategy", [None, "bucketed"],
                         ids=["implicit", "bucketed"])
@pytest.mark.parametrize("D", LANES)
def test_ranks_match_reference_mesh(runs, D, strategy):
    """The two ranks against the JAX package's SyncDPEngine on a D-lane
    CPU mesh from the same parameters and batches: weights within f32
    1e-5 on the implicit path (zero1, replicated and fsdp alike) and
    under the bucketed merge; losses within 1e-4 relative."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.parallel.syncdp import SyncDPEngine as RefEngine
    from kubeml_tpu_torch.models import get_model

    ranks, _, flax, _ = runs
    ref_model = get_builtin("mlp")(hidden=HIDDEN, num_classes=CLASSES)
    eng = RefEngine(make_mesh(n_data=D, devices=jax.devices()[:D]),
                    ref_model.loss, lambda lr, e: optax.adam(lr),
                    donate=False, merge_strategy=strategy,
                    merge_bucket_mb=CAP_MB if strategy else 0.0)
    state = eng.init_state({"params": jax.tree_util.tree_map(jnp.asarray,
                                                             flax)})
    losses = []
    for r in range(2):
        batch, mask, keys, lr = _dispatch(r)
        state, loss = eng.train_steps(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, mask,
            keys, lr=lr, epoch=0)
        losses.append(np.asarray(loss))
    want = get_model("mlp")(hidden=HIDDEN, num_classes=CLASSES) \
        .params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                 state["params"]))
    for mode in (("zero1", "replicated", "fsdp") if strategy is None
                 else (strategy,)):
        got = _sub(ranks[0], f"mlp/{D}/{mode}")
        for k, v in want.items():
            np.testing.assert_allclose(got[f"w/{k}"], v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=(mode, k))
        for r in range(2):
            np.testing.assert_allclose(got[f"loss/{r}"], losses[r],
                                       rtol=1e-4, err_msg=(mode, r))


@pytest.mark.parametrize("mode", STATS_MODES)
@pytest.mark.parametrize("D", LANES)
def test_stats_over_ranks_equal_one_process(runs, D, mode):
    """The per-step squared global grad, update and parameter norms each
    rank reports (its shards and, on rank 0, the replicated leaves,
    summed over the ranks) equal each other bit for bit and one
    process's within f32 1e-5."""
    ranks, single, _, _ = runs
    pre = f"mlp/{D}/{mode}"
    one = _sub(single, pre)
    keys = [k for k in one if k.startswith("stats/")]
    assert len(keys) == 2
    for k in keys:
        assert one[k].shape == (S, 3) and (one[k] > 0).all(), (k, one[k])
        got = [_sub(ranks[r], pre)[k] for r in range(2)]
        np.testing.assert_array_equal(got[0], got[1], err_msg=k)
        np.testing.assert_allclose(got[0], one[k], rtol=1e-5, atol=0,
                                   err_msg=k)


# ---------------------------------------------------------------- the GPT

@pytest.mark.parametrize("mode", GPT_MODES)
def test_gpt_ranks_against_one_process(runs, mode):
    """A 2-layer GPT with dropout 0.1 over two ranks of one lane: both
    ranks equal each other; ef_bf16 equals one process bit for bit; the
    implicit paths (each rank drawing the global batch's dropout and
    keeping its rows) within AdamW's 2 x steps x lr, 99.5 % of the
    elements within 1e-5."""
    ranks, single, _, _ = runs
    a, b = (_sub(ranks[r], f"gpt/{mode}") for r in range(2))
    one = _sub(single, f"gpt/{mode}")
    weights = [k for k in one if k.startswith("w/")]
    assert weights
    for k in weights:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if mode == "ef_bf16":
        for k in weights + ["loss/0", "loss/1"]:
            np.testing.assert_array_equal(a[k], one[k], err_msg=k)
        return
    diffs = np.concatenate([np.abs(a[k] - one[k]).ravel() for k in weights])
    assert diffs.max() <= 2 * 2 * S * GPT_LR, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()
    np.testing.assert_allclose(a["loss/1"], one["loss/1"], rtol=1e-4)
    assert not a["skipped/0"].any() and not a["skipped/1"].any()


# ------------------------------------------------------- branches, refusals

@pytest.mark.parametrize("mode", ["zero1", "ef_bf16"])
def test_branches_are_global(runs, mode):
    """Each rank takes the branch one process takes: a NaN in rank 1's
    slice skips step 1 on both ranks (Adam's step count 1, the EF
    residuals zeroed); a step whose real samples are all on rank 0 runs
    on both; a step with no real sample runs on neither (one readback)."""
    ranks, single, _, _ = runs
    for case, skipped, steps, readbacks in (("nan", [0, 1], 1, 2),
                                            ("rank1", [0, 0], 2, 2),
                                            ("all", [0, 0], 1, 1)):
        one = _sub(single, f"branch/{mode}/{case}")
        for r in range(2):
            got = _sub(ranks[r], f"branch/{mode}/{case}")
            assert got["skipped/0"].tolist() == skipped == \
                one["skipped/0"].tolist(), (case, r)
            assert list(got["steps"]) == [steps], (case, r)
            assert int(got["readbacks"]) == readbacks, (case, r)
            for k in one:
                if k.startswith("w/"):
                    np.testing.assert_array_equal(
                        got[k], _sub(ranks[0], f"branch/{mode}/{case}")[k])
                    np.testing.assert_allclose(got[k], one[k], rtol=0,
                                               atol=1e-5, err_msg=(case, k))
            if case == "nan" and mode == "ef_bf16":
                res = [v for k, v in got.items() if k.startswith("res/")]
                assert res and not any(v.any() for v in res)


def test_implicit_refuses_row_coupled_models_over_ranks(runs):
    """Over two ranks the implicit path refuses a BatchNorm model and an
    MoE model with a 400 naming ROADMAP A.21; the explicit path builds
    over the BatchNorm model; one process builds all three."""
    _, _, _, outdir = runs
    for tag in ("p0", "p1"):
        with open(os.path.join(outdir, f"refusals_{tag}.json")) as f:
            got = json.load(f)
        for name in ("bn", "moe"):
            assert got[name]["status"] == 400, got
            assert "ROADMAP A.21" in got[name]["error"], got
        assert got["bn_explicit"] == {"status": None, "error": "built"}
    with open(os.path.join(outdir, "refusals_single.json")) as f:
        assert all(v["error"] == "built" for v in json.load(f).values())


# ---------------------------------------------------------------- the jobs

def _history(outdir, name, tag):
    with open(os.path.join(outdir, f"history_{name}_{tag}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(JOB_OPTS))
def test_two_rank_syncdp_job_equals_one_process(runs, name):
    """A two-rank syncdp job (2 lanes, 2 epochs over the blobs): both
    ranks' histories and final weights equal bit for bit; under ef_bf16
    (one lane a rank) they equal the one-process job's bit for bit, under
    fsdp (the implicit path) within 1e-5."""
    _, _, _, outdir = runs
    h0, h1, hs = (_history(outdir, name, t) for t in ("p0", "p1", "single"))
    assert h0 == h1
    assert len(h0["train_loss"]) == 2 and h0["parallelism"] == [2, 2]
    finals = [np.load(os.path.join(outdir, f"final_{name}_{t}.npz"))
              for t in ("p0", "p1", "single")]
    for k in finals[2].files:
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
        if name == "ef_bf16":
            np.testing.assert_array_equal(finals[0][k], finals[2][k],
                                          err_msg=k)
        else:
            np.testing.assert_allclose(finals[0][k], finals[2][k], rtol=0,
                                       atol=1e-5, err_msg=k)
    if name == "ef_bf16":
        assert h0 == hs
    else:
        assert h0["parallelism"] == hs["parallelism"]
        for key in ("train_loss", "validation_loss", "accuracy"):
            np.testing.assert_allclose(h0[key], hs[key], rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("name", sorted(JOB_OPTS))
def test_two_rank_syncdp_checkpoint_loads_in_both_packages(runs, name):
    """Each rank wrote the job's checkpoint under its own home: the port
    and the JAX package load it, and it holds the final weights."""
    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint

    _, _, _, outdir = runs
    final = np.load(os.path.join(outdir, f"final_{name}_p0.npz"))
    model = get_model("mlp")(hidden=HIDDEN, num_classes=CLASSES)
    for r in range(2):
        root = os.path.join(outdir, f"p{r}", "models")
        port_tree, manifest = load_checkpoint(JOB_ID[name], root=root)
        ref_tree, _ = ref_load(JOB_ID[name], root=root)
        assert manifest.get("completed") and manifest["model"] == "mlp"
        for tree in (port_tree["params"], {
                k: {n: np.asarray(a) for n, a in v.items()}
                for k, v in ref_tree["params"].items()}):
            state = model.params_from_flax(tree)
            for k in final.files:
                np.testing.assert_array_equal(state[k].numpy(), final[k])


WORKERS = {"engine": engine_cases, "job": job_cases}


if __name__ == "__main__":
    import faulthandler

    # a cross-process hang shows where each rank is stuck
    faulthandler.dump_traceback_later(120, repeat=True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from kubeml_tpu_torch.parallel import distributed as dist_lib

    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    dist_lib.initialize(device="cpu", timeout=120)
    WORKERS[mode](outdir, f"p{dist_lib.rank()}")
    print(f"{mode} rank {dist_lib.rank()} OK", flush=True)
