"""Port parity: sequence-parallel training over ``torch.distributed`` ranks
(the K-avg engine's seq round, ``kubeml_tpu_torch/parallel/kavg.py``;
the GPT and BERT modules with ``seq_axis``; the job's ``n_seq`` path)
against the JAX package's seq round and against the port in one process.

The ranks are processes of ``tools/launch_distributed`` (``--emulate-cpu
1``) joined over gloo, each running this file's ``__main__`` block: four
ranks as a (data 2 x seq 2) rank grid for the rounds, two for the job.
Both launches start together in the module fixture; the JAX package's
rounds (``make_mesh(n_data=2, n_seq=2)``, the setup of
tests/test_parallel_tp_sp.py's ``_sp_train_compare``) and the port's
one-process rounds run in the test process meanwhile, torch on one
thread.

What is held, and how tightly:
  - one K-avg round (W=2, S=2, B=4, T=32, SGD, dropout 0) of a narrow GPT
    under the ring and under Ulysses and of bert-tiny under the ring, at
    (data 2 x seq 2): the four ranks' merged weights, loss sums and eval
    metrics equal each other bit for bit, and the reference's (data=2,
    seq=2) round within f32 1e-5 with f32 modules; bert-tiny in bf16 (its
    default) within the reference's own bounds of its SP-vs-dense test
    (weights rtol 2e-2 atol 2e-3, losses 5e-3). bert-tiny's classifier
    sits after the pooled seq sum: counted twice, its weights would miss;
  - the same GPT (ring) and bert-tiny rounds with dropout 0.1 against
    the port's one-process 2-lane dense round: each seq rank keeps its
    block of the whole sequence's dropout draw, so they agree within f32
    1e-5;
  - the SP LM loss at n = 4 with right padding ending inside blocks and a
    fully padded row equals the dense loss within f32 1e-5;
  - a two-rank TrainJob with n_seq=2: both ranks' histories equal, and
    the loss finite;
  - the job's 400s in the reference's order (syncdp; the world; the
    model's enable_seq_parallel; no seq_batch_dims; T per split).
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
W, S, B, T, LR = 2, 2, 4, 32, 1e-2
GPT = dict(vocab_size=64, max_len=32, hidden=32, layers=2, heads=2, ffn=64)
# name: (model, impl, dtype, dropout); "ref" rounds are held against the
# JAX package's, "drop" rounds against the port's one process
ROUNDS = {
    "gpt-ring-f32": ("gpt", "ring", "f32", 0.0),
    "gpt-ulysses-f32": ("gpt", "ulysses", "f32", 0.0),
    "bert-ring-f32": ("bert", "ring", "f32", 0.0),
    "bert-ring-bf16": ("bert", "ring", "bf16", 0.0),
    "gpt-ring-drop": ("gpt", "ring", "f32", 0.1),
    "bert-ring-drop": ("bert", "ring", "f32", 0.1),
}
REF_ROUNDS = [k for k, v in ROUNDS.items() if v[3] == 0.0]
DROP_ROUNDS = [k for k, v in ROUNDS.items() if v[3] > 0.0]
JOB_T, JOB_N, JOB_TEST = 16, 64, 16


# ------------------------------------------------------------- the inputs

def _batch(kind):
    """The reference test's batches and step keys (RandomState(0)):
    ascending token runs for the LM, random ids and labels for BERT."""
    rng = np.random.RandomState(0)
    if kind == "gpt":
        start = rng.randint(1, 63, size=(W * S * B, 1))
        seq = (start + np.arange(T)[None, :] - 1) % 63 + 1
        batch = {"x": seq.reshape(W, S, B, T).astype(np.int32)}
    else:
        batch = {"x": rng.randint(1, 1000, size=(W, S, B, T)).astype(
                     np.int32),
                 "y": rng.randint(0, 2, size=(W, S, B)).astype(np.int32)}
    rngs = rng.randint(0, 2 ** 31, size=(W, S, 2)).astype(np.uint32)
    return batch, rngs


MASKS = dict(sample_mask=np.ones((W, S, B), np.float32),
             step_mask=np.ones((W, S), np.float32),
             worker_mask=np.ones(W, np.float32))


def _port_model(kind, dtype, dropout):
    """A port model whose modules build at the test's widths."""
    import torch

    from kubeml_tpu_torch.convert import params_to_flax
    from kubeml_tpu_torch.models.bert import BertModule, BertTiny
    from kubeml_tpu_torch.models.gpt import GPTMini, GPTModule

    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    if kind == "gpt":
        class Tiny(GPTMini):
            def build(self, dtype=None, device=None):
                return GPTModule(**GPT, dropout=dropout, dtype=dt,
                                 device=device, seq_axis=self.seq_axis,
                                 seq_impl=self.seq_impl)

            def params_to_flax(self, state):
                return params_to_flax(state, heads=GPT["heads"])
        return Tiny(dt)

    class Bert(BertTiny):
        def build(self, dtype=None, device=None):
            return BertModule(num_classes=2, dropout=dropout, dtype=dt,
                              device=device, seq_axis=self.seq_axis,
                              seq_impl=self.seq_impl)
    return Bert(dt)


def _sgd(lr, epoch):
    import torch

    return functools.partial(torch.optim.SGD, lr=lr)


def _port_round(name, init, n_seq):
    """One round of ROUNDS[name] from the port state ``init`` over the
    current group (n_seq > 1: the seq round) or in one process: (merged
    state, loss sums, eval metrics)."""
    import torch

    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    kind, impl, dtype, dropout = ROUNDS[name]
    model = _port_model(kind, dtype, dropout)
    if n_seq > 1:
        model.enable_seq_parallel(impl)
    module = model.build(device="cpu")
    with torch.no_grad():
        for k, t in module_state(module).items():
            t.copy_(torch.from_numpy(init[k]))
    engine = KAvgEngine(module, model.loss, model.metrics, _sgd, n_lanes=2,
                        n_seq=n_seq, batch_seq_dims=model.seq_batch_dims)
    batch, rngs = _batch(kind)
    variables = {k: torch.from_numpy(v) for k, v in init.items()}
    out, stats = engine.train_round(variables, batch, rngs=rngs, lr=LR,
                                    epoch=0, **MASKS)
    ev = engine.eval_round(out, batch, MASKS["sample_mask"])
    return ({k: v.numpy() for k, v in out.items()}, stats.loss_sum,
            np.array([ev["loss"], ev["accuracy"], ev["n"]]))


def _lm_padded():
    """The reference test's padded LM windows (right padding ending
    inside blocks 1 and 2 of 4, a fully padded row)."""
    rng = np.random.RandomState(1)
    x = rng.randint(1, 63, size=(4, T)).astype(np.int32)
    x[0, 20:] = 0
    x[1, 8:] = 0
    x[2, :] = 0
    return x


# ------------------------------------------------------------- the ranks

def rounds_worker(outdir):
    """Every round of ROUNDS over the (data 2 x seq 2) grid, then the SP
    loss at n = 4; each rank writes its rows."""
    import torch

    from kubeml_tpu_torch.models.gpt import GPTModule, _lm_per_example_sp
    from kubeml_tpu_torch.parallel import distributed as dl

    rank = dl.rank()
    inits = dict(np.load(os.path.join(outdir, "init.npz")))
    out = {}
    for name, (kind, _, dtype, _) in ROUNDS.items():
        init = {k[len(f"{kind}-{dtype}/"):]: v for k, v in inits.items()
                if k.startswith(f"{kind}-{dtype}/")}
        state, losses, ev = _port_round(name, init, 2)
        out.update({f"{name}/w/{k}": v for k, v in state.items()})
        out[f"{name}/loss"] = losses
        out[f"{name}/eval"] = ev
    grid = dl.make_grid(4)
    module = GPTModule(**GPT, dropout=0.0, dtype=torch.float32,
                       device="cpu", seq_axis="seq")
    with torch.no_grad():
        for k, t in module.state_dict().items():
            t.copy_(torch.from_numpy(inits[f"gpt-f32/{k}"]))
    x = torch.from_numpy(_lm_padded())
    Tl = T // 4
    xb = x[:, grid.seq_index * Tl:(grid.seq_index + 1) * Tl]
    with torch.no_grad():
        out["sp_loss"] = _lm_per_example_sp(module.logits(xb), xb,
                                            "seq").numpy()
    np.savez(os.path.join(outdir, f"rounds_p{rank}.npz"), **out)


def _token_home(home):
    """This process's KUBEML_TPU_HOME with a token-window dataset."""
    os.environ["KUBEML_TPU_HOME"] = home
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    rng = np.random.RandomState(5)
    start = rng.randint(1, 63, size=(JOB_N + JOB_TEST, 1))
    x = ((start + np.arange(JOB_T)[None, :] - 1) % 63 + 1).astype(np.int32)
    x[::5, JOB_T - 3:] = 0
    y = np.zeros(len(x), np.int32)
    reg = DatasetRegistry()
    reg.create("toks", x[:JOB_N], y[:JOB_N], x[JOB_N:], y[JOB_N:])
    return reg


def _job_task(job_id, **opts):
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)

    req = TrainRequest(model_type="gpt-mini", batch_size=8, epochs=2,
                       dataset="toks", lr=1e-3, options=TrainOptions(
                           default_parallelism=2, static_parallelism=True,
                           validate_every=1, k=2, **opts))
    return TrainTask(job_id=job_id, parameters=req, parallelism=2)


def _job(task, reg, model=None):
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.history import HistoryStore
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    return TrainJob(task, model or _port_model("gpt", "f32", 0.1),
                    KubeDataset("toks"), "cpu", n_lanes=1, registry=reg,
                    history_store=HistoryStore(), callbacks=JobCallbacks())


def job_worker(outdir):
    """A two-rank job with n_seq=2 (one lane); each rank writes its
    history."""
    from kubeml_tpu_torch.parallel import distributed as dl

    rank = dl.rank()
    reg = _token_home(os.path.join(outdir, f"home_p{rank}"))
    record = _job(_job_task("spjob", n_seq=2), reg).train()
    with open(os.path.join(outdir, f"job_p{rank}.json"), "w") as f:
        json.dump({"train_loss": list(map(float, record.data.train_loss)),
                   "validation_loss": list(map(
                       float, record.data.validation_loss)),
                   "accuracy": list(map(float, record.data.accuracy)),
                   "parallelism": list(record.data.parallelism)}, f)


WORKERS = {"rounds": rounds_worker, "job": job_worker}


# -------------------------------------------------------------- fixtures

def _inits():
    """The reference's initial variables (PRNGKey(0)) of each model, as
    the port's state dicts, prefixed by model and dtype."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models import get_builtin
    from test_models_gpt import TinyGPT

    out = {}
    refs = (("gpt", TinyGPT()), ("bert", get_builtin("bert-tiny")()))
    for kind, ref in refs:
        batch, _ = _batch(kind)
        variables = ref.init_variables(
            jax.random.PRNGKey(0),
            {k: jnp.asarray(v[0, 0]) for k, v in batch.items()})
        flax = jax.tree_util.tree_map(np.asarray, variables["params"])
        for dtype in ("f32", "bf16"):
            state = _port_model(kind, dtype, 0.0).params_from_flax(flax)
            out.update({f"{kind}-{dtype}/{k}": v.numpy()
                        for k, v in state.items()})
    return out


def _reference_round(name):
    """The JAX package's (data=2, seq=2) round of ROUNDS[name]: (flax
    params, loss sums, eval [loss, accuracy, n])."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.kavg import KAvgEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from test_models_gpt import TinyGPT

    kind, impl, dtype, _ = ROUNDS[name]
    model = TinyGPT() if kind == "gpt" else get_builtin("bert-tiny")()
    dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    batch, rngs = _batch(kind)
    variables = model.init_variables(
        jax.random.PRNGKey(0),
        {k: jnp.asarray(v[0, 0]) for k, v in batch.items()})
    model._module = model.module.clone(dropout=0.0, dtype=dt)
    model.enable_seq_parallel(impl)
    eng = KAvgEngine(make_mesh(n_data=2, n_seq=2, devices=jax.devices()[:4]),
                     model.loss, model.metrics,
                     lambda lr, e: optax.sgd(lr), donate=False,
                     batch_seq_dims=model.seq_batch_dims)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, stats = eng.train_round(variables, jb, rngs=rngs, lr=LR, epoch=0,
                                 **MASKS)
    ev = eng.eval_round(out, jb, MASKS["sample_mask"])
    return (jax.tree_util.tree_map(np.asarray, out["params"]),
            np.asarray(stats.loss_sum),
            np.array([ev["loss"], ev["accuracy"], ev["n"]]))


def _launch(mode, world, outdir):
    return subprocess.Popen(
        [sys.executable, "-m", "tools.launch_distributed", "--processes",
         str(world), "--emulate-cpu", "1", "--", sys.executable,
         os.path.abspath(__file__), mode, outdir],
        cwd=REPO, env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches started together; meanwhile the reference's rounds
    and the port's one-process rounds here."""
    import torch

    outdir = str(tmp_path_factory.mktemp("seqpar"))
    inits = _inits()
    np.savez(os.path.join(outdir, "init.npz"), **inits)
    procs = {"rounds": _launch("rounds", 4, outdir),
             "job": _launch("job", 2, outdir)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {name: _reference_round(name) for name in REF_ROUNDS}
        single = {}
        for name in DROP_ROUNDS:
            kind, _, dtype, _ = ROUNDS[name]
            init = {k[len(f"{kind}-{dtype}/"):]: v for k, v in inits.items()
                    if k.startswith(f"{kind}-{dtype}/")}
            single[name] = _port_round(name, init, 1)
    finally:
        torch.set_num_threads(threads)
        texts = {}
        for mode, p in procs.items():
            try:
                texts[mode] = p.communicate(timeout=600)[0]
            finally:
                if p.poll() is None:
                    p.kill()
    for mode, p in procs.items():
        assert p.returncode == 0, f"{mode} ranks failed:\n" \
            f"{texts[mode][-8000:]}"
    ranks = [dict(np.load(os.path.join(outdir, f"rounds_p{r}.npz")))
             for r in range(4)]
    jobs = []
    for r in range(2):
        with open(os.path.join(outdir, f"job_p{r}.json")) as f:
            jobs.append(json.load(f))
    return ranks, refs, single, jobs, inits


def _weights(ranks, name, r=0):
    pre = f"{name}/w/"
    return {k[len(pre):]: v for k, v in ranks[r].items()
            if k.startswith(pre)}


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_seq_ranks_equal_each_other(runs, name):
    """All four ranks (two lane groups of two seq ranks) hold the same
    merged weights, loss sums and eval metrics, bit for bit."""
    ranks = runs[0]
    for r in range(1, 4):
        for k, v in ranks[0].items():
            if k.startswith(name + "/"):
                np.testing.assert_array_equal(ranks[r][k], v,
                                              err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", REF_ROUNDS)
def test_seq_round_matches_reference(runs, name):
    """The (data 2 x seq 2) round against the reference's (data=2,
    seq=2) round: f32 1e-5 with f32 modules; bert-tiny in bf16 within the
    reference's own SP-vs-dense bounds."""
    import jax
    import torch

    ranks, refs, _, _, _ = runs
    kind, _, dtype, _ = ROUNDS[name]
    model = _port_model(kind, dtype, 0.0)
    have = model.params_to_flax({k: torch.from_numpy(v) for k, v in
                                 _weights(ranks, name).items()})
    want, loss, ev = refs[name]
    flat_have = jax.tree_util.tree_leaves_with_path(have)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_have) == len(flat_want)
    rtol, atol = (1e-5, 1e-5) if dtype == "f32" else (2e-2, 2e-3)
    for path, a in flat_have:
        np.testing.assert_allclose(np.asarray(a), flat_want[path],
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))
    got_loss, got_ev = ranks[0][f"{name}/loss"], ranks[0][f"{name}/eval"]
    if dtype == "f32":
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_ev[:2], ev[:2], rtol=1e-5, atol=1e-5)
    else:
        assert abs(got_loss.sum() - loss.sum()) \
            < 5e-3 * max(1.0, abs(loss.sum()))
        assert abs(got_ev[0] - ev[0]) < 5e-3
    assert got_ev[2] == ev[2]


@pytest.mark.parametrize("name", DROP_ROUNDS)
def test_seq_round_with_dropout_matches_one_process(runs, name):
    """Dropout 0.1: the (data 2 x seq 2) round equals the port's
    one-process 2-lane round within f32 1e-5 (each seq rank keeps its
    block of the whole sequence's draw)."""
    ranks, _, single, _, inits = runs
    state, loss, ev = single[name]
    have = _weights(ranks, name)
    assert set(have) == set(state)
    kind, _, dtype, _ = ROUNDS[name]
    moved = 0
    for k, v in state.items():
        np.testing.assert_allclose(have[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        moved += int(not np.array_equal(v, inits[f"{kind}-{dtype}/{k}"]))
    assert moved > 0
    np.testing.assert_allclose(ranks[0][f"{name}/loss"], loss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ranks[0][f"{name}/eval"], ev, rtol=1e-5,
                               atol=1e-5)


def test_sp_loss_handles_padding_across_shards(runs):
    """The SP LM loss at n = 4 (a boundary target from the next block, the
    global last column masked) equals the dense loss in f32."""
    import torch

    from kubeml_tpu_torch.models.gpt import GPTModule, _lm_per_example

    ranks, _, _, _, inits = runs
    module = GPTModule(**GPT, dropout=0.0, dtype=torch.float32,
                       device="cpu")
    with torch.no_grad():
        for k, t in module.state_dict().items():
            t.copy_(torch.from_numpy(inits[f"gpt-f32/{k}"]))
    x = torch.from_numpy(_lm_padded())
    with torch.no_grad():
        dense = _lm_per_example(module.logits(x), x).numpy()
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["sp_loss"], dense, rtol=1e-5,
                                   atol=1e-5)


def test_two_rank_seq_job_histories_equal(runs):
    """A two-rank TrainJob with n_seq=2 (one lane over two seq ranks):
    both ranks' histories are equal, with finite losses."""
    jobs = runs[3]
    assert jobs[0] == jobs[1]
    assert len(jobs[0]["train_loss"]) == 2
    assert np.isfinite(jobs[0]["train_loss"]).all()
    assert np.isfinite(jobs[0]["validation_loss"]).all()


# the job's 400s, in the reference's order (kubeml_tpu/train/job.py)
REFUSALS = {
    "syncdp": (dict(engine="syncdp"), 1, "gpt",
               "tensor/sequence/pipeline/expert parallelism requires the "
               "kavg engine"),
    "world": ({}, 1, "gpt",
              "1 devices not divisible by the requested model x seq x "
              "stage x expert factor 2"),
    "model": ({}, 2, "mlp",
              "function 'mlp' does not support sequence parallelism"),
    "impl": (dict(seq_impl="zigzag"), 2, "gpt",
             "unknown seq-parallel impl 'zigzag'; expected 'ring' or "
             "'ulysses'"),
    "dims": ({}, 2, "nodims",
             "function 'gpt-mini' enabled sequence parallelism but "
             "declares no seq_batch_dims"),
    "length": ({}, 2, "odd",
               "train-split sequence length 15 of batch key 'x' is not "
               "divisible by --seq-parallel 2"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_seq_job_refusals_in_reference_order(tmp_path, monkeypatch, case):
    """Each misconfiguration fails the job with the reference's 400 and
    wording, before any data is trained: the world is one device without
    a group, and two where a case needs the later checks."""
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPTMini
    from kubeml_tpu_torch.parallel import distributed as dl

    opts, world, kind, message = REFUSALS[case]
    reg = _token_home(str(tmp_path))
    monkeypatch.setattr(dl, "world_size", lambda: world)
    if kind == "mlp":
        model = get_model("mlp")(hidden=8, num_classes=2)
    elif kind == "nodims":
        class NoDims(GPTMini):
            seq_batch_dims = None

            def enable_seq_parallel(self, impl="ring"):
                pass
        model = NoDims()
    else:
        model = _port_model("gpt", "f32", 0.0)
    if kind == "odd":
        from kubeml_tpu_torch.data.registry import DatasetRegistry

        x = np.ones((32, 15), np.int32)
        DatasetRegistry().create("toks15", x, x[:, 0], x[:8], x[:8, 0])
        task = _job_task("refused", n_seq=2, **opts)
        task.parameters.dataset = "toks15"
    else:
        task = _job_task("refused", n_seq=2, **opts)
    with pytest.raises(KubeMLException) as e:
        _job(task, reg, model).train()
    assert e.value.status_code == 400
    assert e.value.message == message
    assert "ROADMAP" not in e.value.message


def test_forward_seq_parallel_equals_dense_in_one_process():
    """forward_seq_parallel over the one-process grid (n = 1) gives the
    dense forward's logits for GPT and bert-tiny."""
    import torch

    gpt = _port_model("gpt", "f32", 0.0)
    module = gpt.build(device="cpu")
    x = _lm_padded()
    got = gpt.forward_seq_parallel(module, x)
    want = module.logits(torch.from_numpy(x))
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)
    assert module.seq_axis is None
    bert = _port_model("bert", "f32", 0.0)
    bmod = bert.build(device="cpu")
    torch.testing.assert_close(bert.forward_seq_parallel(bmod, x),
                               bmod(torch.from_numpy(x)).detach(),
                               rtol=1e-6, atol=1e-6)


if __name__ == "__main__":
    import faulthandler

    faulthandler.dump_traceback_later(180, repeat=True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from kubeml_tpu_torch.parallel import distributed as dist_lib

    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    dist_lib.initialize(device="cpu", timeout=180)
    WORKERS[mode](outdir)
    print(f"{mode} rank {dist_lib.rank()} OK", flush=True)
