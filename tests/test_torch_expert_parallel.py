"""Port parity: expert parallelism over ``torch.distributed`` ranks (the
rank grid's expert axis, ``kubeml_tpu_torch/parallel/distributed.py``;
``parallel/manual.ep_partial_ffn``; gpt-moe-mini with ``ep_axis`` and
``seq_axis``; the K-avg engine's inner round and its ring merge; the
job's ``n_expert`` path) against the JAX package and against the port in
one process.

The ranks are processes of ``tools/launch_distributed`` (``--emulate-cpu
1``) joined over gloo, each running this file's ``__main__`` block: two
ranks (``pair``: data 1 x expert 2) and four (``quad``: seq 2 x expert 2,
data 2 x seq 2, data 2 x expert 2, seq 4). Both launches and two
processes of the JAX package's jobs (their compiles take most of the
file's time) start together in the module fixture; the JAX package's
rounds and forward and the port's one-process runs happen in the test
process meanwhile, torch on one thread. The
model is the reference's ``TinyMoE`` (vocab 64, hidden 32, 2 layers, 2
heads, 4 experts of a 32-wide FFN) in f32, its weights made from seed 0
in the flax layouts (``convert.random_flax_params``) and carried across
by ``convert.py``; the inputs come from numpy seeds (RandomState(4) for
the rounds, as the reference's test_kavg_sp_ep_round_matches_sp_only; 0
for the jobs and the forwards; 7 for the FFN).

What is held, and how tightly:
  - ``ep_partial_ffn`` over two expert ranks equals the port's
    ``moe_apply``, and that the reference's, within f32 1e-5; both ranks
    bit for bit;
  - the lane ring (two lanes on each of two ranks) equals the reference's
    ``ring_psum`` over a 4-lane mesh bit for bit, f32 and bf16 wires;
  - one K-avg round (W=2, S=2, B=4, T=32, SGD) at (data 1 x expert 2)
    with dropout 0.1 equals the port's one-process round within f32 1e-5;
    at (seq 2 x expert 2) it equals the (data 2 x seq 2) round with
    replicated experts within f32 1e-5, and each equals the reference's
    round on its virtual CPU mesh ((2, 2, 2) and (2, 2, 1)) within f32
    1e-5, tighter than the reference's own EP-vs-SP bound (rtol 5e-3,
    atol 5e-4); every rank of a launch holds bit-equal states;
  - the two gradient mutants fail those checks: an expert psum whose
    backward is the identity (the expert weights get 1/n of their
    gradient) and an inner round that sums the gradients over the seq
    group only;
  - gpt-moe-mini's seq-parallel forward over four seq ranks equals the
    dense forward at an overflow-free capacity (factor 4.0) within f32
    1e-5, and at the default capacity (per-shard routing, drops possible)
    the reference's own seq-parallel forward within f32 1e-5;
  - a (data 2 x expert 2) TrainJob warm-started from a JAX-written
    checkpoint equals the reference's ``n_expert=2`` job (its GSPMD
    route) within the reference's 2e-3, with an f32 merge and with
    ``--merge-dtype bf16`` (the port's ring against the reference's);
  - ``kubeml train -f gpt-moe-mini --expert-parallel 2`` (two ranks) and
    ``--seq-parallel 2 --expert-parallel 2`` (four, at the overflow-free
    capacity) train: every rank's history equal, and the one-process
    job's within 1e-3 relative;
  - the job's 400s in the reference's order.
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=64, max_len=32, hidden=32, layers=2, heads=2, ffn=32)
E = 4
W, S, B, T, LR = 2, 2, 4, 32, 1e-2
TOL = 1e-5                     # f32 rounds, forwards and the FFN
JOB_T, JOB_N, JOB_TEST = 16, 128, 32
JOB_K = 4
JOB_TOL = 2e-3                 # the reference's DP x EP job bound
# the rank jobs: name -> (ranks, CLI flags after the common ones, the
# expert capacity factor: per-shard routing equals the one process's only
# without overflow, at 4.0)
CLI_JOBS = {"cli-ep": ("pair", ["--expert-parallel", "2"], 1.25),
            "cli-sp-ep": ("quad", ["--seq-parallel", "2",
                                   "--expert-parallel", "2"], 4.0)}
# (data 2 x expert 2) jobs against the reference's: name -> merge flags
DPEP_JOBS = {"dpep-f32": [], "dpep-bf16": ["--merge-dtype", "bf16"]}
RING_CASES = {"f32": (0, 37), "bf16": (1, 37)}


# ------------------------------------------------------------- the inputs

def _round_batch():
    """The reference test's batch and step keys (RandomState(4)):
    ascending token runs [W, S, B, T]."""
    rng = np.random.RandomState(4)
    start = rng.randint(1, 63, size=(W * S * B, 1))
    x = ((start + np.arange(T)[None, :] - 1) % 63 + 1).astype(
        np.int32).reshape(W, S, B, T)
    rngs = rng.randint(0, 2 ** 31, size=(W, S, 2)).astype(np.uint32)
    return {"x": x}, rngs


MASKS = dict(sample_mask=np.ones((W, S, B), np.float32),
             step_mask=np.ones((W, S), np.float32),
             worker_mask=np.ones(W, np.float32))


def _ffn_inputs():
    """An expert layer's f32 parameters in the flax layouts, 24 tokens
    and a mask with four pads (seed 7)."""
    rng = np.random.RandomState(7)
    d, f = TINY["hidden"], TINY["ffn"]
    params = {"router": rng.randn(d, E) / np.sqrt(d),
              "wi": rng.randn(E, d, f) / np.sqrt(d),
              "bi": rng.randn(E, f) * 0.1,
              "wo": rng.randn(E, f, d) / np.sqrt(f),
              "bo": rng.randn(E, d) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.randn(24, d).astype(np.float32)
    mask = np.ones(24, np.float32)
    mask[[3, 10, 17, 23]] = 0.0
    return params, x, mask


def _forward_tokens():
    """The reference test's forward input (RandomState(0)): [2, 32] ids,
    the first row padded from position 20, across shard boundaries."""
    x = np.random.RandomState(0).randint(1, 64, size=(2, 32)).astype(
        np.int32)
    x[0, 20:] = 0
    return x


def _ring_lanes(seed, n):
    return np.random.RandomState(seed).randn(4, n).astype(np.float32)


def _port_model(dropout=0.0, n_experts=E):
    """The port's gpt-moe-mini at the tiny widths in f32, building with
    the model's seq and expert axes."""
    import torch

    from kubeml_tpu_torch.convert import params_to_flax
    from kubeml_tpu_torch.models.gpt import GPTModule, GPTMoEMini

    class Tiny(GPTMoEMini):
        def build(self, dtype=None, device=None):
            return GPTModule(**TINY, n_experts=n_experts, dropout=dropout,
                             dtype=dtype or self.dtype, device=device,
                             seq_axis=self.seq_axis, seq_impl=self.seq_impl,
                             ep_axis=self.ep_axis, ep_impl=self.ep_impl)

        def params_to_flax(self, state):
            return params_to_flax(state, heads=TINY["heads"])

    return Tiny(torch.float32)


def _sgd(lr, epoch):
    import torch

    return functools.partial(torch.optim.SGD, lr=lr)


def _port_round(init, n_seq, n_expert, dropout=0.0, mutant=None):
    """One round from the port state ``init`` over the current group's
    (n_seq x n_expert) grid, or in one process: (merged state, loss sums,
    eval [loss, accuracy, n]). ``mutant`` breaks the gradient sum:
    'identity-psum' (the expert psum's backward passes the cotangent
    through) or 'seq-sum' (the inner round sums over the seq group
    only)."""
    import torch

    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model = _port_model(dropout)
    if n_seq > 1:
        model.enable_seq_parallel("ring")
    if n_expert > 1:
        model.enable_expert_parallel()
    module = model.build(device="cpu")
    with torch.no_grad():
        for k, t in module_state(module).items():
            t.copy_(torch.from_numpy(init[k]))
    engine = KAvgEngine(module, model.loss, model.metrics, _sgd, n_lanes=2,
                        n_seq=n_seq, n_expert=n_expert,
                        batch_seq_dims=model.seq_batch_dims
                        if n_seq > 1 else None)
    if mutant == "seq-sum":
        engine.grid = dataclasses.replace(
            engine.grid, inner_group=engine.grid.seq_group)
    backward = dl._Psum.__dict__["backward"]
    if mutant == "identity-psum":
        dl._Psum.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        batch, rngs = _round_batch()
        variables = {k: torch.from_numpy(v) for k, v in init.items()}
        out, stats = engine.train_round(variables, batch, rngs=rngs, lr=LR,
                                        epoch=0, **MASKS)
        ev = engine.eval_round(out, batch, MASKS["sample_mask"])
    finally:
        dl._Psum.backward = backward
    return ({k: v.numpy() for k, v in out.items()}, stats.loss_sum,
            np.array([ev["loss"], ev["accuracy"], ev["n"]]))


def _set_capacity(factor):
    from kubeml_tpu_torch.models import gpt

    before, gpt.CAPACITY_FACTOR = gpt.CAPACITY_FACTOR, factor
    return before


def _port_forward(init, capacity, grid=None):
    """The tiny module's logits of _forward_tokens() at an expert capacity
    factor: over the grid's seq axis (``forward_seq_parallel``) or dense
    (None)."""
    import torch

    model = _port_model()
    module = model.build(device="cpu")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    before = _set_capacity(capacity)
    try:
        if grid is None:
            with torch.no_grad():
                return module.logits(
                    torch.from_numpy(_forward_tokens())).numpy()
        return model.forward_seq_parallel(module, _forward_tokens(),
                                          grid).numpy()
    finally:
        _set_capacity(before)


# ---------------------------------------------------------------- the jobs

def _job_home(home):
    """A KUBEML_TPU_HOME with the token-window dataset ``pplm`` (the
    reference's _lm_registry: ascending runs, T=16, RandomState(0))."""
    os.environ["KUBEML_TPU_HOME"] = home
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    rng = np.random.RandomState(0)

    def split(n):
        start = rng.randint(1, 63, size=(n, 1))
        x = ((start + np.arange(JOB_T)[None, :] - 1) % 63 + 1)
        return x.astype(np.int32), np.zeros(n, np.int32)

    reg = DatasetRegistry()
    reg.create("pplm", *split(JOB_N), *split(JOB_TEST))
    return reg


def _cli_task(job_id, flags, resume=True, epochs=2):
    """The TrainTask ``kubeml train`` would submit for these flags
    (``cli.main.train_request``)."""
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.cli.main import build_parser, train_request

    argv = ["train", "-f", "gpt-moe-mini", "-d", "pplm", "-e", str(epochs),
            "-b", "8", "-p", "2", "--static", "-K", str(JOB_K), "--lr",
            "0.003"]
    if resume:
        argv += ["--resume-from", "seedckpt"]
    req = train_request(build_parser().parse_args(argv + list(flags)))
    return TrainTask(job_id=job_id, parameters=req,
                     parallelism=req.options.default_parallelism)


def _port_job(task, n_lanes, dropout=0.0, model=None):
    """The port's job of ``task`` on the CPU (the current group's ranks,
    or one process): its history's numbers."""
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.history import HistoryStore
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    record = TrainJob(task, model or _port_model(dropout),
                      KubeDataset("pplm"), "cpu", n_lanes=n_lanes,
                      history_store=HistoryStore(),
                      callbacks=JobCallbacks()).train()
    return {k: [float(v) for v in getattr(record.data, k)]
            for k in ("train_loss", "validation_loss", "accuracy",
                      "parallelism")}


def _cli_job(name, one_process=False):
    """CLI_JOBS[name] over the current group's ranks (or, with
    ``one_process``, without its parallel flags), dropout 0.1, at its
    capacity factor."""
    _, flags, capacity = CLI_JOBS[name]
    before = _set_capacity(capacity)
    try:
        return _port_job(_cli_task(name, [] if one_process else flags,
                                   False), 1, dropout=0.1)
    finally:
        _set_capacity(before)


# ------------------------------------------------------------- the ranks

def pair_worker(outdir):
    """Two ranks: the FFN and the lane ring, then the (data 1 x expert 2)
    rounds (dropout 0.1, and the identity-psum mutant), then the
    ``--expert-parallel 2`` job."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.collectives import lane_ring_psum
    from kubeml_tpu_torch.parallel.ep import route_tokens
    from kubeml_tpu_torch.parallel.manual import ep_partial_ffn

    rank = dl.rank()
    init = dict(np.load(os.path.join(outdir, "init.npz")))
    out = {}
    dl.make_grid(1, 2)
    params, x, mask = _ffn_inputs()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    xt = torch.from_numpy(x)
    dispatch, combine, _ = route_tokens(p["router"], xt,
                                        token_mask=torch.from_numpy(mask))
    out["ffn"] = ep_partial_ffn(p["wi"], p["bi"], p["wo"], p["bo"], dispatch,
                                combine, xt, "expert",
                                dtype=torch.float32).numpy()
    for wire, (seed, n) in RING_CASES.items():
        lanes = torch.from_numpy(_ring_lanes(seed, n)[2 * rank:2 * rank + 2])
        out[f"ring/{wire}"] = lane_ring_psum(
            lanes, None, torch.bfloat16 if wire == "bf16"
            else torch.float32).numpy()
    for name, mutant in (("ep-drop", None), ("ep-drop-identity-psum",
                                             "identity-psum")):
        state, loss, ev = _port_round(init, 1, 2, 0.1, mutant)
        out.update({f"{name}/w/{k}": v for k, v in state.items()})
        out[f"{name}/loss"], out[f"{name}/eval"] = loss, ev
    _job_home(os.path.join(outdir, f"pair_home_p{rank}"))
    job = _cli_job("cli-ep")
    with open(os.path.join(outdir, f"cli-ep_p{rank}.json"), "w") as f:
        json.dump(job, f)
    np.savez(os.path.join(outdir, f"pair_p{rank}.npz"), **out)


def quad_worker(outdir):
    """Four ranks: the (seq 2 x expert 2) and (data 2 x seq 2) rounds and
    the seq-sum mutant, the forwards over four seq ranks, the (data 2 x
    expert 2) jobs against the reference's, and the ``--seq-parallel 2
    --expert-parallel 2`` job."""
    from kubeml_tpu_torch.parallel import distributed as dl

    rank = dl.rank()
    init = dict(np.load(os.path.join(outdir, "init.npz")))
    out = {}
    for name, (n_seq, n_expert, mutant) in (
            ("sp-ep", (2, 2, None)), ("sp", (2, 1, None)),
            ("sp-ep-seq-sum", (2, 2, "seq-sum"))):
        state, loss, ev = _port_round(init, n_seq, n_expert, 0.0, mutant)
        out.update({f"{name}/w/{k}": v for k, v in state.items()})
        out[f"{name}/loss"], out[f"{name}/eval"] = loss, ev
    grid = dl.make_grid(4)
    out["fwd/cap4"] = _port_forward(init, 4.0, grid)
    out["fwd/default"] = _port_forward(init, 1.25, grid)
    home = os.path.join(outdir, f"quad_home_p{rank}")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    os.environ["KUBEML_TPU_HOME"] = home
    jobs = {name: _port_job(_cli_task(name, ["--expert-parallel", "2"]
                                      + flags, epochs=1), 2)
            for name, flags in DPEP_JOBS.items()}
    jobs["cli-sp-ep"] = _cli_job("cli-sp-ep")
    with open(os.path.join(outdir, f"jobs_p{rank}.json"), "w") as f:
        json.dump(jobs, f)
    np.savez(os.path.join(outdir, f"quad_p{rank}.npz"), **out)


WORKERS = {"pair": pair_worker, "quad": quad_worker}


# -------------------------------------------------------------- fixtures

def _ref_model():
    """The reference's TinyMoE in f32 (dropout 0)."""
    import jax.numpy as jnp

    from test_models_gpt import TinyMoE

    class TinyMoE32(TinyMoE):
        def build(self):
            return super().build().clone(dtype=jnp.float32)

    return TinyMoE32()


def _start():
    """TinyMoE's weights from seed 0 in the flax layouts (numpy, the
    reference's initializers' scales): (flax params, the port's state
    dict of them as numpy)."""
    from kubeml_tpu_torch.convert import random_flax_params

    flax = random_flax_params(**TINY, n_experts=E, seed=0)
    state = _port_model().params_from_flax(flax)
    return flax, {k: v.numpy() for k, v in state.items()}


def _reference_round(flax, n_expert):
    """The JAX package's (data 2 x seq 2 [x expert 2]) round: (flax
    params, loss sums, eval [loss, accuracy, n])."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.parallel.kavg import KAvgEngine
    from kubeml_tpu.parallel.mesh import make_mesh

    model = _ref_model()
    model.enable_seq_parallel("ring")
    if n_expert > 1:
        model.enable_expert_parallel()
    mesh = make_mesh(n_data=2, n_seq=2, n_expert=n_expert,
                     devices=jax.devices()[:4 * n_expert])
    eng = KAvgEngine(mesh, model.loss, model.metrics,
                     lambda lr, e: optax.sgd(lr), donate=False,
                     batch_seq_dims=model.seq_batch_dims)
    batch, rngs = _round_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, stats = eng.train_round({"params": flax}, jb, rngs=rngs, lr=LR,
                                 epoch=0, **MASKS)
    ev = eng.eval_round(out, jb, MASKS["sample_mask"])
    return (jax.tree_util.tree_map(np.asarray, out["params"]),
            np.asarray(stats.loss_sum),
            np.array([ev["loss"], ev["accuracy"], ev["n"]]))


def _reference_forward(flax):
    """The reference's seq-parallel forward of _forward_tokens() over
    (data 2 x seq 4) at the default capacity."""
    import jax

    from kubeml_tpu.parallel.mesh import make_mesh

    return np.asarray(_ref_model().forward_seq_parallel(
        {"params": flax}, _forward_tokens(), make_mesh(n_data=2, n_seq=4)))


def _reference_ring(wire):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.collectives import ring_psum
    from kubeml_tpu.parallel.mesh import DATA_AXIS, make_mesh

    seed, n = RING_CASES[wire]
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    dt = jnp.bfloat16 if wire == "bf16" else jnp.float32
    out = jax.jit(compat.shard_map(
        lambda v: ring_psum(v, DATA_AXIS, dt), mesh=mesh,
        in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS),
        check_vma=False))(jnp.asarray(_ring_lanes(seed, n)))
    return np.asarray(out, np.float32)


def _reference_job(name, flags):
    """The JAX package's n_expert=2 job (its GSPMD route) on a (data 2 x
    expert 2) CPU mesh, the same request: its history's numbers."""
    import jax

    from kubeml_tpu.api.types import TrainOptions, TrainRequest, TrainTask
    from kubeml_tpu.models.base import KubeDataset
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train.history import HistoryStore
    from kubeml_tpu.train.job import TrainJob

    class Windows(KubeDataset):
        dataset = "pplm"

        def transform_train(self, data, labels):
            return {"x": data}

        transform_test = transform_train

    opts = TrainOptions(default_parallelism=2, static_parallelism=True,
                        k=JOB_K, n_expert=2, train_stats=False,
                        merge_dtype="bf16" if flags else "")
    task = TrainTask(job_id=f"ref-{name}", parallelism=2,
                     parameters=TrainRequest(
                         model_type="gpt-moe-mini", batch_size=8, epochs=1,
                         dataset="pplm", lr=0.003, resume_from="seedckpt",
                         function_name="gpt-moe-mini", options=opts))
    record = TrainJob(task, _ref_model(), Windows(),
                      make_mesh(n_data=2, n_expert=2,
                                devices=jax.devices()[:4]),
                      history_store=HistoryStore()).train()
    return {k: [float(v) for v in getattr(record.data, k)]
            for k in ("train_loss", "validation_loss", "accuracy",
                      "parallelism")}


def _launch_reference_job(name, outdir):
    """The reference's job DPEP_JOBS[name] in a process of its own (four
    virtual CPU devices, a copy of the job home), started without
    waiting: its compile runs beside the ranks and the rounds here. It
    writes ref-<name>.json."""
    from kubeml_tpu.testing import virtual_cpu_env

    home = os.path.join(outdir, f"ref-{name}-home")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "refjob", outdir, name],
        cwd=REPO, env=dict(os.environ, KUBEML_TPU_HOME=home,
                           **virtual_cpu_env(4)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _launch(mode, world, outdir):
    return subprocess.Popen(
        [sys.executable, "-m", "tools.launch_distributed", "--processes",
         str(world), "--emulate-cpu", "1", "--", sys.executable,
         os.path.abspath(__file__), mode, outdir],
        cwd=REPO, env=dict(os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches started together; meanwhile the reference's runs and
    the port's one-process runs here. Returns {"pair": [2 rank dicts],
    "quad": [4], "jobs": {name: [rank histories]}, "ref": {...},
    "single": {...}, "init": port state}."""
    import torch

    from kubeml_tpu.train.checkpoint import save_checkpoint

    outdir = str(tmp_path_factory.mktemp("eppar"))
    flax, init = _start()
    np.savez(os.path.join(outdir, "init.npz"), **init)
    home = os.path.join(outdir, "jobhome")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEML_TPU_HOME", home)
        _job_home(home)
        save_checkpoint("seedckpt", {"params": flax},
                        {"model": "gpt-moe-mini",
                         "function": "gpt-moe-mini"})
        procs = {"pair": _launch("pair", 2, outdir),
                 "quad": _launch("quad", 4, outdir),
                 **{f"ref-{name}": _launch_reference_job(name, outdir)
                    for name in DPEP_JOBS}}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        ref, single = {}, {}
        try:
            ref["sp-ep"] = _reference_round(flax, 2)
            ref["sp"] = _reference_round(flax, 1)
            ref["fwd/default"] = _reference_forward(flax)
            for wire in RING_CASES:
                ref[f"ring/{wire}"] = _reference_ring(wire)
            single["ep-drop"] = _port_round(init, 1, 1, 0.1)
            single["fwd/cap4"] = _port_forward(init, 4.0)
            for name in CLI_JOBS:
                mp.setenv("KUBEML_TPU_HOME", os.path.join(outdir, name))
                _job_home(os.path.join(outdir, name))
                single[name] = _cli_job(name, one_process=True)
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
        assert p.returncode == 0, f"{mode} failed:\n" \
            f"{texts[mode][-8000:]}"
    load = lambda name: dict(np.load(os.path.join(outdir, name)))  # noqa
    jobs = {}
    for r in range(4):
        with open(os.path.join(outdir, f"jobs_p{r}.json")) as f:
            for name, hist in json.load(f).items():
                jobs.setdefault(name, []).append(hist)
    for r in range(2):
        with open(os.path.join(outdir, f"cli-ep_p{r}.json")) as f:
            jobs.setdefault("cli-ep", []).append(json.load(f))
    for name in DPEP_JOBS:
        with open(os.path.join(outdir, f"ref-{name}.json")) as f:
            ref[name] = json.load(f)
    return {"pair": [load(f"pair_p{r}.npz") for r in range(2)],
            "quad": [load(f"quad_p{r}.npz") for r in range(4)],
            "jobs": jobs, "ref": ref, "single": single, "init": init}


def _weights(rank_out, name):
    pre = f"{name}/w/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


def _within(have, want, rtol=TOL, atol=TOL):
    """Every leaf of two port state dicts within (rtol, atol)."""
    return set(have) == set(want) and all(
        np.allclose(have[k], want[k], rtol=rtol, atol=atol) for k in want)


def _to_flax(state):
    import torch

    return _port_model().params_to_flax(
        {k: torch.from_numpy(v) for k, v in state.items()})


def _assert_flax_close(have, want, rtol=TOL, atol=TOL):
    import jax

    flat_have = jax.tree_util.tree_leaves_with_path(have)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_have) == len(flat_want)
    for path, a in flat_have:
        np.testing.assert_allclose(np.asarray(a), flat_want[path],
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------------- tests

def test_ep_partial_ffn_matches_moe_apply_and_the_reference(runs):
    """ep_partial_ffn over two expert ranks (each running two of the four
    experts) equals the port's moe_apply on the same inputs, and that the
    reference's moe_apply, within f32 1e-5; the ranks bit for bit."""
    import jax.numpy as jnp
    import torch

    from kubeml_tpu.parallel.ep import moe_apply as ref_moe_apply
    from kubeml_tpu_torch.parallel.ep import moe_apply

    params, x, mask = _ffn_inputs()
    y, _ = moe_apply({k: torch.from_numpy(v) for k, v in params.items()},
                     torch.from_numpy(x), token_mask=torch.from_numpy(mask))
    want, _ = ref_moe_apply({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), token_mask=jnp.asarray(mask))
    ranks = runs["pair"]
    np.testing.assert_array_equal(ranks[1]["ffn"], ranks[0]["ffn"])
    np.testing.assert_allclose(ranks[0]["ffn"], y.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert np.abs(y.numpy()).max() > 0.1


@pytest.mark.parametrize("wire", sorted(RING_CASES))
def test_lane_ring_matches_the_references_ring(runs, wire):
    """The lane ring over two ranks of two lanes each (the merge's
    use_ring) equals the reference's ring_psum over four lanes bit for
    bit, on every lane."""
    want = runs["ref"][f"ring/{wire}"]
    for r in range(2):
        for lane in range(4):
            np.testing.assert_array_equal(runs["pair"][r][f"ring/{wire}"],
                                          want[lane])


def test_expert_round_with_dropout_matches_one_process(runs):
    """(data 1 x expert 2), dropout 0.1: both ranks bit-equal (the same
    masks drawn on each), and the one-process round within f32 1e-5."""
    ranks = runs["pair"]
    for k, v in ranks[0].items():
        if k.startswith("ep-drop/"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    state, loss, ev = runs["single"]["ep-drop"]
    have = _weights(ranks[0], "ep-drop")
    assert _within(have, state)
    assert any(not np.array_equal(state[k], runs["init"][k]) for k in state)
    np.testing.assert_allclose(ranks[0]["ep-drop/loss"], loss, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ranks[0]["ep-drop/eval"], ev, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["sp-ep", "sp"])
def test_inner_ranks_hold_bit_equal_states(runs, name):
    """Every one of the four ranks (one inner group of seq 2 x expert 2,
    or two lane groups of two seq ranks) holds the same merged state,
    loss sums and eval metrics, bit for bit."""
    ranks = runs["quad"]
    for r in range(1, 4):
        for k, v in ranks[0].items():
            if k.startswith(name + "/"):
                np.testing.assert_array_equal(ranks[r][k], v,
                                              err_msg=f"rank {r} {k}")


def test_seq_expert_round_matches_seq_round(runs):
    """(seq 2 x expert 2) equals (data 2 x seq 2) with replicated experts
    within f32 1e-5 (the reference's bound is rtol 5e-3, atol 5e-4)."""
    q = runs["quad"][0]
    assert _within(_weights(q, "sp-ep"), _weights(q, "sp"))
    np.testing.assert_allclose(q["sp-ep/loss"], q["sp/loss"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(q["sp-ep/eval"], q["sp/eval"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["sp-ep", "sp"])
def test_inner_round_matches_the_references(runs, name):
    """Each port round against the reference's round on its CPU mesh
    ((data 2, seq 2, expert 2) and (data 2, seq 2)) within f32 1e-5."""
    q = runs["quad"][0]
    want, loss, ev = runs["ref"][name]
    _assert_flax_close(_to_flax(_weights(q, name)), want)
    np.testing.assert_allclose(q[f"{name}/loss"], loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(q[f"{name}/eval"], ev, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mutant,ranks,name,want", [
    ("identity-psum", "pair", "ep-drop-identity-psum", "ep-drop"),
    ("seq-sum", "quad", "sp-ep-seq-sum", "sp")])
def test_gradient_mutants_fail_the_checks(runs, mutant, ranks, name, want):
    """The checks above catch a broken gradient sum: an expert psum whose
    backward is the identity, and an inner round summing over the seq
    group only, each miss the state they are held to by more than ten
    times the tolerance."""
    got = _weights(runs[ranks][0], name)
    ref = (runs["single"]["ep-drop"][0] if want == "ep-drop"
           else _weights(runs["quad"][0], want))
    assert not _within(got, ref)
    assert max(float(np.abs(got[k] - ref[k]).max()) for k in ref) > 10 * TOL


def test_seq_forward_equals_dense_without_overflow(runs):
    """At capacity factor 4.0 (= E, no expert overflows) the forward over
    four seq ranks, each routing its own block, equals the dense forward
    within f32 1e-5."""
    for r in range(4):
        np.testing.assert_allclose(runs["quad"][r]["fwd/cap4"],
                                   runs["single"]["fwd/cap4"], rtol=TOL,
                                   atol=TOL)


def test_seq_forward_matches_the_references_per_shard_routing(runs):
    """At the default capacity (drops possible) the forward over four seq
    ranks equals the reference's seq-parallel forward within f32 1e-5:
    the same per-shard routing."""
    want = runs["ref"]["fwd/default"]
    for r in range(4):
        got = runs["quad"][r]["fwd/default"]
        assert got.shape == (2, 32, TINY["vocab_size"])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(DPEP_JOBS))
def test_data_expert_job_matches_the_references(runs, name):
    """(data 2 x expert 2) from the JAX-written checkpoint: the four
    ranks' histories equal, and the reference's n_expert=2 job's within
    its 2e-3; with --merge-dtype bf16 both merges take their rings."""
    hists = runs["jobs"][name]
    assert len(hists) == 4 and all(h == hists[0] for h in hists)
    want = runs["ref"][name]
    assert hists[0]["parallelism"] == want["parallelism"] == [2]
    for key in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(hists[0][key], want[key], rtol=JOB_TOL,
                                   atol=JOB_TOL, err_msg=key)
    assert hists[0]["validation_loss"][0] < hists[0]["train_loss"][0]


@pytest.mark.parametrize("name", sorted(CLI_JOBS))
def test_cli_expert_jobs_train_over_ranks(runs, name):
    """`kubeml train -f gpt-moe-mini --expert-parallel 2` (two ranks) and
    `--seq-parallel 2 --expert-parallel 2` (four; at capacity factor 4.0,
    where each seq rank's routing of its block is the one process's):
    every rank's history equal, and the one-process job's within 1e-3
    relative (dropout 0.1; two epochs of AdamW amplify the last bits of
    another summation order)."""
    hists = runs["jobs"][name]
    assert len(hists) == {"pair": 2, "quad": 4}[CLI_JOBS[name][0]]
    assert all(h == hists[0] for h in hists)
    want = runs["single"][name]
    assert hists[0]["parallelism"] == want["parallelism"]
    for key in ("train_loss", "validation_loss"):
        assert np.isfinite(hists[0][key]).all()
        np.testing.assert_allclose(hists[0][key], want[key], rtol=1e-3,
                                   atol=0, err_msg=key)


# the job's 400s, in the reference's order (kubeml_tpu/train/job.py)
REFUSALS = {
    "syncdp": (dict(engine="syncdp", n_expert=2), 2, "moe",
               "tensor/sequence/pipeline/expert parallelism requires the "
               "kavg engine"),
    "world": (dict(n_expert=2), 1, "moe",
              "1 devices not divisible by the requested model x seq x "
              "stage x expert factor 2"),
    "world-seq": (dict(n_seq=2, n_expert=2), 2, "moe",
                  "2 devices not divisible by the requested model x seq x "
                  "stage x expert factor 4"),
    "seq-first": (dict(n_seq=2, n_expert=2), 4, "mlp",
                  "function 'mlp' does not support sequence parallelism"),
    "alone-no-experts": (dict(n_expert=2), 2, "mlp",
                         "function 'mlp' has no experts to shard (expert "
                         "parallelism applies to MoE families like "
                         "gpt-moe-mini)"),
    "seq-no-experts": (dict(n_seq=2, n_expert=2), 4, "gpt",
                       "function 'gpt-mini' has no experts to shard "
                       "(expert parallelism applies to MoE families like "
                       "gpt-moe-mini)"),
    "divide": (dict(n_expert=2), 2, "moe3",
               "3 experts do not divide over a 2-way expert axis"),
    "length": (dict(n_seq=2, n_expert=2), 4, "odd",
               "train-split sequence length 15 of batch key 'x' is not "
               "divisible by --seq-parallel 2"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_expert_job_refusals_in_reference_order(tmp_path, monkeypatch, case):
    """Each misconfiguration fails the job with the reference's 400 and
    wording (test_job.py's twins, and its divide check), before any data
    is trained; the world is one device without a group, and a stated
    size where a case needs the later checks."""
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel import distributed as dl
    from test_torch_seq_parallel import (_job, _job_task, _port_model as
                                         seq_model, _token_home)

    opts, world, kind, message = REFUSALS[case]
    reg = _token_home(str(tmp_path))
    monkeypatch.setattr(dl, "world_size", lambda: world)
    model = {"mlp": lambda: get_model("mlp")(hidden=8, num_classes=2),
             "gpt": lambda: seq_model("gpt", "f32", 0.0),
             "moe3": lambda: _port_model(n_experts=3)}.get(
        kind, _port_model)()
    task = _job_task("refused", **opts)
    if kind == "odd":
        from kubeml_tpu_torch.data.registry import DatasetRegistry

        x = np.ones((32, 15), np.int32)
        DatasetRegistry().create("toks15", x, x[:, 0], x[:8], x[:8, 0])
        task.parameters.dataset = "toks15"
    with pytest.raises(KubeMLException) as e:
        _job(task, reg, model).train()
    assert e.value.status_code == 400
    assert e.value.message == message
    assert "ROADMAP" not in e.value.message


def test_grid_layout_and_groups_in_one_process():
    """Without a group every axis has size 1 and the grid of one process
    is one data index; an unknown axis is refused by name."""
    from kubeml_tpu_torch.parallel import distributed as dl

    grid = dl.make_grid(1, 1)
    assert (grid.n_data, grid.n_seq, grid.n_expert, grid.n_inner) == (
        1, 1, 1, 1)
    assert (dl.axis_size("seq"), dl.axis_size("expert")) == (1, 1)
    assert (dl.axis_size("stage"), dl.axis_index("stage")) == (1, 0)
    with pytest.raises(ValueError,
                       match="'model', 'seq', 'stage' and 'expert'"):
        dl.axis_size("pipe")
    with pytest.raises(ValueError, match="inner groups of 2 seq x 2"):
        dl.make_grid(2, 2)


if __name__ == "__main__":
    import faulthandler

    faulthandler.dump_traceback_later(240, repeat=True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from kubeml_tpu_torch.parallel import distributed as dist_lib

    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    if mode == "refjob":
        name = sys.argv[3]
        hist = _reference_job(name, DPEP_JOBS[name])
        with open(os.path.join(outdir, f"ref-{name}.json"), "w") as f:
            json.dump(hist, f)
    else:
        dist_lib.initialize(device="cpu", timeout=240)
        WORKERS[mode](outdir)
        print(f"{mode} rank {dist_lib.rank()} OK", flush=True)
