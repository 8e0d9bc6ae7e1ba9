"""Port parity: pipeline parallelism over ``torch.distributed`` ranks (the
rank grid's stage axis, ``kubeml_tpu_torch/parallel/distributed.py``; the
GPipe body of ``parallel/pp.py``; the token-sharded expert FFN
``parallel/manual.ep_alltoall_ffn``; the GPT, BERT and MoE models'
pipelined losses and ``forward_pipelined``; the K-avg engine's stage
axis; the job's ``n_stage`` path) against the JAX package and against
the port in one process.

The ranks are processes of ``tools/launch_distributed`` (``--emulate-cpu
1``) joined over gloo, each running this file's ``__main__`` block: two
ranks (``pair``: data 1 x stage 2) and four (``quad``: stage 4, stage 2 x
expert 2, expert 4). Both launches and three processes of the JAX
package's pipelined jobs (their compiles take most of the file's time)
start together in the module fixture; the JAX package's pipelines,
losses, gradients and forwards (on its virtual CPU mesh) and the port's
one-process runs happen in the test process meanwhile, torch on one
thread. The models are the reference tests' TinyGPT (vocab 64, hidden
32, 2 layers, 2 heads, FFN 64), TinyMoE (4 experts of a 32-wide FFN) and
TinyBert (vocab 1000, max_len 16), in f32, their weights made from numpy
seeds in the flax layouts (``convert.random_flax_params``) and carried
across by ``convert.py``; the inputs come from numpy seeds.

What is held, and how tightly:
  - ``pipeline_apply`` over four stage ranks equals the port's
    ``sequential_apply`` and the reference's ``pipeline_apply`` (tanh
    stages, with and without aux), and its gradients the reference's,
    within f32 1e-6 (the aux and its gradient within the reference's own
    1e-5 relative: the sum's order differs); every rank bit for bit;
  - the pipelined losses of GPT, BERT and MoE (data 1 x stage 2; the MoE
    also at stage 2 x expert 2) at dropout 0 equal the reference's
    ``_pp_forward_loss`` within f32 1e-5, and their inner-summed
    gradients within 1e-5;
  - ``forward_pipelined`` of the GPT and the MoE equals the reference's
    within f32 1e-5; under ``ep_impl="alltoall"`` at stage 2 x expert 2
    (capacity 4.0: no expert overflows) it equals "replicated" within
    1e-5; its guards raise the reference's messages;
  - ``ep_alltoall_ffn`` over a 4-way expert axis equals the per-shard
    dense expert math and the reference's ``ep_alltoall_ffn`` within
    1e-6;
  - one K-avg round (W=2, S=2, B=8, T=16, SGD) at (data 1 x stage 2)
    with dropout 0.1 leaves both stage ranks bit for bit and equals the
    one-process round (the sequential schedule, the same draws) within
    f32 1e-6, for the GPT and BERT;
  - the two mutants fail those checks: a stage psum whose backward is
    the identity (the last stage gets 1/P of the cotangent), and a
    schedule that computes the fill and drain ticks and counts their
    aux;
  - the port's pipelined jobs (the reference tests' GPT and BERT at data
    4 x stage 2, the MoE at data 2 x stage 2 x expert 2), warm-started
    from a JAX-written checkpoint, equal the reference's pipelined jobs
    within 2e-3, every rank's history equal;
  - the job's 400s in the reference's order, and the refusal of every
    family without a pipelineable trunk.
"""

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
GPT = dict(vocab_size=64, max_len=32, hidden=32, layers=2, heads=2, ffn=64)
MOE = dict(GPT, ffn=32)
E = 4
BERT = dict(vocab_size=1000, max_len=16, hidden=32, layers=2, heads=2,
            ffn=64)
M = 4                               # microbatches, 2 x stages
TOL = 1e-5                          # f32 losses, gradients, forwards
EXACT = 1e-6                        # the pipeline against its sequence
JOB_TOL = 2e-3                      # the reference's PP-vs-dense bound
W, S, B, T, LR = 2, 2, 8, 16, 1e-2
# the reference tests' pipelined jobs (tests/test_job.py): name -> (kind,
# launch, n_lanes, flags), each one epoch at parallelism 2, K=1, batch 8
JOBS = {"pp-gpt": ("gpt", "pair", 4, dict(n_stage=2)),
        "pp-bert": ("bert", "pair", 4, dict(n_stage=2)),
        "pp-ep-moe": ("moe", "quad", 2, dict(n_stage=2, n_expert=2))}
JOB_LR = {"gpt": 3e-3, "moe": 3e-3, "bert": 1e-3}


# ------------------------------------------------------------- the inputs

def _flax(kind, seed=0):
    """The model's f32 weights in the flax layouts (numpy)."""
    from kubeml_tpu_torch.convert import random_flax_params

    if kind == "gpt":
        return random_flax_params(**GPT, seed=seed)
    if kind == "moe":
        return random_flax_params(**MOE, seed=seed, n_experts=E)
    tree = random_flax_params(**BERT, seed=seed)
    rng = np.random.RandomState(seed + 1)
    tree["classifier"] = {
        "kernel": (rng.randn(BERT["hidden"], 2)
                   / np.sqrt(BERT["hidden"])).astype(np.float32),
        "bias": (rng.randn(2) * 0.1).astype(np.float32)}
    return tree


def _batch(kind):
    """A loss's batch (RandomState(1)): [8, 16] ids, a row padded from
    position 10, and BERT's labels."""
    rng = np.random.RandomState(1)
    vocab = BERT["vocab_size"] if kind == "bert" else 64
    x = rng.randint(1, vocab, size=(B, T)).astype(np.int32)
    x[0, 10:] = 0
    return {"x": x, "y": rng.randint(0, 2, size=B).astype(np.int32)}


def _round_batch(kind):
    """A round's batch and step keys (RandomState(0)): ascending token
    runs for the LMs, random ids and labels for BERT, [W, S, B, T]."""
    rng = np.random.RandomState(0)
    if kind == "bert":
        batch = {"x": rng.randint(1, 1000, size=(W, S, B, T)).astype(
                     np.int32),
                 "y": rng.randint(0, 2, size=(W, S, B)).astype(np.int32)}
    else:
        start = rng.randint(1, 63, size=(W * S * B, 1))
        x = ((start + np.arange(T)[None, :] - 1) % 63 + 1).astype(np.int32)
        batch = {"x": x.reshape(W, S, B, T)}
    rngs = rng.randint(0, 2 ** 31, size=(W, S, 2)).astype(np.uint32)
    return batch, rngs


MASKS = dict(sample_mask=np.ones((W, S, B), np.float32),
             step_mask=np.ones((W, S), np.float32),
             worker_mask=np.ones(W, np.float32))


def _stages(n_stage=4, f=8, seed=0):
    """The primitives' inputs (RandomState(seed)): [P, f, f] weights and
    [P, f] biases, x [6, 3, f] (M = 6 microbatches), a target."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(n_stage, f, f) / np.sqrt(f)).astype(np.float32)
    b = (0.01 * np.arange(n_stage)[:, None] * np.ones(f)).astype(np.float32)
    x = rng.randn(6, 3, f).astype(np.float32)
    return w, b, x, rng.randn(6, 3, f).astype(np.float32)


def _ffn_inputs():
    """The reference test's ep_alltoall_ffn operands (RandomState(5)): 4
    shards of 16 tokens, d 8, f 16, 8 experts, four pads in shard 0."""
    rng = np.random.RandomState(5)
    n, tl, d, f, e = 4, 16, 8, 16, 8
    x = rng.randn(n * tl, d).astype(np.float32)
    mask = np.ones(n * tl, np.float32)
    mask[10:14] = 0.0
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    params = {"router": f32(rng.randn(d, e) * 0.3),
              "wi": f32(rng.randn(e, d, f) * 0.2),
              "bi": f32(rng.randn(e, f) * 0.1),
              "wo": f32(rng.randn(e, f, d) * 0.2),
              "bo": f32(rng.randn(e, d) * 0.1)}
    return x, mask, params


def _flat(tree, prefix=""):
    """{'/'-joined path: numpy leaf} of a nested dict (a flax tree)."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(node)
    return out


# ------------------------------------------------------------ the port

def _port_model(kind, dropout=0.0, layers=None, n_experts=E):
    """A port model whose modules build at the test's widths in f32 and
    carry the model's expert axis."""
    import torch

    from kubeml_tpu_torch.convert import params_to_flax
    from kubeml_tpu_torch.models.bert import BertModule, BertTiny
    from kubeml_tpu_torch.models.gpt import GPTMini, GPTModule, GPTMoEMini

    if kind == "bert":
        class Bert(BertTiny):
            def build(self, dtype=None, device=None):
                return BertModule(**BERT, num_classes=2, dropout=dropout,
                                  dtype=torch.float32, device=device)
        return Bert(torch.float32)
    widths = dict(GPT if kind == "gpt" else MOE)
    if layers:
        widths["layers"] = layers

    class Tiny(GPTMini if kind == "gpt" else GPTMoEMini):
        def build(self, dtype=None, device=None):
            moe = dict(n_experts=n_experts, ep_axis=self.ep_axis,
                       ep_impl=self.ep_impl) if kind == "moe" else {}
            return GPTModule(**widths, dropout=dropout, dtype=torch.float32,
                             device=device, **moe)

        def params_to_flax(self, state):
            return params_to_flax(state, heads=GPT["heads"])
    return Tiny(torch.float32)


def _module(model, kind):
    module = model.build(device="cpu")
    module.load_state_dict(model.params_from_flax(_flax(kind)))
    return module


def _inner_sum(grads):
    """The gradients summed over the current grid's inner group."""
    from kubeml_tpu_torch.parallel import distributed as dl

    grid = dl.current_grid()
    if grid.n_inner == 1:
        return grads
    return {k: dl.all_reduce(v, group=grid.inner_group)
            for k, v in grads.items()}


def _pp_loss(kind, n_expert=1):
    """The pipelined per-example loss of _batch(kind) at dropout 0 over
    the current grid, and the flax gradients of its batch mean (each rank
    backpropagating 1 / n_inner of it, summed over the inner group)."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl

    model = _port_model(kind)
    if n_expert > 1:
        model.enable_expert_parallel()
    model.enable_pipeline_parallel(dl.current_grid().n_stage or 1, M)
    module = _module(model, kind)
    batch = {k: torch.from_numpy(v) for k, v in _batch(kind).items()}
    per_ex = model.loss(module, batch, torch.Generator().manual_seed(0),
                        torch.ones(B))
    (per_ex.mean() / dl.current_grid().n_inner).backward()
    grads = _inner_sum({n: p.grad if p.grad is not None
                        else torch.zeros_like(p)
                        for n, p in module.named_parameters()})
    return per_ex.detach().numpy(), _flat(model.params_to_flax(grads))


def _forward(kind, impl="replicated", layers=None, n_experts=E,
             capacity=None):
    """forward_pipelined of _batch(kind)'s rows made pad-free, over the
    current grid: the logits (and the aux of an MoE)."""
    import torch

    from kubeml_tpu_torch.models import gpt

    model = _port_model(kind, layers=layers, n_experts=n_experts)
    model.ep_impl = impl
    module = model.build(device="cpu")
    if layers is None and n_experts == E:
        module.load_state_dict(model.params_from_flax(_flax(kind)))
    x = np.maximum(_batch(kind)["x"], 1)
    before = gpt.CAPACITY_FACTOR
    if capacity:
        gpt.CAPACITY_FACTOR = capacity
    try:
        out = model.forward_pipelined(module, x, microbatches=M)
    finally:
        gpt.CAPACITY_FACTOR = before
    if kind == "moe":
        return {"logits": out[0].numpy(), "aux": np.array(float(out[1]))}
    return {"logits": out.numpy()}


def _guard(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


def _sgd(lr, epoch):
    import torch

    return functools.partial(torch.optim.SGD, lr=lr)


def _port_round(kind, pipelined=True):
    """One K-avg round of ROUND's batch at dropout 0.1 over the current
    grid (pipelined: the model's pipelined loss at M microbatches; one
    process without a group runs it as the sequential schedule): (merged
    state, loss sums)."""
    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model = _port_model(kind, dropout=0.1)
    if pipelined:
        model.enable_pipeline_parallel(2, M)
    module = _module(model, kind)
    grid = dl.current_grid()
    engine = KAvgEngine(module, model.loss, model.metrics, _sgd, n_lanes=1,
                        n_stage=grid.n_stage, manual_inner=True)
    batch, rngs = _round_batch(kind)
    out, stats = engine.train_round(
        {n: p.detach().clone() for n, p in module.named_parameters()},
        batch, rngs=rngs, lr=LR, epoch=0, **MASKS)
    return {k: v.numpy() for k, v in out.items()}, stats.loss_sum


def _primitives():
    """pipeline_apply over the current grid's stages against
    sequential_apply, with and without aux, and their gradients."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.pp import (pipeline_apply,
                                              sequential_apply)

    n = dl.current_grid().n_stage
    w, b, x, tgt = (torch.from_numpy(a) for a in _stages(n))
    out = {}

    def dense(p, a):
        return torch.tanh(a @ p["w"] + p["b"])

    def with_aux(p, a):
        y = torch.tanh(a @ p["w"])
        return y, (y ** 2).sum()

    for name, run in (("pp", pipeline_apply), ("seq", sequential_apply)):
        p = {"w": w.clone().requires_grad_(), "b": b.clone()
             .requires_grad_()}
        share = n if name == "pp" else 1      # each rank backpropagates
        ys = run(dense, p, x)                 # 1 / n of the loss
        (((ys - tgt) ** 2).mean() / share).backward()
        gw, gb = (_inner_sum({"g": t.grad})["g"] if name == "pp"
                  else t.grad for t in (p["w"], p["b"]))
        out.update({f"{name}/ys": ys.detach().numpy(),
                    f"{name}/gw": gw.numpy(), f"{name}/gb": gb.numpy()})
        pa = {"w": w.clone().requires_grad_()}
        ys, aux = run(with_aux, pa, x, has_aux=True)
        (aux / share).backward()
        g = _inner_sum({"g": pa["w"].grad})["g"] if name == "pp" \
            else pa["w"].grad
        out.update({f"{name}/aux_ys": ys.detach().numpy(),
                    f"{name}/aux": aux.detach().numpy(),
                    f"{name}/aux_gw": g.numpy()})
    return out


def _alltoall_ffn():
    """ep_alltoall_ffn on this rank's shard of _ffn_inputs over the
    current grid's 4-way expert axis: its [16, 8] output."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.ep import route_tokens
    from kubeml_tpu_torch.parallel.manual import ep_alltoall_ffn

    x, mask, params = _ffn_inputs()
    i, tl = dl.axis_index("expert"), x.shape[0] // 4
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    x_l = torch.from_numpy(x[i * tl:(i + 1) * tl])
    disp, comb, _ = route_tokens(t["router"], x_l, k=2, capacity_factor=2.0,
                                 token_mask=torch.from_numpy(
                                     mask[i * tl:(i + 1) * tl]))
    return ep_alltoall_ffn(t["wi"], t["bi"], t["wo"], t["bo"], disp, comb,
                           x_l, "expert", dtype=torch.float32).numpy()


def _mutant_aux_loss():
    """The MoE's pipelined loss with the schedule counting the fill and
    drain ticks: every stage chews the clipped microbatch at every tick
    (the reference's schedule without its aux mask)."""
    from kubeml_tpu_torch.parallel import pp

    chews = pp._chews
    pp._chews = lambda t, sid, m: min(max(t - sid, 0), m - 1)
    try:
        import torch
        with torch.no_grad():
            model = _port_model("moe")
            model.enable_pipeline_parallel(2, M)
            module = _module(model, "moe")
            batch = {k: torch.from_numpy(v)
                     for k, v in _batch("moe").items()}
            return model.loss(module, batch, torch.Generator(),
                              torch.ones(B)).numpy()
    finally:
        pp._chews = chews


# ---------------------------------------------------------------- the jobs

def _job_home(home):
    """A KUBEML_TPU_HOME with the reference tests' datasets: ``pplm``
    (128 + 32 ascending runs, RandomState(0); tests/test_job.py
    _lm_registry) and ``toktask`` (256 + 64 ids, label = first token >
    500; make_token_task), T = 16, and each model's seed checkpoint
    (``seed-gpt``, ``seed-bert``, ``seed-moe``), written through the JAX
    package's save_checkpoint."""
    os.environ["KUBEML_TPU_HOME"] = home
    from kubeml_tpu.train.checkpoint import save_checkpoint
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    reg = DatasetRegistry()
    rng = np.random.RandomState(0)

    def lm(n):
        start = rng.randint(1, 63, size=(n, 1))
        x = (start + np.arange(T)[None, :] - 1) % 63 + 1
        return x.astype(np.int32), np.zeros(n, np.int32)

    reg.create("pplm", *lm(128), *lm(32))
    trng = np.random.RandomState(0)

    def tok(n):
        x = trng.randint(1, 1000, size=(n, T)).astype(np.int32)
        return x, (x[:, 0] > 500).astype(np.int32)

    reg.create("toktask", *tok(256), *tok(64))
    for kind, fn in (("gpt", "gpt-mini"), ("bert", "bert-tiny"),
                     ("moe", "gpt-moe-mini")):
        save_checkpoint(f"seed-{kind}", {"params": _flax(kind)},
                        {"model": fn, "function": fn})


def _task(job_id, kind, n_stage=1, n_expert=1, **opts):
    """The reference tests' job task (make_task(epochs=1, parallelism=2,
    k=1, batch=8)) from the seed checkpoint, in the port's types."""
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)

    fn = {"gpt": "gpt-mini", "bert": "bert-tiny", "moe": "gpt-moe-mini"}[
        kind]
    options = TrainOptions(default_parallelism=2, static_parallelism=True,
                           k=1, n_stage=n_stage, n_expert=n_expert, **opts)
    return TrainTask(job_id=job_id, parallelism=2, parameters=TrainRequest(
        model_type=fn, batch_size=8, epochs=1,
        dataset="toktask" if kind == "bert" else "pplm", lr=JOB_LR[kind],
        resume_from=f"seed-{kind}", function_name=fn, options=options))


def _datasets(kind):
    from kubeml_tpu_torch.models.base import KubeDataset

    if kind == "bert":
        return KubeDataset("toktask")

    class LM(KubeDataset):
        def transform_train(self, data, labels):
            return {"x": data}

        transform_test = transform_train
    return LM("pplm")


def _port_job(name):
    """JOBS[name] over the current group: its history's numbers."""
    from kubeml_tpu_torch.train.history import HistoryStore
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    kind, _, lanes, opts = JOBS[name]
    record = TrainJob(_task(name, kind, **opts), _port_model(kind),
                      _datasets(kind), "cpu", n_lanes=lanes,
                      history_store=HistoryStore(),
                      callbacks=JobCallbacks()).train()
    return {k: [float(v) for v in getattr(record.data, k)]
            for k in ("train_loss", "validation_loss", "accuracy",
                      "parallelism")}


# ------------------------------------------------------------- the ranks

def pair_worker(outdir):
    """Two ranks (data 1 x stage 2): the GPT, BERT and MoE losses and
    gradients, the forwards and a guard, the dropout rounds and the
    identity-psum mutant, the GPT and BERT jobs."""
    from kubeml_tpu_torch.parallel import distributed as dl

    rank = dl.rank()
    dl.make_grid(1, 1, 1, 2)
    out = {}
    for kind in ("gpt", "bert", "moe"):
        loss, grads = _pp_loss(kind)
        out[f"loss/{kind}"] = loss
        out.update({f"grad/{kind}/{k}": v for k, v in grads.items()})
    for kind in ("gpt", "moe"):
        out.update({f"fwd/{kind}/{k}": v for k, v in _forward(kind).items()})
    guards = {"layers": _guard(lambda: _forward("gpt", layers=3))}
    for kind in ("gpt", "bert"):
        state, loss = _port_round(kind)
        out.update({f"round/{kind}/w/{k}": v for k, v in state.items()})
        out[f"round/{kind}/loss"] = loss
    backward = dl._Psum.__dict__["backward"]
    dl._Psum.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        state, _ = _port_round("gpt")
    finally:
        dl._Psum.backward = backward
    out.update({f"round/identity-psum/w/{k}": v for k, v in state.items()})
    home = os.path.join(outdir, f"pair_home_p{rank}")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    os.environ["KUBEML_TPU_HOME"] = home
    jobs = {name: _port_job(name) for name, (_, launch, _, _) in JOBS.items()
            if launch == "pair"}
    with open(os.path.join(outdir, f"pair_p{rank}.json"), "w") as f:
        json.dump({"jobs": jobs, "guards": guards}, f)
    np.savez(os.path.join(outdir, f"pair_p{rank}.npz"), **out)


def quad_worker(outdir):
    """Four ranks: the primitives at stage 4; the MoE's loss and gradients
    at stage 2 x expert 2, its forward under both expert routes, the
    fill-and-drain mutant, the guards; ep_alltoall_ffn at expert 4; the
    PP x EP job."""
    from kubeml_tpu_torch.parallel import distributed as dl

    rank = dl.rank()
    dl.make_grid(1, 1, 1, 4)
    out = {f"prim/{k}": v for k, v in _primitives().items()}
    dl.make_grid(1, 4)
    out["a2a"] = _alltoall_ffn()
    dl.make_grid(1, 2, 1, 2)
    loss, grads = _pp_loss("moe", n_expert=2)
    out["loss/moe-ep"] = loss
    out.update({f"grad/moe-ep/{k}": v for k, v in grads.items()})
    out["mutant/aux"] = _mutant_aux_loss()
    for impl in ("replicated", "alltoall"):
        out.update({f"fwd/{impl}/{k}": v for k, v in _forward(
            "moe", impl, capacity=4.0).items()})
    guards = {"no-experts": _guard(lambda: _forward("gpt")),
              "experts": _guard(lambda: _forward("moe", n_experts=3))}
    home = os.path.join(outdir, f"quad_home_p{rank}")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    os.environ["KUBEML_TPU_HOME"] = home
    jobs = {name: _port_job(name) for name, (_, launch, _, _) in JOBS.items()
            if launch == "quad"}
    with open(os.path.join(outdir, f"quad_p{rank}.json"), "w") as f:
        json.dump({"jobs": jobs, "guards": guards}, f)
    np.savez(os.path.join(outdir, f"quad_p{rank}.npz"), **out)


WORKERS = {"pair": pair_worker, "quad": quad_worker}


# ------------------------------------------------------------ the reference

def _ref_model(kind, n_experts=E, capacity=None, impl=None, layers=None):
    """The reference tests' TinyGPT, TinyMoE or TinyBert in f32."""
    import jax.numpy as jnp

    from kubeml_tpu.models.bert import BertModule, BertTiny
    from test_models_gpt import TinyGPT, TinyMoE

    if kind == "bert":
        class TinyBert(BertTiny):
            def build(self):
                return BertModule(**BERT, dropout=0.0, num_classes=2,
                                  dtype=jnp.float32)
        return TinyBert()
    model = TinyGPT() if kind == "gpt" else TinyMoE()
    kw = dict(dtype=jnp.float32)
    if kind == "moe":
        kw["n_experts"] = n_experts
        if capacity:
            kw["capacity_factor"] = capacity
        if impl:
            kw["ep_impl"] = impl
    if layers:
        kw["layers"] = layers
    model._module = model.module.clone(**kw)
    return model


def _mesh(**axes):
    import jax

    from kubeml_tpu.parallel.mesh import make_mesh

    n = int(np.prod(list(axes.values())))
    return make_mesh(n_data=1, devices=jax.devices()[:n], **axes)


def _reference_primitives():
    """The reference's pipeline_apply over a 4-stage mesh on _stages(4),
    with and without aux, and its gradients."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.pp import pipeline_apply

    w, b, x, tgt = (jnp.asarray(a) for a in _stages(4))
    mesh = _mesh(n_stage=4)

    def dense(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    def with_aux(p, a):
        y = jnp.tanh(a @ p["w"])
        return y, (y ** 2).sum()

    ys = pipeline_apply(dense, {"w": w, "b": b}, x, mesh)
    g = jax.grad(lambda p: jnp.mean(
        (pipeline_apply(dense, p, x, mesh) - tgt) ** 2))({"w": w, "b": b})
    ys_aux, aux = pipeline_apply(with_aux, {"w": w}, x, mesh, has_aux=True)
    g_aux = jax.grad(lambda p: pipeline_apply(with_aux, p, x, mesh,
                                              has_aux=True)[1])({"w": w})
    return {k: np.asarray(v) for k, v in (
        ("ys", ys), ("gw", g["w"]), ("gb", g["b"]), ("aux_ys", ys_aux),
        ("aux", aux), ("aux_gw", g_aux["w"]))}


def _reference_loss(kind, n_expert=1):
    """The reference's _pp_forward_loss of _batch(kind) at dropout 0 in a
    fully-manual shard_map over (stage 2[ x expert 2]), and the gradients
    of its batch mean (check_vma assembles them)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat

    model = _ref_model(kind)
    if n_expert > 1:
        model.enable_expert_parallel()
    model.enable_pipeline_parallel(2, M)
    batch = {k: jnp.asarray(v) for k, v in _batch(kind).items()}
    key = jax.random.PRNGKey(3)

    def loss(v, b):
        if kind == "bert":
            return model._pp_forward_loss(v, b, key)[0]
        return model._pp_forward_loss(v, b["x"], key)[0]

    def both(v, b):
        return loss(v, b), jax.grad(lambda v: loss(v, b).mean())(v)

    per_ex, g = jax.jit(compat.shard_map(
        both, mesh=_mesh(n_stage=2, n_expert=n_expert),
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=True))(
        {"params": _flax(kind)}, batch)
    return np.asarray(per_ex), _flat(jax.tree_util.tree_map(
        np.asarray, g["params"]))


def _reference_forward(kind, impl=None, capacity=None):
    """The reference's forward_pipelined of _forward's rows on (stage 2[ x
    expert 2 for an MoE route])."""
    import jax.numpy as jnp

    model = _ref_model(kind, capacity=capacity, impl=impl)
    mesh = _mesh(n_stage=2, n_expert=2) if impl else _mesh(n_stage=2)
    x = jnp.asarray(np.maximum(_batch(kind)["x"], 1))
    out = model.forward_pipelined({"params": _flax(kind)}, x, mesh,
                                  microbatches=M)
    if kind == "moe":
        return {"logits": np.asarray(out[0]), "aux": np.asarray(out[1])}
    return {"logits": np.asarray(out)}


def _reference_guards():
    """The reference's forward_pipelined refusals over its mesh: layers
    that do not split, an expert axis without experts, experts that do
    not divide over it."""
    from kubeml_tpu_torch.convert import random_flax_params

    x = np.maximum(_batch("gpt")["x"], 1)
    ep = _mesh(n_stage=2, n_expert=2)
    v = {"params": _flax("gpt")}
    three = {"params": random_flax_params(**MOE, n_experts=3)}
    return {"layers": _guard(lambda: _ref_model("gpt", layers=3)
                             .forward_pipelined(v, x, _mesh(n_stage=2), M)),
            "no-experts": _guard(lambda: _ref_model("gpt").forward_pipelined(
                v, x, ep, M)),
            "experts": _guard(lambda: _ref_model("moe", n_experts=3)
                              .forward_pipelined(three, x, ep, M))}


def _reference_ffn():
    """The reference's ep_alltoall_ffn in a shard_map over a 4-way expert
    axis on _ffn_inputs, and the per-shard dense expert math."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.ep import route_tokens
    from kubeml_tpu.parallel.manual import ep_alltoall_ffn
    from kubeml_tpu.parallel.mesh import EXPERT_AXIS

    x, mask, p = (jax.tree_util.tree_map(jnp.asarray, a)
                  for a in _ffn_inputs())

    def body(x_l, m_l, router, wi, bi, wo, bo):
        disp, comb, _ = route_tokens(router, x_l, k=2, capacity_factor=2.0,
                                     token_mask=m_l)
        return ep_alltoall_ffn(wi, bi, wo, bo, disp, comb, x_l,
                               EXPERT_AXIS, dtype=jnp.float32)

    args = (p["router"], p["wi"], p["bi"], p["wo"], p["bo"])
    y = jax.jit(compat.shard_map(
        body, mesh=_mesh(n_expert=4),
        in_specs=(P(EXPERT_AXIS), P(EXPERT_AXIS)) + (P(),) * 5,
        out_specs=P(EXPERT_AXIS), check_vma=False))(x, mask, *args)
    dense = []
    for i in range(4):
        sl = slice(16 * i, 16 * (i + 1))
        disp, comb, _ = route_tokens(p["router"], x[sl], k=2,
                                     capacity_factor=2.0,
                                     token_mask=mask[sl])
        ein = jnp.einsum("tec,td->ecd", disp, x[sl])
        hh = jax.nn.gelu(jnp.einsum("ecd,edf->ecf", ein, p["wi"])
                         + p["bi"][:, None, :])
        out = jnp.einsum("ecf,efd->ecd", hh, p["wo"]) + p["bo"][:, None, :]
        dense.append(jnp.einsum("tec,ecd->td", comb, out))
    return np.asarray(y), np.asarray(jnp.concatenate(dense))


def _reference_job(name):
    """The JAX package's pipelined job of JOBS[name] on its CPU mesh (data
    x stage[ x expert], 8 devices as the reference tests carve them),
    warm-started from the seed checkpoint: its history's numbers."""
    import jax

    from kubeml_tpu.api.types import TrainOptions, TrainRequest, TrainTask
    from kubeml_tpu.models.base import KubeDataset
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train.history import HistoryStore
    from kubeml_tpu.train.job import TrainJob

    kind, _, lanes, opts = JOBS[name]

    class Data(KubeDataset):
        dataset = "toktask" if kind == "bert" else "pplm"

        if kind != "bert":
            def transform_train(self, data, labels):
                return {"x": data}

            transform_test = transform_train

    fn = {"gpt": "gpt-mini", "bert": "bert-tiny", "moe": "gpt-moe-mini"}[
        kind]
    options = TrainOptions(default_parallelism=2, static_parallelism=True,
                           k=1, train_stats=False, **opts)
    task = TrainTask(job_id=f"ref-{name}", parallelism=2,
                     parameters=TrainRequest(
                         model_type=fn, batch_size=8, epochs=1,
                         dataset=Data.dataset, lr=JOB_LR[kind],
                         resume_from=f"seed-{kind}", function_name=fn,
                         options=options))
    inner = int(np.prod(list(opts.values())))
    job = TrainJob(task, _ref_model(kind), Data(),
                   make_mesh(n_data=lanes * inner, devices=jax.devices()[
                       :lanes * inner]), history_store=HistoryStore())
    record = job.train()
    assert job._pp
    return {k: [float(v) for v in getattr(record.data, k)]
            for k in ("train_loss", "validation_loss", "accuracy",
                      "parallelism")}


def _launch_reference_job(name, outdir):
    """_reference_job(name) in a process of its own (eight virtual CPU
    devices, a copy of the job home), started without waiting. It writes
    ref-NAME.json."""
    from kubeml_tpu.testing import virtual_cpu_env

    home = os.path.join(outdir, f"ref-{name}-home")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "refjob", outdir, name],
        cwd=REPO, env=dict(os.environ, KUBEML_TPU_HOME=home,
                           **virtual_cpu_env(8)),
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
    """Both launches and the reference's jobs started together; meanwhile
    the reference's pipelines, losses, forwards and guards and the port's
    one-process rounds here. Returns {"pair": [2 rank dicts], "quad": [4],
    "meta": {"pair"|"quad": [rank json]}, "ref": {...}, "single":
    {...}}."""
    import torch

    outdir = str(tmp_path_factory.mktemp("pppar"))
    home = os.path.join(outdir, "jobhome")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEML_TPU_HOME", home)
        _job_home(home)
        procs = {"pair": _launch("pair", 2, outdir),
                 "quad": _launch("quad", 4, outdir)}
        procs.update({f"ref-{name}": _launch_reference_job(name, outdir)
                      for name in JOBS})
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        ref, single = {}, {}
        try:
            ref["prim"] = _reference_primitives()
            for kind in ("gpt", "bert", "moe"):
                ref[f"loss/{kind}"] = _reference_loss(kind)
            ref["loss/moe-ep"] = _reference_loss("moe", n_expert=2)
            for kind in ("gpt", "moe"):
                ref[f"fwd/{kind}"] = _reference_forward(kind)
            ref["fwd/alltoall"] = _reference_forward("moe", "alltoall", 4.0)
            ref["guards"] = _reference_guards()
            ref["a2a"], ref["a2a-dense"] = _reference_ffn()
            for kind in ("gpt", "bert"):
                single[kind] = _port_round(kind)
            single["moe"] = _pp_loss("moe")[0]
        finally:
            torch.set_num_threads(threads)
            texts = {}
            for mode, p in procs.items():
                try:
                    texts[mode] = p.communicate(timeout=900)[0]
                finally:
                    if p.poll() is None:
                        p.kill()
    for mode, p in procs.items():
        assert p.returncode == 0, f"{mode} failed:\n" \
            f"{texts[mode][-8000:]}"
    load = lambda name: dict(np.load(os.path.join(outdir, name)))  # noqa
    meta = {}
    for mode, world in (("pair", 2), ("quad", 4)):
        meta[mode] = []
        for r in range(world):
            with open(os.path.join(outdir, f"{mode}_p{r}.json")) as f:
                meta[mode].append(json.load(f))
    for name in JOBS:
        with open(os.path.join(outdir, f"ref-{name}.json")) as f:
            ref[name] = json.load(f)
    return {"pair": [load(f"pair_p{r}.npz") for r in range(2)],
            "quad": [load(f"quad_p{r}.npz") for r in range(4)],
            "meta": meta, "ref": ref, "single": single}


def _same_on_every_rank(ranks, prefix):
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith(prefix):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def _grads(rank_out, key):
    pre = f"grad/{key}/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


def _weights(rank_out, key):
    pre = f"round/{key}/w/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("aux", [False, True])
def test_pipeline_matches_sequential_and_the_reference(runs, aux):
    """pipeline_apply over four stage ranks (M = 6 microbatches of tanh
    stages) equals sequential_apply in one process and the reference's
    pipeline_apply over a 4-stage mesh within f32 1e-6; with aux (the
    stages' real ticks only) the aux and its gradient within the
    reference's own 1e-5 relative; every rank bit for bit."""
    ranks = runs["quad"]
    _same_on_every_rank(ranks, "prim/")
    got, want = ranks[0], runs["ref"]["prim"]
    key = "aux_ys" if aux else "ys"
    np.testing.assert_allclose(got[f"prim/pp/{key}"],
                               got[f"prim/seq/{key}"], rtol=EXACT,
                               atol=EXACT)
    np.testing.assert_allclose(got[f"prim/pp/{key}"], want[key], rtol=EXACT,
                               atol=EXACT)
    if aux:
        for a in (got["prim/seq/aux"], want["aux"]):
            np.testing.assert_allclose(got["prim/pp/aux"], a, rtol=TOL)
        assert float(want["aux"]) > 1.0


def test_pipeline_gradients_match(runs):
    """The pipelined gradients of the stage parameters (the schedule's
    explicit backward, summed over the stage group) equal sequential
    autograd's and the reference's jax.grad through its ppermute ring:
    the weights and biases within f32 1e-6, the aux path's within 1e-5
    relative."""
    got, want = runs["quad"][0], runs["ref"]["prim"]
    for k in ("gw", "gb"):
        for other in (got[f"prim/seq/{k}"], want[k]):
            np.testing.assert_allclose(got[f"prim/pp/{k}"], other,
                                       rtol=EXACT, atol=EXACT)
    for other in (got["prim/seq/aux_gw"], want["aux_gw"]):
        np.testing.assert_allclose(got["prim/pp/aux_gw"], other, rtol=TOL,
                                   atol=TOL)
    assert np.abs(want["gw"]).max() > 1e-3


@pytest.mark.parametrize("key,launch", [("gpt", "pair"), ("bert", "pair"),
                                        ("moe", "pair"),
                                        ("moe-ep", "quad")])
def test_pipelined_loss_and_gradients_match_the_reference(runs, key,
                                                          launch):
    """The pipelined per-example loss at dropout 0 (GPT, BERT and the MoE
    over two stage ranks; the MoE also over stage 2 x expert 2) equals the
    reference's _pp_forward_loss within f32 1e-5, and the gradients of
    its mean (each rank backpropagating 1 / n of it, summed over the inner
    group) the reference's check_vma gradients within 1e-5; every rank
    bit for bit."""
    ranks = runs[launch]
    _same_on_every_rank(ranks, f"loss/{key}")
    _same_on_every_rank(ranks, f"grad/{key}/")
    want_loss, want_grads = runs["ref"][f"loss/{key}"]
    np.testing.assert_allclose(ranks[0][f"loss/{key}"], want_loss, rtol=TOL,
                               atol=TOL)
    got = _grads(ranks[0], key)
    assert set(got) == set(want_grads)
    for path, g in got.items():
        np.testing.assert_allclose(g, want_grads[path], rtol=TOL, atol=TOL,
                                   err_msg=path)
    assert max(np.abs(v).max() for v in want_grads.values()) > 1e-3


@pytest.mark.parametrize("kind", ["gpt", "moe"])
def test_forward_pipelined_matches_the_reference(runs, kind):
    """forward_pipelined over two stage ranks equals the reference's on
    its (stage 2) mesh within f32 1e-5: the logits, and the MoE's aux
    (per-microbatch routing, over layers x microbatches)."""
    ranks = runs["pair"]
    _same_on_every_rank(ranks, f"fwd/{kind}/")
    want = runs["ref"][f"fwd/{kind}"]
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][f"fwd/{kind}/{k}"], v, rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert want["logits"].shape == (B, T, 64)


def test_pipelined_alltoall_matches_replicated(runs):
    """At stage 2 x expert 2 and an overflow-free capacity (4.0), the
    token-sharded route's logits (ep_impl='alltoall': each expert rank
    routes half the tokens, two all-to-alls) equal the replicated-token
    route's within f32 1e-5, and its logits and aux (the shards' load
    statistics averaged over the axis) the reference's alltoall forward's
    within 1e-5."""
    ranks = runs["quad"]
    _same_on_every_rank(ranks, "fwd/")
    got = ranks[0]
    np.testing.assert_allclose(got["fwd/alltoall/logits"],
                               got["fwd/replicated/logits"], rtol=TOL,
                               atol=TOL)
    # the aux is each shard's statistics averaged, not the whole set's
    assert got["fwd/alltoall/aux"] != got["fwd/replicated/aux"]
    for k in ("logits", "aux"):
        np.testing.assert_allclose(got[f"fwd/alltoall/{k}"],
                                   runs["ref"]["fwd/alltoall"][k], rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_ep_alltoall_ffn_matches_dense(runs):
    """ep_alltoall_ffn over a 4-way expert axis (local routing with pads
    in shard 0, two all-to-alls) equals the per-shard dense expert math
    and the reference's ep_alltoall_ffn within f32 1e-6, each rank its
    own shard."""
    got = np.concatenate([r["a2a"] for r in runs["quad"]])
    for want in (runs["ref"]["a2a"], runs["ref"]["a2a-dense"]):
        np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT)
    assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("case", ["layers", "no-experts", "experts"])
def test_forward_pipelined_guards_match_the_reference(runs, case):
    """forward_pipelined refuses what the reference's refuses, with its
    message: layers that do not split over the stages (3 over 2), an
    expert axis under a model without experts, experts that do not
    divide over it (3 over 2)."""
    launch = "pair" if case == "layers" else "quad"
    got = {m["guards"][case] for m in runs["meta"][launch]}
    want = runs["ref"]["guards"][case]
    assert want is not None and got == {want}


@pytest.mark.parametrize("case", ["pads", "microbatches", "max_len"])
def test_forward_pipelined_input_guards_in_one_process(case):
    """In one process (one stage) the reference's input guards
    (tests/test_models_gpt.py test_gpt_pipelined_guards), in its words:
    padded rows, a batch that does not split into the microbatches, a
    sequence past max_len; a pad-free batch gives the dense logits."""
    import torch

    x = np.ones((8, 16), np.int32)
    padded = x.copy()
    padded[0, 10:] = 0
    bad = {"pads": padded, "microbatches": x[:6],
           "max_len": np.ones((8, 40), np.int32)}[case]
    model = _port_model("gpt")
    module = _module(model, "gpt")
    with pytest.raises(ValueError) as want:
        _ref_model("gpt").forward_pipelined({"params": _flax("gpt")}, bad,
                                            _mesh(n_stage=2), M)
    with pytest.raises(ValueError) as got:
        model.forward_pipelined(module, bad, microbatches=M)
    assert str(got.value) == str(want.value)
    with torch.no_grad():
        dense = module.logits(torch.from_numpy(x))
    torch.testing.assert_close(model.forward_pipelined(module, x), dense,
                               rtol=EXACT, atol=EXACT)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_dropout_round_matches_one_process(runs, kind):
    """One K-avg round (SGD, dropout 0.1) at (data 1 x stage 2): both stage
    ranks draw the same masks (one generator per microbatch and global
    block, seeded from the step's key) and hold the same state bit for
    bit, and the one-process round (the sequential schedule, the same
    draws) within f32 1e-6, its loss sums too."""
    ranks = runs["pair"]
    _same_on_every_rank(ranks, f"round/{kind}/")
    state, loss = runs["single"][kind]
    got = _weights(ranks[0], kind)
    assert set(got) == set(state)
    for k, v in state.items():
        np.testing.assert_allclose(got[k], v, rtol=EXACT, atol=EXACT,
                                   err_msg=k)
    np.testing.assert_allclose(ranks[0][f"round/{kind}/loss"], loss,
                               rtol=EXACT, atol=EXACT)


def test_mutants_fail_the_checks(runs):
    """The checks above catch a broken pipeline: a stage psum whose
    backward is the identity (the last stage gets 1/P of the cotangent)
    misses the one-process round, and a schedule that computes the fill
    and drain ticks and counts their aux misses the sequential MoE loss,
    each by more than ten times the tolerance."""
    state, _ = runs["single"]["gpt"]
    got = _weights(runs["pair"][0], "identity-psum")
    assert max(float(np.abs(got[k] - state[k]).max()) for k in state) \
        > 10 * EXACT
    mutant, want = runs["quad"][0]["mutant/aux"], runs["single"]["moe"]
    assert float(np.abs(mutant - want).max()) > 10 * TOL
    np.testing.assert_allclose(runs["pair"][0]["loss/moe"], want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_pipelined_jobs_match_the_references_jobs(runs, name):
    """The reference tests' pipelined jobs (GPT and BERT at data 4 x stage
    2, the MoE at data 2 x stage 2 x expert 2; one epoch), warm-started
    from the JAX-written checkpoint: every rank's history equal, and the
    reference's pipelined job's within 2e-3."""
    launch = JOBS[name][1]
    hists = [m["jobs"][name] for m in runs["meta"][launch]]
    assert len(hists) == {"pair": 2, "quad": 4}[launch]
    assert all(h == hists[0] for h in hists)
    want = runs["ref"][name]
    assert hists[0]["parallelism"] == want["parallelism"] == [2]
    for key in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(hists[0][key], want[key], rtol=JOB_TOL,
                                   atol=JOB_TOL, err_msg=key)


# the job's 400s, in the reference's order (kubeml_tpu/train/job.py)
REFUSALS = {
    "pp-sp": (dict(n_stage=2, n_seq=2), 4, "gpt",
              "--pipeline-parallel composes with --expert-parallel only "
              "(the pipelined trunk owns the layer split that "
              "--tensor-parallel/--seq-parallel would reshard)"),
    "pp-tp": (dict(n_stage=2, n_model=2), 4, "gpt",
              "--pipeline-parallel composes with --expert-parallel only "
              "(the pipelined trunk owns the layer split that "
              "--tensor-parallel/--seq-parallel would reshard)"),
    "syncdp": (dict(n_stage=2, engine="syncdp"), 2, "gpt",
               "tensor/sequence/pipeline/expert parallelism requires the "
               "kavg engine"),
    "world": (dict(n_stage=2), 1, "gpt",
              "1 devices not divisible by the requested model x seq x "
              "stage x expert factor 2"),
    "world-pp-ep": (dict(n_stage=2, n_expert=2), 2, "moe",
                    "2 devices not divisible by the requested model x seq "
                    "x stage x expert factor 4"),
    "microbatches-negative": (dict(n_stage=2, pp_microbatches=-1), 2, "gpt",
                              "pp_microbatches must be >= 0"),
    "family": (dict(n_stage=2), 2, "mlp",
               "function 'mlp' does not support pipeline parallelism "
               "(requires a uniform pipelineable trunk — the transformer "
               "families: GPT, BERT)"),
    "layers": (dict(n_stage=4), 4, "gpt",
               "2 layers do not split over a 4-stage axis"),
    "batch": (dict(n_stage=2, pp_microbatches=3), 2, "gpt",
              "batch size 8 not divisible by 3 pipeline microbatches"),
    "pp-ep-no-experts": (dict(n_stage=2, n_expert=2), 4, "gpt",
                         "function 'gpt-mini' has no experts to shard "
                         "(expert parallelism applies to MoE families like "
                         "gpt-moe-mini)"),
    "pp-ep-divide": (dict(n_stage=2, n_expert=3), 6, "moe",
                     "4 experts do not divide over a 3-way expert axis"),
    "device-cache": (dict(n_stage=2, device_cache="on"), 2, "gpt",
                     "device_cache='on' requires a single-process job "
                     "without sequence-parallel/pipeline/manual-TP rounds "
                     "and an identity transform_train (or a "
                     "transform_train_device hook)"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_pp_job_refusals_in_reference_order(tmp_path, monkeypatch, case):
    """Each misconfiguration fails the job with the reference's 400 and
    wording, before any data is trained; the world is one device without
    a group, and a stated size where a case needs the later checks. The
    layers and batch checks come after the model's own refusal, the
    expert checks after the pipeline's, as in the reference."""
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel import distributed as dl
    from test_torch_seq_parallel import _job, _job_task, _token_home

    opts, world, kind, message = REFUSALS[case]
    reg = _token_home(str(tmp_path))
    monkeypatch.setattr(dl, "world_size", lambda: world)
    model = get_model("mlp")(hidden=8, num_classes=2) if kind == "mlp" \
        else _port_model(kind)
    task = _job_task("refused", **opts)
    task.parameters.model_type = {"mlp": "mlp", "moe": "gpt-moe-mini",
                                  "gpt": "gpt-mini"}[kind]
    job = _job(task, reg, model)
    with pytest.raises(KubeMLException) as e:
        job.train()
    assert e.value.status_code == 400
    assert e.value.message == message


@pytest.mark.parametrize("name", ["mlp", "lenet", "resnet18", "vgg11",
                                  "lstm"])
def test_other_families_refuse_pipeline_parallelism(name):
    """Every family without a uniform pipelineable trunk refuses
    enable_pipeline_parallel with the reference's ValueError and message
    (kubeml_tpu/models/base.py); the GPT, MoE and BERT families set their
    microbatches (2 x stages by default)."""
    from kubeml_tpu.models import get_builtin
    from kubeml_tpu_torch.models import get_model

    pair = []
    for get in (get_builtin, get_model):
        with pytest.raises(ValueError) as e:
            get(name)().enable_pipeline_parallel(2)
        pair.append(str(e.value))
    assert pair[0] == pair[1]
    assert "does not support pipeline parallelism" in pair[0]
    for kind in ("gpt", "moe", "bert"):
        model = _port_model(kind)
        model.enable_pipeline_parallel(2)
        assert model._pp_microbatches == 4
        model.enable_pipeline_parallel(2, 8)
        assert model._pp_microbatches == 8


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch,t_len,heads,causal", [(2, 512, 4, True),
                                                      (8, 64, 2, False)])
def test_microbatch_kernels_match_plain_on_card(cuda_device, batch, t_len,
                                                heads, causal):
    """On the card, at the microbatch shapes M = 4 gives the flash kernels
    (gpt-mini's B=8 as [2, 512, 4, 64] causal, bert-tiny's B=32 as [8, 64,
    2, 64] not causal; bf16, a padded tail and a fully padded sequence):
    #2-#4 each against its plain version within the flash tolerance 2e-2,
    one launch each, and a second launch equal to the first bit for
    bit."""
    import torch

    from kubeml_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(batch * t_len)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (batch, t_len, heads, 64)).astype(np.float32)).to(
            cuda_device, torch.bfloat16) for _ in range(4))
    lengths = np.linspace(t_len, 0, batch).astype(np.int64)
    pad = torch.from_numpy((np.arange(t_len)[None, :] < lengths[:, None])
                           .astype(np.float32)).to(cuda_device)
    kernels = (fa.fa_fwd_kernel, fa.fa_bwd_dkv_kernel, fa.fa_bwd_dq_kernel)
    before = [kern.launches for kern in kernels]
    out, m, l = fa.fa_fwd_kernel(q, k, v, pad, causal)
    bwd = (q, k, v, pad, g, m, l, fa._delta(g, out), causal)
    dk, dv = fa.fa_bwd_dkv_kernel(*bwd)
    dq = fa.fa_bwd_dq_kernel(*bwd)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kernels] == [n + 1 for n in before]
    for got, want in (((out, m, l), fa._fa_forward_plain(q, k, v, pad,
                                                         causal)),
                      ((dk, dv), fa._fa_bwd_dkv_plain(*bwd)),
                      ((dq,), (fa._fa_bwd_dq_plain(*bwd),))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2)
    again = (*fa.fa_fwd_kernel(q, k, v, pad, causal),
             *fa.fa_bwd_dkv_kernel(*bwd), fa.fa_bwd_dq_kernel(*bwd))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((out, m, l, dk, dv, dq),
                                                 again))


def test_grid_stage_axis_layout_in_one_process():
    """Without a group the stage axis has size 1, and a grid whose stage
    axis does not split the world is refused naming every inner axis."""
    from kubeml_tpu_torch.parallel import distributed as dl

    grid = dl.make_grid(1, 1, 1, 1)
    assert (grid.n_stage, grid.stage_index, grid.stage_group) == (1, 0, None)
    assert (dl.axis_size("stage"), dl.axis_index("stage")) == (1, 0)
    with pytest.raises(ValueError, match="inner groups of 1 model x 1 seq x "
                                         "2 stage x 1 expert ranks"):
        dl.make_grid(1, 1, 1, 2)


if __name__ == "__main__":
    import faulthandler

    faulthandler.dump_traceback_later(600, repeat=True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    mode, outdir = sys.argv[1], sys.argv[2]
    if mode == "refjob":
        name = sys.argv[3]
        hist = _reference_job(name)
        with open(os.path.join(outdir, f"ref-{name}.json"), "w") as f:
            json.dump(hist, f)
    else:
        import torch

        from kubeml_tpu_torch.parallel import distributed as dist_lib

        torch.set_num_threads(1)
        dist_lib.initialize(device="cpu", timeout=600)
        WORKERS[mode](outdir)
        print(f"{mode} rank {dist_lib.rank()} OK", flush=True)
