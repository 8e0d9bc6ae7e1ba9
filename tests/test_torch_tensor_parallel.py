"""Port parity: tensor parallelism over ``torch.distributed`` ranks (the
rank grid's model axis, ``kubeml_tpu_torch/parallel/distributed.py``; the
Megatron layers of ``parallel/manual.py``; the rule table and its plan,
``parallel/tp.py``; the GPT and BERT modules with ``tp_axis``; the K-avg
engine's inner round and its ring rule; the job's ``n_model`` path under
both ``tp_impl`` routes) against the JAX package and against the port in
one process.

The ranks are processes of ``tools/launch_distributed`` (``--emulate-cpu
1``) joined over gloo, each running this file's ``__main__`` block: two
ranks (``pair``: data 1 x model 2) and four (``quad``: data 2 x model 2,
model 2 x seq 2, model 4). Both launches and one process of the JAX
package's GSPMD tensor-parallel job (its compile takes most of the
file's time) start together in the module fixture; the JAX package's
layers, forwards, gradients and manual-TP rounds (on its 8-device CPU
mesh) and the port's one-process runs happen in the test process
meanwhile, torch on one thread. The models are the reference's TinyGPT
widths (vocab 64, hidden 32, 2 layers, 2 heads, FFN 64) and bert-tiny
at its published widths (2 heads: one a rank at M = 2), their weights
made from numpy seeds in the flax layouts (``convert.random_flax_params``:
the biases nonzero, so the row layers' one bias add shows) and carried
across by ``convert.py``; the inputs come from numpy seeds.

What is held, and how tightly:
  - each Megatron layer over two model ranks equals the reference's
    layer (``TPHeadsDense``, ``TPOutDense``, ``TPColumnDense``,
    ``TPRowDense``) in a shard_map over a 2-device mesh, f32 within 1e-5
    and bf16 within the reference's 5e-2/2e-2; both ranks of a
    replicated output bit for bit;
  - the GPT and BERT tensor-parallel forwards equal the port's dense
    forward and the reference's manual-TP forward within f32 1e-5; in
    bf16, on the reference test's own weights and inputs
    (tests/test_manual_tp.py), the dense forward within its 5e-2/2e-2
    and the reference's within 2e-2 of the logits' largest magnitude
    (chip_smoke.py's bf16 logits measure: the frameworks sum bf16
    products in another order, and the reference's same-framework
    bound misses 2 of 2048 GPT logits by up to 0.004);
  - the inner-summed tensor-parallel gradients equal the port's dense
    gradients and the reference's manual-TP gradients within f32 1e-5;
  - one K-avg round (W=2, S=2, B=4, T=32, SGD, dropout 0) at (data 2 x
    model 2) of both models and at (model 2 x seq 2) of the GPT equals
    the reference's manual-TP round within f32 1e-5, every rank holding
    the same state bit for bit; at (data 1 x model 2) with dropout 0.1
    both models equal the port's one-process round within f32 1e-5;
  - the two gradient mutants fail those checks: a model psum whose
    backward is the identity, and an inner round that sums the
    gradients over the seq group only (leaving out the model axis);
  - the GSPMD route's job at (data 2 x model 2), warm-started from a
    JAX-written checkpoint, equals the reference's GSPMD ``n_model=2``
    job within its 2e-2/2e-3 (tests/test_parallel_tp_sp.py);
  - ``kubeml train -f gpt-mini|bert-tiny --tensor-parallel 2`` under
    both ``--tp-impl`` routes (two ranks) and ``-f bert-tiny
    --tensor-parallel 2 --seq-parallel 2`` (four) train: their losses
    fall, every rank's history is equal, and each epoch's losses stay
    within 2e-2 relative of the one-process job's (the reference's own
    TP-against-dense bound in bf16; AdamW at 1e-3: at 3e-3 the
    one-process bf16 job alone is 2.3 % off its f32 twin);
  - bert-tiny at M = 4 (2 heads on a 4-way axis) trains under the GSPMD
    route (the attention pair whole, the FFN split) within 1e-3
    relative of the one-process job, and is the 400 of
    ``validate_tp_geometry`` under the manual route;
  - ``tree_specs`` equal the reference's on every leaf of gpt-mini and
    bert-tiny, and ``shard_plan`` splits what ``shard_variables`` shards;
  - the engine's ring rule equals the reference engine's ``_wire_ring``
    for the GSPMD route, the manual route and TP x SP;
  - the paged builders refuse a tensor-parallel module with the
    reference's messages; the job's 400s in the reference's order.
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
GPT = dict(vocab_size=64, max_len=32, hidden=32, layers=2, heads=2, ffn=64)
BERT = dict(vocab_size=30522, max_len=128, hidden=128, layers=2, heads=2,
            ffn=512)
W, S, B, T, LR = 2, 2, 4, 32, 1e-2
TOL = 1e-5                          # f32 layers, forwards, grads, rounds
BF16_TOL = (5e-2, 2e-2)             # the reference's manual-TP bf16 bound
# bf16 logits across the two frameworks, which sum bf16 products in
# another order: the largest difference as a share of the logits' largest
# magnitude (chip_smoke.py's SEQ_LOGIT_TOL for bf16 logits)
BF16_LOGIT_SHARE = 2e-2
JOB_TOL = (2e-2, 2e-3)              # the reference's GSPMD TP bound
CLI_REL = 2e-2                      # TP against one process in bf16
# the CLI jobs' AdamW rate: at 3e-3 gpt-mini's one-process bf16 job is
# itself 2.3 % off its f32 twin in the second epoch's validation loss
CLI_LR = 1e-3
JOB_T, JOB_N, JOB_TEST, JOB_K = 16, 64, 16, 2
# round name -> (model, n_model, n_seq, lanes, dropout, mutant)
ROUNDS = {
    "dp-tp-gpt": ("gpt", 2, 1, 2, 0.0, None),
    "dp-tp-bert": ("bert", 2, 1, 2, 0.0, None),
    "tp-sp-gpt": ("gpt", 2, 2, 1, 0.0, None),
    "tp-sp-gpt-seq-sum": ("gpt", 2, 2, 1, 0.0, "seq-sum"),
    "tp-drop-gpt": ("gpt", 2, 1, 1, 0.1, None),
    "tp-drop-bert": ("bert", 2, 1, 1, 0.1, None),
    "tp-drop-gpt-identity-psum": ("gpt", 2, 1, 1, 0.1, "identity-psum"),
}
PAIR_ROUNDS = [k for k in ROUNDS if k.startswith("tp-drop")]
QUAD_ROUNDS = [k for k in ROUNDS if k not in PAIR_ROUNDS]
REF_ROUNDS = ("dp-tp-gpt", "dp-tp-bert", "tp-sp-gpt")
# the CLI's jobs over ranks: name -> (launch, model, flags)
CLI_JOBS = {
    "cli-gpt-gspmd": ("pair", "gpt-mini", ["--tensor-parallel", "2"]),
    "cli-gpt-manual": ("pair", "gpt-mini", ["--tensor-parallel", "2",
                                            "--tp-impl", "manual"]),
    "cli-bert-gspmd": ("pair", "bert-tiny", ["--tensor-parallel", "2"]),
    "cli-bert-manual": ("pair", "bert-tiny", ["--tensor-parallel", "2",
                                              "--tp-impl", "manual"]),
    "cli-bert-tp-sp": ("quad", "bert-tiny", ["--tensor-parallel", "2",
                                             "--seq-parallel", "2"]),
}
WIRE_CASES = {"gspmd": (2, 1, False), "manual": (2, 1, True),
              "tp-sp": (2, 2, True)}    # (n_model, n_seq, manual_inner)


# ------------------------------------------------------------- the inputs

def _flax(kind, seed=0):
    """The model's f32 weights in the flax layouts (numpy): GPT's from
    random_flax_params, bert-tiny's plus a classifier."""
    from kubeml_tpu_torch.convert import random_flax_params

    if kind == "gpt":
        return random_flax_params(**GPT, seed=seed)
    tree = random_flax_params(**BERT, seed=seed)
    rng = np.random.RandomState(seed + 1)
    tree["classifier"] = {
        "kernel": (rng.randn(BERT["hidden"], 2)
                   / np.sqrt(BERT["hidden"])).astype(np.float32),
        "bias": (rng.randn(2) * 0.1).astype(np.float32)}
    return tree


def _round_batch(kind):
    """A round's batch and step keys (RandomState(0)): ascending token
    runs for the LM, random ids and labels for BERT, [W, S, B, T]."""
    rng = np.random.RandomState(0)
    if kind == "gpt":
        start = rng.randint(1, 63, size=(W * S * B, 1))
        x = ((start + np.arange(T)[None, :] - 1) % 63 + 1).astype(np.int32)
        batch = {"x": x.reshape(W, S, B, T)}
    else:
        batch = {"x": rng.randint(1, 1000, size=(W, S, B, T)).astype(
                     np.int32),
                 "y": rng.randint(0, 2, size=(W, S, B)).astype(np.int32)}
    rngs = rng.randint(0, 2 ** 31, size=(W, S, 2)).astype(np.uint32)
    return batch, rngs


MASKS = dict(sample_mask=np.ones((W, S, B), np.float32),
             step_mask=np.ones((W, S), np.float32),
             worker_mask=np.ones(W, np.float32))


def _forward_batch(kind, dtype="f32"):
    """A forward's batch: in f32 [4, 16] ids (RandomState(1)) with a row
    padded from position 10, and BERT's labels; in bf16 the reference
    test's own inputs (test_manual_tp.py: GPT [2, 16] ids of
    RandomState(1), BERT [4, 16] of RandomState(0)), on which its bound
    was set."""
    if dtype == "bf16":
        if kind == "gpt":
            x = np.random.RandomState(1).randint(1, 63, size=(2, 16))
        else:
            x = np.random.RandomState(0).randint(1, 1000, size=(4, 16))
        return {"x": x.astype(np.int32)}
    rng = np.random.RandomState(1)
    x = rng.randint(1, 63, size=(4, 16)).astype(np.int32)
    x[0, 10:] = 0
    return {"x": x, "y": rng.randint(0, 2, size=4).astype(np.int32)}


def _layer_inputs():
    """One block's four layers' operands (seed 7, f32, flax layouts): x
    [4, 8, 32], the q kernel [32, 2, 16] and bias, the out kernel [2, 16,
    32] and bias, the FFN's Dense_0 [32, 64] and Dense_1 [64, 32]."""
    rng = np.random.RandomState(7)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"x": f(4, 8, 32), "attn": f(4, 8, 2, 16), "h": f(4, 8, 64),
            "q": (f(32, 2, 16) / 6, f(2, 16) * 0.1),
            "out": (f(2, 16, 32) / 6, f(32) * 0.1),
            "Dense_0": (f(32, 64) / 6, f(64) * 0.1),
            "Dense_1": (f(64, 32) / 8, f(32) * 0.1)}


def _port_model(kind, dtype="f32", dropout=0.0):
    """A port model whose modules build at the test's widths and carry
    the model's seq and tensor-parallel settings."""
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
                                 seq_impl=self.seq_impl,
                                 tp_axis=self.tp_axis, tp_plan=self.tp_plan)

            def params_to_flax(self, state):
                return params_to_flax(state, heads=GPT["heads"])
        return Tiny(dt)

    class Bert(BertTiny):
        def build(self, dtype=None, device=None):
            return BertModule(num_classes=2, dropout=dropout, dtype=dt,
                              device=device, seq_axis=self.seq_axis,
                              seq_impl=self.seq_impl, tp_axis=self.tp_axis,
                              tp_plan=self.tp_plan)
    return Bert(dt)


def _module(kind, dtype, tp=False, dropout=0.0, flax=None):
    """(model, module on the CPU with the weights ``flax``, _flax(kind)'s
    by default), built tensor-parallel (manual route) with ``tp``."""
    model = _port_model(kind, dtype, dropout)
    if tp:
        model.enable_tensor_parallel()
    module = model.build(device="cpu")
    module.load_state_dict(model.params_from_flax(
        _flax(kind) if flax is None else flax))
    return model, module


def _unflat(flat):
    """The nested dict of a _flat dict."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def _forward(kind, dtype, tp, outdir):
    """The module's f32 logits of _forward_batch(kind, dtype), no grad:
    in f32 on _flax(kind)'s weights, in bf16 on the reference test's
    (its init_variables(PRNGKey(0)), which the fixture writes to
    ``outdir``), the data its bf16 bound was set on."""
    import torch

    flax = None if dtype == "f32" else _unflat(dict(np.load(
        os.path.join(outdir, f"init_{kind}.npz"))))
    _, module = _module(kind, dtype, tp, flax=flax)
    x = torch.from_numpy(_forward_batch(kind, dtype)["x"])
    with torch.no_grad():
        out = module.logits(x) if kind == "gpt" else module(x)
    return out.float().numpy()


def _grads(kind, tp):
    """The f32 gradients of the batch-mean loss of _forward_batch(kind)
    as a flax tree: dense in one process, or tensor-parallel with each
    model rank backpropagating 1 / n of it and the gradients summed over
    the inner group."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl

    model, module = _module(kind, "f32", tp)
    batch = {k: torch.from_numpy(v) for k, v in _forward_batch(kind).items()}
    loss = model.loss(module, batch, torch.Generator().manual_seed(0),
                      torch.ones(4)).mean()
    n = dl.current_grid().n_inner if tp else 1
    (loss / n).backward()
    grads = {name: dl.all_reduce(p.grad, group=dl.current_grid().inner_group)
             if tp else p.grad for name, p in module.named_parameters()}
    return model.params_to_flax(grads)


def _flat(tree, prefix=""):
    """{'/'-joined path: numpy leaf} of a nested dict (a flax tree)."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat(node, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(node)
    return out


def _sgd(lr, epoch):
    import torch

    return functools.partial(torch.optim.SGD, lr=lr)


def _port_round(name, one_process=False):
    """One round of ROUNDS[name] over the current group's grid (or, with
    ``one_process``, dense without a group): (merged state, loss sums,
    eval [loss, accuracy, n]). The mutants break the gradient sum:
    'identity-psum' (the model psum's backward passes the cotangent
    through) and 'seq-sum' (the inner round sums over the seq group
    only)."""
    import torch

    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    kind, n_model, n_seq, lanes, dropout, mutant = ROUNDS[name]
    if one_process:
        n_model = n_seq = 1
    model = _port_model(kind, "f32", dropout)
    if n_model > 1:
        model.enable_tensor_parallel()
    if n_seq > 1:
        model.enable_seq_parallel("ring")
    module = model.build(device="cpu")
    init = model.params_from_flax(_flax(kind))
    module.load_state_dict(init)
    engine = KAvgEngine(module, model.loss, model.metrics, _sgd,
                        n_lanes=lanes, n_seq=n_seq, n_model=n_model,
                        manual_inner=n_model > 1,
                        batch_seq_dims=model.seq_batch_dims
                        if n_seq > 1 else None)
    if mutant == "seq-sum":
        engine.grid = dataclasses.replace(
            engine.grid, inner_group=engine.grid.seq_group)
    backward = dl._Psum.__dict__["backward"]
    if mutant == "identity-psum":
        dl._Psum.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        batch, rngs = _round_batch(kind)
        out, stats = engine.train_round(dict(init), batch, rngs=rngs, lr=LR,
                                        epoch=0, **MASKS)
        ev = engine.eval_round(out, batch, MASKS["sample_mask"])
    finally:
        dl._Psum.backward = backward
    return ({k: v.numpy() for k, v in out.items()}, stats.loss_sum,
            np.array([ev["loss"], ev["accuracy"], ev["n"]]))


# ---------------------------------------------------------------- the jobs

def _job_home(home):
    """A KUBEML_TPU_HOME with the token-window dataset ``pplm`` (ascending
    runs, RandomState(0)) and the classification set ``toktask`` (class 1
    draws its tokens from [1, 48), class 0 from [16, 64): the mean-pool
    tells most windows apart, so two epochs learn without memorizing;
    RandomState(1)), T = 16."""
    os.environ["KUBEML_TPU_HOME"] = home
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    rng = np.random.RandomState(0)

    def lm(n):
        start = rng.randint(1, 63, size=(n, 1))
        x = ((start + np.arange(JOB_T)[None, :] - 1) % 63 + 1)
        return x.astype(np.int32), np.zeros(n, np.int32)

    reg = DatasetRegistry()
    reg.create("pplm", *lm(JOB_N), *lm(JOB_TEST))
    crng = np.random.RandomState(1)

    def tok(n):
        y = crng.randint(0, 2, size=n).astype(np.int32)
        x = np.where(y[:, None] == 1, crng.randint(1, 48, (n, JOB_T)),
                     crng.randint(16, 64, (n, JOB_T)))
        return x.astype(np.int32), y

    reg.create("toktask", *tok(JOB_N), *tok(JOB_TEST))
    return reg


class _Windows:
    """The LM windows as the GPT's batch ({'x'}), or the classification
    set as it is ({'x', 'y'})."""

    @staticmethod
    def dataset(name):
        from kubeml_tpu_torch.models.base import KubeDataset

        if name == "toktask":
            return KubeDataset("toktask")

        class LM(KubeDataset):
            def transform_train(self, data, labels):
                return {"x": data}

            transform_test = transform_train
        return LM("pplm")


def _cli_task(job_id, function, flags, epochs=2, resume=False, lr=3e-3):
    """The TrainTask ``kubeml train`` would submit for these flags
    (``cli.main.train_request``)."""
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.cli.main import build_parser, train_request

    dataset = "pplm" if function.startswith("gpt") else "toktask"
    argv = ["train", "-f", function, "-d", dataset, "-e", str(epochs),
            "-b", "8", "-p", "2", "--static", "-K", str(JOB_K), "--lr",
            str(lr)]
    if resume:
        argv += ["--resume-from", "seedckpt"]
    req = train_request(build_parser().parse_args(argv + list(flags)))
    return TrainTask(job_id=job_id, parameters=req,
                     parallelism=req.options.default_parallelism)


def _port_job(task, model, n_lanes):
    """The port's job of ``task`` on the CPU (the current group's ranks,
    or one process): its history's numbers."""
    from kubeml_tpu_torch.train.history import HistoryStore
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    record = TrainJob(task, model,
                      _Windows.dataset(task.parameters.dataset), "cpu",
                      n_lanes=n_lanes, history_store=HistoryStore(),
                      callbacks=JobCallbacks()).train()
    return {k: [float(v) for v in getattr(record.data, k)]
            for k in ("train_loss", "validation_loss", "accuracy",
                      "parallelism")}


def _cli_job(name, one_process=False):
    """CLI_JOBS[name] at the registered model's published widths and
    dtype (bf16, dropout 0.1), over the current group (one lane) or, with
    ``one_process``, without its parallel flags."""
    from kubeml_tpu_torch.models import get_model

    _, function, flags = CLI_JOBS[name]
    return _port_job(_cli_task(name, function, [] if one_process else flags,
                               lr=CLI_LR), get_model(function)(), 1)


def _bert_m4_job(n_model):
    """bert-tiny in f32 (dropout 0.1) for one epoch, at ``n_model`` model
    ranks under the GSPMD route (the 2 heads do not divide over 4: the
    attention pair runs whole, the FFN splits) or in one process (1)."""
    import torch

    from kubeml_tpu_torch.models import get_model

    flags = [] if n_model == 1 else ["--tensor-parallel", str(n_model)]
    return _port_job(_cli_task("bert-m4", "bert-tiny", flags, epochs=2),
                     get_model("bert-tiny")(torch.float32), 1)


# ------------------------------------------------------------- the ranks

def _layers(rank):
    """The four Megatron layers on this rank (f32 and bf16): q's local
    heads, the out-projection, Dense_0's local columns, Dense_1's sum."""
    import torch

    from kubeml_tpu_torch.parallel.manual import (tp_column_dense,
                                                  tp_heads_dense,
                                                  tp_out_dense, tp_row_dense)

    inp = _layer_inputs()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    qk, qb = inp["q"]
    ok, ob = inp["out"]
    d0k, d0b = inp["Dense_0"]
    d1k, d1b = inp["Dense_1"]
    # the torch layouts: [out, in] weights, flattened heads
    wq, bq = t(qk.reshape(32, -1).T), t(qb.reshape(-1))
    wo = t(ok.reshape(-1, 32).T)
    w0, w1 = t(d0k.T), t(d1k.T)
    out = {}
    for dtype, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        c = lambda a: a.to(dt)  # noqa: E731
        x = c(t(inp["x"]))
        attn = c(t(inp["attn"][:, :, rank:rank + 1]))
        h = c(t(inp["h"][..., 32 * rank:32 * (rank + 1)]))
        out[f"{dtype}/q"] = tp_heads_dense(x, c(wq), c(bq), 2,
                                           "model").float().numpy()
        out[f"{dtype}/out"] = tp_out_dense(attn, c(wo), t(ob),
                                           "model").float().numpy()
        out[f"{dtype}/Dense_0"] = tp_column_dense(x, c(w0), c(t(d0b)),
                                                  "model").float().numpy()
        out[f"{dtype}/Dense_1"] = tp_row_dense(h, c(w1), t(d1b),
                                               "model").float().numpy()
    return out


def pair_worker(outdir):
    """Two ranks (data 1 x model 2): the layers, the forwards, the
    gradients, the dropout rounds (and the identity-psum mutant), then
    the CLI jobs."""
    from kubeml_tpu_torch.parallel import distributed as dl

    rank = dl.rank()
    dl.make_grid(1, 1, 2)
    out = {f"layer/{k}": v for k, v in _layers(rank).items()}
    for kind in ("gpt", "bert"):
        for dtype in ("f32", "bf16"):
            out[f"fwd/{kind}/{dtype}"] = _forward(kind, dtype, True, outdir)
        out.update({f"grad/{kind}/{k}": v
                    for k, v in _flat(_grads(kind, True)).items()})
    for name in PAIR_ROUNDS:
        state, loss, ev = _port_round(name)
        out.update({f"{name}/w/{k}": v for k, v in state.items()})
        out[f"{name}/loss"], out[f"{name}/eval"] = loss, ev
    home = os.path.join(outdir, f"pair_home_p{rank}")
    _job_home(home)
    jobs = {name: _cli_job(name) for name, (launch, _, _) in CLI_JOBS.items()
            if launch == "pair"}
    with open(os.path.join(outdir, f"pair_jobs_p{rank}.json"), "w") as f:
        json.dump(jobs, f)
    np.savez(os.path.join(outdir, f"pair_p{rank}.npz"), **out)


def quad_worker(outdir):
    """Four ranks: the (data 2 x model 2) and (model 2 x seq 2) rounds and
    the seq-sum mutant, the engine's ring rule per route, the GSPMD
    route's job against the reference's, bert-tiny at M = 4, and the TP x
    SP CLI job."""
    from kubeml_tpu_torch.parallel import distributed as dl
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    rank = dl.rank()
    out = {}
    for name in QUAD_ROUNDS:
        state, loss, ev = _port_round(name)
        out.update({f"{name}/w/{k}": v for k, v in state.items()})
        out[f"{name}/loss"], out[f"{name}/eval"] = loss, ev
    model, module = _module("gpt", "f32", True)
    for case, (n_model, n_seq, manual) in WIRE_CASES.items():
        engine = KAvgEngine(module, model.loss, model.metrics, _sgd,
                            n_lanes=4 // (n_model * n_seq), n_seq=n_seq,
                            n_model=n_model, manual_inner=manual,
                            batch_seq_dims={"x": 0} if n_seq > 1 else None)
        out[f"wire/{case}"] = np.array(engine._wire_ring)
    home = os.path.join(outdir, f"quad_home_p{rank}")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    os.environ["KUBEML_TPU_HOME"] = home
    jobs = {"dp-tp-job": _port_job(
        _cli_task("dp-tp-job", "gpt-mini", ["--tensor-parallel", "2"],
                  epochs=1, resume=True), _port_model("gpt"), 2),
        "bert-m4": _bert_m4_job(4), "cli-bert-tp-sp":
            _cli_job("cli-bert-tp-sp")}
    with open(os.path.join(outdir, f"quad_jobs_p{rank}.json"), "w") as f:
        json.dump(jobs, f)
    np.savez(os.path.join(outdir, f"quad_p{rank}.npz"), **out)


WORKERS = {"pair": pair_worker, "quad": quad_worker}


# -------------------------------------------------------------- fixtures

def _ref_model(kind, dtype="f32", dropout=0.0):
    """The reference's TinyGPT or bert-tiny module at a dtype and dropout."""
    import jax.numpy as jnp

    from kubeml_tpu.models import get_builtin
    from test_models_gpt import TinyGPT

    model = TinyGPT() if kind == "gpt" else get_builtin("bert-tiny")()
    model._module = model.module.clone(
        dropout=dropout,
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    return model


def _tp_mesh(n=2):
    import jax

    from kubeml_tpu.parallel.mesh import make_mesh

    return make_mesh(n_data=1, n_model=n, devices=jax.devices()[:n])


def _reference_layers():
    """The reference's four layers in a shard_map over a 2-device model
    axis, f32 and bf16, on _layer_inputs(): outputs gathered over the
    axis where they are local."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.manual import (TPColumnDense, TPHeadsDense,
                                            TPOutDense, TPRowDense)
    from kubeml_tpu.parallel.mesh import MODEL_AXIS as M

    inp = _layer_inputs()
    mesh = _tp_mesh()
    out = {}
    for dtype, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        cases = {
            "q": (TPHeadsDense(2, 16, M, dt), "x", P(), P(None, None, M)),
            "out": (TPOutDense(2, 16, 32, M, dt), "attn", P(None, None, M),
                    P()),
            "Dense_0": (TPColumnDense(64, M, dt), "x", P(), P(None, None, M)),
            "Dense_1": (TPRowDense(32, 64, M, dt), "h", P(None, None, M),
                        P()),
        }
        for name, (layer, arg, in_spec, out_spec) in cases.items():
            kernel, bias = inp[name]
            params = {"params": {"kernel": jnp.asarray(kernel),
                                 "bias": jnp.asarray(bias)}}
            fn = jax.jit(compat.shard_map(
                lambda p, x, layer=layer: layer.apply(p, x), mesh=mesh,
                in_specs=(P(), in_spec), out_specs=out_spec,
                check_vma=False))
            out[f"{dtype}/{name}"] = np.asarray(
                fn(params, jnp.asarray(inp[arg]).astype(dt)), np.float32)
    return out


def _reference_init(kind):
    """The reference test's weights: init_variables(PRNGKey(0)) of its
    TinyGPT or bert-tiny, a numpy flax tree."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(_forward_batch(kind, "bf16")["x"])
    variables = _ref_model(kind).init_variables(jax.random.PRNGKey(0),
                                                {"x": x})
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _reference_forward(kind, dtype, flax):
    """The reference's manual-TP forward (module.clone(tp_axis=model) in
    a fully-manual shard_map over 2 devices) of _forward_batch(kind,
    dtype) on the weights ``flax``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.mesh import MODEL_AXIS

    tp_module = _ref_model(kind, dtype).module.clone(tp_axis=MODEL_AXIS)
    fn = jax.jit(compat.shard_map(
        lambda v, x: tp_module.apply(v, x, train=False), mesh=_tp_mesh(),
        in_specs=(P(), P()), out_specs=P(), check_vma=False))
    return np.asarray(fn({"params": flax}, jnp.asarray(
        _forward_batch(kind, dtype)["x"])), np.float32)


def _reference_grads(kind):
    """The reference's manual-TP gradients of the batch-mean loss (its
    test_manual_tp_grads_match_dense: check_vma assembles them)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.mesh import MODEL_AXIS

    model = _ref_model(kind)
    model._module = model.module.clone(tp_axis=MODEL_AXIS)
    batch = {k: jnp.asarray(v) for k, v in _forward_batch(kind).items()}
    if kind == "gpt":
        batch.pop("y")
    key, ones = jax.random.PRNGKey(3), jnp.ones(4)

    def grads(v, b):
        return jax.grad(lambda v: model.loss(v, b, key, ones)[0].mean())(v)

    g = jax.jit(compat.shard_map(
        grads, mesh=_tp_mesh(), in_specs=(P(), P()), out_specs=P(),
        check_vma=True))({"params": _flax(kind)}, batch)
    return jax.tree_util.tree_map(np.asarray, g["params"])


def _reference_round(name):
    """The JAX package's manual-TP round of ROUNDS[name] on its CPU mesh:
    (flax params, loss sums, eval [loss, accuracy, n])."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.parallel.kavg import KAvgEngine
    from kubeml_tpu.parallel.mesh import make_mesh

    kind, n_model, n_seq, lanes, _, _ = ROUNDS[name]
    model = _ref_model(kind)
    model.enable_tensor_parallel()
    kw = {}
    if n_seq > 1:
        model.enable_seq_parallel("ring")
        kw["batch_seq_dims"] = model.seq_batch_dims
    mesh = make_mesh(n_data=lanes, n_model=n_model, n_seq=n_seq,
                     devices=jax.devices()[:lanes * n_model * n_seq])
    eng = KAvgEngine(mesh, model.loss, model.metrics,
                     lambda lr, e: optax.sgd(lr), donate=False,
                     manual_inner=True, **kw)
    batch, rngs = _round_batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out, stats = eng.train_round({"params": _flax(kind)}, jb, rngs=rngs,
                                 lr=LR, epoch=0, **MASKS)
    ev = eng.eval_round(out, jb, MASKS["sample_mask"])
    return (jax.tree_util.tree_map(np.asarray, out["params"]),
            np.asarray(stats.loss_sum),
            np.array([ev["loss"], ev["accuracy"], ev["n"]]))


def _reference_wire_ring(case):
    """The reference engine's _wire_ring on the case's mesh: the GSPMD
    route (data 2 x model 2, manual_inner False), the manual route
    (manual_inner True) and TP x SP (model 2 x seq 2, a seq round)."""
    import jax
    import optax

    from kubeml_tpu.parallel.kavg import KAvgEngine
    from kubeml_tpu.parallel.mesh import make_mesh

    n_model, n_seq, manual = WIRE_CASES[case]
    model = _ref_model("gpt")
    mesh = make_mesh(n_data=4 // (n_model * n_seq), n_model=n_model,
                     n_seq=n_seq, devices=jax.devices()[:4])
    return KAvgEngine(mesh, model.loss, model.metrics,
                      lambda lr, e: optax.sgd(lr), donate=False,
                      manual_inner=manual,
                      batch_seq_dims={"x": 0} if n_seq > 1
                      else None)._wire_ring


def _reference_job():
    """The JAX package's GSPMD n_model=2 job of the TinyGPT in f32 on a
    (data 2 x model 2) CPU mesh, warm-started from ``seedckpt``: its
    history's numbers."""
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
                        k=JOB_K, n_model=2, train_stats=False)
    task = TrainTask(job_id="ref-dp-tp-job", parallelism=2,
                     parameters=TrainRequest(
                         model_type="gpt-mini", batch_size=8, epochs=1,
                         dataset="pplm", lr=0.003, resume_from="seedckpt",
                         function_name="gpt-mini", options=opts))
    job = TrainJob(task, _ref_model("gpt"), Windows(),
                   make_mesh(n_data=4, devices=jax.devices()[:4]),
                   history_store=HistoryStore())
    record = job.train()
    assert job._tp_rules is not None and not job._manual_tp
    return {k: [float(v) for v in getattr(record.data, k)]
            for k in ("train_loss", "validation_loss", "accuracy",
                      "parallelism")}


def _launch_reference_job(outdir):
    """_reference_job in a process of its own (four virtual CPU devices,
    a copy of the job home), started without waiting. It writes
    ref-job.json."""
    from kubeml_tpu.testing import virtual_cpu_env

    home = os.path.join(outdir, "ref-job-home")
    shutil.copytree(os.path.join(outdir, "jobhome"), home)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "refjob", outdir],
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
    """Both launches and the reference's job started together; meanwhile
    the reference's layers, forwards, gradients and rounds and the port's
    one-process runs here. Returns {"pair": [2 rank dicts], "quad": [4],
    "jobs": {name: [rank histories]}, "ref": {...}, "single": {...}}."""
    import torch

    from kubeml_tpu.train.checkpoint import save_checkpoint

    outdir = str(tmp_path_factory.mktemp("tppar"))
    inits = {kind: _reference_init(kind) for kind in ("gpt", "bert")}
    for kind, tree in inits.items():
        np.savez(os.path.join(outdir, f"init_{kind}.npz"), **_flat(tree))
    home = os.path.join(outdir, "jobhome")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEML_TPU_HOME", home)
        _job_home(home)
        save_checkpoint("seedckpt", {"params": _flax("gpt")},
                        {"model": "gpt-mini", "function": "gpt-mini"})
        procs = {"pair": _launch("pair", 2, outdir),
                 "quad": _launch("quad", 4, outdir),
                 "ref-job": _launch_reference_job(outdir)}
        # the one-process jobs write into a home of their own: the quad
        # ranks copy the job home when they reach their jobs
        single_home = os.path.join(outdir, "single-home")
        shutil.copytree(home, single_home)
        mp.setenv("KUBEML_TPU_HOME", single_home)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        ref, single = {}, {}
        try:
            ref["layers"] = _reference_layers()
            for kind in ("gpt", "bert"):
                for dtype in ("f32", "bf16"):
                    ref[f"fwd/{kind}/{dtype}"] = _reference_forward(
                        kind, dtype, _flax(kind) if dtype == "f32"
                        else inits[kind])
                    single[f"fwd/{kind}/{dtype}"] = _forward(
                        kind, dtype, False, outdir)
                ref[f"grad/{kind}"] = _reference_grads(kind)
                single[f"grad/{kind}"] = _grads(kind, False)
            for name in REF_ROUNDS:
                ref[name] = _reference_round(name)
            for case in WIRE_CASES:
                ref[f"wire/{case}"] = _reference_wire_ring(case)
            for name in ("tp-drop-gpt", "tp-drop-bert"):
                single[name] = _port_round(name, one_process=True)
            for kind in ("gpt", "bert"):
                single[f"cli-{kind}"] = _cli_job(f"cli-{kind}-gspmd",
                                                 one_process=True)
            single["bert-m4"] = _bert_m4_job(1)
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
    jobs = {}
    for mode, world in (("pair", 2), ("quad", 4)):
        for r in range(world):
            with open(os.path.join(outdir, f"{mode}_jobs_p{r}.json")) as f:
                for name, hist in json.load(f).items():
                    jobs.setdefault(name, []).append(hist)
    with open(os.path.join(outdir, "ref-job.json")) as f:
        ref["dp-tp-job"] = json.load(f)
    return {"pair": [load(f"pair_p{r}.npz") for r in range(2)],
            "quad": [load(f"quad_p{r}.npz") for r in range(4)],
            "jobs": jobs, "ref": ref, "single": single}


def _weights(rank_out, name):
    pre = f"{name}/w/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


def _within(have, want, rtol=TOL, atol=TOL):
    """Every leaf of two port state dicts within (rtol, atol)."""
    return set(have) == set(want) and all(
        np.allclose(have[k], want[k], rtol=rtol, atol=atol) for k in want)


def _to_flax(kind, state):
    import torch

    return _port_model(kind).params_to_flax(
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


def _rank_grads(rank_out, kind):
    pre = f"grad/{kind}/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layer", ["q", "out", "Dense_0", "Dense_1"])
def test_layers_match_the_references_layers(runs, layer, dtype):
    """Each Megatron layer over two model ranks equals the reference's in
    a shard_map over a 2-device model axis (the column layers' local
    outputs concatenated over the ranks): f32 within 1e-5, bf16 within
    5e-2/2e-2; the row layers' outputs equal on both ranks bit for
    bit."""
    ranks = [r[f"layer/{dtype}/{layer}"] for r in runs["pair"]]
    want = runs["ref"]["layers"][f"{dtype}/{layer}"]
    if layer in ("q", "Dense_0"):
        got = np.concatenate(ranks, axis=-2 if layer == "q" else -1)
    else:
        np.testing.assert_array_equal(ranks[1], ranks[0])
        got = ranks[0]
    assert got.shape == want.shape
    rtol, atol = (TOL, TOL) if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_tp_forward_matches_dense_and_the_reference(runs, kind, dtype):
    """The tensor-parallel forward over two model ranks (bert-tiny: one
    head a rank) equals the port's dense forward (f32 within 1e-5, bf16
    within the reference's own TP-against-dense 5e-2/2e-2) and the
    reference's manual-TP forward (f32 within 1e-5; bf16 within 2e-2 of
    the logits' largest magnitude, the frameworks summing bf16 products
    in another order); both ranks bit for bit."""
    key = f"fwd/{kind}/{dtype}"
    ranks = [r[key] for r in runs["pair"]]
    np.testing.assert_array_equal(ranks[1], ranks[0])
    rtol, atol = (TOL, TOL) if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(ranks[0], runs["single"][key], rtol=rtol,
                               atol=atol)
    if dtype == "f32":
        np.testing.assert_allclose(ranks[0], runs["ref"][key], rtol=TOL,
                                   atol=TOL)
    else:
        want = runs["ref"][key]
        assert np.abs(ranks[0] - want).max() \
            <= BF16_LOGIT_SHARE * np.abs(want).max()


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_tp_gradients_match_dense_and_the_reference(runs, kind):
    """The inner-summed tensor-parallel gradients (each model rank
    backpropagating half the loss) equal the port's dense gradients and
    the reference's manual-TP gradients within f32 1e-5, on both
    ranks."""
    flat_dense = _flat(runs["single"][f"grad/{kind}"])
    flat_want = _flat(runs["ref"][f"grad/{kind}"])
    assert set(flat_dense) == set(flat_want)
    for r in runs["pair"]:
        got = _rank_grads(r, kind)
        assert set(got) == set(flat_want)
        for path, g in got.items():
            np.testing.assert_allclose(g, flat_dense[path], rtol=TOL,
                                       atol=TOL, err_msg=path)
            np.testing.assert_allclose(g, flat_want[path], rtol=TOL,
                                       atol=TOL, err_msg=path)
    assert max(np.abs(v).max() for v in flat_want.values()) > 1e-3


@pytest.mark.parametrize("name", list(REF_ROUNDS))
def test_rounds_match_the_references_rounds(runs, name):
    """(data 2 x model 2) of both models and (model 2 x seq 2) of the GPT:
    every rank holds the same merged state, loss sums and eval bit for
    bit, and the reference's manual-TP round within f32 1e-5."""
    ranks = runs["quad"]
    for r in range(1, 4):
        for k, v in ranks[0].items():
            if k.startswith(name + "/"):
                np.testing.assert_array_equal(ranks[r][k], v,
                                              err_msg=f"rank {r} {k}")
    want, loss, ev = runs["ref"][name]
    kind = ROUNDS[name][0]
    _assert_flax_close(_to_flax(kind, _weights(ranks[0], name)), want)
    np.testing.assert_allclose(ranks[0][f"{name}/loss"], loss, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ranks[0][f"{name}/eval"], ev, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["tp-drop-gpt", "tp-drop-bert"])
def test_dropout_round_matches_one_process(runs, name):
    """(data 1 x model 2), dropout 0.1: both model ranks draw the same
    masks and hold the same state bit for bit, and the one-process round
    within f32 1e-5."""
    ranks = runs["pair"]
    for k, v in ranks[0].items():
        if k.startswith(name + "/"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    state, loss, ev = runs["single"][name]
    assert _within(_weights(ranks[0], name), state)
    np.testing.assert_allclose(ranks[0][f"{name}/loss"], loss, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ranks[0][f"{name}/eval"], ev, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("mutant,launch,name,want", [
    ("identity-psum", "pair", "tp-drop-gpt-identity-psum", "tp-drop-gpt"),
    ("seq-sum", "quad", "tp-sp-gpt-seq-sum", "tp-sp-gpt")])
def test_gradient_mutants_fail_the_checks(runs, mutant, launch, name, want):
    """The checks above catch a broken gradient sum: a model psum whose
    backward is the identity (the split weights get 1/n of their
    gradient) and an inner round summing over the seq group only (the
    model axis left out): each misses the state it is held to by more
    than ten times the tolerance."""
    got = _weights(runs[launch][0], name)
    ref = (runs["single"][want][0] if launch == "pair"
           else _weights(runs["quad"][0], want))
    assert not _within(got, ref)
    assert max(float(np.abs(got[k] - ref[k]).max()) for k in ref) > 10 * TOL


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_ring_rule_matches_the_references_wire_ring(runs, case):
    """The engine takes the merge's ring where the reference's does: the
    GSPMD route (its inner axes stay AUTO) yes; the manual route and TP
    x SP (fully-manual rounds) no; on every rank."""
    want = runs["ref"][f"wire/{case}"]
    assert want == (case == "gspmd")
    for r in runs["quad"]:
        assert bool(r[f"wire/{case}"]) == want


def test_gspmd_job_matches_the_references_gspmd_job(runs):
    """(data 2 x model 2) under the GSPMD route, from the JAX-written
    checkpoint: the four ranks' histories equal, and the reference's
    n_model=2 job's (its variables Megatron-sharded) within its
    2e-2/2e-3."""
    hists = runs["jobs"]["dp-tp-job"]
    assert len(hists) == 4 and all(h == hists[0] for h in hists)
    want = runs["ref"]["dp-tp-job"]
    assert hists[0]["parallelism"] == want["parallelism"] == [2]
    for key in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(hists[0][key], want[key],
                                   rtol=JOB_TOL[0], atol=JOB_TOL[1],
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(CLI_JOBS))
def test_cli_tp_jobs_train_over_ranks(runs, name):
    """`kubeml train -f gpt-mini|bert-tiny --tensor-parallel 2` under
    both routes (two ranks) and `-f bert-tiny --tensor-parallel 2
    --seq-parallel 2` (four): every rank's history equal, the losses
    fall, and each epoch's within 2e-2 relative of the one-process
    job's."""
    launch, function, _ = CLI_JOBS[name]
    hists = runs["jobs"][name]
    assert len(hists) == {"pair": 2, "quad": 4}[launch]
    assert all(h == hists[0] for h in hists)
    want = runs["single"]["cli-gpt" if function == "gpt-mini"
                          else "cli-bert"]
    h = hists[0]
    assert h["parallelism"] == want["parallelism"]
    assert h["train_loss"][-1] < h["train_loss"][0]
    for key in ("train_loss", "validation_loss"):
        assert np.isfinite(h[key]).all()
        np.testing.assert_allclose(h[key], want[key], rtol=CLI_REL, atol=0,
                                   err_msg=key)


def test_indivisible_heads_train_whole_under_gspmd(runs):
    """bert-tiny at M = 4 under the GSPMD route: its 2 heads do not
    divide, so the attention pair runs whole on every rank while the
    FFN splits (shard_variables' fallback); the four ranks' histories
    equal, and the one-process f32 job's within 1e-3 relative."""
    hists = runs["jobs"]["bert-m4"]
    assert len(hists) == 4 and all(h == hists[0] for h in hists)
    want = runs["single"]["bert-m4"]
    for key in ("train_loss", "validation_loss"):
        np.testing.assert_allclose(hists[0][key], want[key], rtol=1e-3,
                                   atol=0, err_msg=key)


@pytest.mark.parametrize("name", ["gpt-mini", "bert-tiny"])
def test_tree_specs_and_plan_match_the_references(name):
    """tree_specs over the port's flax tree equals the reference's on
    every leaf; shard_plan splits a pair exactly where shard_variables
    keeps its leaves sharded (M = 2, and M = 4 where bert-tiny's 2 heads
    replicate)."""
    import jax
    import jax.numpy as jnp
    import torch

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.parallel.tp import shard_variables
    from kubeml_tpu.parallel.tp import tree_specs as ref_tree_specs
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel.tp import shard_plan, tree_specs

    ref_model = get_builtin(name)()
    x = jnp.ones((2, 16), jnp.int32)
    variables = ref_model.init_variables(jax.random.PRNGKey(0), {"x": x})
    model = get_model(name)()
    state = {k: torch.empty(v.shape) for k, v in
             model.build(device="meta").state_dict().items()}
    port_tree = model.params_to_flax(state)
    want = {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                ref_tree_specs(variables["params"], ref_model.tp_rules),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    got = {jax.tree_util.keystr(p): s for p, s in
           jax.tree_util.tree_leaves_with_path(
               tree_specs(port_tree, model.tp_rules),
               is_leaf=lambda s: isinstance(s, tuple))}
    assert got == want
    assert sum(1 for s in got.values() if s) == 10 * (
        4 if name == "gpt-mini" else 2)
    for n in (2, 4):
        mesh = make_mesh(n_data=8 // n, n_model=n)
        placed = shard_variables(variables["params"], mesh,
                                 ref_model.tp_rules)
        plan = shard_plan(port_tree, model.tp_rules, n)
        for layer, pairs in plan.items():
            sharded = {sub: bool(placed[layer][sub]["kernel"].sharding.spec)
                       for sub in ("q", "out", "Dense_0", "Dense_1")}
            assert pairs == {"heads": sharded["q"] and sharded["out"],
                             "ffn": sharded["Dense_0"]
                             and sharded["Dense_1"]}, (n, layer)
        assert all(p["heads"] == (name == "gpt-mini" or n == 2)
                   and p["ffn"] for p in plan.values())


def _paged_calls(port):
    """(name, call) of each paged builder on a tensor-parallel module:
    the reference's (``port`` False) or the port's."""
    from kubeml_tpu.parallel.mesh import MODEL_AXIS

    if port:
        from kubeml_tpu_torch.models import gpt
        tp = gpt.GPTModule(**GPT, device="meta", tp_axis=MODEL_AXIS)
        dense = gpt.GPTModule(**GPT, device="meta")
    else:
        from kubeml_tpu.models import gpt
        tp = gpt.GPTModule(**GPT, tp_axis=MODEL_AXIS)
        dense = gpt.GPTModule(**GPT)
    return {"decode": lambda: gpt.build_paged_decode_step(tp),
            "prefill": lambda: gpt.build_paged_prefill_step(tp, 8),
            "multi": lambda: gpt.build_paged_multi_step_decode(tp, 2),
            "verify": lambda: gpt.build_paged_spec_verify_step(dense, tp,
                                                               2, 4)}


@pytest.mark.parametrize("builder", ["decode", "prefill", "multi", "verify"])
def test_paged_builders_refuse_a_tp_module(builder):
    """The serving programs take dense GPT modules only: each paged
    builder refuses a tensor-parallel module (the speculative verify: a
    tensor-parallel draft) with the reference's ValueError and message."""
    with pytest.raises(ValueError) as want:
        _paged_calls(False)[builder]()
    with pytest.raises(ValueError) as got:
        _paged_calls(True)[builder]()
    assert str(got.value) == str(want.value)
    assert "manual-TP" in str(got.value)


# the job's 400s, in the reference's order (kubeml_tpu/train/job.py)
REFUSALS = {
    "pipeline-first": (dict(n_model=2, n_stage=2), 4, "gpt",
                       "--pipeline-parallel composes with --expert-parallel "
                       "only (the pipelined trunk owns the layer split that "
                       "--tensor-parallel/--seq-parallel would reshard)"),
    "syncdp": (dict(engine="syncdp", n_model=2), 2, "gpt",
               "tensor/sequence/pipeline/expert parallelism requires the "
               "kavg engine"),
    "tp-impl": (dict(n_model=2, tp_impl="bogus"), 2, "gpt",
                "unknown tp_impl 'bogus'; expected 'gspmd' or 'manual'"),
    "tp-impl-seq": (dict(n_seq=2, tp_impl="bogus"), 2, "gpt",
                    "unknown tp_impl 'bogus'; expected 'gspmd' or "
                    "'manual'"),
    "ulysses": (dict(n_model=2, n_seq=2, seq_impl="ulysses"), 4, "gpt",
                "tensor parallelism composes with seq_impl='ring' only "
                "(ulysses re-shards the head axis the TP split owns)"),
    "world": (dict(n_model=2), 1, "gpt",
              "1 devices not divisible by the requested model x seq x "
              "stage x expert factor 2"),
    "world-tp-sp": (dict(n_model=2, n_seq=2), 2, "gpt",
                    "2 devices not divisible by the requested model x seq "
                    "x stage x expert factor 4"),
    "manual-mlp": (dict(n_model=2, tp_impl="manual"), 2, "mlp",
                   "function 'mlp' does not support manual tensor "
                   "parallelism"),
    "manual-moe": (dict(n_model=2, tp_impl="manual"), 2, "moe",
                   "gpt-moe-mini does not support tensor parallelism (the "
                   "Megatron split would leave the expert FFNs — the bulk "
                   "of the params — replicated); use expert parallelism "
                   "(ep_mesh) for this family"),
    "tp-sp-forces-manual": (dict(n_model=2, n_seq=2), 4, "mlp",
                            "function 'mlp' does not support manual tensor "
                            "parallelism"),
    "manual-geometry": (dict(n_model=4, tp_impl="manual"), 4, "bert",
                        "2 attention heads do not divide over a 4-way "
                        "model axis"),
    "gspmd-mlp": (dict(n_model=2), 2, "mlp",
                  "function 'mlp' does not publish tensor-parallel "
                  "sharding rules"),
    "gspmd-moe": (dict(n_model=2), 2, "moe",
                  "function 'gpt-moe-mini' does not publish "
                  "tensor-parallel sharding rules"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_tp_job_refusals_in_reference_order(tmp_path, monkeypatch, case):
    """Each misconfiguration fails the job with the reference's 400 and
    wording, before any data is trained; the world is one device
    without a group, and a stated size where a case needs the later
    checks. Pipeline parallelism with tensor (or sequence) parallelism is
    the reference's first 400."""
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.api.types import TrainOptions
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPTMoEMini
    from kubeml_tpu_torch.parallel import distributed as dl
    from test_torch_seq_parallel import _job, _job_task, _token_home

    opts, world, kind, message = REFUSALS[case]
    reg = _token_home(str(tmp_path))
    monkeypatch.setattr(dl, "world_size", lambda: world)
    model = {"mlp": lambda: get_model("mlp")(hidden=8, num_classes=2),
             "moe": GPTMoEMini, "bert": lambda: _port_model("bert"),
             "gpt": lambda: _port_model("gpt")}[kind]()
    task = _job_task("refused", **opts)
    if kind in ("moe", "mlp"):
        task.parameters.model_type = {"moe": "gpt-moe-mini",
                                      "mlp": "mlp"}[kind]
    job = _job(task, reg, model)
    with pytest.raises(KubeMLException) as e:
        job.train()
    assert e.value.status_code == 400
    assert e.value.message == message
    if case == "pipeline-first":
        with pytest.raises(KubeMLException) as e:
            job._inner_axes(TrainOptions(n_seq=2, n_stage=2))
        assert e.value.message == message


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("batch,t_len,causal", [(32, 64, False),
                                                (8, 512, True)])
def test_local_head_kernels_match_plain_on_card(cuda_device, heads, batch,
                                                t_len, causal):
    """On the card, at the local head counts tensor parallelism gives the
    flash kernels (bert-tiny's 2 heads and gpt-mini's 4 over M = 2: 1 and
    2 a rank; bert-tiny's [32, 64] not causal, gpt-mini's [8, 512]
    causal; bf16, a padded tail and a fully padded sequence): #2-#4 each
    against its plain version within the flash tolerance 2e-2, one
    launch each, and a second launch equal to the first bit for bit."""
    import torch

    from kubeml_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(heads * t_len)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (batch, t_len, heads, 64)).astype(np.float32)).to(
            cuda_device, torch.bfloat16) for _ in range(4))
    lengths = np.linspace(t_len, 0, batch).astype(np.int64)
    pad = torch.from_numpy((np.arange(t_len)[None, :] < lengths[:, None])
                           .astype(np.float32)).to(cuda_device)
    tol = 2e-2
    before = [kern.launches for kern in (fa.fa_fwd_kernel,
                                         fa.fa_bwd_dkv_kernel,
                                         fa.fa_bwd_dq_kernel)]
    out, m, l = fa.fa_fwd_kernel(q, k, v, pad, causal)
    delta = fa._delta(g, out)
    bwd = (q, k, v, pad, g, m, l, delta, causal)
    dk, dv = fa.fa_bwd_dkv_kernel(*bwd)
    dq = fa.fa_bwd_dq_kernel(*bwd)
    torch.cuda.synchronize()
    assert [kern.launches for kern in (fa.fa_fwd_kernel,
                                       fa.fa_bwd_dkv_kernel,
                                       fa.fa_bwd_dq_kernel)] == [
        n + 1 for n in before]
    for got, want in (((out, m, l), fa._fa_forward_plain(q, k, v, pad,
                                                         causal)),
                      ((dk, dv), fa._fa_bwd_dkv_plain(*bwd)),
                      ((dq,), (fa._fa_bwd_dq_plain(*bwd),))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol)
    again = (*fa.fa_fwd_kernel(q, k, v, pad, causal),
             *fa.fa_bwd_dkv_kernel(*bwd), fa.fa_bwd_dq_kernel(*bwd))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((out, m, l, dk, dv, dq),
                                                 again))


def test_grid_layout_and_groups_in_one_process():
    """Without a group every axis has size 1 and the grid of one process
    is one data index of one model rank; a grid that does not split is
    refused naming its model, seq and expert sizes."""
    from kubeml_tpu_torch.parallel import distributed as dl

    grid = dl.make_grid(1, 1, 1)
    assert (grid.n_data, grid.n_model, grid.n_inner) == (1, 1, 1)
    assert (dl.axis_size("model"), dl.axis_index("model")) == (1, 0)
    assert dl.axis_group("model") is None
    with pytest.raises(ValueError, match="inner groups of 2 model x 1 seq "
                                         "x 1 expert ranks"):
        dl.make_grid(1, 1, 2)


if __name__ == "__main__":
    import faulthandler

    faulthandler.dump_traceback_later(600, repeat=True)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    mode, outdir = sys.argv[1], sys.argv[2]
    if mode == "refjob":
        hist = _reference_job()
        with open(os.path.join(outdir, "ref-job.json"), "w") as f:
            json.dump(hist, f)
    else:
        import torch

        from kubeml_tpu_torch.parallel import distributed as dist_lib

        torch.set_num_threads(1)
        dist_lib.initialize(device="cpu", timeout=600)
        WORKERS[mode](outdir)
        print(f"{mode} rank {dist_lib.rank()} OK", flush=True)
