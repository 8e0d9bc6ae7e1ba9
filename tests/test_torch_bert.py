"""Port parity: BERT-tiny (kubeml_tpu_torch/models/bert.py) against the
JAX package's (kubeml_tpu/models/bert.py), on the CPU, at a small vocab
(200) and T = 16 with BERT-tiny's other widths (hidden 128, 2 layers, 2
heads of 64, FFN 512).

The same numpy token ids and the same flax parameters (the JAX
initializers from a fixed key, carried across by
``convert.bert_params_from_flax``) drive both packages; the JAX side runs
its ``attn_impl="flash"`` path (Pallas in interpret mode; T = 16 tiles)
and its ``"reference"`` path.

Tolerances:
  - logits and block outputs: f32 1e-5, bf16 2e-2 (the frameworks sum
    matmuls and softmaxes in other orders; bf16 rounds each layer);
  - padding invariance 1e-5 (masked positions must not leak at all);
  - a K-avg round (f32, dropout 0, AdamW): counts exactly, loss sums
    1e-5, merged parameters within AdamW's bound 2·K·lr for every
    element and 1e-5 for all but 0.5 % (the bound of
    tests/test_torch_train.py: AdamW's first steps divide each gradient
    element by its own magnitude).
"""

import numpy as np
import pytest
import torch

# JAX is imported inside the tests only: the `gpu` tests run on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

VOCAB, T = 200, 16
# the job's answer to --seq-parallel 2 in one process (the reference's)
SEQ_WORLD_400 = ("1 devices not divisible by the requested model x seq x "
                 "stage x expert factor 2")
W, S, B = 2, 2, 4
LR = 1e-3
TOL = {"f32": 1e-5, "bf16": 2e-2}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """Beside other test workers more intra-op threads only oversubscribe
    the cores; one keeps the CPU sums in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tokens(seed, n=4, t=T, vocab=VOCAB):
    """Token ids with a ragged pad tail, interior pads and one all-pad
    row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (n, t)).astype(np.int32)
    x[0, t - 6:] = 0
    x[1, 3:6] = 0
    x[n - 1] = 0
    return x


def text_task(rng, shape, num_classes, vocab=VOCAB):
    """Learnable synthetic text (tests/test_models_text.py's): class c
    sequences are dominated by token ids in [10 + 20 c, 30 + 20 c), then
    a pad tail."""
    y = rng.integers(0, num_classes, shape).astype(np.int32)
    x = rng.integers(10, vocab, shape + (T,)).astype(np.int32)
    band = 10 + y[..., None] * 20
    x[..., :10] = band + rng.integers(0, 20, shape + (10,))
    x[..., 12:] = 0
    return x, y


def round_inputs(num_classes, seed=0):
    """A round's batch with a padded example, a masked step and worker
    masks of ones."""
    rng = np.random.default_rng(seed)
    x, y = text_task(rng, (W, S, B), num_classes)
    smask = np.ones((W, S, B), np.float32)
    smask[0, 1, 3] = 0.0
    stmask = np.ones((W, S), np.float32)
    stmask[1, 1] = 0.0
    rngs = rng.integers(0, 2 ** 32, (W, S, 2), dtype=np.uint32)
    return {"x": x, "y": y}, smask, stmask, np.ones(W, np.float32), rngs


def leaves(tree):
    import jax

    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def assert_round_close(ref, got, tmodel, k_steps, lr=LR):
    """Counts exactly, loss sums 1e-5, merged parameters within the
    adaptive optimizer's 2·K·lr bound (99.5 % within 1e-5)."""
    (jvars, jst), (tvars, tst) = ref, got
    np.testing.assert_array_equal(tst.step_count, jst.step_count)
    np.testing.assert_array_equal(tst.sample_count, jst.sample_count)
    np.testing.assert_array_equal(tst.dropped, np.asarray(jst.dropped))
    assert tst.contributors == jst.contributors
    np.testing.assert_allclose(tst.loss_sum, np.asarray(jst.loss_sum),
                               rtol=1e-5, atol=1e-5)
    diffs = np.concatenate([
        np.abs(a - b).ravel() for a, b in
        zip(leaves(tmodel.params_to_flax(tvars)), leaves(jvars["params"]))])
    assert diffs.max() <= 2 * k_steps * lr, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()


def round_both(jmodel, tmodel, params, args):
    """One train_round of the JAX engine and of the port's on the same
    parameters and batch."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    jeng = JaxEngine(make_mesh(n_data=1), jmodel.loss, jmodel.metrics,
                     jmodel.configure_optimizers, donate=False)
    jvars, jst = jeng.train_round(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)}, *args,
        lr=LR, epoch=0)
    module = tmodel.build(device="cpu")
    teng = KAvgEngine(module, tmodel.loss, tmodel.metrics,
                      tmodel.configure_optimizers)
    tvars, tst = teng.train_round(tmodel.params_from_flax(params), *args,
                                  lr=LR, epoch=0)
    return (jax.tree_util.tree_map(np.asarray, jvars), jst), (tvars, tst)


# ------------------------------------------------------------ the models
def jax_bert(dtype="f32", impl="reference", dropout=0.0):
    """The JAX package's BertTiny at the test vocab."""
    import jax.numpy as jnp

    from kubeml_tpu.models.bert import BertModule as JaxModule
    from kubeml_tpu.models.bert import BertTiny as JaxTiny

    model = JaxTiny()
    model._module = JaxModule(
        vocab_size=VOCAB, dropout=dropout, attn_impl=impl,
        flash_interpret=True,
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    return model


def port_bert(dtype="f32", dropout=0.0):
    """The port's BertTiny at the test vocab."""
    from kubeml_tpu_torch.models.bert import BertModule, BertTiny

    class Small(BertTiny):
        def build(self, dtype=None, device=None):
            return BertModule(vocab_size=VOCAB, dropout=dropout,
                              dtype=dtype or self.dtype, device=device)

    return Small(dtype=TORCH_DT[dtype])


def bert_params(seed=0):
    """The JAX initializers' BERT tree at the test vocab, as numpy, with
    numpy noise on the biases and LayerNorms so every parameter carries
    signal."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.bert import BertModule as JaxModule

    v = JaxModule(vocab_size=VOCAB).init(jax.random.PRNGKey(seed),
                                         jnp.ones((1, T), jnp.int32))
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "bias" in name or "scale" in name:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(noisy, v["params"])


def port_module(params, dtype="f32", device="cpu", dropout=0.0):
    module = port_bert(dtype, dropout).build(device=device)
    module.load_state_dict(port_bert().params_from_flax(params))
    return module


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_encoder_block_matches_jax(impl, dtype):
    """One EncoderBlock (eval) over the same hidden states and keep-mask:
    the port's (flash's plain version on the CPU) against the
    reference's flash (interpret) and reference paths."""
    import jax.numpy as jnp

    from kubeml_tpu.models.bert import EncoderBlock as JaxBlock

    params = bert_params(1)
    x = tokens(2)
    mask = (x != 0).astype(np.float32)
    h = np.random.default_rng(3).standard_normal(
        (x.shape[0], T, 128)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    ref = JaxBlock(128, 2, 512, 0.0, jdt, attn_impl=impl,
                   flash_interpret=True).apply(
        {"params": params["layer_0"]}, jnp.asarray(h).astype(jdt),
        jnp.asarray(mask), False)
    block = port_module(params, dtype).blocks[0]
    with torch.no_grad():
        got = block(torch.from_numpy(h).to(TORCH_DT[dtype]),
                    torch.from_numpy(mask))
    want = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_bert_logits_match_jax(impl, dtype):
    """BertModule's logits (eval) with a pad tail, interior pads and an
    all-pad row, against the reference module's."""
    import jax.numpy as jnp

    params = bert_params(0)
    x = tokens(0)
    ref = jax_bert(dtype, impl).module.apply({"params": params},
                                             jnp.asarray(x))
    got = port_module(params, dtype)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_padding_invariance_and_finite_all_pad_rows():
    """tests/test_models_text.py's invariance on the port: position
    embeddings past the pad boundary changed by +100 leave the logits
    unchanged (1e-5, bf16 as the reference runs it); an all-pad batch
    gives finite logits."""
    params = bert_params(0)
    x = tokens(4, n=2)
    x[:, 8:] = 0
    module = port_module(params, "bf16")
    base = module(torch.from_numpy(x)).detach()
    with torch.no_grad():
        module.pos_embed.weight[8:] += 100.0
    out = module(torch.from_numpy(x)).detach()
    torch.testing.assert_close(out, base, rtol=1e-5, atol=1e-5)
    allpad = module(torch.zeros_like(torch.from_numpy(x))).detach()
    assert bool(allpad.isfinite().all())


def test_max_len_guard():
    """A sequence past max_len raises the model's input error, a
    ValueError naming max_len, as the reference's guard does."""
    from kubeml_tpu_torch.models.base import InferenceInputError

    module = port_module(bert_params(0))
    with pytest.raises(InferenceInputError, match="max_len"):
        module(torch.ones((1, 200), dtype=torch.int32))
    assert issubclass(InferenceInputError, ValueError)


def _seq_logits(path):
    """(the dense module's logits, the sequence- or tensor-parallel
    path's) of one batch in one process, where the seq and model axes
    have size 1: the path builds and runs the same forward on the same
    parameters."""
    from kubeml_tpu_torch.models.bert import BertModule, BertTiny

    torch.manual_seed(0)
    dense = BertModule(vocab_size=VOCAB, dropout=0.0, dtype=torch.float32,
                       device="cpu")
    x = torch.from_numpy(tokens(4))
    kw = {"seq_axis": dict(seq_axis="seq"),
          "seq_impl": dict(seq_axis="seq", seq_impl="ulysses"),
          "tp_axis": dict(tp_axis="model")}.get(path)
    if kw is not None:
        sp = BertModule(vocab_size=VOCAB, dropout=0.0, dtype=torch.float32,
                        device="cpu", **kw)
        sp.load_state_dict(dense.state_dict())
        return dense(x), sp(x)
    model = BertTiny(torch.float32)
    if path in ("enable_seq_parallel", "enable_tensor_parallel"):
        if path == "enable_seq_parallel":
            model.enable_seq_parallel("ring")
        else:
            model.enable_tensor_parallel()
        built = model.build(device="cpu")
        assert (built.seq_axis, built.seq_impl, built.tp_axis) == (
            ("seq", "ring", None) if path == "enable_seq_parallel"
            else (None, "ring", "model"))
        big = BertModule(dtype=torch.float32, device="cpu", dropout=0.1)
        built.load_state_dict(big.state_dict())
        return big(x), built(x)
    return dense(x), model.forward_seq_parallel(dense, x.numpy())


SEQ_PATHS = ("seq_axis", "seq_impl", "enable_seq_parallel",
             "forward_seq_parallel", "tp_axis", "enable_tensor_parallel")
# every parallel path of the reference's BertTiny, each ported: path ->
# the ROADMAP item that brought it
REFUSED = {
    "seq_axis": "A.6", "seq_impl": "A.6", "tp_axis": "A.12",
    "enable_seq_parallel": "A.6", "forward_seq_parallel": "A.6",
    "enable_tensor_parallel": "A.12", "enable_pipeline_parallel": "A.12",
}


def _pipelined_loss():
    """(the dense loss, the pipelined one) of one batch in one process at
    dropout 0, where the stage axis has size 1: the pipelined loss runs
    its microbatches through every block in turn (sequential_apply)."""
    from kubeml_tpu_torch.models.bert import BertModule, BertTiny

    torch.manual_seed(0)
    dense = BertModule(vocab_size=VOCAB, dropout=0.0, dtype=torch.float32,
                       device="cpu")
    batch = {"x": torch.from_numpy(tokens(4)),
             "y": torch.tensor([0, 1, 1, 0])}
    model = BertTiny(torch.float32)
    gen, mask = torch.Generator().manual_seed(0), torch.ones(4)
    want = model.loss(dense, batch, gen, mask)
    model.enable_pipeline_parallel(2)
    assert model._pp_microbatches == 4
    return want, model.loss(dense, batch, gen, mask)


@pytest.mark.parametrize("path", sorted(REFUSED))
def test_parallel_paths_refuse_naming_their_item(path):
    """Every parallel path of the reference's BertTiny is ported and no
    longer refuses: the sequence- and tensor-parallel paths build and run,
    giving the dense logits where the seq and model axes have size 1, and
    the pipeline-parallel path's loss equals the dense loss where the
    stage axis has size 1 (tests/test_torch_seq_parallel.py,
    tests/test_torch_tensor_parallel.py and
    tests/test_torch_pipeline_parallel.py run them over ranks)."""
    assert REFUSED[path] in ("A.6", "A.12")
    if path in SEQ_PATHS:
        want, got = _seq_logits(path)
        assert got.shape == want.shape == (4, 2)
        torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)
        return
    want, got = _pipelined_loss()
    assert got.shape == want.shape == (4,)
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)


def test_convert_round_trip_and_leaf_order():
    """bert_params_{from,to}_flax invert each other exactly, and the
    port's state names sort into the flax flatten order, so the merge's
    buckets hold the reference's leaves; the 4 MB plan of the full model
    equals the reference's."""
    import jax

    from kubeml_tpu.models.bert import BertModule as JaxModule
    from kubeml_tpu.parallel.merge import plan_buckets as ref_plan
    from kubeml_tpu_torch.convert import flax_leaf_order
    from kubeml_tpu_torch.models.bert import BertTiny
    from kubeml_tpu_torch.parallel.merge import plan_buckets

    params = bert_params(0)
    model = port_bert()
    sd = model.params_from_flax(params)
    back = model.params_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(leaves(back), leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    order = flax_leaf_order(sd)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [sd[n].numel() for n in order] == [a.size for _, a in flat]
    # the full model's 4 MB bucket plan
    full = JaxModule().init(jax.random.PRNGKey(0),
                            np.ones((1, 8), np.int32))["params"]
    want = ref_plan(jax.tree_util.tree_leaves(full), 4.0)
    module = BertTiny().build(device="cpu")
    state = dict(module.named_parameters())
    got = plan_buckets([state[n] for n in flax_leaf_order(state)], 4.0)
    assert got.n_leaves == want.n_leaves == len(state)
    assert [(b.indices, b.sizes, b.length, b.compressible)
            for b in got.buckets] == \
        [(tuple(b.indices), tuple(b.sizes), b.length, b.compressible)
         for b in want.buckets]


# ------------------------------------------------------- training and jobs
@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_kavg_round_matches_jax(impl):
    """One K=2 round of W=2 workers (f32, dropout 0, AdamW with weight
    decay 0.01), a padded example and a masked step: counts exactly,
    loss sums 1e-5, merged weights within AdamW's 2·K·lr."""
    params = bert_params(0)
    ref, got = round_both(jax_bert("f32", impl), port_bert("f32"), params,
                          round_inputs(2))
    assert_round_close(ref, got, port_bert(), k_steps=S)


def text_registry(name, num_classes, n_train=64, n_test=32, seed=0,
                  vocab=VOCAB):
    """A registry dataset of int32 token ids [N, T] and int32 labels."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    rng = np.random.default_rng(seed)
    x, y = text_task(rng, (n_train + n_test,), num_classes, vocab)
    DatasetRegistry().create(name, x[:n_train], y[:n_train], x[n_train:],
                             y[n_train:])


def text_task_spec(pkg, job_id, model_type, lr=LR, epochs=1,
                   resume_from="", batch=8, **opts):
    types = __import__(f"{pkg}.api.types", fromlist=["TrainTask"])
    req = types.TrainRequest(
        model_type=model_type, batch_size=batch, epochs=epochs,
        dataset="toks", lr=lr, resume_from=resume_from,
        options=types.TrainOptions(default_parallelism=2,
                                   static_parallelism=True, k=2, **opts))
    return types.TrainTask(job_id=job_id, parameters=req, parallelism=2)


def check_checkpoints_both_ways(jmodel, tmodel, params, model_type):
    """A JAX-written checkpoint warm-starts the port's TrainJob (int token
    batches through the device cache); the port's final checkpoint is the
    JAX package's tree, read by its load_checkpoint, and the JAX module
    over it gives the port's logits."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu.train.checkpoint import save_checkpoint as ref_save
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint
    from kubeml_tpu_torch.train.job import TrainJob

    ref_save("seed", {"params": params}, {"model": model_type,
                                          "function": model_type})
    variables, _ = load_checkpoint("seed")
    x = tokens(5)
    warm = tmodel.module_from_flax(variables, device="cpu")
    want = jmodel.module.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(warm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    job = TrainJob(text_task_spec("kubeml_tpu_torch", "port-a", model_type,
                                  resume_from="seed"), tmodel,
                   KubeDataset("toks"), device="cpu")
    hist = job.train()
    assert job._device_cache is not None
    assert np.isfinite(hist.data.train_loss).all()
    tree, manifest = ref_load("port-a")
    assert manifest["completed"]
    assert jax.tree_util.tree_structure(tree["params"]) == \
        jax.tree_util.tree_structure(params)
    module = tmodel.module_from_flax(load_checkpoint("port-a")[0],
                                     device="cpu")
    ours = module(torch.from_numpy(x)).detach().numpy()
    theirs = jmodel.module.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree["params"])},
        jnp.asarray(x))
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)


def test_checkpoints_load_both_ways(tmp_home):
    text_registry("toks", 2)
    check_checkpoints_both_ways(jax_bert(), port_bert(), bert_params(0),
                                "bert-tiny")


def learns_on_port_engine(model, lr, num_classes):
    """tests/test_models_text.py's learning check on the port's engine:
    W=8 workers x S=2 steps of B=8 band-structured sequences, 6 rounds at
    the model's published widths; the mean loss falls and the eval
    accuracy beats chance."""
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    rng = np.random.RandomState(0)
    Wl, Sl, Bl = 8, 2, 8
    y = rng.randint(0, num_classes, size=Wl * Sl * Bl).astype(np.int32)
    x = rng.randint(10, VOCAB, size=(Wl * Sl * Bl, T)).astype(np.int32)
    for i in range(len(y)):
        band = 10 + y[i] * 20
        x[i, :10] = rng.randint(band, band + 20, size=10)
        x[i, 12:] = 0
    batch = {"x": x.reshape(Wl, Sl, Bl, T), "y": y.reshape(Wl, Sl, Bl)}
    module = model.init_module({"x": batch["x"][0, 0]},
                               torch.Generator().manual_seed(0),
                               device="cpu")
    engine = KAvgEngine(module, model.loss, model.metrics,
                        model.configure_optimizers)
    state = {k: v.detach().clone() for k, v in module.state_dict().items()}
    masks = dict(sample_mask=np.ones((Wl, Sl, Bl), np.float32),
                 step_mask=np.ones((Wl, Sl), np.float32),
                 worker_mask=np.ones(Wl, np.float32))
    first = last = None
    for _ in range(6):
        rngs = rng.randint(0, 2 ** 31, size=(Wl, Sl, 2)).astype(np.uint32)
        state, stats = engine.train_round(state, batch, rngs=rngs, lr=lr,
                                          epoch=0, **masks)
        last = stats.loss_sum.sum() / stats.step_count.sum()
        if first is None:
            first = last
    assert last < first, (first, last)
    out = engine.eval_round(state, batch, masks["sample_mask"])
    assert out["accuracy"] > 1.0 / num_classes, out


def test_bert_tiny_learns_on_the_port_engine():
    """bert-tiny at its published widths (vocab 30522, dropout 0.1)."""
    from kubeml_tpu_torch.models.bert import BertTiny

    learns_on_port_engine(BertTiny(), 1e-3, 2)


# ------------------------------------------------------ the job surface
@pytest.mark.parametrize("model_type", ["bert-tiny", "lstm"])
def test_cli_trains_and_infers_a_text_model(model_type, tmp_path, tmp_home,
                                            monkeypatch, capsys):
    """`kubeml train -f bert-tiny|lstm` parses as the reference's parser
    does (tests/test_cli.py:108), submits through the port's CLI and
    trains int token batches; `kubeml infer` answers with the model's
    classes; a sequence-parallel request is refused naming its item."""
    import json
    import time

    from kubeml_tpu.cli.main import build_parser as ref_parser
    from kubeml_tpu.models import get_builtin as get_ref
    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu_torch.cli.main import build_parser, main
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.train.history import HistoryStore

    argv = ["train", "-f", model_type, "-d", "toks", "-e", "1", "--lr",
            "0.001", "-b", "16", "-p", "2", "--static"]
    ours, theirs = (vars(p().parse_args(argv))
                    for p in (build_parser, ref_parser))
    assert ours.pop("fn").__name__ == theirs.pop("fn").__name__
    assert ours == theirs
    rng = np.random.default_rng(0)
    ncls = 2 if model_type == "bert-tiny" else 4
    x, y = text_task(rng, (96,), ncls)
    paths = {}
    for name, arr in (("xtr", x[:64]), ("ytr", y[:64]), ("xte", x[64:]),
                      ("yte", y[64:])):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    dep = start_deployment(device="cpu")
    monkeypatch.setenv("KUBEML_CONTROLLER_URL", dep.controller_url)

    def cli(*args):
        return main(["--controller", dep.controller_url] + list(args))
    try:
        cli("dataset", "create", "-n", "toks", "--traindata", paths["xtr"],
            "--trainlabels", paths["ytr"], "--testdata", paths["xte"],
            "--testlabels", paths["yte"])
        capsys.readouterr()
        # one process, no group: the job answers the reference's 400
        cli(*argv, "--seq-parallel", "2")
        refused = capsys.readouterr().out.strip()
        deadline = time.monotonic() + 120  # the PS starts it after the reply
        while refused not in dep.ps.errors:
            assert time.monotonic() < deadline, "the job did not fail"
            time.sleep(0.2)
        assert SEQ_WORLD_400 in dep.ps.errors[refused]
        assert "ROADMAP" not in dep.ps.errors[refused]
        cli(*argv)
        job_id = capsys.readouterr().out.strip()
        deadline = time.monotonic() + 240
        while not any(h.id == job_id for h in HistoryStore().list()):
            assert time.monotonic() < deadline, "no history"
            assert job_id not in dep.ps.errors, dep.ps.errors
            time.sleep(0.2)
        assert dep.ps.wait_for_job(job_id, timeout=60)
        hist = HistoryStore().get(job_id).data
        assert len(hist.train_loss) == 1
        assert np.isfinite(hist.train_loss).all()
        df = tmp_path / "infer.npy"
        np.save(df, x[:5])
        cli("infer", "-n", job_id, "--datafile", str(df))
        preds = json.loads(capsys.readouterr().out)
        # the reference's model over the same checkpoint, where its
        # margin is past bf16's rounding
        variables, _ = ref_load(job_id)
        ref_model = get_ref(model_type)()
        logits = np.asarray(ref_model.module.apply(variables, x[:5]))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 0.1
        assert len(preds) == 5
        np.testing.assert_array_equal(np.asarray(preds)[sure],
                                      logits.argmax(-1)[sure])
        if model_type == "bert-tiny":
            # an overlong sequence is the client's error, as in the
            # reference's PS: 400 naming max_len
            from kubeml_tpu_torch.control.client import KubemlClient

            with pytest.raises(Exception) as e:
                KubemlClient(dep.controller_url).v1().networks().infer(
                    job_id, np.ones((1, 200), np.int32).tolist())
            assert getattr(e.value, "status_code", None) == 400
            assert "max_len" in str(e.value)
        assert set(dep.ps.errors) == {refused}   # the --seq-parallel job
    finally:
        dep.stop()


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


def _plain_params(seed=0):
    """A numpy BERT tree at the test vocab without JAX (the card's machine
    has none): the port's flax-default init, through the bridge."""
    model = port_bert()
    module = model.init_module({"x": tokens(0)},
                               torch.Generator().manual_seed(seed),
                               device="cpu")
    return model.params_to_flax(module.state_dict())


@pytest.mark.gpu
def test_bert_forward_and_backward_on_card_match_cpu(cuda_device):
    """bf16 on the card (the non-causal flash kernels: one forward, one
    dK/dV and one dQ launch per layer) against the plain versions on the
    CPU: logits and every parameter gradient within 2e-2 (relative to the
    gradient's largest element), all-pad rows finite."""
    from kubeml_tpu_torch.ops import flash_attention as fa

    params = _plain_params()
    x = torch.from_numpy(tokens(6, n=8))
    out = {}
    for dev in ("cpu", cuda_device):
        module = port_module(params, "bf16", device=dev)
        f0, k0, q0 = (fa.fa_fwd_kernel.launches, fa.fa_bwd_dkv_kernel.launches,
                      fa.fa_bwd_dq_kernel.launches)
        logits = module(x)
        logits.float().square().sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (fa.fa_fwd_kernel.launches - f0,
                    fa.fa_bwd_dkv_kernel.launches - k0,
                    fa.fa_bwd_dq_kernel.launches - q0) == (2, 2, 2)
        out[str(dev)] = (logits.detach().float().cpu(),
                         {n: p.grad.float().cpu()
                          for n, p in module.named_parameters()})
    (la, ga), (lb, gb) = out["cpu"], out[str(cuda_device)]
    assert bool(lb.isfinite().all())
    torch.testing.assert_close(lb, la, rtol=2e-2, atol=2e-2)
    # bf16 gradients against the largest one: some are ~0 in exact math
    # (the k biases: softmax ignores a shift of every score of a row)
    scale = max(float(g.abs().max()) for g in ga.values())
    for n in ga:
        assert bool(gb[n].isfinite().all()), n
        assert float((gb[n] - ga[n]).abs().max()) <= 2e-2 * scale, n


@pytest.mark.gpu
def test_bert_round_on_card_matches_cpu(cuda_device):
    """f32, dropout 0: one K-avg round on the card (the flash kernels in
    f32 and the fused merge over 2 lanes) and on the CPU (their plain
    versions) within AdamW's 2·K·lr."""
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.ops.fused_merge import fused_merge_kernel
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = port_bert("f32")
    start = model.params_from_flax(_plain_params())
    batch, smask, stmask, wmask, rngs = round_inputs(2)
    out = {}
    for dev in ("cpu", cuda_device):
        engine = KAvgEngine(model.build(device=dev), model.loss,
                            model.metrics, model.configure_optimizers,
                            n_lanes=2, merge_bucket_mb=4.0)
        f0, m0 = fa.fa_bwd_dq_kernel.launches, fused_merge_kernel.launches
        out[str(dev)], _ = engine.train_round(
            {k: v.to(dev, copy=True) for k, v in start.items()}, batch,
            smask, stmask, wmask, rngs, LR, 0)
        if dev != "cpu":
            torch.cuda.synchronize()
            # 2 layers x the round's real steps (one step masked out)
            assert fa.fa_bwd_dq_kernel.launches - f0 == \
                2 * int(stmask.sum())
            assert fused_merge_kernel.launches > m0
    diffs = torch.cat([(out["cpu"][k] - out[str(cuda_device)][k].cpu())
                       .abs().flatten() for k in start])
    assert float(diffs.max()) <= 2 * S * LR
    assert float((diffs <= 1e-5).float().mean()) >= 0.995
