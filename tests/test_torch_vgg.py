"""Port parity: VGG-11 (kubeml_tpu_torch/models/vgg.py) against the JAX
package's (kubeml_tpu/models/vgg.py), on the CPU: the real convolution
widths with the Dense layers cut to hidden 64, batches of 2-4 images at
32x32 and at 64x64 (where the NHWC flatten decides Dense_0's rows); the
bucket plan and the CLI job at the published widths (hidden 4096, 100
classes).

The same flax variables (the JAX initializers from a fixed key, then
numpy noise at a trained network's scale, tests/test_torch_vision.py's
``_noisy``) and the same numpy images drive both packages.

Tolerances:
  - logits: f32 1e-5, bf16 2e-2 (atol = rtol);
  - one K-avg round (f32, dropout 0, SGD with momentum 0.9): counts and
    drop flags exactly, loss sums 1e-5 relative, merged parameters within
    1e-5 absolute (the bound of the port's SGD tests), the ledger's
    records equal;
  - bucket plans, leaf order and the checkpoint bridge exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_vision import _assert_trees_close, _leaves, _noisy

# JAX is imported inside the tests only: the `gpu` tests run on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

HIDDEN = 64
TOL = {"f32": 1e-5, "bf16": 2e-2}
W, S, B, LR = 2, 2, 2, 0.05


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes, whose thread pools would otherwise spin on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dtypes(name):
    import jax.numpy as jnp
    return ({"f32": jnp.float32, "bf16": jnp.bfloat16}[name],
            {"f32": torch.float32, "bf16": torch.bfloat16}[name])


def _images(seed, n, side):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32)


def _jax_vars(module, x, seed=1):
    """The reference's initializers, then the noise of _noisy."""
    import jax
    import jax.numpy as jnp

    init = jax.jit(lambda key: module.init(key, jnp.asarray(x)))
    return _noisy(init(jax.random.PRNGKey(seed)), seed + 1)


def _port_model(dropout=0.0, hidden=HIDDEN):
    """The port's VGG11 at the given Dense width and dropout, f32 compute
    (the built-in at hidden 4096, bf16 and dropout 0.5)."""
    from kubeml_tpu_torch.models import vgg as port

    class PortSmall(port.VGG11):
        def build(self, dtype=torch.float32, device=None):
            return port.VGGModule(
                num_classes=self.num_classes, hidden=hidden,
                dropout=dropout, in_channels=self.in_channels,
                features=self.features, dtype=dtype, device=device)

    return PortSmall()


def _models(dropout=0.0, hidden=HIDDEN):
    """The two packages' VGG11 at the given Dense width and dropout, f32
    compute."""
    import jax.numpy as jnp

    from kubeml_tpu.models import vgg as ref

    class JaxSmall(ref.VGG11):
        def build(self):
            return ref.VGGModule(num_classes=self.num_classes, hidden=hidden,
                                 dropout=dropout, dtype=jnp.float32)

    return JaxSmall(), _port_model(dropout, hidden)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("side", [32, 64])
def test_vgg_forward_matches_jax(side, dtype):
    """Eval-mode logits, and train-mode ones with dropout 0, of 2 images;
    at 64x64 the 2x2x512 feature map flattens in NHWC order (an NCHW
    flatten gives other numbers)."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.vgg import VGGModule as JaxVGG
    from kubeml_tpu_torch.convert import vision_params_from_flax
    from kubeml_tpu_torch.models.vgg import VGGModule, feature_size

    jdt, tdt = _dtypes(dtype)
    x = _images(side, 2, side)
    jmod = JaxVGG(hidden=HIDDEN, dropout=0.0, dtype=jdt)
    variables = _jax_vars(jmod, x)
    tmod = VGGModule(hidden=HIDDEN, dropout=0.0,
                     features=feature_size(side, side), dtype=tdt,
                     device="cpu")
    tmod.load_state_dict(vision_params_from_flax(variables))
    assert tmod.Dense_0.in_features == 512 * (side // 32) ** 2
    for train in (False, True):
        want = np.asarray(jax.jit(lambda v, x: jmod.apply(
            v, x, train=train))(variables, jnp.asarray(x)))
        got = tmod(torch.from_numpy(x), train=train,
                   generator=torch.Generator().manual_seed(0))
        assert got.dtype == torch.float32 and got.shape == (2, 100)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype])
    if side == 64 and dtype == "f32":
        # the same features in NCHW order land on other Dense_0 rows
        w = tmod.Dense_0.weight.detach()
        nchw = w.view(HIDDEN, 2, 2, 512).permute(0, 3, 1, 2).reshape(
            HIDDEN, -1)
        with torch.no_grad():
            tmod.Dense_0.weight.copy_(nchw)
            other = tmod(torch.from_numpy(x)).numpy()
        assert np.abs(other - want).max() > 1e-3


def _round(seed=0, side=32):
    """A round's images with learnable class means, a padded example, a
    masked step, worker masks of ones."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 100, (W, S, B)).astype(np.int32)
    x = rng.standard_normal((W, S, B, side, side, 3)).astype(np.float32)
    x[..., 0] += (y % 10)[..., None, None] / 5.0
    smask = np.ones((W, S, B), np.float32)
    smask[0, 1, 1] = 0.0
    stmask = np.ones((W, S), np.float32)
    stmask[1, 1] = 0.0
    rngs = rng.integers(0, 2 ** 32, (W, S, 2), dtype=np.uint32)
    return ({"x": x, "y": y}, smask, stmask, np.ones(W, np.float32), rngs)


def test_vgg_kavg_round_matches_jax():
    """One round (f32, dropout 0, SGD with momentum 0.9) of W=2 workers x
    2 steps of 2 images: counts and drops exactly, merged parameters
    within 1e-5, the ledger's records equal."""
    import json

    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    jmodel, tmodel = _models()
    args = _round()
    variables = _jax_vars(jmodel.module, args[0]["x"][0, 0])
    jeng = JaxEngine(make_mesh(n_data=1), jmodel.loss, jmodel.metrics,
                     jmodel.configure_optimizers, donate=False)
    jvars, jst = jeng.train_round(
        jax.tree_util.tree_map(jnp.asarray, variables), *args, lr=LR,
        epoch=0)
    module = tmodel.init_module({"x": args[0]["x"][0, 0]},
                                torch.Generator().manual_seed(0), "cpu")
    teng = KAvgEngine(module, tmodel.loss, tmodel.metrics,
                      tmodel.configure_optimizers)
    tvars, tst = teng.train_round(
        tmodel.params_from_flax(variables["params"]), *args, lr=LR, epoch=0)
    np.testing.assert_array_equal(tst.step_count, jst.step_count)
    np.testing.assert_array_equal(tst.sample_count, jst.sample_count)
    np.testing.assert_array_equal(tst.dropped, np.asarray(jst.dropped))
    assert tst.contributors == jst.contributors
    np.testing.assert_allclose(tst.loss_sum, np.asarray(jst.loss_sum),
                               rtol=1e-5)
    _assert_trees_close(tmodel.params_to_flax(tvars),
                        jax.tree_util.tree_map(np.asarray,
                                               jvars["params"]), 1e-5)
    # the round moved the weights past the tolerance
    assert np.abs(np.asarray(jvars["params"]["Dense_2"]["kernel"])
                  - variables["params"]["Dense_2"]["kernel"]).max() > 1e-3
    assert json.dumps(teng.ledger.snapshot()) == \
        json.dumps(jeng.ledger.snapshot())


def test_dropout_follows_the_engines_generator():
    """vgg11's loss draws its two dropouts from the generator the engine
    hands it: the same seed gives the same loss, another seed another,
    and the eval metrics none; LeNet's loss (no dropout) is the same
    under either generator."""
    from kubeml_tpu_torch.models.lenet import LeNet

    tmodel = _port_model(dropout=0.5)
    x = _images(0, 4, 32)
    batch = {"x": torch.from_numpy(x), "y": torch.tensor([1, 5, 7, 99])}
    module = tmodel.init_module({"x": x}, torch.Generator().manual_seed(0),
                                "cpu")

    def loss(model, module, seed):
        return model.loss(module, batch, torch.Generator().manual_seed(seed),
                          torch.ones(4)).detach()

    torch.testing.assert_close(loss(tmodel, module, 1),
                               loss(tmodel, module, 1), rtol=0, atol=0)
    assert not torch.equal(loss(tmodel, module, 1), loss(tmodel, module, 2))
    a, b = (tmodel.metrics(module, batch)["loss"] for _ in range(2))
    assert torch.equal(a, b)
    lenet = LeNet()
    batch = {"x": torch.rand(4, 28, 28, generator=torch.Generator()
                             .manual_seed(0)), "y": torch.tensor([1, 5, 7, 9])}
    lmod = lenet.init_module(batch, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(loss(lenet, lmod, 1), loss(lenet, lmod, 2))


def test_published_plan_leaf_order_and_round_trip():
    """At vgg11's published widths (hidden 4096, 100 classes, 32x32x3):
    the reference's tree, from shapes alone, loads strictly into the
    port's module and round trips exactly; flax_leaf_order is
    jax.tree_util's order; the 4 MB bucket plan equals the reference's,
    Dense_1's 16,777,216-element kernel a bucket of its own."""
    import jax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.merge import plan_buckets as ref_plan
    from kubeml_tpu_torch.convert import flax_leaf_order
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel.merge import BucketedMerge, plan_buckets

    sample = np.zeros((1, 32, 32, 3), np.float32)
    shapes = jax.eval_shape(lambda: get_builtin("vgg11")().init_variables(
        jax.random.PRNGKey(0), {"x": sample}))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        shapes)["params"]
    model = get_model("vgg11")()
    module = model.init_module({"x": sample},
                               torch.Generator().manual_seed(0), "cpu")
    sd = model.params_from_flax(params)
    module.load_state_dict(sd)             # strict: every name and shape
    assert sum(t.numel() for t in sd.values()) == 28_512_740
    back = model.params_to_flax(module.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(_leaves(back), _leaves(params)):
        np.testing.assert_array_equal(a, b)
    flat, tree = jax.tree_util.tree_flatten(params)
    tagged = model.params_from_flax(jax.tree_util.tree_unflatten(
        tree, [np.full(a.shape, i, np.float32) for i, a in enumerate(flat)]))
    order = flax_leaf_order(tagged)
    assert [int(tagged[n].reshape(-1)[0]) for n in order] == \
        list(range(len(flat)))
    want = ref_plan(flat, 4.0)
    got = plan_buckets([sd[n] for n in order], 4.0)
    assert [(b.indices, b.sizes, b.length, b.compressible)
            for b in got.buckets] == \
        [(tuple(b.indices), tuple(b.sizes), b.length, b.compressible)
         for b in want.buckets]
    assert max(b.length for b in got.buckets) == 4096 * 4096
    assert BucketedMerge(bucket_mb=4.0).comm_proxy(sd)[
        "buckets_per_round"] == want.n_buckets
    assert isinstance(model.configure_optimizers(0.05, 0)(
        [torch.zeros(2)]), torch.optim.SGD)


# ------------------------------------------------------------- the job
def _image_registry(n_train=32, n_test=16, side=32, seed=0):
    """u8 NHWC images whose class shifts channel 0's mean, labels
    0..99."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    rng = np.random.default_rng(seed)

    def split(n):
        y = rng.integers(0, 100, n).astype(np.int32)
        x = rng.integers(0, 150, (n, side, side, 3))
        x[..., 0] += y[:, None, None]
        return x.astype(np.uint8), y
    DatasetRegistry().create("images", *split(n_train), *split(n_test))
    return split(8)


def test_checkpoints_and_jobs_match_both_ways(tmp_home):
    """A JAX-written seed checkpoint warm-starts both packages' jobs (the
    small f32 VGG, one epoch at N = 2, K = 2, a bucketed merge): counts
    and losses agree, the port's job runs from its device cache, its
    final checkpoint is the JAX package's tree and warm-starts a JAX job
    in turn."""
    import jax

    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu.train.checkpoint import save_checkpoint as ref_save
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train import job as ref_job
    from test_torch_job import _assert_close, _run_both, _tasks
    from test_torch_vision import _image_dataset

    _image_registry()
    jmodel, _ = _models()
    seed_vars = _jax_vars(jmodel.module, np.zeros((1, 32, 32, 3),
                                                  np.float32))
    ref_save("seedckpt", {"params": seed_vars["params"]},
             {"model": "vgg11", "function": "vgg11"})
    tasks = _tasks("vgg", "vgg11", "images", epochs=1, batch=8, k=2, lr=LR,
                   merge_bucket_mb=0.5, train_stats=False)
    out = _run_both(tasks, lambda key: _models()[key == "port"],
                    _image_dataset)
    (r, _, _), (g, _, _) = out["ref"], out["port"]
    assert g.data.parallelism == r.data.parallelism == [2]
    _assert_close(g.data.train_loss, r.data.train_loss, 1e-5)
    _assert_close(g.data.validation_loss, r.data.validation_loss, 1e-5)
    assert g.data.accuracy == r.data.accuracy
    want, _ = ref_load(tasks["ref"].job_id)
    have, manifest = ref_load(tasks["port"].job_id)  # the JAX package reads
    assert manifest["completed"]
    # the epoch's rounds sum each conv bias's gradient over batch and
    # positions in another order: 1e-4 at lr 0.05 (the round alone: 1e-5)
    _assert_trees_close(have, want, 1e-4)
    ref_b = ref_job.TrainJob(
        _tasks("b", "vgg11", "images", epochs=1, batch=8, k=2, lr=LR,
               resume_from=tasks["port"].job_id, train_stats=False)["ref"],
        _models()[0], _image_dataset("ref"), make_mesh(n_data=1)).train()
    assert np.isfinite(ref_b.data.train_loss).all()
    assert jax.tree_util.tree_structure(ref_load("ref-b")[0]) == \
        jax.tree_util.tree_structure(want)


def test_cli_trains_and_infers_vgg11(tmp_path, tmp_home, monkeypatch,
                                     capsys):
    """`kubeml train -f vgg11` parses as the reference's parser does, is
    submitted through the port's CLI to a CPU deployment and trains the
    published widths on u8 CIFAR-100-shaped images (the raw pixels, as
    the built-in takes them); `kubeml infer` answers with the classes of
    the reference's module over the job's checkpoint where its margin is
    past bf16's rounding."""
    import json
    import time

    from kubeml_tpu.cli.main import build_parser as ref_parser
    from kubeml_tpu.models import get_builtin as get_ref
    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu_torch.cli.main import build_parser, main
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.train.history import HistoryStore

    argv = ["train", "-f", "vgg11", "-d", "cifar", "-e", "1", "--lr",
            "0.01", "-b", "8", "-p", "2", "--static"]
    ours, theirs = (vars(p().parse_args(argv))
                    for p in (build_parser, ref_parser))
    assert ours.pop("fn").__name__ == theirs.pop("fn").__name__
    assert ours == theirs
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (40, 32, 32, 3)).astype(np.uint8)
    y = rng.integers(0, 100, 40).astype(np.int32)
    paths = {}
    for name, arr in (("xtr", x[:32]), ("ytr", y[:32]), ("xte", x[32:]),
                      ("yte", y[32:])):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    dep = start_deployment(device="cpu")
    monkeypatch.setenv("KUBEML_CONTROLLER_URL", dep.controller_url)

    def cli(*args):
        return main(["--controller", dep.controller_url] + list(args))
    try:
        cli("dataset", "create", "-n", "cifar", "--traindata", paths["xtr"],
            "--trainlabels", paths["ytr"], "--testdata", paths["xte"],
            "--testlabels", paths["yte"])
        capsys.readouterr()
        cli(*argv)
        job_id = capsys.readouterr().out.strip()
        deadline = time.monotonic() + 240
        while not any(h.id == job_id for h in HistoryStore().list()):
            assert time.monotonic() < deadline, "no history"
            assert job_id not in dep.ps.errors, dep.ps.errors
            time.sleep(0.2)
        assert dep.ps.wait_for_job(job_id, timeout=60)
        hist = HistoryStore().get(job_id).data
        assert hist.parallelism == [2]
        assert np.isfinite(hist.train_loss).all()
        df = tmp_path / "infer.npy"
        np.save(df, x[:5])
        cli("infer", "-n", job_id, "--datafile", str(df))
        preds = json.loads(capsys.readouterr().out)
        variables, _ = ref_load(job_id)
        logits = np.asarray(get_ref("vgg11")().module.apply(variables, x[:5]))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 0.1
        assert len(preds) == 5
        np.testing.assert_array_equal(np.asarray(preds)[sure],
                                      logits.argmax(-1)[sure])
        assert dep.ps.errors == {}
    finally:
        dep.stop()


# ---------------------------------------------------------------- the card
def _cuda():
    if not torch.cuda.is_available():   # decided at run time, not import
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")


@pytest.mark.gpu
def test_vgg_forward_and_round_on_the_card_match_cpu():
    """The small VGG in f32 (cuDNN convolutions, TF32 off): eval logits at
    32x32 and 64x64 within 1e-4 of the CPU's; one round (SGD, momentum)
    within 1e-4."""
    _cuda()
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmodel = _port_model()
    for side in (32, 64):
        x = torch.from_numpy(_images(side, 4, side))
        mods = {dev: tmodel.init_module({"x": x.numpy()},
                                        torch.Generator().manual_seed(0), dev)
                for dev in ("cpu", "cuda")}
        mods["cuda"].load_state_dict(mods["cpu"].state_dict())
        torch.testing.assert_close(mods["cuda"](x.cuda()).cpu(),
                                   mods["cpu"](x), rtol=1e-4, atol=1e-4)
    args = _round()
    out = {}
    for dev in ("cpu", "cuda"):
        module = tmodel.init_module({"x": args[0]["x"][0, 0]},
                                    torch.Generator().manual_seed(0), dev)
        eng = KAvgEngine(module, tmodel.loss, tmodel.metrics,
                         tmodel.configure_optimizers)
        state = {k: v.detach().clone() for k, v in module.state_dict().items()}
        if dev == "cuda":
            state = {k: out["cpu_start"][k].to(dev) for k in state}
        else:
            out["cpu_start"] = {k: v.clone() for k, v in state.items()}
        out[dev], _ = eng.train_round(state, *args, lr=LR, epoch=0)
    diff = max(float((out["cuda"][k].cpu() - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    assert diff <= 1e-4, diff
