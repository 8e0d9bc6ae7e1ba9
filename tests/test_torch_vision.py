"""Port parity: the vision models (LeNet, the ResNets) of
kubeml_tpu_torch against the JAX package's, and their state (BatchNorm's
running statistics) through the port's K-avg round and its checkpoints.

The same flax variables (the JAX initializers from a fixed key, then
numpy noise from a seed so that zero-initialised scales and unit running
variances carry signal) and the same numpy inputs drive both packages.

Tolerances:
  - forward outputs and the running statistics after a train-mode
    forward: f32 within 1e-5, bf16 within 2e-2 (atol = rtol: the two
    frameworks sum convolutions and batch means in other orders, and bf16
    rounds each layer's output);
  - one K-avg round (f32, SGD with momentum and weight decay):
    step/sample/contributor counts and drop flags exactly, loss sums 1e-5
    relative, merged parameters and running statistics within 1e-5
    absolute (the bound the port's SGD job tests use);
  - bucket plans, leaf order and the checkpoint bridge exactly.
"""

import numpy as np
import pytest
import torch

# JAX is imported inside the tests only: the `gpu` test runs on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes, and the small convolutions here slow down many times over
    when every worker's thread pool spins on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TOL = {"f32": 1e-5, "bf16": 2e-2}


def _dtypes(name):
    import jax.numpy as jnp
    return ({"f32": jnp.float32, "bf16": jnp.bfloat16}[name],
            {"f32": torch.float32, "bf16": torch.bfloat16}[name])


# (stage_sizes, block, width, cifar_stem, H, B): a narrow ResNet with a
# stride-2 stage (SAME pads (0, 1) at stride 2), the non-CIFAR stem at
# 64x64 (7x7 stride 2 pads (2, 3), the SAME max-pool (0, 1)), and
# ResNet-18 at its published widths
RESNETS = {
    "narrow": ((1, 1), "BasicBlock", 8, True, 32, 4),
    "imagenet_stem": ((1, 1), "BottleneckBlock", 8, False, 64, 2),
    "resnet18": ((2, 2, 2, 2), "BasicBlock", 64, True, 32, 2),
}


def _jax_resnet(stages, block, width, stem, dtype):
    from kubeml_tpu.models import resnet as ref

    return ref.ResNetModule(stage_sizes=stages,
                            block=getattr(ref, block), width=width,
                            cifar_stem=stem, dtype=dtype)


def _noisy(variables, seed):
    """flax variables as numpy with noise from ``seed``, at the scale of
    a trained network's: kernels + 10 % of their own spread, scales
    1 + N(0, 0.1) (so the zero-initialised ones carry signal), biases
    N(0, 0.05), running means N(0, 0.1), running variances U(0.5, 1.5)."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "kernel":
            a = a + 0.1 * a.std() * rng.standard_normal(a.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif name == "bias":
            a = 0.05 * rng.standard_normal(a.shape)
        elif name == "mean":
            a = 0.1 * rng.standard_normal(a.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(variables))


def _jax_vars(module, x, seed=1):
    import jax
    import jax.numpy as jnp

    init = jax.jit(lambda key: module.init(key, jnp.asarray(x), train=False))
    return _noisy(init(jax.random.PRNGKey(seed)), seed + 1)


def _leaves(tree):
    import jax
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_trees_close(got, want, tol):
    import jax

    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), rtol=tol, atol=tol)


def _forward_both(jmod, tmod, variables, x, tol):
    """Eval and train-mode forwards of both packages: outputs within tol,
    and the running statistics the train forward leaves."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu_torch.convert import (vision_params_from_flax,
                                          vision_params_to_flax)
    from kubeml_tpu_torch.models.base import module_state

    tmod.load_state_dict(vision_params_from_flax(variables))
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    got = tmod(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)
    mutable = ["batch_stats"] if "batch_stats" in variables else []
    want, new = jax.jit(lambda v, x: jmod.apply(v, x, train=True,
                                                mutable=mutable))(
        variables, jnp.asarray(x))
    got = tmod(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    if mutable:
        _assert_trees_close(
            vision_params_to_flax(module_state(tmod))["batch_stats"],
            new["batch_stats"], tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(RESNETS))
def test_resnet_forward_and_running_stats_match_jax(case, dtype):
    from kubeml_tpu_torch.models.resnet import ResNetModule

    stages, block, width, stem, H, B = RESNETS[case]
    jdt, tdt = _dtypes(dtype)
    x = np.random.default_rng(3).standard_normal((B, H, H, 3)).astype(
        np.float32)
    jmod = _jax_resnet(stages, block, width, stem, jdt)
    variables = _jax_vars(jmod, x)
    tmod = ResNetModule(stages, block, 10, width, stem, dtype=tdt,
                        device="cpu")
    _forward_both(jmod, tmod, variables, x, TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lenet_forward_matches_jax_with_nhwc_flatten(dtype):
    """LeNet on [B, 28, 28] (and NHWC) inputs; Dense_0 reads (h, w, c)."""
    from kubeml_tpu.models.lenet import LeNetModule as JaxLeNet
    from kubeml_tpu_torch.models.lenet import LeNetModule

    jdt, tdt = _dtypes(dtype)
    x = np.random.default_rng(4).standard_normal((4, 28, 28)).astype(
        np.float32)
    jmod = JaxLeNet(dtype=jdt)
    variables = _jax_vars(jmod, x)
    tmod = LeNetModule(dtype=tdt, device="cpu")
    _forward_both(jmod, tmod, variables, x, TOL[dtype])
    _forward_both(jmod, tmod, variables, x[..., None], TOL[dtype])


def test_same_padding_follows_xla():
    from kubeml_tpu_torch.models.layers import same_pads

    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(64, 7, 2) == (2, 3)
    assert same_pads(32, 3, 1) == (1, 1)
    assert same_pads(28, 5, 1) == (2, 2)
    assert same_pads(32, 1, 2) == (0, 0)


MODELS = ("lenet", "resnet18", "resnet32", "resnet34", "resnet50")


def _sample(name):
    if name == "lenet":
        return np.zeros((1, 28, 28), np.float32)
    side = 64 if name == "resnet50" else 32
    return np.zeros((1, side, side, 3), np.float32)


def _reference_variables(name, seed=0):
    """The JAX package's variable tree for the model (its structure,
    shapes and dtypes, from jax.eval_shape of init_variables), filled
    with numpy normals from ``seed``."""
    import jax

    from kubeml_tpu.models import get_builtin

    shapes = jax.eval_shape(lambda: get_builtin(name)().init_variables(
        jax.random.PRNGKey(0), {"x": _sample(name)}))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("name", MODELS)
def test_convert_round_trip_and_leaf_order(name):
    """The JAX package's variables -> the port's module -> back, exactly;
    flax_leaf_order equals jax.tree_util's flattening of the whole
    {"batch_stats", "params"} tree (resnet34: BasicBlock_10 before
    BasicBlock_2); the model's own bridge (the whole tree for a model
    with running statistics, the params for LeNet) round trips."""
    import jax

    from kubeml_tpu_torch.convert import (flax_leaf_order,
                                          vision_params_from_flax,
                                          vision_params_to_flax)
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import module_state

    variables = _reference_variables(name)
    model = get_model(name)()
    module = model.init_module({"x": _sample(name)},
                               torch.Generator().manual_seed(0),
                               device="cpu")
    sd = vision_params_from_flax(variables)
    module.load_state_dict(sd)            # strict: every name and shape
    state = module_state(module)
    assert sorted(state) == sorted(sd)
    back = vision_params_to_flax(state)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(_leaves(back), _leaves(variables)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the model's bridge: the tree the job's checkpoints hold
    if model.collections == ("params",):
        assert set(variables) == {"params"}
        mine = {"params": model.params_to_flax(state)}
        again = model.params_from_flax(variables["params"])
    else:
        assert set(variables) == {"batch_stats", "params"}
        mine = model.params_to_flax(state)
        again = model.params_from_flax(variables)
    for a, b in zip(_leaves(mine), _leaves(variables)):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    # leaf order: tag each leaf with its flatten index
    flat, tree = jax.tree_util.tree_flatten(variables)
    tagged = jax.tree_util.tree_unflatten(
        tree, [np.full(a.shape, i, np.float32) for i, a in enumerate(flat)])
    tsd = vision_params_from_flax(tagged)
    order = flax_leaf_order(tsd)
    assert [int(tsd[n].reshape(-1)[0]) for n in order] == \
        list(range(len(flat)))
    if name == "resnet34":
        assert order.index("BasicBlock_10.Conv_0.weight") < \
            order.index("BasicBlock_2.Conv_0.weight")


def test_resnet18_bucket_plan_at_4mb_equals_reference():
    import jax

    from kubeml_tpu.parallel.merge import plan_buckets as ref_plan
    from kubeml_tpu_torch.convert import (flax_leaf_order,
                                          vision_params_from_flax)
    from kubeml_tpu_torch.parallel.merge import BucketedMerge, plan_buckets

    variables = _reference_variables("resnet18")
    sd = vision_params_from_flax(variables)
    want = ref_plan(jax.tree_util.tree_leaves(variables), 4.0)
    got = plan_buckets([sd[n] for n in flax_leaf_order(sd)], 4.0)
    assert got.n_leaves == want.n_leaves == len(sd)
    assert [(b.indices, b.sizes, b.length, b.compressible)
            for b in got.buckets] == \
        [(tuple(b.indices), tuple(b.sizes), b.length, b.compressible)
         for b in want.buckets]
    assert BucketedMerge(bucket_mb=4.0).comm_proxy(sd)[
        "buckets_per_round"] == want.n_buckets


# ------------------------------------------------------------ K-avg round

W, S, B, H = 3, 2, 4, 16
LR = 0.1


# a ResNet of one BasicBlock per stage over two stages, width 8: the
# registered models' recipe (SGD + momentum + weight decay, the LR step at
# epoch 15) at a size the CPU runs in seconds
NARROW_STAGES, NARROW_WIDTH = (1, 1), 8


def _models():
    import jax.numpy as jnp

    from kubeml_tpu.models import resnet as ref
    from kubeml_tpu_torch.models import resnet as port

    class JaxNarrow(ref._ResNetBase):
        name = "resnet-narrow"

        def build(self):
            return ref.ResNetModule(stage_sizes=NARROW_STAGES,
                                    width=NARROW_WIDTH, dtype=jnp.float32)

    class PortNarrow(port._ResNetBase):
        name = "resnet-narrow"
        stage_sizes, width = NARROW_STAGES, NARROW_WIDTH

        def build(self, dtype=torch.float32, device=None):
            return super().build(dtype=dtype, device=device)

    return JaxNarrow(), PortNarrow()


def _vision_round(seed=0):
    """Images with learnable class means, a padded example, worker 1
    masked out and worker 2's second step masked."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, (W, S, B)).astype(np.int32)
    x = rng.standard_normal((W, S, B, H, H, 3)).astype(np.float32)
    x[..., 0] += y[..., None, None] / 5.0
    smask = np.ones((W, S, B), np.float32)
    smask[0, 1, 3] = 0.0
    stmask = np.ones((W, S), np.float32)
    stmask[2, 1] = 0.0
    wmask = np.array([1.0, 0.0, 1.0], np.float32)
    rngs = rng.integers(0, 2 ** 32, (W, S, 2), dtype=np.uint32)
    return {"x": x, "y": y}, smask, stmask, wmask, rngs


def _round_both(jmodel, tmodel, variables, args, epoch, **knobs):
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    jeng = JaxEngine(make_mesh(n_data=1), jmodel.loss, jmodel.metrics,
                     jmodel.configure_optimizers, donate=False, **knobs)
    jvars, jst = jeng.train_round(
        jax.tree_util.tree_map(jnp.asarray, variables), *args, lr=LR,
        epoch=epoch)
    module = tmodel.build(device="cpu")
    teng = KAvgEngine(module, tmodel.loss, tmodel.metrics,
                      tmodel.configure_optimizers, **knobs)
    state = {k: v.clone() for k, v in
             tmodel.params_from_flax(variables).items()}
    assert sorted(state) == sorted(module_state(module))
    tvars, tst = teng.train_round(state, *args, lr=LR, epoch=epoch)
    return (jax.tree_util.tree_map(np.asarray, jvars), jst), (tvars, tst)


def _assert_round_equal(ref, got, tmodel):
    (jvars, jst), (tvars, tst) = ref, got
    np.testing.assert_array_equal(tst.step_count, jst.step_count)
    np.testing.assert_array_equal(tst.sample_count, jst.sample_count)
    np.testing.assert_array_equal(tst.dropped, np.asarray(jst.dropped))
    assert tst.contributors == jst.contributors
    np.testing.assert_allclose(tst.loss_sum, np.asarray(jst.loss_sum),
                               rtol=1e-5)
    _assert_trees_close(tmodel.params_to_flax(tvars), jvars, 1e-5)


@pytest.mark.parametrize("merge", ["monolithic", "bucketed"])
@pytest.mark.parametrize("epoch", [0, 15])
def test_resnet_kavg_round_matches_jax(epoch, merge):
    """One round of a narrow ResNet (f32): counts and drops exactly,
    parameters and batch_stats after the merge within 1e-5; epoch 15 runs
    at a tenth of the rate, so the two epochs merge to different
    weights; the bucketed merge (several buckets mixing batch_stats and
    params) matches too."""
    jmodel, tmodel = _models()
    args = _vision_round()
    variables = _jax_vars(jmodel.module, args[0]["x"][0, 0])
    knobs = {"merge_bucket_mb": 0.002} if merge == "bucketed" else {}
    ref, got = _round_both(jmodel, tmodel, variables, args, epoch, **knobs)
    _assert_round_equal(ref, got, tmodel)
    factor = np.float32(1.0 if epoch < 15 else 0.1)
    assert tmodel.lr_at(LR, epoch) == float(np.float32(LR) * factor)
    # the running statistics moved (the train forwards updated them)
    start = variables["batch_stats"]["stem_norm"]["mean"]
    assert not np.allclose(ref[0]["batch_stats"]["stem_norm"]["mean"],
                           start)


def test_torch_sgd_is_optax_chain_of_decay_and_momentum():
    """torch.optim.SGD(momentum=0.9, weight_decay=5e-4) takes the steps
    of optax.chain(add_decayed_weights(5e-4), sgd(lr, momentum=0.9)),
    with the f32 learning-rate factor of epochs >= 15 and >= 25."""
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu_torch.models import get_model

    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(4)]
    for epoch in (0, 15, 25):
        tx = get_builtin("resnet18")().configure_optimizers(
            jnp.float32(0.1), jnp.int32(epoch))
        p, st = jnp.asarray(p0), None
        st = tx.init(p)
        for g in grads:
            u, st = tx.update(jnp.asarray(g), st, p)
            p = optax.apply_updates(p, u)
        t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = get_model("resnet18")().configure_optimizers(0.1, epoch)([t])
        for g in grads:
            t.grad = torch.from_numpy(g.copy())
            opt.step()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p),
                                   rtol=0, atol=1e-6)


def _counter_models():
    """A Dense classifier with an int32 step counter in batch_stats: the
    integer leaf through the merge (averaged in f32, truncated)."""
    import flax.linen as fnn
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.models.base import ClassifierModel as JaxClassifier
    from kubeml_tpu_torch.models.base import ClassifierModel
    from kubeml_tpu_torch.models.layers import Dense

    class JaxCounter(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            count = self.variable("batch_stats", "count",
                                  lambda: jnp.zeros((), jnp.int32))
            if train and not self.is_initializing():
                count.value = count.value + 1
            x = x.reshape((x.shape[0], -1))
            return fnn.Dense(10, dtype=jnp.float32)(x)

    class JaxModel(JaxClassifier):
        def build(self):
            return JaxCounter()

        def configure_optimizers(self, lr, epoch):
            return optax.sgd(lr)

    class PortCounter(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(H * H * 3, 10, dtype=torch.float32,
                                 device="cpu")
            self.register_buffer("running_count",
                                 torch.zeros((), dtype=torch.int32))

        @property
        def device(self):
            return self.Dense_0.weight.device

        def forward(self, x, train=False):
            if train:
                self.running_count += 1
            return self.Dense_0(x.reshape(x.shape[0], -1))

    class PortModel(ClassifierModel):
        collections = ("batch_stats", "params")

        def build(self, dtype=torch.float32, device=None):
            return PortCounter()

        def params_to_flax(self, state):
            from kubeml_tpu_torch.convert import vision_params_to_flax
            return vision_params_to_flax(state)

        def params_from_flax(self, variables):
            from kubeml_tpu_torch.convert import vision_params_from_flax
            return vision_params_from_flax(variables)

    return JaxModel(), PortModel()


@pytest.mark.parametrize("merge", ["monolithic", "bucketed"])
def test_integer_leaf_through_the_merge_matches_jax(merge):
    """Worker 0 takes two steps and worker 2 one, from a counter of 5:
    (7 + 6) / 2 = 6.5 truncates to 6 in both packages, in its own exact
    bucket under the bucketed merge."""
    import jax

    jmodel, tmodel = _counter_models()
    args = _vision_round(seed=5)
    x0 = args[0]["x"][0, 0]
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init_variables(
        jax.random.PRNGKey(0), {"x": x0}))
    variables["batch_stats"]["count"] = np.asarray(5, np.int32)
    knobs = {"merge_bucket_mb": 0.001} if merge == "bucketed" else {}
    ref, got = _round_both(jmodel, tmodel, variables, args, 0, **knobs)
    _assert_round_equal(ref, got, tmodel)
    assert int(ref[0]["batch_stats"]["count"]) == 6
    assert got[0]["running_count"].dtype == torch.int32
    assert int(got[0]["running_count"]) == 6


# ------------------------------------------------------------ checkpoints

def _image_registry(n_train=96, n_test=32, seed=0):
    """u8 NHWC 16x16x3 images whose class shifts channel 0's mean."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    rng = np.random.default_rng(seed)

    def split(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = rng.integers(0, 160, (n, H, H, 3))
        x[..., 0] += 9 * y[:, None, None]
        return x.astype(np.uint8), y
    DatasetRegistry().create("images", *split(n_train), *split(n_test))


def _image_dataset(key):
    """u8 -> f32 / 255 on the host and, as its device twin, on the card."""
    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu_torch.models.base import KubeDataset

    def host(self, data, labels):
        return {"x": np.asarray(data).astype(np.float32) / 255.0,
                "y": np.asarray(labels)}

    def device(x, y):
        if isinstance(x, torch.Tensor):
            return {"x": x.float() / 255.0, "y": y}
        return {"x": x.astype("float32") / 255.0, "y": y}

    base = RefDataset if key == "ref" else KubeDataset
    cls = type("Images", (base,), {"transform_train": host,
                                   "transform_test": host,
                                   "transform_train_device":
                                   staticmethod(device)})
    return cls("images")


def _task(pkg, job_id, epochs=1, resume_from="", **opts):
    types = __import__(f"{pkg}.api.types", fromlist=["TrainTask"])
    req = types.TrainRequest(
        model_type="resnet-narrow", batch_size=8, epochs=epochs,
        dataset="images", lr=LR, resume_from=resume_from,
        options=types.TrainOptions(default_parallelism=2,
                                   static_parallelism=True, k=2, **opts))
    return types.TrainTask(job_id=job_id, parameters=req, parallelism=2)


def test_resnet_jobs_warm_start_from_each_others_checkpoints(tmp_home):
    """A JAX-written ResNet checkpoint (params and batch_stats)
    warm-starts the port's job, which trains from the device cache; the
    port's final checkpoint holds the JAX package's tree and warm-starts
    a JAX job in turn. Both jobs trained from the same seed agree."""
    import jax

    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train import job as ref_job
    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu.train.checkpoint import save_checkpoint as ref_save
    from kubeml_tpu_torch.train import job as port_job

    _image_registry()
    jmodel, tmodel = _models()
    x0 = np.zeros((1, H, H, 3), np.float32)
    seed_vars = _jax_vars(jmodel.module, x0)
    ref_save("seed", seed_vars, {"model": "resnet-narrow",
                                 "function": "resnet-narrow"})
    ref = ref_job.TrainJob(_task("kubeml_tpu", "ref-a", resume_from="seed"),
                           jmodel, _image_dataset("ref"),
                           make_mesh(n_data=1)).train()
    job = port_job.TrainJob(
        _task("kubeml_tpu_torch", "port-a", resume_from="seed"), tmodel,
        _image_dataset("port"), device="cpu")
    got = job.train()
    assert job._device_cache is not None
    assert job._device_cache.layout == "sharded"
    np.testing.assert_allclose(got.data.train_loss, ref.data.train_loss,
                               rtol=1e-5)
    np.testing.assert_allclose(got.data.validation_loss,
                               ref.data.validation_loss, rtol=1e-5)
    want, _ = ref_load("ref-a")
    have, manifest = ref_load("port-a")      # the JAX package reads it
    assert manifest["completed"]
    _assert_trees_close(have, want, 1e-5)
    # the port's checkpoint warm-starts a JAX job
    ref_b = ref_job.TrainJob(
        _task("kubeml_tpu", "ref-b", resume_from="port-a"),
        _models()[0], _image_dataset("ref"), make_mesh(n_data=1)).train()
    assert np.isfinite(ref_b.data.train_loss).all()
    assert jax.tree_util.tree_structure(ref_load("ref-b")[0]) == \
        jax.tree_util.tree_structure(want)


@pytest.mark.gpu
def test_resnet_forward_on_the_card_matches_cpu():
    """ResNet-18 in f32, train and eval forwards: the card's (cuDNN
    convolutions) and the CPU's within 1e-4, running statistics too."""
    if not torch.cuda.is_available():   # decided at run time, not import
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.models.resnet import ResNetModule

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    mods = {}
    for dev in ("cpu", "cuda"):
        torch.manual_seed(0)
        mods[dev] = ResNetModule((2, 2, 2, 2), dtype=torch.float32,
                                 device=dev)
    mods["cuda"].load_state_dict(mods["cpu"].state_dict())
    torch.backends.cudnn.allow_tf32 = False
    for train in (False, True):
        a = mods["cpu"](x, train=train)
        b = mods["cuda"](x.cuda(), train=train).cpu()
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    sa, sb = module_state(mods["cpu"]), module_state(mods["cuda"])
    for k in sa:
        torch.testing.assert_close(sb[k].cpu(), sa[k], rtol=1e-4,
                                   atol=1e-4)
