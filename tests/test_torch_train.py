"""Port parity: the GPT training path and the one-device K-avg round of
kubeml_tpu_torch against the JAX package's.

The same flax parameters (numpy, from a seed) and the same numpy batches
drive the JAX model/engine and the port's, at gpt-nano widths (2 layers,
hidden 32, T = 16) in float32 with dropout 0, so what is compared is the
algorithm, not bf16 rounding or random bits (jax.random's stream cannot be
reproduced). The JAX side runs with attn_impl='reference' and with
attn_impl='flash' (its Pallas kernels in interpret mode).

Tolerances:
  - per-sequence losses and eval metrics 1e-5 and gradients 1e-4 (f32;
    the frameworks sum matmuls and softmaxes in different orders);
  - merged parameters after K AdamW steps: AdamW's first steps divide
    each gradient element by its own magnitude (m / (sqrt(v) + eps)), so a
    gradient element near zero whose sign the summation order flips moves
    its parameter by up to 2 lr per step. The bound is therefore
    |diff| <= 2 K lr for every element, and all but a sliver (0.5 %) of
    the elements within 1e-5 (measured: 99.8 %, max 4.6e-4 at lr 1e-3);
  - loss sums 1e-5; step/sample/contributor counts and drop flags exactly.
"""

import numpy as np
import pytest
import torch

# JAX is imported inside the parity tests only: the `gpu` test runs on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

W, S, B, T = 3, 2, 4, 16
LR = 1e-3


def _nano():
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    return GPT_CONFIGS["gpt-nano"]


def _params(seed=4):
    from kubeml_tpu_torch.convert import random_flax_params
    return random_flax_params(**_nano(), seed=seed)


def _jax_model(impl="reference"):
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.models.gpt import GPTNano as JaxNano

    model = JaxNano()
    model._module = JaxGPT(**_nano(), dropout=0.0, dtype=jnp.float32,
                           attn_impl=impl, flash_interpret=True)
    return model


def _torch_model(params):
    from kubeml_tpu_torch.convert import params_from_flax
    from kubeml_tpu_torch.models.gpt import GPTNano

    model = GPTNano()
    module = model.build(dtype=torch.float32, device="cpu")
    module.load_state_dict(params_from_flax(params))
    return model, module


def _round_inputs(seed=0):
    """Arithmetic token runs (learnable) with a padded tail, a padded
    example, worker 1 masked out and worker 2's second step masked."""
    rng = np.random.default_rng(seed)
    start = rng.integers(1, 500, (W, S, B, 1))
    x = ((start + np.arange(T) - 1) % 511 + 1).astype(np.int32)
    x[:, :, 0, 11:] = 0
    smask = np.ones((W, S, B), np.float32)
    smask[0, 1, 3] = 0.0
    stmask = np.ones((W, S), np.float32)
    stmask[2, 1] = 0.0
    wmask = np.array([1.0, 0.0, 1.0], np.float32)
    rngs = rng.integers(0, 2 ** 32, (W, S, 2), dtype=np.uint32)
    return x, smask, stmask, wmask, rngs


def _engines(params, impl="reference", loss_wrap=None):
    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    jm = _jax_model(impl)
    tm, module = _torch_model(params)
    jloss, tloss = jm.loss, tm.loss
    if loss_wrap is not None:
        jloss, tloss = loss_wrap(jloss, tloss)
    jeng = JaxEngine(make_mesh(n_data=1), jloss, jm.metrics,
                     jm.configure_optimizers, donate=False)
    teng = KAvgEngine(module, tloss, tm.metrics, tm.configure_optimizers)
    return jeng, teng


def _jax_vars(params):
    import jax
    import jax.numpy as jnp

    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def _assert_params_close(ref, got, k_steps):
    """Merged state dicts (by parameter name) within the AdamW bound."""
    diffs = np.concatenate([
        np.abs(np.asarray(ref[n], np.float32)
               - got[n].detach().cpu().numpy()).ravel() for n in ref])
    assert diffs.max() <= 2 * k_steps * LR, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()


def _assert_counts_equal(jst, tst):
    np.testing.assert_array_equal(tst.step_count, jst.step_count)
    np.testing.assert_array_equal(tst.sample_count, jst.sample_count)
    np.testing.assert_array_equal(tst.dropped, np.asarray(jst.dropped))
    assert tst.contributors == jst.contributors


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_training_loss_and_grads_match_jax(impl):
    """GPTMini.loss (per sequence) and the gradients of the masked-mean
    step loss w.r.t. every parameter, against the JAX model's."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.kavg import masked_scalar_loss as jax_msl
    from kubeml_tpu_torch.convert import params_to_flax
    from kubeml_tpu_torch.parallel.kavg import masked_scalar_loss

    params = _params(seed=5)
    x, smask, *_ = _round_inputs(seed=1)
    x, smask = x[0, 0], smask[0, 1]
    jm = _jax_model(impl)
    key = jax.random.key_data(jax.random.PRNGKey(0))
    (jl, _), jg = jax.value_and_grad(
        jax_msl(jm.loss, {}, {"x": jnp.asarray(x)}, key, jnp.asarray(smask)),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
    j_per_ex, _ = jm.loss({"params": params}, {"x": jnp.asarray(x)},
                          jax.random.PRNGKey(0), jnp.asarray(smask))

    tm, module = _torch_model(params)
    gen = torch.Generator()
    per_ex = tm.loss(module, {"x": torch.from_numpy(x)}, gen,
                     torch.from_numpy(smask))
    torch.testing.assert_close(per_ex, torch.tensor(np.asarray(j_per_ex)),
                               rtol=1e-5, atol=1e-5)
    loss = masked_scalar_loss(tm.loss, module, {"x": torch.from_numpy(x)},
                              gen, torch.from_numpy(smask))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    loss.backward()
    grads = params_to_flax({n: p.grad for n, p in module.named_parameters()},
                           heads=_nano()["heads"])
    for a, b in zip(jax.tree_util.tree_leaves(jg),
                    jax.tree_util.tree_leaves(grads)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_train_round_matches_jax_engine(impl):
    """One K=2 round, W=3 virtual workers (one masked out, one step
    masked, one padded example), AdamW from configure_optimizers: merged
    params, loss sums and every count against the JAX engine's."""
    import jax.numpy as jnp

    from kubeml_tpu_torch.convert import params_from_flax

    params = _params()
    x, smask, stmask, wmask, rngs = _round_inputs()
    jeng, teng = _engines(params, impl)
    javg, jst = jeng.train_round(_jax_vars(params), {"x": jnp.asarray(x)},
                                 smask, stmask, wmask, rngs, LR, 0)
    tavg, tst = teng.train_round(params_from_flax(params), {"x": x}, smask,
                                 stmask, wmask, rngs, LR, 0)
    assert set(tavg) == set(params_from_flax(params))
    assert all(t.dtype == torch.float32 for t in tavg.values())
    _assert_params_close(params_from_flax(javg["params"]), tavg, k_steps=S)
    np.testing.assert_allclose(tst.loss_sum, np.asarray(jst.loss_sum),
                               rtol=1e-5, atol=1e-5)
    _assert_counts_equal(jst, tst)
    assert tst.contributors == 2.0 and tst.loss_sum[1] == 0.0


def _poison(worker_values):
    """Loss wrappers adding a per-step poison leaf [W, S, B] (0 or NaN)
    to every per-example loss, for both frameworks."""
    def wrap(jloss, tloss):
        def jl(variables, batch, rng, smask):
            per_ex, state = jloss(variables, batch, rng, smask)
            return per_ex + batch["poison"], state

        def tl(module, batch, gen, smask):
            return tloss(module, batch, gen, smask) + batch["poison"]
        return jl, tl
    poison = np.zeros((W, S, B), np.float32)
    for w, val in enumerate(worker_values):
        poison[w] = val
    return wrap, poison


@pytest.mark.parametrize("poisoned", [(0.0, 0.0, np.nan),
                                      (np.nan, np.nan, np.nan)])
def test_non_finite_drop_and_all_dropped_carry_forward(poisoned):
    """A worker whose loss goes NaN is dropped by a select (the others
    still merge, as in the JAX engine); when every worker drops, the
    round-start weights come back bit for bit."""
    import jax.numpy as jnp

    from kubeml_tpu_torch.convert import params_from_flax

    params = _params()
    x, smask, stmask, _, rngs = _round_inputs(seed=2)
    wmask = np.ones(W, np.float32)
    wrap, poison = _poison(poisoned)
    jeng, teng = _engines(params, loss_wrap=wrap)
    javg, jst = jeng.train_round(
        _jax_vars(params), {"x": jnp.asarray(x), "poison": jnp.asarray(poison)},
        smask, stmask, wmask, rngs, LR, 0)
    start = params_from_flax(params)
    tavg, tst = teng.train_round(start, {"x": x, "poison": poison}, smask,
                                 stmask, wmask, rngs, LR, 0)
    _assert_counts_equal(jst, tst)
    np.testing.assert_array_equal(tst.dropped, np.isnan(poisoned) * 1.0)
    assert np.isfinite(tst.loss_sum).all()
    if np.isnan(poisoned).all():
        assert tst.contributors == 0.0
        for name, t in tavg.items():
            assert torch.equal(t, start[name]), name
    else:
        assert tst.contributors == 2.0
        _assert_params_close(params_from_flax(javg["params"]), tavg,
                             k_steps=S)


def test_eval_round_matches_jax():
    """The datapoint-weighted eval (loss, accuracy, n) after a round."""
    import jax.numpy as jnp

    from kubeml_tpu_torch.convert import params_from_flax

    params = _params(seed=6)
    x, smask, *_ = _round_inputs(seed=3)
    jeng, teng = _engines(params)
    ref = jeng.eval_round(_jax_vars(params), {"x": jnp.asarray(x)}, smask)
    got = teng.eval_round(params_from_flax(params), {"x": x}, smask)
    assert got["n"] == ref["n"] == smask.sum()
    for name in ("loss", "accuracy"):
        assert abs(got[name] - ref[name]) <= 1e-5, (name, got, ref)


def test_comm_proxy_equals_jax_for_gpt_mini():
    """The monolithic merge's wire proxy of gpt-mini equals the JAX
    engine's exactly (same leaves, same f32 bytes)."""
    import jax

    from kubeml_tpu.parallel.merge import MonolithicMerge as JaxMerge
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.parallel.merge import MonolithicMerge

    params = random_flax_params(**GPT_CONFIGS["gpt-mini"], seed=0)
    ref = JaxMerge().comm_proxy({"params": params})
    got = MonolithicMerge().comm_proxy(params_from_flax(params))
    assert got == ref
    assert got["merge_payload_bytes"] == 4 * sum(
        a.size for a in jax.tree_util.tree_leaves(params))


def test_models_registered_with_reference_widths_and_dropout():
    """gpt-mini, gpt-nano and gpt-moe-mini train at the JAX package's
    widths, dropout and optimizer settings, gpt-moe-mini with its experts,
    routing and aux weight; vgg11 at its classes, Dense width, dropout
    and SGD with momentum 0.9."""
    from kubeml_tpu.models import get_builtin as jax_builtin
    from kubeml_tpu_torch.models import get_builtin, get_model
    from kubeml_tpu_torch.models import gpt
    from kubeml_tpu_torch.models.gpt import GPTMoEMini
    from kubeml_tpu_torch.models.vgg import VGG11

    for name in ("gpt-mini", "gpt-nano"):
        ref = jax_builtin(name)().module
        cls = get_model(name)
        assert cls is not None and cls.name == name
        mod = cls().build(device="cpu")
        assert mod.dropout == ref.dropout
        assert get_builtin(name)(device="cpu").dropout == ref.dropout
        for field in ("vocab_size", "max_len", "hidden", "layers", "heads",
                      "ffn"):
            assert getattr(mod, field) == getattr(ref, field)
        opt = cls().configure_optimizers(1e-3, 0)([torch.zeros(2)])
        assert isinstance(opt, torch.optim.AdamW)
        group = opt.param_groups[0]
        assert (group["lr"], group["betas"], group["eps"],
                group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 0.01)
    # gpt-moe-mini: a training model, not a serving built-in
    ref_model = jax_builtin("gpt-moe-mini")()
    ref = ref_model.module
    assert get_model("gpt-moe-mini") is GPTMoEMini
    assert GPTMoEMini.name == ref_model.name == "gpt-moe-mini"
    assert GPTMoEMini.aux_coef == ref_model.aux_coef
    assert get_builtin("gpt-moe-mini") is None
    mod = GPTMoEMini().build(device="cpu")
    for field in ("vocab_size", "max_len", "hidden", "layers", "heads",
                  "ffn", "n_experts", "dropout"):
        assert getattr(mod, field) == getattr(ref, field), field
    assert (gpt.MOE_K, gpt.CAPACITY_FACTOR) == (ref.moe_k,
                                                ref.capacity_factor)
    opt = GPTMoEMini().configure_optimizers(1e-3, 0)([torch.zeros(2)])
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 0.01)
    # vgg11: the reference's num_classes, hidden, dropout; optax.sgd(lr,
    # momentum=0.9) is SGD(momentum=0.9) with no decay and no nesterov
    ref_model = jax_builtin("vgg11")()
    ref = ref_model.module
    assert get_model("vgg11") is VGG11
    assert VGG11.name == ref_model.name == "vgg11"
    assert VGG11.num_classes == ref_model.num_classes == ref.num_classes
    mod = VGG11().build(device="cpu")
    assert mod.Dense_0.out_features == ref.hidden
    assert mod.Dense_2.out_features == ref.num_classes
    assert mod.dropout == ref.dropout
    opt = VGG11().configure_optimizers(0.05, 3)([torch.zeros(2)])
    assert type(opt) is torch.optim.SGD
    group = opt.param_groups[0]
    assert (group["lr"], group["momentum"], group["weight_decay"],
            group["nesterov"], group["dampening"]) == (0.05, 0.9, 0, False, 0)


def test_dropout_follows_the_generator():
    """Training dropout draws only from the given generator: the same
    seed gives the same loss, another seed another; eval has none."""
    from kubeml_tpu_torch.models.gpt import GPTMini, _dropout

    torch.manual_seed(0)
    model = GPTMini()
    module = model.build(dtype=torch.float32, device="cpu")
    x = {"x": torch.randint(1, 8192, (2, 16), generator=torch.Generator()
                            .manual_seed(0))}
    smask = torch.ones(2)

    def loss(seed):
        gen = torch.Generator().manual_seed(seed)
        return model.loss(module, x, gen, smask)

    torch.testing.assert_close(loss(1), loss(1), rtol=0, atol=0)
    assert not torch.equal(loss(1), loss(2))
    ev = model.metrics(module, x)["loss"]
    torch.testing.assert_close(ev, model.metrics(module, x)["loss"])
    ones = torch.ones(20000)
    kept = _dropout(ones, 0.1, torch.Generator().manual_seed(3))
    assert abs(float((kept > 0).float().mean()) - 0.9) < 0.01
    torch.testing.assert_close(kept[kept > 0],
                               torch.full_like(kept[kept > 0], 1 / 0.9))


def test_training_entry_points_default_to_cuda():
    """device=None means CUDA: without a card the model build raises."""
    from kubeml_tpu_torch.models import get_model

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("gpt-nano")().build()


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_round_on_card_matches_cpu(cuda_device):
    """A gpt-nano f32 round on the card (flash kernels, cuBLAS) against
    the same round on the CPU (plain versions), with the AdamW bound
    above; three flash launches per layer per real step."""
    from kubeml_tpu_torch.convert import params_from_flax
    from kubeml_tpu_torch.models.gpt import GPTNano
    from kubeml_tpu_torch.ops import flash_attention as fa
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    params = _params()
    x, smask, stmask, wmask, rngs = _round_inputs()
    out = {}
    for dev in ("cpu", "cuda"):
        model = GPTNano()
        module = model.build(dtype=torch.float32, device=dev)
        module.load_state_dict(params_from_flax(params))
        eng = KAvgEngine(module, model.loss, model.metrics,
                         model.configure_optimizers)
        start = {k: v.to(dev) for k, v in params_from_flax(params).items()}
        before = fa.fa_fwd_kernel.launches
        out[dev], st = eng.train_round(start, {"x": x}, smask, stmask, wmask,
                                       rngs, LR, 0)
        real = int((stmask * wmask[:, None]).sum())
        launched = fa.fa_fwd_kernel.launches - before
        assert launched == (module.layers * real if dev == "cuda" else 0)
    _assert_params_close(out["cpu"], out["cuda"], k_steps=S)
