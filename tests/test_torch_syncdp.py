"""Port parity: kubeml_tpu_torch's SyncDPEngine against the JAX package's
(kubeml_tpu/parallel/syncdp.py) on the CPU.

The reference runs on a D-lane CPU mesh (``make_mesh(n_data=D)``), the
port over D lanes on one device, from the same flax variables and the
same seeded numpy batches; the mlp is the reference's own SyncDP test
problem (noisy blobs, 16 features, hidden 32, 4 classes), trained with
Adam whose learning rate changes from one dispatch to the next.

Tolerances:
  - the implicit path (``zero1`` on and off, ``fsdp``), the explicit
    monolithic and bucketed merges: parameters and Adam's moments within
    f32 1e-5 of the reference's (torch and XLA sum the batch's products
    in other orders), the per-step losses within 1e-4 relative (the
    port's Adam parity bound: a loss reads weights that already differ
    in their last bits); the optimizer's step count exactly. Within the
    port, bucketed equals monolithic bit for bit, and the explicit path
    equals the implicit one within 1e-6 (the reference gets them
    bit-equal from XLA's partitioner; torch divides by the sample count
    after the lane sum, not before the batch sum);
  - the EF strategies against the reference's own EF run: a payload
    element whose f32 rounding lands on the other side of a quantization
    boundary than the reference's ships one quantum more or less. bf16:
    the quantum is 2^-8 of the element, which moves an Adam step by at
    most 2 x 2^-8 x lr, so the weights stay within steps x lr x 2^-7;
    int8: the quantum is the bucket's scale, which can flip the sign of a
    near-zero element's step, so the weights stay within AdamW's 2 x
    steps x lr with 99.5 % of the elements within 1e-5. Both must also
    be at least ten times closer to the reference's EF output than that
    is to the reference's monolithic one. The per-step lane merge itself
    (count 1, a zero ref) on the reference's per-lane gradients: the sum
    and the residuals bit for bit;
  - skip-step, masking, layout decisions, ledger records and dispatch
    counts exactly; the health-stat rows within 1e-4 relative; the
    BatchNorm statistics within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

# JAX is imported inside the parity tests only: the `gpu` tests run on
# the card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

S, B = 4, 32          # steps per dispatch, global batch
LRS = (1e-2, 5e-3)    # the learning rate of even and odd dispatches
SMALL_CAP_MB = 52 * 4 / (1024 * 1024)     # several buckets for the mlp


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _blobs(seed=0, rounds=4):
    """The reference's SyncDP problem: [S * rounds, B] noisy blobs, and
    [S * rounds, 2] step keys."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, 16) * 3
    y = rng.randint(0, 4, size=(S * rounds, B)).astype(np.int32)
    x = (centers[y] + rng.randn(*y.shape, 16)).astype(np.float32)
    rngs = np.random.RandomState(1).randint(
        0, 2 ** 31, size=(S * rounds, 2)).astype(np.uint32)
    return x, y, rngs


@functools.lru_cache(maxsize=None)
def _mlp_variables(seed=0):
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models import get_builtin

    x, _, _ = _blobs(seed)
    variables = get_builtin("mlp")(hidden=32, num_classes=4).init_variables(
        jax.random.PRNGKey(0), {"x": jnp.asarray(x[0])})
    return jax.tree_util.tree_map(np.asarray, variables)


def _round(r, seed=0, nan_at=None, mask_half_at=None):
    """Dispatch r's (batch, sample mask, keys, lr): a NaN in lane 0's
    slice of one step, or half of one step's samples masked."""
    x, y, rngs = _blobs(seed)
    sl = slice(r * S, (r + 1) * S)
    xs = np.array(x[sl])
    mask = np.ones((S, B), np.float32)
    if mask_half_at is not None and r == mask_half_at:
        mask[1, B // 2:] = 0.0
    if nan_at is not None and r == nan_at[0]:
        xs[nan_at[1], :4] = np.nan          # poisons lane 0's slice
    return {"x": xs, "y": y[sl]}, mask, rngs[sl], LRS[r % 2]


def _port_mlp(variables):
    from kubeml_tpu_torch.models import get_model

    model = get_model("mlp")(hidden=32, num_classes=4)
    model.in_features = 16
    return model, model.module_from_flax(variables, device="cpu")


def _ref_engine(D, strategy=None, opt="adam", **kw):
    import optax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.parallel.syncdp import SyncDPEngine as RefEngine

    model = get_builtin("mlp")(hidden=32, num_classes=4)
    tx = {"adam": lambda lr, e: optax.adam(lr),
          "sgd": lambda lr, e: optax.sgd(lr)}[opt]
    return RefEngine(make_mesh(n_data=D), model.loss, tx, donate=False,
                     merge_strategy=strategy, **kw)


def _port_engine(D, strategy=None, opt="adam", variables=None, **kw):
    from kubeml_tpu_torch.convert import flax_layout_shapes
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    variables = _mlp_variables() if variables is None else variables
    model, module = _port_mlp(variables)
    tx = {"adam": lambda lr, e: functools.partial(torch.optim.Adam, lr=lr),
          "sgd": lambda lr, e: functools.partial(torch.optim.SGD, lr=lr)}[opt]
    state = {n: t.detach().clone() for n, t in module.state_dict().items()}
    shapes = flax_layout_shapes(state, {"params": model.params_to_flax(state)})
    eng = SyncDPEngine(module, model.loss, tx, n_lanes=D,
                       merge_strategy=strategy, layout_shapes=shapes, **kw)
    return model, eng, state


def _run_ref(D, strategy=None, rounds=2, nan_at=None, mask_half_at=None,
             **kw):
    import jax
    import jax.numpy as jnp

    eng = _ref_engine(D, strategy, **kw)
    state = eng.init_state(jax.tree_util.tree_map(jnp.asarray,
                                                  _mlp_variables()))
    losses, skipped, stats = [], [], []
    for r in range(rounds):
        batch, mask, keys, lr = _round(r, nan_at=nan_at,
                                       mask_half_at=mask_half_at)
        state, loss = eng.train_steps(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, mask,
            keys, lr=lr, epoch=0)
        losses.append(np.asarray(loss))
        skipped.append(np.asarray(eng.last_skipped_device))
        if eng.last_stats_device is not None:
            stats.append(np.asarray(eng.last_stats_device))
    return eng, state, losses, skipped, stats


def _run_port(D, strategy=None, rounds=2, nan_at=None, mask_half_at=None,
              **kw):
    model, eng, variables = _port_engine(D, strategy, **kw)
    state = eng.init_state(variables)
    losses, skipped, stats = [], [], []
    for r in range(rounds):
        batch, mask, keys, lr = _round(r, nan_at=nan_at,
                                       mask_half_at=mask_half_at)
        state, loss = eng.train_steps(state, batch, mask, keys, lr=lr,
                                      epoch=0)
        losses.append(loss.numpy())
        skipped.append(eng.last_skipped_device.numpy())
        if eng.last_stats_device is not None:
            stats.append(eng.last_stats_device.numpy())
    return model, eng, state, losses, skipped, stats


def _leaves(tree):
    import jax
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_leaves(model, tensors):
    """A port state's tensors in the reference's layout and leaf order."""
    return _leaves(model.params_to_flax(tensors))


def _max_diff(a, b):
    return max(float(np.abs(u - v).max()) for u, v in zip(a, b))


def _ef_bf16_bound(steps):
    """The EF-bf16 bound of the module docstring: steps x lr x 2^-7."""
    return steps * max(LRS) * 2.0 ** -7


def _moments(model, state):
    """(Adam's first moments, second moments, step counts) of a port
    state, the moments in the reference's layout."""
    opt = state["opt_state"]
    params = dict(zip(state["params"], opt.param_groups[0]["params"]))
    mu = {n: opt.state[p]["exp_avg"] for n, p in params.items()}
    nu = {n: opt.state[p]["exp_avg_sq"] for n, p in params.items()}
    steps = {int(opt.state[p]["step"]) for p in params.values()}
    return _port_leaves(model, mu), _port_leaves(model, nu), steps


# ----------------------------------------------------------- implicit path
@pytest.mark.parametrize("layout", ["zero1", "replicated", "fsdp"])
def test_implicit_path_matches_reference(layout):
    """Two dispatches of the implicit path (D = 2) with the learning rate
    changing between them, half a step masked in the second: parameters,
    Adam's moments and losses within 1e-5, the step count exactly (the
    optimizer persists across dispatches); ZeRO-1 and FSDP change no
    number."""
    kw = {"zero1": dict(zero1=True), "replicated": dict(zero1=False),
          "fsdp": dict(fsdp=True)}[layout]
    ref_eng, rs, r_loss, r_skip, _ = _run_ref(2, mask_half_at=1, **kw)
    model, eng, ps, p_loss, p_skip, _ = _run_port(2, mask_half_at=1, **kw)
    assert _max_diff(_port_leaves(model, ps["params"]),
                     _leaves(rs["params"])) <= 1e-5
    mu, nu, steps = _moments(model, ps)
    adam = rs["opt_state"][0]
    assert steps == {2 * S} and int(adam.count) == 2 * S
    assert _max_diff(mu, _leaves(adam.mu)) <= 1e-5
    assert _max_diff(nu, _leaves(adam.nu)) <= 1e-5
    np.testing.assert_allclose(np.concatenate(p_loss),
                               np.concatenate(r_loss), rtol=1e-4)
    assert not np.concatenate(p_skip).any()
    assert not np.concatenate(r_skip).any()


def test_padded_samples_do_not_contribute():
    """A masked sample leaves the update of the batch without it (the
    reference's test), and both equal the reference's."""
    import jax
    import jax.numpy as jnp

    batch, _, keys, _ = _round(0)
    xa, ya = batch["x"][:1, :B - 8], batch["y"][:1, :B - 8]
    xb = batch["x"][:1].copy()
    xb[0, B - 8:] = 1e3                       # garbage in the padded slots
    mask = np.ones((1, B), np.float32)
    mask[0, B - 8:] = 0.0
    keys = keys[:1]
    model, eng, variables = _port_engine(2, opt="sgd", zero1=False)
    sa = eng.init_state(variables)
    sa, _ = eng.train_steps(sa, {"x": xa, "y": ya},
                            np.ones((1, B - 8), np.float32), keys, 0.1, 0)
    sb = eng.init_state(variables)
    sb, _ = eng.train_steps(sb, {"x": xb, "y": batch["y"][:1]}, mask, keys,
                            0.1, 0)
    ref = _ref_engine(2, opt="sgd", zero1=False)
    rb = ref.init_state(jax.tree_util.tree_map(jnp.asarray,
                                               _mlp_variables()))
    rb, _ = ref.train_steps(rb, {"x": jnp.asarray(xb),
                                 "y": jnp.asarray(batch["y"][:1])},
                            mask, keys, lr=0.1, epoch=0)
    for a, b in zip(_port_leaves(model, sa["params"]),
                    _port_leaves(model, sb["params"])):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    assert _max_diff(_port_leaves(model, sb["params"]),
                     _leaves(rb["params"])) <= 1e-5


# ----------------------------------------------------------- explicit path
@pytest.mark.parametrize("strategy", ["monolithic", "bucketed"])
def test_explicit_merge_matches_implicit_and_reference(strategy):
    """Through a masked half step and a NaN skip-step: the explicit merge
    equals the reference's within 1e-5 and the port's implicit path
    within 1e-6; bucketed equals monolithic bit for bit."""
    kw = {"merge_bucket_mb": SMALL_CAP_MB} if strategy == "bucketed" else {}
    common = dict(rounds=3, nan_at=(2, 1), mask_half_at=1)
    _, rs, r_loss, r_skip, _ = _run_ref(2, strategy, **common, **kw)
    model, eng, ps, p_loss, p_skip, _ = _run_port(2, strategy, **common,
                                                  **kw)
    _, _, implicit, *_ = _run_port(2, None, **common)
    got = _port_leaves(model, ps["params"])
    assert _max_diff(got, _leaves(rs["params"])) <= 1e-5
    assert _max_diff(got, _port_leaves(model, implicit["params"])) <= 1e-6
    np.testing.assert_array_equal(np.concatenate(p_skip),
                                  np.concatenate(r_skip))
    assert np.concatenate(p_skip).tolist() == [0] * 9 + [1] + [0] * 2
    np.testing.assert_allclose(np.concatenate(p_loss),
                               np.concatenate(r_loss), rtol=1e-4)
    if strategy == "bucketed":
        _, _, mono, *_ = _run_port(2, "monolithic", **common)
        for a, b in zip(got, _port_leaves(model, mono["params"])):
            np.testing.assert_array_equal(a, b)
        assert eng._merge._plan(ps["params"])[1].n_buckets > 1


@pytest.mark.parametrize("strategy", ["ef_bf16", "ef_int8"])
def test_ef_merge_matches_reference_ef_run(strategy):
    """Four dispatches of error-feedback merging against the reference's
    own EF run (ROADMAP C.2's direct check): within the EF bound of the
    module docstring, and far closer to it than to the reference's
    monolithic run; residuals carried and non-zero."""
    common = dict(rounds=4, nan_at=None, mask_half_at=1)
    _, rs, r_loss, *_ = _run_ref(2, strategy, **common)
    _, mono, *_ = _run_ref(2, "monolithic", **common)
    model, eng, ps, p_loss, *_ = _run_port(2, strategy, **common)
    got, want = _port_leaves(model, ps["params"]), _leaves(rs["params"])
    diffs = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(got, want)])
    steps = 4 * S
    if strategy == "ef_bf16":
        assert diffs.max() <= _ef_bf16_bound(steps), diffs.max()
    else:
        assert diffs.max() <= 2 * steps * max(LRS), diffs.max()
        assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()
    assert 10 * diffs.max() <= _max_diff(want, _leaves(mono["params"]))
    np.testing.assert_allclose(np.concatenate(p_loss),
                               np.concatenate(r_loss), rtol=1e-4)
    assert set(ps["merge_resid"]) == set(rs["merge_resid"])
    for k, v in ps["merge_resid"].items():
        assert v.shape == rs["merge_resid"][k].shape
        assert float(v.abs().max()) > 0


def _reference_lane_grads(D, r=0):
    """The reference's per-lane gradients of dispatch r's first step: the
    gradient of each lane's unnormalized masked loss sum, [D, ...] by
    port name, and the lanes' sample counts."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models import get_builtin

    model = get_builtin("mlp")(hidden=32, num_classes=4)
    batch, mask, keys, _ = _round(r, mask_half_at=r)
    params = jax.tree_util.tree_map(jnp.asarray, _mlp_variables()["params"])
    L = B // D
    lanes = []
    for d in range(D):
        sl = slice(d * L, (d + 1) * L)
        mb = {k: jnp.asarray(v[1, sl]) for k, v in batch.items()}
        m = jnp.asarray(mask[1, sl])

        def lsum(p, mb=mb, m=m):
            per_ex, _ = model.loss({"params": p}, mb,
                                   jax.random.wrap_key_data(
                                       jnp.asarray(keys[1])), m)
            return (per_ex * m).sum()
        lanes.append(_leaves(jax.grad(lsum)(params)))
    return [np.stack(g) for g in zip(*lanes)], mask[1].reshape(D, L).sum(1)


def _bucket_flats(plan, lanes):
    """EF residuals of a bucket plan from per-lane leaf lists (leaf i of
    the plan's order, each in one package's own layout): per compressible
    bucket the lanes' flattened leaves, lane-major, [D * L]."""
    return {f"b{bi}": np.concatenate([np.concatenate(
        [lane[i].reshape(-1) for i in b.indices]) for lane in lanes])
        for bi, b in enumerate(plan.buckets) if b.compressible}


def _bucket_leaves(plan, flat, shapes):
    """The inverse for one bucket plan: [D * L] residuals -> per-lane
    leaf lists in the given shapes."""
    D = len(next(iter(flat.values()))) // plan.buckets[0].length
    lanes = [[None] * plan.n_leaves for _ in range(D)]
    for bi, b in enumerate(plan.buckets):
        per_lane = np.asarray(flat[f"b{bi}"]).reshape(D, -1)
        for d in range(D):
            off = 0
            for i, n in zip(b.indices, b.sizes):
                lanes[d][i] = per_lane[d, off:off + n].reshape(shapes[i])
                off += n
    return lanes


@pytest.mark.parametrize("alive", [(1, 1), (1, 0), (0, 0)],
                         ids=["both-alive", "dead-lane", "all-dead"])
@pytest.mark.parametrize("strategy", ["bucketed", "ef_bf16", "ef_int8"])
def test_count1_lane_merge_bit_identical_on_reference_grads(strategy, alive):
    """SyncDP's call of lane_merge (count 1, a zero ref, raw = the live
    lanes) on the reference's per-lane gradients and a carried residual:
    the port's sum and new residuals equal the reference's bit for bit.
    A bucket flattens its leaves in each package's own layout (a Dense
    kernel is [in, out] there, [out, in] here), so the residuals are
    carried across leaf by leaf."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel import merge as ref_merge
    from kubeml_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from kubeml_tpu_torch.parallel import merge

    D = 2
    grads, _ = _reference_lane_grads(D)
    tree = _mlp_variables()["params"]
    treedef = jax.tree_util.tree_structure(tree)
    j_s = ref_merge.strategy_by_name(strategy, bucket_mb=SMALL_CAP_MB)
    t_s = merge.strategy_by_name(strategy, bucket_mb=SMALL_CAP_MB)
    model, _ = _port_mlp(_mlp_variables())
    port_zeros = {n: torch.zeros(t.shape) for n, t in
                  model.params_from_flax(tree).items()}
    names, plan = t_s._plan(port_zeros)
    # per-lane residual leaves in the reference's layout, and the port's
    rng = np.random.default_rng(3)
    ref_lanes = [[(rng.standard_normal(a.shape) * 1e-3).astype(np.float32)
                  for a in _leaves(tree)] for _ in range(D)]
    port_lanes = [[model.params_from_flax(jax.tree_util.tree_unflatten(
        treedef, lane))[n].numpy() for n in names] for lane in ref_lanes]
    residual = (_bucket_flats(plan, ref_lanes)
                if j_s.needs_residual else {})
    zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                   tree)

    def body(g, a, res):
        g = jax.tree_util.tree_map(lambda x: x[0], g)
        a = a.reshape(()) > 0
        raw = lax.psum(a.astype(jnp.float32), DATA_AXIS)
        return j_s.lane_merge(g, zeros, raw, jnp.float32(1.0), lane_alive=a,
                              residual=res)

    res_spec = {k: P(DATA_AXIS) for k in residual} if residual else None
    f = compat.shard_map(jax.jit(body), mesh=make_mesh(n_data=D),
                         in_specs=(P(DATA_AXIS), P(DATA_AXIS), res_spec),
                         out_specs=(P(), res_spec), check_vma=False)
    want, want_res = f(
        jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g)
                                               for g in grads]),
        jnp.asarray(alive, jnp.float32).reshape(D, 1),
        {k: jnp.asarray(v) for k, v in residual.items()} or None)

    # the gradients in the port's layout: each lane through params_from_flax
    per_lane = [model.params_from_flax(jax.tree_util.tree_unflatten(
        treedef, [g[d] for g in grads])) for d in range(D)]
    contrib = {n: torch.stack([pl[n] for pl in per_lane]) for n in names}
    alive_t = torch.tensor(alive) > 0
    got, got_res = t_s.lane_merge(
        contrib, port_zeros, alive_t.float().sum(), torch.tensor(1.0),
        lane_alive=alive_t,
        residual={k: torch.from_numpy(v) for k, v in
                  _bucket_flats(plan, port_lanes).items()}
        if j_s.needs_residual else None)
    for a, b in zip(_port_leaves(model, got), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    if alive == (0, 0):
        assert all(not a.any() for a in _port_leaves(model, got))
    if not j_s.needs_residual:
        assert got_res is None and want_res is None
        return
    # the port's new residuals, leaf by leaf in the reference's layout
    shapes = [tuple(port_zeros[n].shape) for n in names]
    back = [_leaves(model.params_to_flax(dict(zip(
        names, (torch.from_numpy(a) for a in lane)))))
        for lane in _bucket_leaves(plan, {k: v.numpy() for k, v in
                                          got_res.items()}, shapes)]
    got_flat = _bucket_flats(plan, back)
    assert set(got_flat) == set(want_res)
    for k, v in got_flat.items():
        np.testing.assert_array_equal(v, np.asarray(want_res[k]), err_msg=k)


# ---------------------------------------------------------------- skipping
@pytest.mark.parametrize("strategy", [None, "ef_bf16"],
                         ids=["implicit", "ef_bf16"])
def test_skipped_step_keeps_optimizer_and_zeroes_residual(strategy):
    """A NaN in the last step of the second dispatch: that step is
    skipped (loss 0, flag set) and leaves parameters, Adam's moments and
    step count exactly where the step before left them; the EF residuals
    are zeroed; the reference skips the same step."""
    common = dict(rounds=2, nan_at=(1, S - 1))
    _, rs, _, r_skip, _ = _run_ref(2, strategy, **common)
    model, eng, ps, losses, skipped, _ = _run_port(2, strategy, **common)
    assert skipped[1].tolist() == [0, 0, 0, 1] == r_skip[1].tolist()
    assert losses[1][-1] == 0.0 and np.isfinite(losses[1]).all()
    assert eng.readbacks == 2 * S           # one per real step
    # the same steps without the poisoned one: one dispatch of S - 1
    _, ref_eng, variables = _port_engine(2, strategy)
    clean = ref_eng.init_state(variables)
    batch, mask, keys, lr = _round(0)
    clean, _ = ref_eng.train_steps(clean, batch, mask, keys, lr, 0)
    batch, mask, keys, lr = _round(1)
    clean, _ = ref_eng.train_steps(
        clean, {k: v[:S - 1] for k, v in batch.items()}, mask[:S - 1],
        keys[:S - 1], lr, 0)
    for a, b in zip(_port_leaves(model, ps["params"]),
                    _port_leaves(model, clean["params"])):
        np.testing.assert_array_equal(a, b)
    mu, nu, steps = _moments(model, ps)
    mu0, nu0, steps0 = _moments(model, clean)
    assert steps == steps0 == {2 * S - 1}
    for a, b in zip(mu + nu, mu0 + nu0):
        np.testing.assert_array_equal(a, b)
    # the reference's weights: f32 parity, or the EF-bf16 bound
    assert _max_diff(_port_leaves(model, ps["params"]),
                     _leaves(rs["params"])) <= (
        1e-5 if strategy is None else _ef_bf16_bound(2 * S))
    if strategy is not None:
        for k, v in ps["merge_resid"].items():
            assert not v.any(), k
            assert not np.asarray(rs["merge_resid"][k]).any(), k


def test_all_masked_step_is_a_no_op():
    """A step with no real sample runs nothing: no readback, no optimizer
    step, loss 0, not flagged; the EF residuals carry."""
    model, eng, variables = _port_engine(2, "ef_bf16")
    state = eng.init_state(variables)
    batch, mask, keys, lr = _round(0)
    mask[2] = 0.0
    state, losses = eng.train_steps(state, batch, mask, keys, lr, 0)
    assert eng.readbacks == S - 1
    assert losses[2] == 0.0 and eng.last_skipped_device.tolist() == [0] * S
    assert _moments(model, state)[2] == {S - 1}
    resid = {k: v.clone() for k, v in state["merge_resid"].items()}
    state, _ = eng.train_steps(state, batch, np.zeros_like(mask), keys,
                               lr, 0)
    for k, v in state["merge_resid"].items():
        assert torch.equal(v, resid[k])


def test_explicit_merge_with_fsdp_raises():
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    model, module = _port_mlp(_mlp_variables())
    with pytest.raises(ValueError, match="fsdp"):
        SyncDPEngine(module, model.loss, model.configure_optimizers,
                     n_lanes=2, fsdp=True, merge_strategy="bucketed")


# ------------------------------------------------------------------ layout
def _gpt_nano_both():
    """gpt-nano's flax parameters, the port module holding them, and the
    port's layout shapes (q/k/v/out kernels differ from the port's)."""
    from kubeml_tpu_torch.convert import (flax_layout_shapes,
                                          random_flax_params)
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS

    params = random_flax_params(**GPT_CONFIGS["gpt-nano"], seed=0)
    model = get_model("gpt-nano")(dtype=torch.float32)
    module = model.module_from_flax({"params": params}, device="cpu")
    state = {n: t.detach() for n, t in module.state_dict().items()}
    shapes = flax_layout_shapes(state, {"params": params})
    return params, model, module, state, shapes


@pytest.mark.parametrize("model_name", ["mlp", "gpt-nano"])
@pytest.mark.parametrize("layout", ["zero1", "replicated", "fsdp"])
def test_layout_decisions_match_reference(mesh8, model_name, layout):
    """param_specs / opt_specs: the reference's ZeRO decisions on an
    8-lane mesh, leaf for leaf (the port reads the flax layout shapes: a
    GPT's q kernel is [hidden, H, Dh] there, [H*Dh, hidden] here); the
    optimizer's scalar counts replicate."""
    import jax
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.parallel.syncdp import SyncDPEngine as RefEngine
    from kubeml_tpu_torch.convert import flax_leaf_order, flax_layout_shapes
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    kw = {"zero1": dict(zero1=True), "replicated": dict(zero1=False),
          "fsdp": dict(fsdp=True)}[layout]
    if model_name == "mlp":
        params = _mlp_variables()["params"]
        model, module = _port_mlp(_mlp_variables())
        state = {n: t.detach() for n, t in module.state_dict().items()}
        shapes = flax_layout_shapes(state, {"params": params})
    else:
        params, model, module, state, shapes = _gpt_nano_both()
    ref = RefEngine(mesh8, lambda *a: None,
                    lambda lr, e: optax.adam(1e-2), donate=False, **kw)
    ref.init_state({"params": jax.tree_util.tree_map(jnp.asarray, params)})
    eng = SyncDPEngine(module, model.loss, model.configure_optimizers,
                       n_lanes=8, layout_shapes=shapes, **kw)
    eng.init_state(state)
    names = flax_leaf_order(eng.param_specs)
    want_params = [tuple(p) for p in jax.tree_util.tree_leaves(
        ref._param_specs, is_leaf=lambda x: isinstance(x, tuple))]
    assert [eng.param_specs[n] for n in names] == want_params
    adam = ref._opt_specs[0]
    assert tuple(adam.count) == ()
    for moments in (adam.mu, adam.nu):
        want = [tuple(p) for p in jax.tree_util.tree_leaves(
            moments, is_leaf=lambda x: isinstance(x, tuple))]
        assert [eng.opt_specs[n] for n in names] == want
    # the decisions depend on the layout shapes: some leaf is sharded and
    # some is not, and the port's own shapes would decide otherwise
    decided = [eng.opt_specs[n] for n in names]
    if layout != "replicated":
        assert ("data",) in decided and () in decided
    own = SyncDPEngine(module, model.loss, model.configure_optimizers,
                       n_lanes=8, **kw)
    own.init_state(state)
    if layout != "replicated":
        assert own.opt_specs != eng.opt_specs


# ------------------------------------------------------------ index feeding
def test_index_fed_dispatch_equals_host_staged():
    """train_steps_indexed over a replicated cache equals train_steps of
    the gathered samples bit for bit; a sharded cache is refused."""
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    x, y, rngs = _blobs()
    flat_x, flat_y = x.reshape(-1, 16), y.reshape(-1)
    cache = DeviceDatasetCache.from_arrays("cpu", {"x": flat_x, "y": flat_y})
    idx = np.random.default_rng(5).integers(0, len(flat_x), (S, B)).astype(
        np.int32)
    mask = np.ones((S, B), np.float32)
    mask[3, 5:] = 0.0
    out = []
    for indexed in (True, False):
        model, eng, variables = _port_engine(2, "ef_int8")
        state = eng.init_state(variables)
        for lr in LRS:
            if indexed:
                state, loss = eng.train_steps_indexed(state, cache, idx, mask,
                                                      rngs[:S], lr, 0)
            else:
                state, loss = eng.train_steps(
                    state, {"x": flat_x[idx], "y": flat_y[idx]}, mask,
                    rngs[:S], lr, 0)
        out.append((state, loss, eng.ledger.snapshot()))
    (a, la, snap_a), (b, lb, snap_b) = out
    assert torch.equal(la, lb)
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for k in a["merge_resid"]:
        assert torch.equal(a["merge_resid"][k], b["merge_resid"][k]), k
    assert set(snap_a) == {"syncdp.train_indexed", "merge.ef_int8"}
    assert set(snap_b) == {"syncdp.train", "merge.ef_int8"}
    sharded = DeviceDatasetCache.from_arrays(
        "cpu", {"x": flat_x, "y": flat_y}, layout="sharded", n_lanes=2)
    with pytest.raises(ValueError, match="replicated cache"):
        eng.train_steps_indexed(a, sharded, idx, mask, rngs[:S], 0.1, 0)


# ------------------------------------------------------------ cost ledger
@pytest.mark.parametrize("strategy", [None, "ef_bf16"],
                         ids=["implicit", "ef_bf16"])
def test_ledger_records_match_reference(strategy):
    """With KUBEML_COST_LEDGER=0 (the test suite's setting) the
    reference records its closed forms: the port's snapshot, the
    compile flag of each dispatch and the program count equal them, over
    two dispatches of one shape, one of another and two index-fed ones."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.data.device_cache import DeviceDatasetCache as RefCache
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    x, y, _ = _blobs()
    arrays = {"x": x.reshape(-1, 16), "y": y.reshape(-1)}
    idx = np.arange(S * B, dtype=np.int32).reshape(S, B)
    ref = _ref_engine(2, strategy)
    rs = ref.init_state(jax.tree_util.tree_map(jnp.asarray,
                                               _mlp_variables()))
    rcache = RefCache.from_arrays(make_mesh(n_data=2), arrays)
    model, eng, variables = _port_engine(2, strategy)
    ps = eng.init_state(variables)
    pcache = DeviceDatasetCache.from_arrays("cpu", arrays)
    flags = []
    for r, (steps, half) in enumerate([(S, 0), (S, 1), (2, 0)]):
        batch, mask, keys, lr = _round(r % 2, mask_half_at=half)
        batch = {k: v[:steps] for k, v in batch.items()}
        rs, _ = ref.train_steps(rs, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                                mask[:steps], keys[:steps], lr=lr, epoch=0)
        ps, _ = eng.train_steps(ps, batch, mask[:steps], keys[:steps], lr, 0)
        flags.append((ref.last_compiled, eng.last_compiled))
    for _ in range(2):
        batch, mask, keys, lr = _round(0)
        rs, _ = ref.train_steps_indexed(rs, rcache, idx, mask, keys, lr=lr,
                                        epoch=0)
        ps, _ = eng.train_steps_indexed(ps, pcache, idx, mask, keys, lr, 0)
        flags.append((ref.last_compiled, eng.last_compiled))
    assert [r for r, _ in flags] == [p for _, p in flags] == \
        [True, False, True, True, False]
    assert eng.programs_compiled == ref.programs_compiled == 3
    assert eng.ledger.snapshot() == ref.ledger.snapshot()
    assert eng.merge_comm_proxy(variables) == ref.merge_comm_proxy(
        _mlp_variables())


# ------------------------------------------------------------ health stats
@pytest.mark.parametrize("strategy", [None, "bucketed"],
                         ids=["implicit", "bucketed"])
def test_collect_stats_rows_match_reference(strategy):
    """collect_stats: [S, 3] rows (squared grad, update and new-param
    norms) within 1e-4 relative of the reference's, zero rows for the
    skipped step; weights equal with the stats off."""
    kw = {"merge_bucket_mb": SMALL_CAP_MB} if strategy == "bucketed" else {}
    common = dict(rounds=2, nan_at=(1, 2), collect_stats=True)
    *_, r_stats = _run_ref(2, strategy, **common, **kw)
    model, eng, ps, _, _, p_stats = _run_port(2, strategy, **common, **kw)
    got, want = np.concatenate(p_stats), np.concatenate(r_stats)
    assert got.shape == want.shape == (2 * S, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not got[S + 2].any() and got[:S + 2].all()
    common["collect_stats"] = False
    _, _, off, *_ = _run_port(2, strategy, **common, **kw)
    for n in ps["params"]:
        assert torch.equal(ps["params"][n], off["params"][n]), n


# ---------------------------------------------------------------- BatchNorm
def _bn_models(F=12):
    """Dense -> BatchNorm -> relu -> Dense with an int32 step counter in
    batch_stats, in both packages (SGD with momentum, the rate a tenth
    from epoch 15): running statistics and an integer leaf through both
    gradient paths, at a size the CPU compiles in a second."""
    import flax.linen as fnn
    import jax.numpy as jnp
    import optax

    from kubeml_tpu.models.base import ClassifierModel as JaxClassifier
    from kubeml_tpu_torch.models.base import ClassifierModel
    from kubeml_tpu_torch.models.layers import BatchNorm, Dense

    def rate(lr, epoch):
        return lr * (epoch < 15) + 0.1 * lr * (epoch >= 15)

    class JaxNet(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            count = self.variable("batch_stats", "count",
                                  lambda: jnp.zeros((), jnp.int32))
            if train and not self.is_initializing():
                count.value = count.value + 1
            x = fnn.Dense(8, dtype=jnp.float32)(x)
            x = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                              epsilon=1e-5, dtype=jnp.float32)(x)
            return fnn.Dense(4, dtype=jnp.float32)(fnn.relu(x))

    class JaxModel(JaxClassifier):
        def build(self):
            return JaxNet()

        def configure_optimizers(self, lr, epoch):
            return optax.sgd(rate(lr, epoch), momentum=0.9)

    class PortNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(F, 8, dtype=torch.float32, device="cpu")
            self.BatchNorm_0 = BatchNorm(8, dtype=torch.float32,
                                         device="cpu")
            self.Dense_1 = Dense(8, 4, dtype=torch.float32, device="cpu")
            self.register_buffer("running_count",
                                 torch.zeros((), dtype=torch.int32))

        @property
        def device(self):
            return self.Dense_0.weight.device

        def forward(self, x, train=False):
            if train:
                self.running_count += 1
            h = self.BatchNorm_0(self.Dense_0(x)[:, :, None, None], train)
            return self.Dense_1(torch.relu(h[:, :, 0, 0]))

    class PortModel(ClassifierModel):
        collections = ("batch_stats", "params")

        def build(self, dtype=torch.float32, device=None):
            return PortNet()

        def configure_optimizers(self, lr, epoch):
            return functools.partial(torch.optim.SGD, lr=rate(lr, epoch),
                                     momentum=0.9)

        def params_to_flax(self, state):
            from kubeml_tpu_torch.convert import vision_params_to_flax
            return vision_params_to_flax(state)

        def params_from_flax(self, variables):
            from kubeml_tpu_torch.convert import vision_params_from_flax
            return vision_params_from_flax(variables)

    return JaxModel(), PortModel()


def test_batchnorm_statistics_match_reference():
    """The implicit path's running statistics come from the global batch,
    the explicit path's are the cross-lane mean of per-lane statistics
    (lane 1 sees shifted inputs, so the two differ), each as the
    reference's within 1e-5; the integer counter passes through (one
    count a step on either path); the momentum buffers persist while the
    second dispatch runs at epoch 15's rate."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.parallel.syncdp import SyncDPEngine as RefEngine
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    jmodel, tmodel = _bn_models()
    rng = np.random.default_rng(0)
    Sb, Gb, F = 3, 16, 12
    y = rng.integers(0, 4, (Sb, Gb)).astype(np.int32)
    x = rng.standard_normal((Sb, Gb, F)).astype(np.float32)
    x[..., 0] += y
    x[:, Gb // 2:, 1:] += 1.5                 # lane 1 sees shifted inputs
    mask = np.ones((Sb, Gb), np.float32)
    mask[2, 3] = 0.0
    keys = rng.integers(0, 2 ** 32, (Sb, 2), dtype=np.uint32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init_variables(
        jax.random.PRNGKey(0), {"x": x[0]}))
    out = {}
    for strat in (None, "monolithic"):
        ref = RefEngine(make_mesh(n_data=2), jmodel.loss,
                        jmodel.configure_optimizers, donate=False,
                        merge_strategy=strat)
        rs = ref.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
        module = tmodel.build()
        eng = SyncDPEngine(module, tmodel.loss, tmodel.configure_optimizers,
                           n_lanes=2, merge_strategy=strat)
        ps = eng.init_state({k: v.clone() for k, v in
                             tmodel.params_from_flax(variables).items()})
        for epoch in (0, 15):
            batch = {"x": x, "y": y}
            rs, _ = ref.train_steps(rs, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, mask, keys, lr=0.1,
                                    epoch=epoch)
            ps, _ = eng.train_steps(ps, batch, mask, keys, 0.1, epoch)
        got = tmodel.params_to_flax(eng.variables(ps))
        want = jax.tree_util.tree_map(np.asarray, ref.variables(rs))
        assert int(got["batch_stats"]["count"]) == 2 * Sb
        assert int(want["batch_stats"]["count"]) == 2 * Sb
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        out[strat] = got["batch_stats"]["BatchNorm_0"]
    a, b = (_leaves(v) for v in out.values())
    assert _max_diff(a, b) > 1e-2


# -------------------------------------------------------------- the card
def _card_pair(device, strategy, dtype_name="f32"):
    """gpt-nano in f32 (dropout 0) on ``device``: its engine and state."""
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    from kubeml_tpu_torch.parallel.syncdp import SyncDPEngine

    model = get_model("gpt-nano")(dtype=torch.float32)
    module = model.module_from_flax(
        {"params": random_flax_params(**GPT_CONFIGS["gpt-nano"], seed=0)},
        device=device)
    eng = SyncDPEngine(module, model.loss, model.configure_optimizers,
                       n_lanes=2, merge_strategy=strategy)
    state = eng.init_state({n: t.detach().clone()
                            for n, t in module.state_dict().items()})
    return eng, state


@pytest.mark.gpu
def test_count1_fused_merge_on_card_equals_plain(cuda_device):
    """#5 at SyncDP's call (avg mode, count 1, a zero ref, raw_count 2
    and 0) on the card equals its plain version bit for bit."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    rng = np.random.default_rng(0)
    lengths = (7, 5000, 65536)
    pairs = [(torch.from_numpy((rng.standard_normal(n) * 3).astype(
        np.float32)), torch.zeros(n)) for n in lengths]
    one = torch.tensor(1.0)
    for raw in (2.0, 0.0):
        want = fm.fused_merge_apply("avg", pairs, one, torch.tensor(raw))
        before = fm.fused_merge_kernel.launches
        got = fm.fused_merge_apply(
            "avg", [(s.to(cuda_device), r.to(cuda_device)) for s, r in pairs],
            one.to(cuda_device), torch.tensor(raw, device=cuda_device))
        assert fm.fused_merge_kernel.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", [None, "ef_bf16"],
                         ids=["implicit", "ef_bf16"])
def test_dispatch_on_card_matches_cpu(cuda_device, strategy):
    """One dispatch of gpt-nano (f32) on the card (flash kernels, fused
    merge) and on the CPU (plain versions): weights within AdamW's bound
    (2 x steps x lr), 99.5 % within 1e-5; the same steps skipped."""
    lr, K, Gb, T = 1e-3, 2, 8, 64
    rng = np.random.default_rng(0)
    start = rng.integers(1, 500, (K, Gb, 1))
    x = ((start + np.arange(T) - 1) % 511 + 1).astype(np.int32)
    x[:, ::3, 40:] = 0
    mask = np.ones((K, Gb), np.float32)
    keys = rng.integers(0, 2 ** 32, (K, 2), dtype=np.uint32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng, state = _card_pair(dev, strategy)
        state, loss = eng.train_steps(state, {"x": x}, mask, keys, lr, 0)
        out[dev.type] = ({n: t.cpu() for n, t in state["params"].items()},
                         loss.cpu(), eng.last_skipped_device.cpu())
    (card, c_loss, c_skip), (cpu, p_loss, p_skip) = out["cuda"], out["cpu"]
    assert torch.equal(c_skip, p_skip)
    np.testing.assert_allclose(c_loss.numpy(), p_loss.numpy(), rtol=1e-4)
    diffs = torch.cat([(card[n] - cpu[n]).abs().ravel() for n in cpu])
    assert float(diffs.max()) <= 2 * K * lr
    assert float((diffs <= 1e-5).float().mean()) >= 0.995
