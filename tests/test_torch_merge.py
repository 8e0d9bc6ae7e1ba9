"""Port parity: the K-avg merge strategies over data lanes and the fused
merge-apply of kubeml_tpu_torch against the JAX package's.

Groups, each with its tolerance:
  - the fused merge's plain version against kubeml_tpu.ops.pallas.
    fused_merge, the JAX side run plain (fused=False) and as the Pallas
    kernel in interpret mode: avg mode and the all-dropped guard EXACTLY;
    sgd mode within rtol 2e-7 / atol 1e-8, the reference's own tolerance
    (XLA on the CPU may contract ``ref - lr * avg`` into an FMA);
  - the grouped ``fused_merge_apply`` over a table of buckets (empty,
    ragged, one-element, more than one launch takes) against the plain
    version and the reference's lax path, pair by pair, EXACTLY; and
    ``lane_merge`` with one grouped apply against the per-bucket merge,
    bit for bit, at the 4 MB plans of gpt-nano, ResNet-18 and vgg11;
  - bucket planner, leaf order and comm proxy: EXACTLY equal to the
    reference's (pure counters), gpt-nano and gpt-mini;
  - strategy parity at D = 2 lanes: the reference's ``lane_merge`` under
    ``shard_map`` on a 2-lane CPU mesh against the port's over a 2-lane
    axis, merged trees and new residuals BIT-IDENTICAL (two lanes have one
    summation order), a dead lane and an all-dropped merge included; at
    D = 4 the reference's bf16 lane sum is pinned (see its test);
  - the engine against the JAX engine, gpt-nano in f32, dropout 0,
    n_lanes = 2, W = 4: merged parameters within AdamW's bound (2·K·lr,
    99.5 % of the elements within 1e-5; see tests/test_torch_train.py),
    plus one quantum of the bucket for the EF strategies; counts and drop
    flags exactly; loss sums 1e-5; health stats 1e-4 relative;
  - within the port: EF bookkeeping exact (residual == payload - decoded
    per lane, zero for a dead lane), bucketed == monolithic bit for bit,
    train_rounds(R=2) == two train_round calls bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

# JAX is imported inside the parity tests only: the `gpu` test runs on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

LR = 1e-3
W, S, B, T = 4, 2, 4, 16
LANES = 2
# engine strategies: (name, merge_bucket_mb, merge_compress)
# (gpt-nano's 35,584 parameters in six buckets at 0.02 MB)
ENGINE_STRATEGIES = [("monolithic", 0.0, "none"),
                     ("bucketed", 0.02, "none"),
                     ("ef_bf16", 0.02, "bf16"), ("ef_int8", 0.02, "int8")]


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _flax_params(name, seed=0):
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    return random_flax_params(**GPT_CONFIGS[name], seed=seed)


# ------------------------------------------------------ fused merge-apply
@pytest.mark.parametrize("jax_fused", [False, True],
                         ids=["jax-plain", "jax-interpret"])
@pytest.mark.parametrize("n", [7, 1024, 5000])
def test_fused_merge_plain_matches_reference(n, jax_fused):
    """fused_avg_select / fused_sgd_select on CPU tensors (the plain
    version) against the reference's, both modes, raw_count 3 and 0."""
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas import fused_merge as ref_fm
    from kubeml_tpu_torch.ops import fused_merge as fm

    rng = np.random.default_rng(n)
    s = (rng.standard_normal(n) * 7).astype(np.float32)
    ref = rng.standard_normal(n).astype(np.float32)
    s[1] = np.nan                     # the guard path must not look at s
    kw = dict(fused=jax_fused, interpret=True if jax_fused else None)
    for raw in (3.0, 0.0):
        cnt = max(raw, 1.0)
        j_args = (jnp.asarray(s), jnp.asarray(ref), jnp.float32(cnt),
                  jnp.float32(raw))
        t_ref = torch.from_numpy(ref)
        t_args = (torch.from_numpy(s), t_ref, torch.tensor(cnt),
                  torch.tensor(raw))
        avg = fm.fused_avg_select(*t_args)
        sgd = fm.fused_sgd_select(*t_args, 0.05)
        assert avg.data_ptr() != t_ref.data_ptr()      # a fresh output
        np.testing.assert_array_equal(
            avg.numpy(), np.asarray(ref_fm.fused_avg_select(*j_args, **kw)))
        j_sgd = np.asarray(ref_fm.fused_sgd_select(*j_args, 0.05, **kw))
        if raw == 0.0:
            np.testing.assert_array_equal(avg.numpy(), ref)
            np.testing.assert_array_equal(sgd.numpy(), ref)
            np.testing.assert_array_equal(j_sgd, ref)
        else:
            np.testing.assert_allclose(sgd.numpy(), j_sgd, rtol=2e-7,
                                       atol=1e-8)


def test_fused_merge_routes_by_device():
    """CPU tensors run the plain version (no launch counted); a device
    other than CUDA or CPU raises instead of falling back."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    before = fm.fused_merge_kernel.launches
    one = torch.tensor(1.0)
    fm.fused_avg_select(torch.ones(5), torch.zeros(5), one, one)
    assert fm.fused_merge_kernel.launches == before
    meta = torch.empty(5, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fm.fused_avg_select(meta, meta, one, one)


# Grouped tables: an empty segment, ragged lengths, a one-element one, and
# (the second) more segments than one launch takes.
GROUP_TABLES = [(0, 7, 1, 5000, 4096, 4099, 12289),
                tuple(np.random.default_rng(70).integers(0, 300, 70))]


def _group_pairs(lengths, seed, nan=True):
    rng = np.random.default_rng(seed)
    pairs = []
    for n in lengths:
        s = (rng.standard_normal(n) * 7).astype(np.float32)
        ref = rng.standard_normal(n).astype(np.float32)
        if nan and n:
            s[n // 2] = np.nan          # the guard path must not look at s
        pairs.append((s, ref))
    return pairs


@pytest.mark.parametrize("table", range(len(GROUP_TABLES)),
                         ids=["ragged", "past-max-segments"])
def test_fused_merge_apply_matches_plain_and_reference(table):
    """fused_merge_apply on CPU tensors over a round's table equals
    _apply_plain pair by pair and the reference's fused_avg_select /
    fused_sgd_select (lax path) bit for bit: both modes, raw_count 3 and 0
    with NaN in s, each output fresh, in order."""
    import jax.numpy as jnp

    from kubeml_tpu.ops.pallas import fused_merge as ref_fm
    from kubeml_tpu_torch.ops import fused_merge as fm

    lengths = GROUP_TABLES[table]
    assert table == 0 or len(lengths) > fm.MAX_SEGMENTS
    pairs = _group_pairs(lengths, seed=table)
    t_pairs = [(torch.from_numpy(s), torch.from_numpy(r)) for s, r in pairs]
    before = (fm.fused_merge_kernel.launches, fm.fused_merge_kernel.segments)
    for raw in (3.0, 0.0):
        cnt = max(raw, 1.0)
        t_c, t_raw = torch.tensor(cnt), torch.tensor(raw)
        for mode, lr in (("avg", 0.0), ("sgd", 0.05)):
            got = fm.fused_merge_apply(mode, t_pairs, t_c, t_raw, lr)
            assert len(got) == len(pairs)
            for (s, r), (ts, tr), out in zip(pairs, t_pairs, got):
                assert out.shape == ts.shape and out.dtype == torch.float32
                assert out.numel() == 0 or out.data_ptr() != tr.data_ptr()
                want = fm._apply_plain(mode, ts, tr, t_c, t_raw, lr)
                assert torch.equal(out.isnan(), want.isnan())
                assert torch.equal(out.nan_to_num(), want.nan_to_num())
                j_args = (jnp.asarray(s), jnp.asarray(r), jnp.float32(cnt),
                          jnp.float32(raw))
                ref_out = (ref_fm.fused_avg_select(*j_args, fused=False)
                           if mode == "avg" else ref_fm.fused_sgd_select(
                               *j_args, lr, fused=False))
                np.testing.assert_array_equal(out.numpy(),
                                              np.asarray(ref_out))
                if raw == 0:
                    np.testing.assert_array_equal(out.numpy(), r)
    assert (fm.fused_merge_kernel.launches,
            fm.fused_merge_kernel.segments) == before   # CPU: no launch


def test_fused_merge_apply_refuses_what_the_kernel_does_not_take():
    """Mismatched lengths, a non-f32 operand, buckets on two devices, a
    count that is not 0-d and an empty table raise; nothing runs."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    one = torch.tensor(1.0)
    ok = (torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="one length"):
        fm.fused_merge_apply("avg", [ok, (torch.ones(8), torch.zeros(7))],
                             one, one)
    for bad in ((torch.ones(8, dtype=torch.float64), torch.zeros(8)),
                (torch.ones(8), torch.zeros(8, dtype=torch.bfloat16))):
        with pytest.raises(TypeError, match="must be f32"):
            fm.fused_merge_apply("avg", [ok, bad], one, one)
    with pytest.raises(TypeError, match="must be f32"):
        fm.fused_merge_apply("avg", [ok], one.double(), one)
    meta = torch.empty(8, device="meta")
    for pairs in ([ok, (meta, meta)], [(torch.ones(8), meta)]):
        with pytest.raises(ValueError, match="lives on|one device"):
            fm.fused_merge_apply("avg", pairs, one, one)
    with pytest.raises(ValueError, match="0-d"):
        fm.fused_merge_apply("avg", [ok], torch.ones(1), one)
    with pytest.raises(ValueError, match="at least one"):
        fm.fused_merge_apply("avg", [], one, one)


def _per_bucket_lane_merge(strategy, contrib, ref, raw_count, count,
                           lane_alive=None, residual=None):
    """The bucketed merge as it ran before the round's buckets shared one
    fused merge: reduce, apply and split one bucket at a time."""
    from kubeml_tpu_torch.ops.fused_merge import fused_avg_select

    names, plan = strategy._plan(ref)
    merged, new_resid = {}, {}
    for bi, bucket in enumerate(plan.buckets):
        members = [names[i] for i in bucket.indices]
        lanes = contrib[members[0]].shape[0]
        flat_c = strategy._flat([contrib[n].reshape(lanes, -1)
                                 for n in members])
        ref_f32 = strategy._flat([ref[n].reshape(-1) for n in members])
        r_in = (residual[f"b{bi}"]
                if strategy.needs_residual and bucket.compressible else None)
        s, r_out = strategy._reduce_bucket(flat_c, bucket, lane_alive, r_in)
        if r_out is not None:
            new_resid[f"b{bi}"] = r_out
        m = fused_avg_select(s, ref_f32, count, raw_count)
        off = 0
        for n, size in zip(members, bucket.sizes):
            merged[n] = m[off:off + size].reshape(ref[n].shape).to(
                ref[n].dtype)
            off += size
    return merged, new_resid


def _model_state(name):
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import module_state

    model = get_model(name)()
    if name == "vgg11":
        module = model.init_module(
            {"x": np.zeros((1, 32, 32, 3), np.float32)},
            torch.Generator().manual_seed(0), "cpu")
    else:
        module = model.build(dtype=torch.float32, device="cpu")
    return {k: v.detach().float() for k, v in module_state(module).items()}


@pytest.mark.parametrize("name,compress", [
    ("gpt-nano", "none"), ("gpt-nano", "bf16"), ("gpt-nano", "int8"),
    ("resnet18", "none"), ("vgg11", "none")])
def test_lane_merge_one_apply_equals_per_bucket(name, compress):
    """lane_merge with every bucket in one fused_merge_apply gives, at the
    model's 4 MB plan, the merged state and residuals of the per-bucket
    merge bit for bit (two lanes, one of them dead in the EF rounds;
    raw_count 3 and 0)."""
    from kubeml_tpu_torch.parallel.merge import make_strategy

    torch.manual_seed(0)
    ref = _model_state(name)
    contrib = {k: torch.randn(LANES, *v.shape) for k, v in ref.items()}
    strategy = make_strategy(bucket_mb=4.0, compress=compress)
    alive = torch.tensor([True, False])
    residual = ({k: torch.randn(LANES * n)
                 for k, n in strategy.residual_sizes(ref).items()}
                if strategy.needs_residual else None)
    for raw in (3.0, 0.0):
        raw_t = torch.tensor(raw)
        cnt = raw_t.clamp_min(1.0)
        got, g_res = strategy.lane_merge(contrib, ref, raw_t, cnt, alive,
                                         residual)
        want, w_res = _per_bucket_lane_merge(strategy, contrib, ref, raw_t,
                                             cnt, alive, residual)
        assert set(got) == set(ref)
        for k in ref:
            assert torch.equal(got[k], want[k]), k
        if residual is not None:
            assert set(g_res) == set(w_res) == set(residual)
            for k in residual:
                assert torch.equal(g_res[k], w_res[k]), k


# ----------------------------------------------- planner, order and proxy
def test_plan_buckets_matches_reference_on_mixed_leaves():
    """The reference's mixed float/int list (tests/test_merge.py): the cap
    split, a leaf larger than the cap, ints never sharing a bucket."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel import merge as ref_merge
    from kubeml_tpu_torch.parallel import merge

    shapes = [((30,), "float32"), ((30,), "float32"), ((), "int32"),
              ((200,), "float32"), ((10,), "float32")]
    j_leaves = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in shapes]
    t_leaves = [torch.empty(s, dtype=getattr(torch, d), device="meta")
                for s, d in shapes]
    for mb in (50 * 4 / (1024 * 1024), 0.0, 1.0):
        assert merge.plan_buckets(t_leaves, mb).buckets == \
            tuple(merge.Bucket(*b.__dict__.values())
                  for b in ref_merge.plan_buckets(j_leaves, mb).buckets)


@pytest.mark.parametrize("model", ["gpt-nano", "gpt-mini"])
def test_flax_leaf_order_matches_jax_flatten(model):
    """Every flax leaf filled with its own position in jax's flatten
    order: the port's state dict read in flax_leaf_order gives 0, 1, 2..."""
    import jax

    from kubeml_tpu_torch.convert import flax_leaf_order, params_from_flax

    leaves, tree = jax.tree_util.tree_flatten(_flax_params(model))
    ids = jax.tree_util.tree_unflatten(
        tree, [np.full(np.shape(a), i, np.float32)
               for i, a in enumerate(leaves)])
    sd = params_from_flax(ids)
    order = flax_leaf_order(sd)
    assert sorted(order) == sorted(sd)
    assert [int(sd[n].reshape(-1)[0]) for n in order] == \
        list(range(len(leaves)))
    assert order[:2] == ["ln_f.bias", "ln_f.weight"]
    assert order[-2:] == ["pos_embed.weight", "tok_embed.weight"]


@pytest.mark.parametrize("wire", ["none", "bf16", "int8", "wire-bf16"])
@pytest.mark.parametrize("cap", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("model", ["gpt-nano", "gpt-mini"])
def test_bucket_plans_and_comm_proxy_equal_reference(model, cap, wire):
    """Bucket plans (leaf positions, sizes, lengths, kinds), EF residual
    sizes and merge_comm_proxy equal the reference's exactly, for every
    knob combination the engines accept ("wire-bf16" is the legacy
    merge_dtype cast, no EF)."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel import merge as ref_merge
    from kubeml_tpu_torch.convert import params_from_flax
    from kubeml_tpu_torch.parallel import merge

    params = _flax_params(model)
    jvars = {"params": params}
    tvars = params_from_flax(params)
    compress = "none" if wire == "wire-bf16" else wire
    j_dt = jnp.bfloat16 if wire == "wire-bf16" else None
    t_dt = torch.bfloat16 if wire == "wire-bf16" else None
    assert merge.merge_comm_proxy(tvars, t_dt, cap, compress) == \
        ref_merge.merge_comm_proxy(jvars, j_dt, cap, compress)
    j_s = ref_merge.make_strategy(merge_dtype=j_dt, bucket_mb=cap,
                                  compress=compress)
    t_s = merge.make_strategy(merge_dtype=t_dt, bucket_mb=cap,
                              compress=compress)
    assert t_s.name == j_s.name
    assert t_s.residual_sizes(tvars) == j_s.residual_sizes(jvars)
    if t_s.name != "monolithic":
        j_plan = ref_merge.plan_buckets(jax.tree_util.tree_leaves(jvars),
                                        t_s.bucket_mb)
        _, t_plan = t_s._plan(tvars)
        assert t_plan.n_leaves == j_plan.n_leaves
        assert [tuple(b.__dict__.values()) for b in t_plan.buckets] == \
            [tuple(b.__dict__.values()) for b in j_plan.buckets]


def test_gpt_mini_merge_numbers_pinned():
    """gpt-mini's published widths: 68 per-leaf collectives monolithic;
    at the 4 MB EF cap five buckets of 791296, 789760, 789760, 919808 and
    2097152 elements, and f32 / bf16 / int8 payloads of 21,551,104 /
    10,775,552 / 5,387,796 bytes."""
    from kubeml_tpu_torch.convert import params_from_flax
    from kubeml_tpu_torch.parallel import merge

    tvars = params_from_flax(_flax_params("gpt-mini"))
    mono = merge.merge_comm_proxy(tvars)
    assert mono == {"merge_payload_bytes": 21551104, "buckets_per_round": 68,
                    "collectives_per_round": 68, "strategy": "monolithic"}
    _, plan = merge.make_strategy(compress="int8")._plan(tvars)
    assert [b.length for b in plan.buckets] == [791296, 789760, 789760,
                                                919808, 2097152]
    for compress, payload in (("none", 21551104), ("bf16", 10775552),
                              ("int8", 5387796)):
        proxy = merge.merge_comm_proxy(tvars, bucket_mb=4.0,
                                       compress=compress)
        assert proxy["merge_payload_bytes"] == payload
        assert proxy["buckets_per_round"] == 5


def test_make_strategy_errors_match_reference():
    """The same knob errors, word for word, and the default EF cap."""
    import jax.numpy as jnp

    from kubeml_tpu.parallel import merge as ref_merge
    from kubeml_tpu_torch.parallel import merge

    cases = [
        (lambda m, dt: m.make_strategy(merge_dtype=dt, compress="bf16")),
        (lambda m, dt: m.make_strategy(compress="fp4")),
        (lambda m, dt: m.strategy_by_name("nope")),
    ]
    for case in cases:
        with pytest.raises(ValueError) as ref_err:
            case(ref_merge, jnp.bfloat16)
        with pytest.raises(ValueError) as got_err:
            case(merge, torch.bfloat16)
        assert str(got_err.value) == str(ref_err.value)
    s = merge.make_strategy(compress="int8")
    assert s.name == "ef_int8" and s.bucket_mb == merge.DEFAULT_EF_BUCKET_MB
    assert merge.strategy_by_name("ef_bf16").bucket_mb == \
        merge.DEFAULT_EF_BUCKET_MB
    assert sorted(merge.MERGE_STRATEGIES) == sorted(ref_merge.MERGE_STRATEGIES)


# --------------------------------------------------- strategy-level parity
# a synthetic tree with an int leaf; a 20-element cap packs it as
# [a], [b.c], [b.n] (int, exact wire), [y, z]
TREE = {"a": ((3, 5), "float32"), "b.c": ((7,), "float32"),
        "b.n": ((4,), "int32"), "y": ((2, 3), "float32"),
        "z": ((11,), "float32")}
CAP_MB = 20 * 4 / (1024 * 1024)
STRATEGIES = ["monolithic", "monolithic-bf16", "bucketed", "bucketed-bf16",
              "ef_bf16", "ef_int8"]


def _strategies(name):
    """(reference strategy, port strategy) for a STRATEGIES entry."""
    import jax.numpy as jnp

    from kubeml_tpu.parallel import merge as ref_merge
    from kubeml_tpu_torch.parallel import merge

    base, _, wire = name.partition("-")
    j_dt, t_dt = (jnp.bfloat16, torch.bfloat16) if wire else (None, None)
    mb = 0.0 if base == "monolithic" else CAP_MB
    return (ref_merge.strategy_by_name(base, wire_dtype=j_dt, bucket_mb=mb),
            merge.strategy_by_name(base, wire_dtype=t_dt, bucket_mb=mb))


def _tree_inputs(lanes, eff, seed):
    """Per-lane contributions (dead lanes all zero, like the engine's),
    round-start values and incoming residuals (nonzero on dead lanes too,
    which must not survive)."""
    rng = np.random.default_rng(seed)
    contrib, ref = {}, {}
    for name, (shape, dt) in TREE.items():
        if dt == "int32":
            c = rng.integers(0, 50, (lanes, *shape)).astype(np.float32)
            ref[name] = rng.integers(0, 50, shape).astype(np.int32)
        else:
            c = (rng.standard_normal((lanes, *shape))
                 * 10.0 ** rng.integers(-2, 3, (lanes, *shape))
                 ).astype(np.float32)
            ref[name] = rng.standard_normal(shape).astype(np.float32)
        c[np.asarray(eff) == 0] = 0.0
        contrib[name] = c
    return contrib, ref, rng


def _nest(flat):
    """{'b.c': x} -> {'b': {'c': x}}, the flax-style tree."""
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _reference_lane_merge(strategy, contrib, ref, eff, residual):
    """The reference's lane_merge inside shard_map over a len(eff)-lane
    CPU mesh: per-lane inputs in, (merged tree, residuals [D * L]) out."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.mesh import DATA_AXIS, make_mesh

    lanes = len(eff)
    ref_tree = jax.tree_util.tree_map(jnp.asarray, _nest(ref))

    def body(c, e, res):
        c = jax.tree_util.tree_map(lambda x: x[0], c)
        e = e.reshape(())
        raw = lax.psum(e, DATA_AXIS)
        avg, nr = strategy.lane_merge(c, ref_tree, raw, jnp.maximum(raw, 1.0),
                                      lane_alive=e > 0, residual=res)
        return avg, nr

    res_spec = {k: P(DATA_AXIS) for k in residual} if residual else None
    f = compat.shard_map(
        jax.jit(body), mesh=make_mesh(n_data=lanes),
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), res_spec),
        out_specs=(P(), res_spec), check_vma=False)
    avg, nr = f(jax.tree_util.tree_map(jnp.asarray, _nest(contrib)),
                jnp.asarray(eff, jnp.float32).reshape(lanes, 1),
                {k: jnp.asarray(v) for k, v in residual.items()}
                if residual else None)
    flat = {}
    for name in TREE:
        node = avg
        for p in name.split("."):
            node = node[p]
        flat[name] = np.asarray(node)
    return flat, ({k: np.asarray(v) for k, v in nr.items()} if nr else None)


def _port_lane_merge(strategy, contrib, ref, eff, residual):
    eff_t = torch.tensor(eff, dtype=torch.float32)
    raw = eff_t.sum()
    avg, nr = strategy.lane_merge(
        {k: torch.from_numpy(v) for k, v in contrib.items()},
        {k: torch.from_numpy(v) for k, v in ref.items()}, raw,
        raw.clamp_min(1.0), lane_alive=eff_t > 0,
        residual={k: torch.from_numpy(v) for k, v in residual.items()}
        if residual else None)
    return ({k: v.numpy() for k, v in avg.items()},
            {k: v.numpy() for k, v in nr.items()} if nr else None)


def _assert_merges_equal(got, want):
    (g_avg, g_res), (w_avg, w_res) = got, want
    assert set(g_avg) == set(w_avg)
    for name in w_avg:
        assert g_avg[name].dtype == w_avg[name].dtype, name
        np.testing.assert_array_equal(g_avg[name], w_avg[name], err_msg=name)
    assert (g_res is None) == (w_res is None)
    if w_res is not None:
        assert set(g_res) == set(w_res)
        for k in w_res:
            np.testing.assert_array_equal(g_res[k], w_res[k], err_msg=k)


@pytest.mark.parametrize("eff", [(2.0, 1.0), (3.0, 0.0), (0.0, 0.0)],
                         ids=["both-alive", "dead-lane", "all-dropped"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_lane_merge_bit_identical_to_reference_two_lanes(name, eff):
    """Merged values (int leaf included) and new residuals of every
    strategy equal the reference's bit for bit at D = 2; a dead lane's
    residual is zeroed, an all-dropped merge returns the round-start
    values."""
    j_s, t_s = _strategies(name)
    contrib, ref, rng = _tree_inputs(2, eff, seed=len(name))
    residual = {k: (rng.standard_normal(2 * n) * 0.01).astype(np.float32)
                for k, n in j_s.residual_sizes(_nest(ref)).items()}
    want = _reference_lane_merge(j_s, contrib, ref, list(eff), residual)
    got = _port_lane_merge(t_s, contrib, ref, list(eff), residual)
    _assert_merges_equal(got, want)
    if j_s.needs_residual:
        assert set(residual) == {"b0", "b1", "b3"}    # b2 is the int leaf
        for k in residual:
            lanes = got[1][k].reshape(2, -1)
            for d in range(2):
                assert (lanes[d] == 0).all() == (eff[d] == 0), (k, d)
    if eff == (0.0, 0.0):
        for k in ref:
            np.testing.assert_array_equal(got[0][k], ref[k])


def test_bf16_lane_sum_rounds_once_on_the_reference_mesh():
    """What the reference's bf16 psum does over 4 lanes on its CPU mesh:
    it sums the bf16 values in f32 and rounds the sum ONCE to bf16 — not
    once per step. Lanes (1, 2^-8, 2^-8, 0): rounding once gives 1 + 2^-7;
    rounding each step gives 1 (1 + 2^-8 ties to even). The port's lossy
    wire does the same (merge._wire_sum)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from kubeml_tpu import compat
    from kubeml_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from kubeml_tpu_torch.parallel.merge import _wire_sum

    x = np.array([[1.0], [2 ** -8], [2 ** -8], [0.0]], np.float32)
    f = compat.shard_map(
        jax.jit(lambda v: lax.psum(v.astype(jnp.bfloat16), DATA_AXIS)
                .astype(jnp.float32)),
        mesh=make_mesh(n_data=4), in_specs=P(DATA_AXIS), out_specs=P(),
        check_vma=False)
    ref = np.asarray(f(jnp.asarray(x)))
    assert ref[0, 0] == 1.0 + 2 ** -7
    step = torch.from_numpy(x).to(torch.bfloat16)
    assert float(step[0] + step[1] + step[2] + step[3]) == 1.0
    np.testing.assert_array_equal(_wire_sum(torch.from_numpy(x),
                                            torch.bfloat16).numpy(), ref[0])


@pytest.mark.parametrize("name", ["monolithic-bf16", "ef_bf16", "ef_int8",
                                  "bucketed"])
def test_lane_merge_bit_identical_to_reference_four_lanes(name):
    """At D = 4 (a dead lane among them) the port's lane order and its
    rounded-once bf16 sums still give the reference's merge bit for bit."""
    j_s, t_s = _strategies(name)
    eff = [1.0, 2.0, 0.0, 1.0]
    contrib, ref, rng = _tree_inputs(4, eff, seed=11)
    residual = {k: (rng.standard_normal(4 * n) * 0.01).astype(np.float32)
                for k, n in j_s.residual_sizes(_nest(ref)).items()}
    _assert_merges_equal(_port_lane_merge(t_s, contrib, ref, eff, residual),
                         _reference_lane_merge(j_s, contrib, ref, eff,
                                               residual))


# --------------------------------------------------------- engine parity
def _nano():
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS
    return GPT_CONFIGS["gpt-nano"]


def _round_inputs(seed=0, worker_mask=(1.0, 1.0, 1.0, 1.0)):
    """Arithmetic token runs with a padded tail, a padded example and
    worker 2's second step masked."""
    rng = np.random.default_rng(seed)
    start = rng.integers(1, 500, (W, S, B, 1))
    x = ((start + np.arange(T) - 1) % 511 + 1).astype(np.int32)
    x[:, :, 0, 11:] = 0
    smask = np.ones((W, S, B), np.float32)
    smask[0, 1, 3] = 0.0
    stmask = np.ones((W, S), np.float32)
    stmask[2, 1] = 0.0
    rngs = rng.integers(0, 2 ** 32, (W, S, 2), dtype=np.uint32)
    return x, smask, stmask, np.asarray(worker_mask, np.float32), rngs


def _port_engine(params, bucket_mb=0.0, compress="none", collect=False,
                 loss_wrap=None, lanes=LANES):
    from kubeml_tpu_torch.convert import params_from_flax
    from kubeml_tpu_torch.models.gpt import GPTNano
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model = GPTNano()
    module = model.build(dtype=torch.float32, device="cpu")
    module.load_state_dict(params_from_flax(params))
    loss = model.loss if loss_wrap is None else loss_wrap(model.loss)
    return KAvgEngine(module, loss, model.metrics, model.configure_optimizers,
                      n_lanes=lanes, merge_bucket_mb=bucket_mb,
                      merge_compress=compress, collect_stats=collect)


def _record_merges(engine):
    """Wrap the engine's lane_merge to keep each call's inputs and
    outputs (copies), for the EF bookkeeping checks."""
    calls = []
    inner = engine._merge.lane_merge

    def recording(contrib, ref, raw_count, count, lane_alive=None,
                  residual=None):
        avg, nr = inner(contrib, ref, raw_count, count, lane_alive,
                        residual)
        calls.append(dict(
            contrib={k: v.clone() for k, v in contrib.items()},
            alive=lane_alive.clone(),
            residual=({k: v.clone() for k, v in residual.items()}
                      if residual is not None else None),
            new_residual=({k: v.clone() for k, v in nr.items()}
                          if nr is not None else None)))
        return avg, nr

    engine._merge.lane_merge = recording
    return calls


def _ef_payloads(strategy, call):
    """Per compressible bucket: (key, names, payload [D, L], lane mask),
    from a recorded merge."""
    names, plan = strategy._plan({k: v[0] for k, v in
                                  call["contrib"].items()})
    alive = call["alive"].numpy()
    out = []
    for bi, bucket in enumerate(plan.buckets):
        if not bucket.compressible:
            continue
        key = f"b{bi}"
        members = [names[i] for i in bucket.indices]
        c = np.concatenate([call["contrib"][n].reshape(LANES, -1).numpy()
                            for n in members], axis=1)
        r_in = call["residual"][key].numpy().reshape(LANES, -1)
        p = np.where(alive[:, None], c + r_in, np.float32(0.0))
        out.append((key, members, p.astype(np.float32), alive))
    return out


def _residual(compress, p):
    """(expected residual before the lane mask, quantum) on the host. bf16:
    payload - its ml_dtypes bf16 cast. int8: the reference's scale
    (max|p| times the f32 reciprocal of 127, as XLA folds ``/ 127.0``),
    round half to even, and payload - q * scale rounded ONCE (XLA fuses it
    into a multiply-add; exact in f64). The quantum bounds one element's
    quantization step."""
    import jax.numpy as jnp

    amax = np.float32(np.abs(p).max())
    if compress == "bf16":
        return p - p.astype(jnp.bfloat16).astype(np.float32), \
            float(amax) * 2 ** -7
    scale = np.float32(amax * np.float32(1.0 / 127.0))
    q = np.round(p / scale) if scale > 0 else np.zeros_like(p)
    exact = p.astype(np.float64) - q.astype(np.float64) * np.float64(scale)
    return exact.astype(np.float32), float(scale)


def _assert_ef_bookkeeping_exact(engine, compress, call):
    """residual' == payload - decoded per lane, exactly (int8: the
    difference rounded once); zero for a dead lane. Returns each
    parameter's quantum."""
    quanta = {}
    for key, members, p, alive in _ef_payloads(engine._merge, call):
        resid, quantum = _residual(compress, p)
        want = np.where(alive[:, None], resid, np.float32(0.0))
        got = call["new_residual"][key].numpy().reshape(LANES, -1)
        np.testing.assert_array_equal(got, want, err_msg=key)
        for d in np.flatnonzero(~alive):
            assert (got[d] == 0).all()
        quanta.update({n: quantum for n in members})
    return quanta


@pytest.mark.parametrize("name,bucket_mb,compress", ENGINE_STRATEGIES,
                         ids=[s[0] for s in ENGINE_STRATEGIES])
def test_engine_round_matches_jax_engine(name, bucket_mb, compress):
    """One round at n_lanes = 2, W = 4, collect_stats on, against the JAX
    engine on a 2-lane mesh: merged params (AdamW bound, + one quantum
    for EF), counts and drops, loss sums, health stats. Then a second
    port round with lane 1 dead: EF bookkeeping exact, lane 1 zeroed."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.models.gpt import GPTNano as JaxNano
    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.convert import params_from_flax

    params = _flax_params("gpt-nano", seed=4)
    jm = JaxNano()
    jm._module = JaxGPT(**_nano(), dropout=0.0, dtype=jnp.float32,
                        attn_impl="reference")
    jeng = JaxEngine(make_mesh(n_data=LANES), jm.loss, jm.metrics,
                     jm.configure_optimizers, donate=False,
                     merge_bucket_mb=bucket_mb, merge_compress=compress,
                     collect_stats=True)
    teng = _port_engine(params, bucket_mb, compress, collect=True)
    assert teng.merge_strategy == jeng.merge_strategy == name
    calls = _record_merges(teng)
    x, smask, stmask, wmask, rngs = _round_inputs(seed=1)
    javg, jst = jeng.train_round(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        {"x": jnp.asarray(x)}, smask, stmask, wmask, rngs, LR, 0)
    start = params_from_flax(params)
    tavg, tst = teng.train_round(start, {"x": x}, smask, stmask, wmask,
                                 rngs, LR, 0)

    quanta = ({} if compress == "none"
              else _assert_ef_bookkeeping_exact(teng, compress, calls[0]))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   javg["params"]))
    diffs, excess = [], []
    for n in want:
        d = (want[n] - tavg[n]).abs().numpy().ravel()
        diffs.append(d)
        excess.append(d.max() - (2 * S * LR + quanta.get(n, 0.0)))
    diffs = np.concatenate(diffs)
    assert max(excess) <= 0.0, max(excess)
    assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()
    np.testing.assert_array_equal(tst.step_count, jst.step_count)
    np.testing.assert_array_equal(tst.sample_count, jst.sample_count)
    np.testing.assert_array_equal(tst.dropped, np.asarray(jst.dropped))
    assert tst.contributors == jst.contributors == W
    np.testing.assert_allclose(tst.loss_sum, np.asarray(jst.loss_sum),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst.stat_device.numpy(),
                               np.asarray(jst.stat_device), rtol=1e-4)
    np.testing.assert_allclose(float(tst.spread_device),
                               float(jst.spread_device), rtol=1e-4)

    x2, smask2, stmask2, wmask2, rngs2 = _round_inputs(
        seed=2, worker_mask=(1.0, 1.0, 0.0, 0.0))
    teng.train_round(tavg, {"x": x2}, smask2, stmask2, wmask2, rngs2, LR, 0)
    assert calls[1]["alive"].tolist() == [True, False]
    if compress != "none":
        _assert_ef_bookkeeping_exact(teng, compress, calls[1])
        for v in teng._ef_state.values():
            lanes = v.reshape(LANES, -1)
            assert (lanes[1] == 0).all() and (lanes[0] != 0).any()


def _poison_wrap(worker_values):
    """A loss wrapper adding a per-step poison leaf [W, S, B] (0 or NaN)
    to every per-example loss (tests/test_torch_train.py's _poison)."""
    def wrap(loss):
        def poisoned(module, batch, gen, smask):
            return loss(module, batch, gen, smask) + batch["poison"]
        return poisoned
    poison = np.zeros((W, S, B), np.float32)
    for w, val in enumerate(worker_values):
        poison[w] = val
    return wrap, poison


def _same_round(a, b):
    (a_avg, a_st), (b_avg, b_st) = a, b
    assert set(a_avg) == set(b_avg)
    for n in a_avg:
        assert torch.equal(a_avg[n], b_avg[n]), n
    assert torch.equal(a_st.loss_sum_device, b_st.loss_sum_device)
    assert torch.equal(a_st.dropped_device, b_st.dropped_device)
    for attr in ("stat_device", "spread_device"):
        x, y = getattr(a_st, attr), getattr(b_st, attr)
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y), attr


@pytest.mark.parametrize("poisoned", [False, True], ids=["clean", "nan"])
@pytest.mark.parametrize("collect", [False, True],
                         ids=["stats-off", "stats-on"])
def test_bucketed_engine_bit_identical_to_monolithic(collect, poisoned):
    """The bucketed (fused-apply) engine equals the monolithic one bit for
    bit — weights, loss sums, drops, stats — with stats on and off and
    with worker 3 going NaN (dropped by the select, lane 1 still alive)."""
    from kubeml_tpu_torch.convert import params_from_flax

    params = _flax_params("gpt-nano", seed=7)
    x, smask, stmask, wmask, rngs = _round_inputs(seed=3)
    wrap, poison = _poison_wrap((0.0, 0.0, 0.0, np.nan if poisoned else 0.0))
    out = []
    for mb in (0.0, 0.02):
        eng = _port_engine(params, bucket_mb=mb, collect=collect,
                           loss_wrap=wrap)
        out.append(eng.train_round(params_from_flax(params),
                                   {"x": x, "poison": poison}, smask, stmask,
                                   wmask, rngs, LR, 0))
    assert out[1][0] is not None and len(out[0][0]) == len(out[1][0])
    _same_round(*out)
    np.testing.assert_array_equal(out[0][1].dropped,
                                  [0, 0, 0, 1.0 if poisoned else 0])


@pytest.mark.parametrize("name,bucket_mb,compress", ENGINE_STRATEGIES,
                         ids=[s[0] for s in ENGINE_STRATEGIES])
def test_train_rounds_equal_sequential_rounds(name, bucket_mb, compress):
    """train_rounds(R=2) equals two train_round calls bit for bit, EF
    residuals carried from the first round into the second (lane 1 dead
    in round 2), stats stacked per round."""
    from kubeml_tpu_torch.convert import params_from_flax

    params = _flax_params("gpt-nano", seed=8)
    rounds = [_round_inputs(seed=5),
              _round_inputs(seed=6, worker_mask=(1.0, 1.0, 0.0, 0.0))]
    seq = _port_engine(params, bucket_mb, compress, collect=True)
    state, stats = params_from_flax(params), []
    for x, *rest in rounds:
        state, st = seq.train_round(state, {"x": x}, *rest, LR, 0)
        stats.append(st)
    multi = _port_engine(params, bucket_mb, compress, collect=True)
    stacked = [np.stack(a) for a in zip(*rounds)]
    m_state, m_st = multi.train_rounds(params_from_flax(params),
                                       {"x": stacked[0]}, *stacked[1:], LR,
                                       0)
    for n in state:
        assert torch.equal(state[n], m_state[n]), n
    for attr in ("loss_sum_device", "dropped_device", "stat_device",
                 "spread_device"):
        assert torch.equal(getattr(m_st, attr),
                           torch.stack([getattr(s, attr) for s in stats]))
    np.testing.assert_array_equal(m_st.step_count,
                                  np.stack([s.step_count for s in stats]))
    np.testing.assert_array_equal(m_st.sample_count,
                                  np.stack([s.sample_count for s in stats]))
    assert m_st.contributors == sum(s.contributors for s in stats) == 6
    assert (seq._ef_state is None) == (compress == "none")
    if compress != "none":
        assert set(seq._ef_state) == set(multi._ef_state)
        for k, v in seq._ef_state.items():
            assert torch.equal(v, multi._ef_state[k]), k


def test_engine_knobs_and_residual_state():
    """The lane check's message, merge_dtype validation, the strategy's
    name and comm proxy, and residual reset/re-make."""
    from kubeml_tpu_torch.convert import params_from_flax
    from kubeml_tpu_torch.models.gpt import GPTNano
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    params = _flax_params("gpt-nano", seed=9)
    model = GPTNano()
    module = model.build(dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="merge_dtype must be a floating"):
        KAvgEngine(module, model.loss, model.metrics,
                   model.configure_optimizers, merge_dtype=torch.int8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        KAvgEngine(module, model.loss, model.metrics,
                   model.configure_optimizers, merge_dtype=torch.bfloat16,
                   merge_compress="int8")
    eng = _port_engine(params, compress="int8", lanes=3)
    x, smask, stmask, wmask, rngs = _round_inputs()
    with pytest.raises(ValueError, match="W=4 not a multiple of lanes=3"):
        eng.train_round(params_from_flax(params), {"x": x}, smask, stmask,
                        wmask, rngs, LR, 0)
    state = params_from_flax(params)
    assert eng.merge_strategy == "ef_int8"
    proxy = eng.merge_comm_proxy(state)
    assert proxy["strategy"] == "ef_int8" and proxy["buckets_per_round"] == 1
    first = eng._ef_residuals(state)
    assert eng._ef_residuals(state) is first
    assert all(v.numel() == 3 * n and not v.any() for v, n in zip(
        first.values(), eng._merge.residual_sizes(state).values()))
    eng.reset_merge_residuals()
    assert eng._ef_state is None
    assert eng._ef_residuals(state) is not first


# ------------------------------------------------------------------- card
@pytest.mark.gpu
def test_fused_merge_kernel_equals_plain_on_card(cuda_device):
    """The Hopper kernel against its plain version on the card, bit for
    bit: both modes, raw_count 3 and 0 (s holding NaN), ragged lengths and
    an unaligned view (the scalar path); launches counted."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for n in (7, 5000, 2 ** 21 + 3):
        s = torch.randn(n + 1, device=cuda_device, generator=gen) * 7
        ref = torch.randn(n + 1, device=cuda_device, generator=gen)
        s[2] = float("nan")
        for s_, r_ in ((s[:n], ref[:n]), (s[1:], ref[1:])):
            for raw in (3.0, 0.0):
                raw_t = torch.tensor(raw, device=cuda_device)
                cnt = raw_t.clamp_min(1.0)
                for mode, lr in (("avg", 0.0), ("sgd", 0.05)):
                    before = fm.fused_merge_kernel.launches
                    got = fm.fused_merge_kernel(mode, s_, r_, cnt, raw_t, lr)
                    torch.cuda.synchronize()
                    assert fm.fused_merge_kernel.launches == before + 1
                    want = fm._apply_plain(mode, s_, r_, cnt, raw_t, lr)
                    assert torch.equal(got, want) or (
                        raw > 0 and torch.equal(got.isnan(), want.isnan())
                        and torch.equal(got.nan_to_num(), want.nan_to_num()))
                    if raw == 0:
                        assert torch.equal(got, r_)


@pytest.mark.gpu
def test_grouped_fused_merge_equals_plain_on_card(cuda_device):
    """One grouped launch per MAX_SEGMENTS buckets against the plain
    version, bit for bit: the CPU tests' tables plus a table of unaligned
    views (the register path) beside aligned ones, both modes, raw_count 3
    and 0 (s holding NaN), the outputs at 16-byte-aligned offsets of one
    buffer; launches and segments counted."""
    from kubeml_tpu_torch.ops import fused_merge as fm

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    base_s = torch.randn(40000, device=cuda_device, generator=gen) * 7
    base_r = torch.randn(40000, device=cuda_device, generator=gen)
    base_s[::997] = float("nan")
    unaligned = [(base_s[1:8194], base_r[1:8194]),
                 (base_s[9000:9001], base_r[9000:9001]),
                 (base_s[10000:30000], base_r[10000:30000]),
                 (base_s[30001:39999], base_r[30002:40000])]
    tables = [[(torch.from_numpy(s).to(cuda_device),
                torch.from_numpy(r).to(cuda_device))
               for s, r in _group_pairs(t, seed=i)]
              for i, t in enumerate(GROUP_TABLES)] + [unaligned]
    for pairs in tables:
        busy = sum(1 for s, _ in pairs if s.numel())
        for raw in (3.0, 0.0):
            raw_t = torch.tensor(raw, device=cuda_device)
            cnt = raw_t.clamp_min(1.0)
            for mode, lr in (("avg", 0.0), ("sgd", 0.05)):
                before = (fm.fused_merge_kernel.launches,
                          fm.fused_merge_kernel.segments)
                got = fm.fused_merge_apply(mode, pairs, cnt, raw_t, lr)
                torch.cuda.synchronize()
                assert (fm.fused_merge_kernel.launches - before[0],
                        fm.fused_merge_kernel.segments - before[1]) == (
                    -(-busy // fm.MAX_SEGMENTS), busy)
                for (s, r), out in zip(pairs, got):
                    assert out.data_ptr() % 16 == 0
                    want = fm._apply_plain(mode, s, r, cnt, raw_t, lr)
                    assert torch.equal(out.isnan(), want.isnan())
                    assert torch.equal(out.nan_to_num(), want.nan_to_num())
                    if raw == 0:
                        assert torch.equal(out, r)
