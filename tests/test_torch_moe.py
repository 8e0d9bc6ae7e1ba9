"""Port parity: the mixture-of-experts routing (kubeml_tpu_torch/parallel/
ep.py) and gpt-moe-mini (kubeml_tpu_torch/models/gpt.py) against the JAX
package's (kubeml_tpu/parallel/ep.py, kubeml_tpu/models/gpt.py), on the
CPU, at a small size: vocab 64, hidden 32, 2 layers, 2 heads, 4 experts
of a 32-wide FFN, T = 16 (the plans and the job run at the published
widths).

The same numpy router logits, tokens and flax parameters drive both
packages; the JAX side runs its ``attn_impl="reference"`` path.

Tolerances:
  - routing: dispatch and each expert's fill exactly; combine and the
    load-balance aux within 1e-6;
  - moe_apply's output: 1e-5 on the same inputs (it runs in f32 in
    either compute dtype); each block's MoE output in each package's own
    forward: f32 1e-5, bf16 2e-2;
  - the model's logits: f32 1e-5; bf16 the per-sequence loss within 2e-2
    and the logits within the dense twin's own cross-framework gap;
  - a K-avg round (f32, dropout 0, AdamW): counts and drop flags
    exactly, loss sums 1e-5 relative, merged parameters within AdamW's
    2·K·lr (99.5 % within 1e-5), the ledger's records equal;
  - bucket plans, leaf order and the checkpoint bridge exactly.

A top-2 choice is discontinuous in the router logits. Before comparing a
model's logits the tests state their premise: every real token's two
gaps (first to second choice, second to third) in the reference's router
logits exceed 1e-4, and the port routes every real token to the same two
experts. bf16 rounds the router's input (the LayerNorm of a bf16
residual) differently in the two frameworks, by up to ~0.02 at this
size, so in bf16 a near-tie can flip; a flip fails the test as a failed
premise, by name, never as a tolerance. A sweep over eight seeds holds
every bf16 flip to a near-tie that the rounding explains.
"""

import numpy as np
import pytest
import torch

# JAX is imported inside the tests only: the `gpu` tests run on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port

TINY = dict(vocab_size=64, max_len=16, hidden=32, layers=2, heads=2, ffn=32)
E, T = 4, 16
W, S, B = 2, 2, 4
LR = 1e-3
TOL = {"f32": 1e-5, "bf16": 2e-2}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
MARGIN = 1e-4          # the premise: reference router gaps past this


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """Beside other test workers more intra-op threads only oversubscribe
    the cores; one keeps the CPU sums in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tokens(seed, n=3, t=T, vocab=64):
    """Token ids with a padded tail, interior pads and, from n = 4, an
    all-pad row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (n, t)).astype(np.int32)
    x[0, t - 6:] = 0
    x[1, 3:5] = 0
    if n >= 4:
        x[n - 1] = 0
    return x


def leaves(tree):
    import jax

    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


# ------------------------------------------------------------- routing
def _router_logits(seed, t=24, e=E):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32)


def _token_mask(t, masked):
    mask = np.ones(t, np.float32)
    if masked:
        mask[[2, 7, 8, t - 1]] = 0.0
    return mask


def _assert_routing_equal(got, want):
    """(dispatch, combine, aux) of both packages: dispatch and each
    expert's fill exactly, combine and aux within 1e-6."""
    (d, c, a), (jd, jc, ja) = got, want
    jd, jc = np.asarray(jd), np.asarray(jc)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(d.sum(dim=(0, 2)).numpy(),
                                  jd.sum(axis=(0, 2)))
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("capacity", [24, 8, 2],
                         ids=["fits", "formula", "overflow"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "padded"])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_make_dispatch_matches_reference(k, masked, capacity):
    """The same router logits [24, 4]: top-1, top-2 and k > E (every
    expert), with and without a token mask, at a capacity that takes
    every choice (24), the capacity formula's (ceil(24 / 4 x 1.25) = 8)
    and one that drops (2)."""
    import jax.numpy as jnp

    from kubeml_tpu.parallel.ep import make_dispatch as ref_dispatch
    from kubeml_tpu_torch.parallel.ep import make_dispatch

    logits = _router_logits(k + 10 * masked)
    mask = _token_mask(len(logits), masked) if masked else None
    want = ref_dispatch(jnp.asarray(logits), capacity, k,
                        token_mask=None if mask is None
                        else jnp.asarray(mask))
    got = make_dispatch(torch.from_numpy(logits), capacity, k,
                        token_mask=None if mask is None
                        else torch.from_numpy(mask))
    _assert_routing_equal(got, want)
    fill = got[0].sum(dim=(0, 2))
    choices = min(k, E) * (len(logits) - 4 * masked)
    assert int(fill.max()) <= capacity
    if capacity == 2:
        assert float(got[0].sum()) < choices     # tokens overflowed
    elif capacity == 24:
        assert float(got[0].sum()) == choices
    if masked:
        # a masked row claims nothing and weighs nothing
        assert float(got[0][[2, 7, 8]].abs().sum()) == 0.0
        assert float(got[1][[2, 7, 8]].abs().sum()) == 0.0


def test_route_tokens_and_moe_apply_match_reference():
    """route_tokens (the f32 router product and the capacity formula) and
    moe_apply over the same tokens [24, 32], padding masked, parameters
    from the reference's init_moe_params: routing as above, y within
    f32 1e-5."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.ep import init_moe_params, moe_apply as ref_apply
    from kubeml_tpu.parallel.ep import route_tokens as ref_route
    from kubeml_tpu_torch.parallel.ep import moe_apply, route_tokens

    params = {k: np.array(v) for k, v in init_moe_params(
        jax.random.PRNGKey(0), 32, 48, E).items()}
    rng = np.random.default_rng(3)
    params["bi"] = 0.05 * rng.standard_normal(params["bi"].shape).astype(
        np.float32)
    params["bo"] = 0.05 * rng.standard_normal(params["bo"].shape).astype(
        np.float32)
    x = rng.standard_normal((24, 32)).astype(np.float32)
    mask = _token_mask(24, True)
    logits = x @ params["router"]
    top = -np.sort(-logits, axis=1)
    real = mask > 0
    assert (top[real, 0] - top[real, 1]).min() > MARGIN
    assert (top[real, 1] - top[real, 2]).min() > MARGIN
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    _assert_routing_equal(
        route_tokens(tp["router"], torch.from_numpy(x),
                     token_mask=torch.from_numpy(mask)),
        ref_route(jp["router"], jnp.asarray(x), token_mask=jnp.asarray(mask)))
    y, aux = moe_apply(tp, torch.from_numpy(x),
                       token_mask=torch.from_numpy(mask))
    jy, jaux = ref_apply(jp, jnp.asarray(x), token_mask=jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# ------------------------------------------------------------ the models
def jax_moe(dtype="f32", dropout=0.0):
    """The JAX package's GPTMoEMini at the tiny widths."""
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.models.gpt import GPTMoEMini as JaxMoE

    model = JaxMoE()
    model._module = JaxGPT(**TINY, n_experts=E, dropout=dropout,
                           attn_impl="reference",
                           dtype=jnp.float32 if dtype == "f32"
                           else jnp.bfloat16)
    return model


def port_moe(dtype="f32", dropout=0.0):
    """The port's GPTMoEMini at the tiny widths."""
    from kubeml_tpu_torch.convert import params_to_flax
    from kubeml_tpu_torch.models.gpt import GPTModule, GPTMoEMini

    class Tiny(GPTMoEMini):
        def build(self, dtype=None, device=None):
            return GPTModule(**TINY, n_experts=E, dropout=dropout,
                             dtype=dtype or self.dtype, device=device)

        def params_to_flax(self, state):
            return params_to_flax(state, heads=TINY["heads"])

    return Tiny(dtype=TORCH_DT[dtype])


def moe_params(seed=0):
    """A flax-layout tiny MoE tree (the port's random_flax_params with
    experts; tests/test_torch_gpt.py holds its structure to flax's)."""
    from kubeml_tpu_torch.convert import random_flax_params

    return random_flax_params(**TINY, seed=seed, n_experts=E)


def moe_params_dense(seed=0):
    """The dense twin of moe_params: the same widths and seed, no experts
    (its embeddings and first attention block are moe_params')."""
    from kubeml_tpu_torch.convert import random_flax_params

    return random_flax_params(**TINY, seed=seed)


def port_module(params, dtype="f32", dropout=0.0):
    module = port_moe(dtype, dropout).build(device="cpu")
    module.load_state_dict(port_moe().params_from_flax(params))
    return module


def routing_premise(params, x, jax_ln, port_ln):
    """The comparison's premise, per layer over the real tokens: the
    reference's router gaps exceed MARGIN and the port picks the same two
    experts in the same order. ``*_ln``: each layer's router input
    [B·T, hidden] in each package."""
    real = (x != 0).reshape(-1)
    for i, (a, b) in enumerate(zip(jax_ln, port_ln)):
        r = params[f"layer_{i}"]["moe"]["router"]
        ref, got = (np.asarray(a, np.float32) @ r,
                    np.asarray(b, np.float32) @ r)
        top = -np.sort(-ref, axis=1)[real]
        gaps = np.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
        if gaps.min() <= MARGIN:
            pytest.fail(f"premise: layer {i}: a reference router gap of "
                        f"{gaps.min():.3g} <= {MARGIN}")
        pick = np.argsort(-ref, axis=1)[:, :2]
        mine = np.argsort(-got, axis=1)[:, :2]
        flips = np.nonzero((pick != mine).any(axis=1) & real)[0]
        if len(flips):
            pytest.fail(f"premise: layer {i}: the frameworks route tokens "
                        f"{flips.tolist()} differently (gaps "
                        f"{gaps.min():.3g} and up)")


def capture_port_moe(monkeypatch):
    """The port's router inputs and MoE outputs, one [B·T, hidden] array
    a layer each, as moe_apply receives and returns them."""
    from kubeml_tpu_torch.models import gpt

    seen, outs = [], []
    real = gpt.moe_apply

    def spy(params, x, **kw):
        seen.append(x.detach().float().numpy().copy())
        y, aux = real(params, x, **kw)
        outs.append(y.detach().float().numpy().copy())
        return y, aux

    monkeypatch.setattr(gpt, "moe_apply", spy)
    return seen, outs


def reference_moe(inter, layers=TINY["layers"]):
    """The reference's router inputs (its f32 LayerNorm_1 output) and
    MoEFFN outputs, one [B·T, hidden] array a layer each."""
    def flat(a):
        return np.array(a, np.float32).reshape(-1, TINY["hidden"])

    return ([flat(inter[f"layer_{i}"]["LayerNorm_1"]["__call__"][0])
             for i in range(layers)],
            [flat(inter[f"layer_{i}"]["moe"]["__call__"][0])
             for i in range(layers)])


def assert_moe_on_reference_inputs(params, x, jax_ln, jax_y):
    """The port's moe_apply on the reference's own router inputs gives
    the reference's MoE output within 1e-5 in either compute dtype: both
    run the router and the experts in f32."""
    from kubeml_tpu_torch.parallel.ep import moe_apply

    mask = torch.from_numpy((x != 0).reshape(-1).astype(np.float32))
    for i, (ln, want) in enumerate(zip(jax_ln, jax_y)):
        lp = {n: torch.from_numpy(np.array(v))
              for n, v in params[f"layer_{i}"]["moe"].items()}
        y, _ = moe_apply(lp, torch.from_numpy(ln), token_mask=mask)
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"layer {i}")


def _logits_both(params, x, dtype, train, n_experts=E):
    """The reference's logits and intermediates, and the port's logits
    and aux, of the same tokens."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.models.gpt import GPTModule

    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jm = JaxGPT(**TINY, n_experts=n_experts, dropout=0.0,
                attn_impl="reference", dtype=jdt)
    kw = dict(rngs={"dropout": jax.random.PRNGKey(0)}) if train else {}
    want, inter = jm.apply({"params": params}, jnp.asarray(x), train=train,
                           capture_intermediates=True,
                           mutable=["intermediates"], **kw)
    module = GPTModule(**TINY, n_experts=n_experts, dropout=0.0,
                       dtype=TORCH_DT[dtype], device="cpu")
    module.load_state_dict(port_moe().params_from_flax(params))
    got, aux = module.logits_and_aux(
        torch.from_numpy(x), train=train,
        generator=torch.Generator().manual_seed(0))
    return (np.asarray(want), inter["intermediates"]), (module, got, aux)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gpt_moe_logits_match_jax(dtype, train, monkeypatch):
    """Logits (and each layer's aux) of three sequences with a padded tail
    and interior pads, in eval and in train mode with dropout 0; the
    routing premise first.

    The MoE part at the stated tolerances in both dtypes: the port's
    moe_apply on the reference's router inputs within 1e-5 (both run it
    in f32), and each block's MoE output in each package's own forward
    within f32 1e-5 / bf16 2e-2. f32: logits within 1e-5. bf16: the
    per-sequence LM loss within 2e-2; the logits themselves differ across
    the frameworks by up to ~0.02-0.07 already in the dense GPT block
    (bf16 attention and the fused bias of its projections), so they are
    held to the dense twin's own difference (the same widths, seed and
    tokens, n_experts = 0): the MoE blocks, routed alike, widen
    nothing."""
    from kubeml_tpu.models.gpt import _lm_per_example as ref_loss
    from kubeml_tpu_torch.models.gpt import _lm_per_example

    params = moe_params(0)
    x = tokens(2)
    seen, port_y = capture_port_moe(monkeypatch)
    (want, inter), (module, got, aux) = _logits_both(params, x, dtype,
                                                     train)
    jax_ln, jax_y = reference_moe(inter)
    routing_premise(params, x, jax_ln, seen)
    assert_moe_on_reference_inputs(params, x, jax_ln, jax_y)
    real = (x != 0).reshape(-1)
    for i, (mine, ref) in enumerate(zip(port_y, jax_y)):
        np.testing.assert_allclose(mine[real], ref[real], rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=f"layer {i}")
    assert got.dtype == torch.float32 and got.shape == (3, T, 64)
    outs = [got.detach()]
    if not train:
        # the dense inference forward (plain attention) runs the MoE
        # blocks too
        outs.append(module(torch.from_numpy(x)))
    if dtype == "bf16":
        (dense_want, _), (_, dense_got, _) = _logits_both(
            moe_params_dense(0), x, dtype, train, n_experts=0)
        dense_gap = np.abs(dense_got.detach().numpy() - dense_want).max()
    for out in outs:
        if dtype == "f32":
            np.testing.assert_allclose(out.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
            continue
        np.testing.assert_allclose(
            _lm_per_example(out, torch.from_numpy(x)).numpy(),
            np.asarray(ref_loss(want, x)), rtol=2e-2, atol=2e-2)
        assert np.abs(out.numpy() - want).max() <= dense_gap, dense_gap
    sown = [float(inter[f"layer_{i}"]["moe"]["moe_aux"][0])
            for i in range(TINY["layers"])]
    np.testing.assert_allclose([float(a.detach()) for a in aux], sown,
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("seed", range(8))
def test_gpt_moe_bf16_routing_flips_only_at_near_ties(seed, monkeypatch):
    """bf16, eval, eight seeds of parameters and tokens, no seed chosen:
    (1) the port's moe_apply on the reference's router inputs gives the
    reference's MoE output within 1e-5 in every layer; (2) where the two
    packages' own forwards route a real token differently, the flip is a
    near-tie that bf16 rounding explains: the reference's gap between the
    choices at stake is below twice the largest difference of that
    token's router logits across the packages. Prints each layer's
    flipped tokens (``pytest -s`` shows the sweep)."""
    params = moe_params(seed)
    x = tokens(seed + 2)
    seen, _ = capture_port_moe(monkeypatch)
    (_, inter), _ = _logits_both(params, x, "bf16", False)
    jax_ln, jax_y = reference_moe(inter)
    for i, ln in enumerate(jax_ln):
        r = params[f"layer_{i}"]["moe"]["router"]
        top = -np.sort(-(ln @ r), axis=1)[(x != 0).reshape(-1)]
        gaps = np.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
        if gaps.min() <= MARGIN:
            pytest.fail(f"premise: layer {i}: a reference router gap of "
                        f"{gaps.min():.3g} <= {MARGIN}")
    assert_moe_on_reference_inputs(params, x, jax_ln, jax_y)
    real = (x != 0).reshape(-1)
    flipped = []
    for i, (a, b) in enumerate(zip(jax_ln, seen)):
        r = params[f"layer_{i}"]["moe"]["router"]
        ref, got = a @ r, b @ r
        top = -np.sort(-ref, axis=1)
        gaps = np.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2])
        flips = np.nonzero((np.argsort(-ref, axis=1)[:, :2]
                            != np.argsort(-got, axis=1)[:, :2]).any(axis=1)
                           & real)[0]
        drift = np.abs(ref - got).max(axis=1)
        for j in flips:
            assert gaps[j] < 2 * drift[j], (i, j, gaps[j], drift[j])
        flipped.append(flips.tolist())
    print(f"seed {seed}: {int(real.sum())} real tokens, flipped by layer "
          f"{flipped}")
def test_gpt_moe_loss_includes_aux():
    """The per-sequence loss adds aux_coef x the mean of the layers' aux
    (the reference's test_gpt_moe_loss_includes_aux), equal to the
    reference's loss with and without it."""
    import jax
    import jax.numpy as jnp

    params = moe_params(1)
    x = tokens(3)
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(1)))
    jmodel, tmodel = jax_moe(), port_moe()
    module = port_module(params)
    gen = torch.Generator().manual_seed(0)
    per_ex = {}
    for coef in (0.01, 0.0):
        jmodel.aux_coef = tmodel.aux_coef = coef
        want, _ = jmodel.loss({"params": params}, {"x": jnp.asarray(x)}, key,
                              None)
        got = tmodel.loss(module, {"x": torch.from_numpy(x)}, gen, None)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        per_ex[coef] = got.detach()
    with torch.no_grad():
        _, aux = module.logits_and_aux(torch.from_numpy(x))
    added = per_ex[0.01] - per_ex[0.0]
    assert float(added.min()) > 0.0
    torch.testing.assert_close(added, torch.full_like(
        added, 0.01 * float(sum(aux)) / len(aux)), rtol=1e-4, atol=1e-7)


def _round_inputs(seed=0):
    """A round's token batch with a padded example, a masked step and
    worker masks of ones."""
    rng = np.random.default_rng(seed)
    x = tokens(seed, n=W * S * B).reshape(W, S, B, T)
    smask = np.ones((W, S, B), np.float32)
    smask[0, 1, 3] = 0.0
    stmask = np.ones((W, S), np.float32)
    stmask[1, 1] = 0.0
    rngs = rng.integers(0, 2 ** 32, (W, S, 2), dtype=np.uint32)
    return {"x": x}, smask, stmask, np.ones(W, np.float32), rngs


def test_kavg_round_matches_jax():
    """One K-avg round (f32, dropout 0, AdamW) of the tiny MoE: counts and
    drops exactly, loss sums 1e-5, merged weights within 2·K·lr; the
    ledger's records (KUBEML_COST_LEDGER=0, as tests/conftest.py sets
    it) equal."""
    import json

    import jax
    import jax.numpy as jnp

    from kubeml_tpu.parallel.kavg import KAvgEngine as JaxEngine
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    params = moe_params(2)
    args = _round_inputs()
    jmodel, tmodel = jax_moe(), port_moe()
    jeng = JaxEngine(make_mesh(n_data=1), jmodel.loss, jmodel.metrics,
                     jmodel.configure_optimizers, donate=False)
    jvars, jst = jeng.train_round(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)}, *args,
        lr=LR, epoch=0)
    teng = KAvgEngine(tmodel.build(device="cpu"), tmodel.loss,
                      tmodel.metrics, tmodel.configure_optimizers)
    tvars, tst = teng.train_round(tmodel.params_from_flax(params), *args,
                                  lr=LR, epoch=0)
    np.testing.assert_array_equal(tst.step_count, jst.step_count)
    np.testing.assert_array_equal(tst.sample_count, jst.sample_count)
    np.testing.assert_array_equal(tst.dropped, np.asarray(jst.dropped))
    assert tst.contributors == jst.contributors
    np.testing.assert_allclose(tst.loss_sum, np.asarray(jst.loss_sum),
                               rtol=1e-5, atol=1e-5)
    diffs = np.concatenate([
        np.abs(a - b).ravel() for a, b in
        zip(leaves(tmodel.params_to_flax(tvars)), leaves(jvars["params"]))])
    assert diffs.max() <= 2 * S * LR, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()
    assert json.dumps(teng.ledger.snapshot()) == \
        json.dumps(jeng.ledger.snapshot())


# ------------------------------------------------- plans and conversion
def _published_tree():
    """gpt-moe-mini's flax params tree at its published widths, from
    shapes alone (jax.eval_shape of the reference's init), filled with
    numpy normals."""
    import jax

    from kubeml_tpu.models import get_builtin

    shapes = jax.eval_shape(lambda: get_builtin("gpt-moe-mini")()
                            .init_variables(jax.random.PRNGKey(0),
                                            {"x": np.ones((1, 8), np.int32)}))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        shapes)["params"]


def test_published_plan_leaf_order_and_round_trip():
    """At gpt-moe-mini's published widths: the port's module holds the
    reference tree's every leaf (strict load), the bridge round trips
    exactly with the expert axes untransposed, flax_leaf_order is
    jax.tree_util's flatten order (moe between k and out), and the 4 MB
    bucket plan equals the reference's."""
    import jax

    from kubeml_tpu.parallel.merge import plan_buckets as ref_plan
    from kubeml_tpu_torch.convert import flax_leaf_order
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.parallel.merge import BucketedMerge, plan_buckets

    params = _published_tree()
    model = get_model("gpt-moe-mini")()
    module = model.build(device="cpu")
    sd = model.params_from_flax(params)
    module.load_state_dict(sd)                 # strict: names and shapes
    assert tuple(sd["blocks.0.moe.wi"].shape) == (8, 256, 512)
    back = model.params_to_flax(module.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(leaves(back), leaves(params)):
        np.testing.assert_array_equal(a, b)
    flat, tree = jax.tree_util.tree_flatten(params)
    tagged = model.params_from_flax(jax.tree_util.tree_unflatten(
        tree, [np.full(a.shape, i, np.float32) for i, a in enumerate(flat)]))
    order = flax_leaf_order(tagged)
    assert [int(tagged[n].reshape(-1)[0]) for n in order] == \
        list(range(len(flat)))
    layer = [n for n in order if n.startswith("blocks.0.")]
    assert layer.index("blocks.0.k.weight") < \
        layer.index("blocks.0.moe.bi") < layer.index("blocks.0.out.bias")
    assert sum(t.numel() for t in sd.values()) == 11_706_880
    want = ref_plan(flat, 4.0)
    got = plan_buckets([sd[n] for n in order], 4.0)
    assert [(b.indices, b.sizes, b.length, b.compressible)
            for b in got.buckets] == \
        [(tuple(b.indices), tuple(b.sizes), b.length, b.compressible)
         for b in want.buckets]
    assert BucketedMerge(bucket_mb=4.0).comm_proxy(sd)[
        "buckets_per_round"] == want.n_buckets


def test_random_flax_params_with_experts_is_the_flax_tree():
    """random_flax_params(n_experts=4) has the reference module's tree
    (structure, shapes, dtypes), and the dense tree it gives without
    experts is unchanged by the experts' draws."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.convert import random_flax_params

    ref = jax.eval_shape(lambda: JaxGPT(**TINY, n_experts=E).init(
        jax.random.PRNGKey(0), jnp.ones((1, T), jnp.int32)))["params"]
    mine = random_flax_params(**TINY, seed=0, n_experts=E)
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    dense = random_flax_params(**TINY, seed=0)
    assert "Dense_0" in dense["layer_0"] and "moe" not in dense["layer_0"]


# ------------------------------------------------------------- the job
def test_checkpoints_and_jobs_match_both_ways(tmp_home):
    """The same token windows and a JAX-written seed checkpoint: the JAX
    job and the port's (tiny MoE, f32, dropout 0, AdamW, one epoch of two
    rounds at N = 2, a bucketed merge) agree in counts and losses, the
    port's job runs from the device cache, its final checkpoint is the
    JAX package's tree, and each package's module over the other's
    checkpoint gives its logits."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu.train.checkpoint import load_checkpoint as ref_load
    from kubeml_tpu.train.checkpoint import save_checkpoint
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint
    from test_torch_job import (_Windows, _assert_close, _final_params,
                                _run_both, _tasks)

    rng = np.random.default_rng(0)
    start = rng.integers(1, 60, (96, 1))
    x = ((start + np.arange(T) - 1) % 63 + 1).astype(np.int32)
    x[::3, 11:] = 0
    DatasetRegistry().create("tokens", x[:64], np.zeros(64, np.int32),
                             x[64:], np.zeros(32, np.int32))
    params = moe_params(3)
    save_checkpoint("seedckpt", {"params": params},
                    {"model": "gpt-moe-mini", "function": "gpt-moe-mini"})
    K = 2
    tasks = _tasks("moe", "gpt-moe-mini", "tokens", epochs=1, batch=8, k=K,
                   lr=LR, merge_bucket_mb=0.02, train_stats=False)

    def dataset(key):
        base = RefDataset if key == "ref" else KubeDataset
        return type("Windows", (_Windows, base), {})()

    out = _run_both(tasks, lambda key: jax_moe() if key == "ref"
                    else port_moe(), dataset)
    r, g = out["ref"][0].data, out["port"][0].data
    assert g.parallelism == r.parallelism == [2]
    _assert_close(g.train_loss, r.train_loss, 1e-4)
    _assert_close(g.validation_loss, r.validation_loss, 1e-4)
    want, _ = _final_params(tasks["ref"].job_id)
    have, manifest = _final_params(tasks["port"].job_id)
    assert manifest["completed"] and len(have) == len(want)
    diffs = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(have, want)])
    assert diffs.max() <= 2 * 2 * K * LR, diffs.max()
    # each package's module over either job's checkpoint (each package
    # reads the other's): the same logits
    probe = tokens(4)
    for job_id in (tasks["ref"].job_id, tasks["port"].job_id):
        ref_vars, _ = ref_load(job_id)
        want = jax_moe().module.apply(
            jax.tree_util.tree_map(jnp.asarray, ref_vars),
            jnp.asarray(probe))
        module = port_moe().module_from_flax(load_checkpoint(job_id)[0],
                                             device="cpu")
        np.testing.assert_allclose(module(torch.from_numpy(probe)).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cli_trains_gpt_moe_mini_at_its_published_widths(
        tmp_path, tmp_home, monkeypatch, capsys):
    """`kubeml train -f gpt-moe-mini` parses as the reference's parser
    does, is submitted through the port's CLI to a CPU deployment and
    trains its published widths (vocab 8192, 8 experts) over short
    windows; `--expert-parallel 2` reaches the job, which in a
    deployment of one process answers the reference's 400 (the ranks
    run it: tests/test_torch_expert_parallel.py)."""
    import time

    from kubeml_tpu.cli.main import build_parser as ref_parser
    from kubeml_tpu_torch.cli.main import build_parser, main
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.train.history import HistoryStore

    argv = ["train", "-f", "gpt-moe-mini", "-d", "toks", "-e", "1", "--lr",
            "0.001", "-b", "8", "-p", "2", "--static"]
    ours, theirs = (vars(p().parse_args(argv))
                    for p in (build_parser, ref_parser))
    assert ours.pop("fn").__name__ == theirs.pop("fn").__name__
    assert ours == theirs
    rng = np.random.default_rng(0)
    x = rng.integers(1, 8192, (48, T)).astype(np.int32)
    x[::4, 10:] = 0
    paths = {}
    for name, arr in (("xtr", x[:32]), ("ytr", np.zeros(32, np.int32)),
                      ("xte", x[32:]), ("yte", np.zeros(16, np.int32))):
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
        cli(*argv, "--expert-parallel", "2")
        refused = capsys.readouterr().out.strip()
        deadline = time.monotonic() + 60
        while refused not in dep.ps.errors:
            assert time.monotonic() < deadline, "the job did not fail"
            time.sleep(0.1)
        assert ("1 devices not divisible by the requested model x seq x "
                "stage x expert factor 2") in dep.ps.errors.pop(refused)
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
        assert dep.ps.errors == {}
    finally:
        dep.stop()


# ------------------------------------------------------------ refusals
def test_serving_refuses_moe_with_the_references_messages():
    """The paged decode, prefill and multi-step builders, a speculative
    draft and the DecodeEngine refuse an MoE module with the reference's
    messages."""
    import jax.numpy as jnp

    from kubeml_tpu.models import gpt as ref
    from kubeml_tpu_torch.models import gpt
    from kubeml_tpu_torch.serve.engine import DecodeEngine

    jmod = ref.GPTModule(**TINY, n_experts=E, dtype=jnp.float32)
    jdense = ref.GPTModule(**TINY, dtype=jnp.float32)
    tmod = port_module(moe_params(0))
    tdense = gpt.GPTModule(**TINY, device="cpu")

    def message(fn, *args):
        with pytest.raises(ValueError) as e:
            fn(*args)
        return str(e.value)

    cases = [
        (ref.build_paged_decode_step, gpt.build_paged_decode_step, (),
         ()),
        (ref.build_paged_prefill_step, gpt.build_paged_prefill_step, (8,),
         (8,)),
        (ref.build_paged_multi_step_decode, gpt.build_paged_multi_step_decode,
         (4,), (4,)),
    ]
    for ref_fn, fn, jargs, targs in cases:
        assert message(fn, tmod, *targs) == message(ref_fn, jmod, *jargs)
    want = message(ref.build_paged_spec_verify_step, jdense, jmod, 4, 8)
    assert message(gpt.build_paged_spec_verify_step, tdense, tmod, 4,
                   8) == want
    assert message(lambda: DecodeEngine(tmod, device="cpu")) == \
        message(ref.build_paged_decode_step, jmod)


def test_parallel_paths_refuse_naming_their_item():
    """ep_mesh (a JAX Mesh: ROADMAP C.13) is refused; the pipeline (A.12,
    landed) sets its microbatches and refuses a seq axis with the
    reference's words; sequence and expert parallelism build their
    modules, with the reference's refusals (no experts, ep_impl) in its
    words; the one-process forward_seq_parallel and forward_pipelined
    are the dense forward; tensor parallelism raises the reference's
    ValueError."""
    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.models.gpt import GPTMoEMini as JaxMoE
    from kubeml_tpu_torch.models.gpt import GPTMini, GPTMoEMini

    with pytest.raises(ValueError, match="ROADMAP C.13") as e:
        GPTMoEMini(ep_mesh=object())
    assert "--expert-parallel" in str(e.value)
    model = GPTMoEMini()
    model.enable_pipeline_parallel(2)
    assert model._pp_microbatches == 4
    model.enable_seq_parallel()
    ref = JaxMoE()
    ref.enable_seq_parallel("ring")
    pair = []
    for m in (model, ref):
        with pytest.raises(ValueError) as e:
            m.enable_pipeline_parallel(2)
        pair.append(str(e.value))
    assert pair[0] == pair[1] and "composes with expert" in pair[0]
    model.enable_expert_parallel()
    module = model.build(device="meta")
    assert (module.seq_axis, module.ep_axis, module.n_experts) == (
        "seq", "expert", 8)
    messages = []
    for port_model, ref_model in (
            (GPTMini(), get_builtin("gpt-mini")()),
            (GPTMoEMini(), JaxMoE())):
        if isinstance(port_model, GPTMoEMini):
            port_model.ep_impl = "alltoall"
            ref_model._module = ref_model.module.clone(ep_impl="alltoall")
        pair = []
        for m in (port_model, ref_model):
            with pytest.raises(ValueError) as e:
                m.enable_expert_parallel()
            pair.append(str(e.value))
        assert pair[0] == pair[1]
        messages.append(pair[0])
    assert "no experts to shard" in messages[0]
    assert "ep_impl='replicated'" in messages[1]
    tiny = port_moe()
    dense = tiny.build(device="cpu")
    x = tokens(5, n=2)
    torch.testing.assert_close(
        tiny.forward_seq_parallel(dense, x),
        dense.logits(torch.from_numpy(x)).detach(), rtol=0, atol=0)
    full = np.maximum(x, 1)      # the pipelined forward takes no pads
    logits, aux = tiny.forward_pipelined(dense, full, microbatches=2)
    torch.testing.assert_close(
        logits, dense.logits(torch.from_numpy(full)).detach(), rtol=1e-6,
        atol=1e-6)
    assert float(aux) > 0.0
    with pytest.raises(ValueError) as want:
        JaxMoE().enable_tensor_parallel()
    with pytest.raises(ValueError) as got:
        model.enable_tensor_parallel()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the card
def _cuda():
    if not torch.cuda.is_available():   # decided at run time, not import
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")


@pytest.mark.gpu
def test_moe_forward_and_round_on_the_card_match_cpu():
    """The tiny MoE in f32 on the card (the flash kernels in f32, cuBLAS
    einsums) against the CPU: logits and aux within 1e-4; one K-avg round
    (AdamW) within 2·K·lr."""
    _cuda()
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    params = moe_params(0)
    x = torch.from_numpy(tokens(2))
    torch.backends.cuda.matmul.allow_tf32 = False
    model = port_moe()
    mods = {}
    for dev in ("cpu", "cuda"):
        mods[dev] = model.build(device=dev)
        mods[dev].load_state_dict(model.params_from_flax(params))
    a, aux_a = mods["cpu"].logits_and_aux(x)
    b, aux_b = mods["cuda"].logits_and_aux(x.cuda())
    torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(torch.stack(aux_b).cpu(), torch.stack(aux_a),
                               rtol=1e-4, atol=1e-4)
    args = _round_inputs()
    out = {}
    for dev in ("cpu", "cuda"):
        eng = KAvgEngine(model.build(device=dev), model.loss, model.metrics,
                         model.configure_optimizers)
        out[dev], _ = eng.train_round(
            {k: v.to(dev) for k, v in model.params_from_flax(params).items()},
            *args, lr=LR, epoch=0)
    diff = max(float((out["cuda"][k].cpu() - out["cpu"][k]).abs().max())
               for k in out["cpu"])
    assert diff <= 2 * S * LR, diff
