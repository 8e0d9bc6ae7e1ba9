"""Port parity: kubeml_tpu_torch's GPT against the JAX package's.

The same flax parameters (numpy, from a seed) drive the JAX GPTModule and
the port's GPTModule through kubeml_tpu_torch.convert, at gpt-nano widths
in float32 so the comparison is of the algorithm, not of bf16 rounding:
the dense forward, the weight bridge, and the paged prefill and decode
steps (their slab contents after the step and their next tokens).

Tolerances: f32 logits and K/V/scales rtol = atol = 1e-5 (the frameworks
sum matmuls in different orders); int8 pages within 1 quantization step,
since a value that lands within an ulp of a rounding boundary may round
either way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)


def _models(seed=1):
    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.convert import params_from_flax, random_flax_params
    from kubeml_tpu_torch.models.gpt import GPTModule

    params = random_flax_params(**NANO, seed=seed)
    jm = JaxGPT(**NANO, dropout=0.0, dtype=jnp.float32)
    tm = GPTModule(**NANO, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_flax(params))
    return jm, tm, params


def test_random_params_match_flax_tree_and_round_trip():
    """The numpy initializer builds exactly flax's parameter tree, and
    params_to_flax(params_from_flax(p)) returns p bit for bit."""
    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu_torch.convert import (params_from_flax, params_to_flax,
                                          random_flax_params)

    p = random_flax_params(**NANO, seed=3)
    ref = JaxGPT(**NANO, dropout=0.0).init(
        jax.random.PRNGKey(0), np.ones((1, 8), np.int32))["params"]
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), p)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    back = params_to_flax(params_from_flax(p), heads=NANO["heads"])
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_builtin_widths_match_jax_registry():
    from kubeml_tpu.models import get_builtin as jax_builtin
    from kubeml_tpu_torch.models import builtin_names, get_builtin

    assert builtin_names() == ["gpt-mini", "gpt-nano"]
    assert get_builtin("resnet18") is None
    for name in builtin_names():
        ref = jax_builtin(name)().module
        mod = get_builtin(name)(device="cpu")
        for field in ("vocab_size", "max_len", "hidden", "layers", "heads",
                      "ffn"):
            assert getattr(mod, field) == getattr(ref, field), (name, field)
        assert mod.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_dense_forward_matches_jax():
    jm, tm, params = _models()
    x = np.random.default_rng(0).integers(1, NANO["vocab_size"], (3, 20))
    x = x.astype(np.int32)
    x[1, 14:] = 0                      # trailing pads
    x[2, 5] = 0                        # an interior pad
    ref = np.asarray(jm.apply({"params": params}, x))
    out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (3, 20, 512)
    torch.testing.assert_close(out, torch.tensor(ref), rtol=1e-5, atol=1e-5)


def _slabs(kv_dtype):
    from kubeml_tpu.serve.pager import KVPageSlab as JaxSlab
    from kubeml_tpu.serve.pager import PageGeometry as JaxGeom
    from kubeml_tpu_torch.serve.pager import KVPageSlab, PageGeometry

    dh = NANO["hidden"] // NANO["heads"]
    js = JaxSlab(JaxGeom.for_module(3, 8, NANO["max_len"]), NANO["layers"],
                 NANO["heads"], dh, jnp.float32, kv_dtype=kv_dtype)
    ts = KVPageSlab(PageGeometry.for_module(3, 8, NANO["max_len"]),
                    NANO["layers"], NANO["heads"], dh, torch.float32,
                    torch.device("cpu"), kv_dtype=kv_dtype)
    return js, ts


def _assert_slabs_match(js, ts, kv_dtype):
    for name in ("k", "v", "k_scale", "v_scale", "valid"):
        ref = torch.tensor(np.asarray(getattr(js, name)).astype(np.float32))
        got = getattr(ts, name).float()
        if kv_dtype == "int8" and name in ("k", "v"):
            torch.testing.assert_close(got, ref, rtol=0, atol=1)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.int64):
    return torch.tensor(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_paged_prefill_and_decode_steps_match_jax(kv_dtype):
    """A prefill chunk for slot 0, then one decode step with slot 0 past
    its prompt (with a copy-on-write split of its page), slot 1 on its
    first token and slot 2 inactive: the slabs (K, V, scales, validity)
    and the next tokens agree with the JAX programs."""
    from kubeml_tpu.models.gpt import build_paged_decode_step as jax_decode
    from kubeml_tpu.models.gpt import build_paged_prefill_step as jax_prefill
    from kubeml_tpu_torch.models.gpt import (build_paged_decode_step,
                                             build_paged_prefill_step,
                                             compute_params)

    jm, tm, params = _models(seed=2)
    tp = compute_params(tm)
    js, ts = _slabs(kv_dtype)
    rng = np.random.default_rng(5)
    pmax = NANO["max_len"] // 8

    C = 8    # chunk: 6 real prompt tokens on page 1, two pad-tail rows
    toks = np.zeros(C, np.int32)
    toks[:6] = rng.integers(1, NANO["vocab_size"], 6)
    pos = np.where(np.arange(C) < 6, np.arange(C), 0).astype(np.int32)
    table = np.zeros(pmax, np.int32)
    table[0] = 1
    wpages = np.where(np.arange(C) < 6, 1, 0).astype(np.int32)
    in_chunk = (np.arange(C) < 6).astype(np.float32)
    pre_args = (toks, pos, table, wpages, pos.copy(), in_chunk)
    out = jax.jit(jax_prefill(jm, C, kv_dtype, attn_impl="gather"))(
        params, js.k, js.v, js.k_scale, js.v_scale, js.valid, *pre_args)
    js.k, js.v, js.k_scale, js.v_scale, js.valid = out
    with torch.no_grad():
        build_paged_prefill_step(tm, C, kv_dtype)(
            tp, ts, _t(toks), _t(pos), _t(table, torch.int32), _t(wpages),
            _t(pos), _t(in_chunk, torch.float32))
    _assert_slabs_match(js, ts, kv_dtype)

    S = 3
    tables = np.zeros((S, pmax), np.int32)
    tables[0, 0], tables[1, 0] = 3, 2   # slot 0's page 1 split into page 3
    tokens = np.array([*rng.integers(1, NANO["vocab_size"], 2), 0], np.int32)
    dpos = np.array([6, 0, 0], np.int32)
    wpage = np.array([3, 2, 0], np.int32)
    woff = np.array([6, 0, 0], np.int32)
    active = np.array([1, 1, 0], np.float32)
    temps = np.zeros(S, np.float32)
    keys = np.zeros((S, 2), np.uint32)
    copy_src = np.array([1, 0, 0], np.int32)
    copy_dst = np.array([3, 0, 0], np.int32)
    poison = np.zeros(S, np.float32)
    nxt, bad, *slab = jax.jit(jax_decode(jm, kv_dtype, attn_impl="gather"))(
        params, js.k, js.v, js.k_scale, js.v_scale, js.valid, tokens, dpos,
        tables, wpage, woff, active, temps, keys, copy_src, copy_dst,
        poison)
    js.k, js.v, js.k_scale, js.v_scale, js.valid = slab
    with torch.no_grad():
        t_nxt, t_bad = build_paged_decode_step(tm, kv_dtype)(
            tp, ts, _t(tokens), _t(dpos), _t(tables, torch.int32),
            _t(wpage), _t(woff), _t(active, torch.float32), temps, keys,
            _t(copy_src), _t(copy_dst), _t(poison, torch.float32))
    _assert_slabs_match(js, ts, kv_dtype)
    np.testing.assert_array_equal(t_nxt.numpy(), np.asarray(nxt))
    np.testing.assert_array_equal(t_bad.numpy(), np.asarray(bad))


def test_decode_step_guards_poisoned_rows_and_never_emits_pad():
    """The non-finite guard flags exactly the poisoned active row and
    forces its pick to 0; healthy rows never pick PAD."""
    from kubeml_tpu_torch.models.gpt import (build_paged_decode_step,
                                             compute_params)

    _, tm, _ = _models()
    _, ts = _slabs("f32")
    S = 3
    pmax = NANO["max_len"] // 8
    tables = np.zeros((S, pmax), np.int32)
    tables[:, 0] = [1, 2, 3]
    with torch.no_grad():
        nxt, bad = build_paged_decode_step(tm)(
            compute_params(tm), ts, _t([5, 6, 7]), _t([0, 0, 0]),
            _t(tables, torch.int32), _t([1, 2, 3]), _t([0, 0, 0]),
            _t([1, 1, 1], torch.float32), np.zeros(S, np.float32),
            np.zeros((S, 2), np.uint32), _t([0, 0, 0]), _t([0, 0, 0]),
            _t([0, 1, 0], torch.float32))
    assert bad.tolist() == [0.0, 1.0, 0.0]
    assert nxt[1].item() == 0
    assert nxt[0].item() != 0 and nxt[2].item() != 0


def test_entry_points_default_to_cuda():
    """device=None means CUDA: without a CUDA device the model builders
    raise instead of running on the CPU."""
    from kubeml_tpu_torch import resolve_device
    from kubeml_tpu_torch.models import get_builtin

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        get_builtin("gpt-nano")()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
