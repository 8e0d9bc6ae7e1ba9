"""Port parity: the 2-layer LSTM classifier (kubeml_tpu_torch/models/
lstm.py) against the JAX package's (kubeml_tpu/models/lstm.py), on the
CPU, at a small vocab (200) and T = 16 with the model's other widths
(embed 128, hidden 256, 2 layers, 4 classes).

The same numpy token ids and flax parameters (the JAX initializers from a
fixed key, biases given numpy noise, carried across by
``convert.lstm_params_from_flax``) drive both packages.

Tolerances: logits f32 1e-5, bf16 2e-2; a K-avg round (f32, Adam):
counts exactly, loss sums 1e-5, merged parameters within Adam's 2·K·lr
(the bound of tests/test_torch_bert.py); the tree bridge exactly.
"""

import numpy as np
import pytest
import torch
from test_torch_bert import (LR, S, TOL, TORCH_DT, VOCAB, assert_round_close,
                             check_checkpoints_both_ways,
                             learns_on_port_engine, leaves, round_both,
                             round_inputs, text_registry, tokens)

# JAX is imported inside the tests only: the `gpu` tests run on the
# card's machine, which has no JAX.
pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_lstm(dtype="f32"):
    import jax.numpy as jnp

    from kubeml_tpu.models.lstm import LSTMClassifier as JaxLSTM
    from kubeml_tpu.models.lstm import LSTMClassifierModule as JaxModule

    model = JaxLSTM()
    model._module = JaxModule(
        vocab_size=VOCAB,
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    return model


def port_lstm(dtype="f32"):
    from kubeml_tpu_torch.models.lstm import (LSTMClassifier,
                                              LSTMClassifierModule)

    class Small(LSTMClassifier):
        def build(self, dtype=None, device=None):
            return LSTMClassifierModule(vocab_size=VOCAB,
                                        dtype=dtype or self.dtype,
                                        device=device)

    return Small(dtype=TORCH_DT[dtype])


def lstm_params(seed=0, head_gain=20.0):
    """The JAX initializers' tree at the test vocab, as numpy: biases get
    numpy noise, and the head is scaled by ``head_gain`` so the logits
    are O(1) and a tolerance reads them, not the initializer's 1e-2."""
    import jax
    import jax.numpy as jnp

    from kubeml_tpu.models.lstm import LSTMClassifierModule as JaxModule

    v = JaxModule(vocab_size=VOCAB).init(jax.random.PRNGKey(seed),
                                         jnp.ones((1, 16), jnp.int32))
    rng = np.random.default_rng(seed)

    def shaped(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "bias" in name:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if "Dense_0" in name:
            a = a * np.float32(head_gain)
        return a
    return jax.tree_util.tree_map_with_path(shaped, v["params"])


def port_module(params, dtype="f32", device="cpu"):
    model = port_lstm(dtype)
    module = model.build(device=device)
    module.load_state_dict(model.params_from_flax(params))
    return module


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lstm_logits_match_jax_over_tail_and_interior_pads(dtype):
    """Logits with a pad tail, interior pads and an all-pad row. The
    reference's seq_lengths are inert (flax's RNN reads them only with
    return_carry or reverse), so the recurrence runs through the pads and
    only the mean-pool masks them: an interior pad changes the states
    after it, a tail pad changes nothing."""
    import jax.numpy as jnp

    params = lstm_params(0)
    x = tokens(0)
    ref = np.asarray(jax_lstm(dtype).module.apply({"params": params},
                                                  jnp.asarray(x)))
    module = port_module(params, dtype)
    got = module(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], 4)
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL[dtype],
                               atol=TOL[dtype])
    # row 1's interior pads (positions 3..5) feed the recurrence: its
    # logits differ from those of the same row with the pads dropped
    # and the rest shifted left, which a frozen carry would give
    packed = x[1:2].copy()
    real = packed[0][packed[0] != 0]
    packed[0] = 0
    packed[0, :len(real)] = real
    ref_packed = np.asarray(jax_lstm(dtype).module.apply(
        {"params": params}, jnp.asarray(packed)))
    assert np.abs(ref_packed - ref[1:2]).max() > 10 * TOL[dtype]
    # row 0's pad tail changes nothing: its real prefix alone gives the
    # same logits
    n_real = int((x[0] != 0).sum())
    assert (x[0, n_real:] == 0).all() and n_real < x.shape[1]
    prefix = module(torch.from_numpy(x[0:1, :n_real])).detach()
    torch.testing.assert_close(prefix, got[0:1], rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_lstm_tree_round_trip_and_leaf_order():
    """The OptimizedLSTMCell_{i} tree (input kernels without bias at the
    top level, not under lstm_{i}) round-trips exactly, and the port's
    state names sort into the flax flatten order with equal sizes."""
    import jax

    from kubeml_tpu_torch.convert import flax_leaf_order

    params = lstm_params(0)
    assert sorted(params) == ["Dense_0", "Embed_0", "OptimizedLSTMCell_0",
                              "OptimizedLSTMCell_1"]
    assert sorted(params["OptimizedLSTMCell_0"]["ii"]) == ["kernel"]
    model = port_lstm()
    sd = model.params_from_flax(params)
    assert sorted(sd) == sorted(model.build(device="cpu").state_dict())
    back = model.params_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(leaves(back), leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [sd[n].numel() for n in flax_leaf_order(sd)] == \
        [a.size for _, a in flat]


def test_adam_round_matches_jax():
    """One K=2 round of W=2 workers (f32, Adam), a padded example and a
    masked step: counts exactly, loss sums 1e-5, merged weights within
    Adam's 2·K·lr."""
    params = lstm_params(0, head_gain=1.0)
    ref, got = round_both(jax_lstm(), port_lstm(), params, round_inputs(4))
    assert_round_close(ref, got, port_lstm(), k_steps=S, lr=LR)


def test_checkpoints_load_both_ways(tmp_home):
    text_registry("toks", 4)
    check_checkpoints_both_ways(jax_lstm(), port_lstm(),
                                lstm_params(0, head_gain=1.0), "lstm")


def test_lstm_learns_on_the_port_engine():
    """The LSTM at its published widths (vocab 32000) at the reference
    test's lr 0.01."""
    from kubeml_tpu_torch.models.lstm import LSTMClassifier

    learns_on_port_engine(LSTMClassifier(), 0.01, 4)


def test_init_draws_flax_distributions():
    """init_module: orthogonal hidden kernels (flax's
    recurrent_kernel_init), lecun-normal input kernels, zero biases."""
    from kubeml_tpu_torch.models.lstm import LSTMClassifier

    model = LSTMClassifier()
    module = model.init_module({"x": np.ones((2, 16), np.int32)},
                               torch.Generator().manual_seed(0),
                               device="cpu")
    cell = module.OptimizedLSTMCell_1
    for g in "ifgo":
        w = cell._modules[f"h{g}"].weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(256), rtol=0,
                                   atol=1e-4)
        assert float(cell._modules[f"h{g}"].bias.detach().abs().max()) == 0
        std = float(cell._modules[f"i{g}"].weight.detach().std())
        assert abs(std - 256 ** -0.5) < 0.1 * 256 ** -0.5


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: the card's tests skip here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_lstm_round_on_card_matches_cpu(cuda_device):
    """The published widths in f32: one round on the card (the fused
    merge kernel, W=2 lanes) and on the CPU within Adam's 2·K·lr."""
    from kubeml_tpu_torch.models.lstm import LSTMClassifier
    from kubeml_tpu_torch.ops.fused_merge import fused_merge_kernel
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model = LSTMClassifier(dtype=torch.float32)
    batch, smask, stmask, wmask, rngs = round_inputs(4)
    init = model.init_module({"x": batch["x"][0, 0]},
                             torch.Generator().manual_seed(0), device="cpu")
    start = {k: v.detach().clone() for k, v in init.state_dict().items()}
    out = {}
    for dev in ("cpu", cuda_device):
        module = model.build(device=dev)
        engine = KAvgEngine(module, model.loss, model.metrics,
                            model.configure_optimizers, n_lanes=2,
                            merge_bucket_mb=4.0)
        launches = fused_merge_kernel.launches
        out[str(dev)], _ = engine.train_round(
            {k: v.to(dev, copy=True) for k, v in start.items()}, batch,
            smask, stmask, wmask, rngs, LR, 0)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert fused_merge_kernel.launches > launches
    diffs = torch.cat([(out["cpu"][k] - out[str(cuda_device)][k].cpu())
                       .abs().flatten() for k in start])
    assert float(diffs.max()) <= 2 * S * LR
    assert float((diffs <= 1e-5).float().mean()) >= 0.995


@pytest.mark.parametrize("name", ["lstm", "bert-tiny"])
def test_text_jobs_host_staged_and_cached_rounds_agree(name, tmp_home):
    """int32 token batches of a dataset with no device transform take
    both of the job's feeds: host-staged rounds (device_cache "off") and
    the device cache's index-fed rounds ("auto" picks it: the identity
    transform is eligible). Same seed, same rounds: equal histories and
    weights."""
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import TrainJob
    from test_torch_bert import port_bert, text_task_spec

    text_registry("toks", 4 if name == "lstm" else 2)
    out = {}
    for cache in ("off", "auto"):
        model = port_lstm() if name == "lstm" else port_bert()
        job = TrainJob(text_task_spec("kubeml_tpu_torch", f"j-{cache}",
                                      name, device_cache=cache), model,
                       KubeDataset("toks"), device="cpu")
        hist = job.train().data
        assert (job._device_cache is None) == (cache == "off")
        out[cache] = (hist, job.state)
    (ha, sa), (hb, sb) = out["off"], out["auto"]
    assert ha.train_loss == hb.train_loss
    assert ha.validation_loss == hb.validation_loss
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
