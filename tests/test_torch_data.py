"""Port parity: the host-side data plane of kubeml_tpu_torch (epoch plans,
the dataset registry, the round loader) against the JAX package's.

Everything here is counters and host arrays, so equality is exact: epoch
plans field for field, round tensors (batch, masks, rng keys) bit for bit
at the same lane count, with shuffle on and off, for a classifier dataset
({'x', 'y'}) and a language-model dataset ({'x'} only).
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

PLAN_GRID = [  # (samples, N, K, B)
    (800, 2, 2, 32), (800, 3, 1, 16), (1000, 5, 4, 8), (64, 4, 2, 32),
    (65, 2, -1, 10), (1, 1, 1, 1), (4096, 7, 3, 24), (300, 8, -1, 64),
]


@pytest.mark.parametrize("samples,n,k,b", PLAN_GRID)
def test_plan_epoch_equals_reference(samples, n, k, b):
    from kubeml_tpu.data.sharding import plan_epoch as ref_plan
    from kubeml_tpu_torch.data.sharding import plan_epoch

    got, ref = plan_epoch(samples, n, k, b), ref_plan(samples, n, k, b)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.total_steps, got.total_samples) == \
        (ref.total_steps, ref.total_samples)


def test_plan_epoch_rejects_what_the_reference_rejects():
    from kubeml_tpu_torch.data.sharding import plan_epoch

    for args in ((10, 0, 1, 4), (10, 2, 1, 0)):
        with pytest.raises(ValueError):
            plan_epoch(*args)


def _arrays(seed=0, n_train=700, n_test=150, lm=False):
    rng = np.random.default_rng(seed)
    if lm:
        def split(n):
            x = rng.integers(0, 500, (n, 16)).astype(np.int32)
            return x, np.zeros(n, np.int32)
    else:
        def split(n):
            return (rng.standard_normal((n, 8)).astype(np.float32),
                    rng.integers(0, 4, n).astype(np.int32))
    return (*split(n_train), *split(n_test))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_dataset(tmp_home, writer):
    from kubeml_tpu.data.registry import DatasetRegistry as RefRegistry
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    regs = {"port": DatasetRegistry(), "reference": RefRegistry()}
    arrays = _arrays()
    regs[writer].create("blobs", *arrays)
    reader = regs["reference" if writer == "port" else "port"]
    assert reader.exists("blobs") and not reader.exists("other")
    h = reader.get("blobs")
    assert (h.train_samples, h.test_samples, h.subset_size,
            h.num_train_docs, h.generation) == (700, 150, 64, 11, 1)
    for got, want in zip(h.train_arrays() + h.test_arrays(), arrays):
        np.testing.assert_array_equal(got, want)
    x, y = h.doc_range("train", 2, 4)
    np.testing.assert_array_equal(x, arrays[0][128:256])
    assert [s.to_dict() for s in regs["port"].list()] == \
        [s.to_dict() for s in regs["reference"].list()]
    reader.delete("blobs")
    assert not regs[writer].exists("blobs")


def test_port_reads_an_appended_reference_dataset(tmp_home):
    """A dataset the JAX package appended to names versioned train files
    and a retention base in its manifest; the port opens it at that
    generation."""
    from kubeml_tpu.data.registry import DatasetRegistry as RefRegistry
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    ref = RefRegistry()
    xtr, ytr, xte, yte = _arrays(n_train=128)
    ref.create("grow", xtr, ytr, xte, yte)
    extra = _arrays(seed=1, n_train=64)
    want = ref.append("grow", extra[0], extra[1], retention_generations=1)
    got = DatasetRegistry().get("grow")
    assert (got.generation, got.train_samples, got.train_base) == \
        (want.generation, want.train_samples, want.train_base) == (2, 64, 128)
    for a, b in zip(got.train_arrays(), want.train_arrays()):
        np.testing.assert_array_equal(a, b)


def test_registry_errors_match_reference(tmp_home):
    from kubeml_tpu_torch.api.errors import (DatasetNotFoundError,
                                             InvalidArgsError, StorageError)
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    reg = DatasetRegistry()
    arrays = _arrays()
    reg.create("blobs", *arrays)
    with pytest.raises(StorageError, match="already exists"):
        reg.create("blobs", *arrays)
    with pytest.raises(StorageError, match="length mismatch"):
        reg.create("bad", arrays[0], arrays[1][:5], arrays[2], arrays[3])
    with pytest.raises(DatasetNotFoundError) as e:
        reg.get("missing")
    assert e.value.status_code == 404
    with pytest.raises(InvalidArgsError):
        reg.get("../escape")


def test_check_name_equals_reference():
    from kubeml_tpu.api.errors import InvalidArgsError as RefErr
    from kubeml_tpu.utils.names import check_name as ref_check
    from kubeml_tpu_torch.api.errors import InvalidArgsError
    from kubeml_tpu_torch.utils.names import check_name

    for name in ("blobs", "a.b-c_d", "9x", "", ".hidden", "a/b", "a..b",
                 "x" * 128, "x" * 129, None, "ok.npy"):
        try:
            want = ref_check(name)
        except RefErr:
            with pytest.raises(InvalidArgsError):
                check_name(name)
        else:
            assert check_name(name) == want


class _LMWindows:
    """A language-model dataset: token windows, no 'y' (the GPT
    example's TextWindows)."""

    def transform_train(self, data, labels):
        return {"x": np.asarray(data).astype(np.int32)}

    transform_test = transform_train


def _datasets(lm):
    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu_torch.models.base import KubeDataset

    if not lm:
        return RefDataset(), KubeDataset()

    class Ref(_LMWindows, RefDataset):
        pass

    class Port(_LMWindows, KubeDataset):
        pass
    return Ref(), Port()


def _loaders(lm, n_lanes, shuffle, w_floor=0, use_native=True):
    from kubeml_tpu.data.loader import RoundLoader as RefLoader
    from kubeml_tpu.data.registry import DatasetRegistry as RefRegistry
    from kubeml_tpu_torch.data.loader import RoundLoader
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    name = "lm" if lm else "blobs"
    ref_reg = RefRegistry()
    if not ref_reg.exists(name):
        ref_reg.create(name, *_arrays(lm=lm))
    ref_ds, port_ds = _datasets(lm)
    ref = RefLoader(ref_reg.get(name), ref_ds, n_lanes=n_lanes, seed=3,
                    shuffle=shuffle, use_native=use_native, w_floor=w_floor)
    port = RoundLoader(DatasetRegistry().get(name), port_ds,
                       n_lanes=n_lanes, seed=3, shuffle=shuffle,
                       w_floor=w_floor)
    return ref, port


def _assert_rounds_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert sorted(got.batch) == sorted(want.batch)
    for k in want.batch:
        np.testing.assert_array_equal(got.batch[k], np.asarray(want.batch[k]))
        assert got.batch[k].dtype == np.asarray(want.batch[k]).dtype
    for field in ("sample_mask", "step_mask", "worker_mask", "rngs"):
        a, b = getattr(got, field), getattr(want, field)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype, field
    for field in ("round_index", "num_rounds", "rounds"):
        assert getattr(got, field, None) == getattr(want, field, None)


@pytest.mark.parametrize("lm", [False, True], ids=["classifier", "lm"])
@pytest.mark.parametrize("n_lanes,shuffle,native", [
    (1, False, True), (1, True, True), (2, False, False), (4, True, False),
    (8, False, True)])
def test_epoch_rounds_equal_reference(tmp_home, lm, n_lanes, shuffle, native):
    """Two epochs at N=3, K=2, B=16 (ragged last doc, a worker with fewer
    chunks): every round's batch, masks and rng keys, bit for bit."""
    ref, port = _loaders(lm, n_lanes, shuffle, use_native=native)
    for epoch in range(2):
        plan, ref_plan = port.plan(3, 2, 16), ref.plan(3, 2, 16)
        assert port.round_geometry(plan) == ref.round_geometry(ref_plan)
        got = list(port.epoch_rounds(plan, epoch))
        want = list(ref.epoch_rounds(ref_plan, epoch))
        assert len(got) == len(want) == len(plan.rounds)
        for g, w in zip(got, want):
            _assert_rounds_equal(g, w)


@pytest.mark.parametrize("lm", [False, True], ids=["classifier", "lm"])
def test_elastic_floors_and_eval_batches_equal_reference(tmp_home, lm):
    """Pinned W (w_floor) across a parallelism change, and the eval split
    over a pinned worker count, equal the reference's."""
    ref, port = _loaders(lm, 2, False, w_floor=4)
    for n in (2, 3, 1):
        plan, ref_plan = port.plan(n, 2, 16), ref.plan(n, 2, 16)
        assert port.round_geometry(plan) == ref.round_geometry(ref_plan)
        for g, w in zip(port.epoch_rounds(plan, n),
                        ref.epoch_rounds(ref_plan, n)):
            _assert_rounds_equal(g, w)
    for n, b in ((4, 16), (3, 32), (1, 8)):
        gb, gm = port.eval_batches(n, b)
        wb, wm = ref.eval_batches(n, b)
        np.testing.assert_array_equal(gm, wm)
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k])


@pytest.mark.parametrize("r", [2, 3])
def test_group_rounds_equal_reference(tmp_home, r):
    """Rounds stacked R at a time (the tail singly), through the prefetch
    thread, equal the reference's group_rounds."""
    from kubeml_tpu.data.loader import group_rounds as ref_group
    from kubeml_tpu_torch.data.loader import group_rounds, prefetch_rounds

    ref, port = _loaders(False, 1, True)
    plan, ref_plan = port.plan(2, 1, 16), ref.plan(2, 1, 16)
    got = list(prefetch_rounds(group_rounds(port.epoch_rounds(plan, 1), r)))
    want = list(ref_group(ref.epoch_rounds(ref_plan, 1), r))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _assert_rounds_equal(g, w)


def test_prefetch_surfaces_feeder_errors_and_group_rejects_empty_rounds():
    from kubeml_tpu_torch.api.errors import MergeError
    from kubeml_tpu_torch.data.loader import (RoundBatch, group_rounds,
                                              prefetch_rounds)

    def boom():
        yield 1
        raise RuntimeError("feeder failed")

    it = prefetch_rounds(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="feeder failed"):
        next(it)
    empty = RoundBatch(batch={}, sample_mask=np.zeros((1, 1, 1)),
                       step_mask=np.zeros((1, 1)), worker_mask=np.zeros(1),
                       rngs=np.zeros((1, 1, 2), np.uint32), round_index=0,
                       num_rounds=1)
    with pytest.raises(MergeError, match="no workers"):
        list(group_rounds(iter([empty]), 2))
