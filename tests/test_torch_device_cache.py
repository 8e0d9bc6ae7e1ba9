"""Port parity: the device-resident dataset cache and index-fed rounds of
kubeml_tpu_torch against the JAX package's.

  - ``epoch_index_rounds`` (indices, masks, rng keys) and the cache's lane
    layout equal the reference's exactly, sharded and replicated, shuffle
    on and off;
  - the job's cache decision (eligibility, layout, budget, the 400s) equals
    the reference job's for the same options and dataset;
  - an index-fed round equals the host-staged round of the same samples
    bit for bit on the CPU (torch.equal), singly and grouped, and so does a
    job run from the cache against the same job host-staged.
"""

import numpy as np
import pytest
import torch

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

N_TRAIN, N_TEST, HW = 200, 40, 8


def _images(seed=0):
    """u8 NHWC images whose class shifts channel 0's mean."""
    rng = np.random.default_rng(seed)

    def split(n):
        y = rng.integers(0, 10, n).astype(np.int32)
        x = rng.integers(0, 160, (n, HW, HW, 3))
        x[..., 0] += 9 * y[:, None, None]
        return x.astype(np.uint8), y
    return (*split(N_TRAIN), *split(N_TEST))


@pytest.fixture()
def images(tmp_home):
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    DatasetRegistry().create("images", *_images())


def _handles():
    from kubeml_tpu.data.registry import DatasetRegistry as RefRegistry
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    return RefRegistry().get("images"), DatasetRegistry().get("images")


def _host(self, data, labels):
    return {"x": np.asarray(data).astype(np.float32) / 255.0,
            "y": np.asarray(labels)}


def _device(x, y):
    """The device twin of _host: the same f32 division on the card."""
    if isinstance(x, torch.Tensor):
        return {"x": x.float() / 255.0, "y": y}
    return {"x": x.astype("float32") / 255.0, "y": y}


def _dataset(pkg, kind):
    """identity: no transform; twin: _host with its device twin;
    host_only: _host without one (not eligible)."""
    if pkg == "ref":
        from kubeml_tpu.models.base import KubeDataset as base
    else:
        from kubeml_tpu_torch.models.base import KubeDataset as base
    body = {}
    if kind in ("twin", "host_only"):
        body.update(transform_train=_host, transform_test=_host)
    if kind == "twin":
        body["transform_train_device"] = staticmethod(_device)
    return type(f"Images_{kind}", (base,), body)("images")


@pytest.mark.parametrize("layout,shuffle", [
    ("sharded", False), ("replicated", False), ("replicated", True)])
def test_epoch_index_rounds_and_layout_equal_reference(images, layout,
                                                        shuffle):
    from kubeml_tpu.data.device_cache import \
        DeviceDatasetCache as RefCache
    from kubeml_tpu.data.loader import RoundLoader as RefLoader
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache
    from kubeml_tpu_torch.data.loader import RoundLoader

    ref_h, h = _handles()
    D = 2
    ref_loader = RefLoader(ref_h, _dataset("ref", "identity"), n_lanes=D,
                           seed=3, shuffle=shuffle)
    loader = RoundLoader(h, _dataset("port", "identity"), n_lanes=D, seed=3,
                         shuffle=shuffle)
    ref_cache = RefCache(ref_h, make_mesh(n_data=D), layout=layout)
    cache = DeviceDatasetCache(h, "cpu", n_lanes=D, layout=layout)
    for epoch, n in ((0, 3), (1, 3), (2, 2)):
        ref_plan, plan = ref_loader.plan(n, 2, 8), loader.plan(n, 2, 8)
        W = loader.round_geometry(plan)[0]
        assert W == ref_loader.round_geometry(ref_plan)[0]
        if layout == "sharded":
            assert cache._lane_ranges(plan, W) == \
                ref_cache._lane_ranges(ref_plan, W)
        assert cache.ensure(plan, W) == ref_cache.ensure(ref_plan, W)
        assert cache.device_bytes == ref_cache.device_bytes
        assert cache.signature == ref_cache.signature
        np.testing.assert_array_equal(
            cache.lane_starts if cache.lane_starts is not None else -1,
            ref_cache.lane_starts if ref_cache.lane_starts is not None
            else -1)
        for k in ("x", "y"):
            np.testing.assert_array_equal(cache.arrays[k].numpy(),
                                          np.asarray(ref_cache.arrays[k]))
        got = list(loader.epoch_index_rounds(plan, epoch,
                                             cache.lane_starts))
        want = list(ref_loader.epoch_index_rounds(ref_plan, epoch,
                                                  ref_cache.lane_starts))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert sorted(g.batch) == sorted(w.batch) == ["idx"]
            for a, b in ((g.batch["idx"], w.batch["idx"]),
                         (g.sample_mask, w.sample_mask),
                         (g.step_mask, w.step_mask),
                         (g.worker_mask, w.worker_mask), (g.rngs, w.rngs)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert (g.round_index, g.num_rounds) == \
                (w.round_index, w.num_rounds)
    assert cache.stats["uploads"] == ref_cache.stats["uploads"]
    for kw in ({}, {"n_lanes": 3}):
        assert DeviceDatasetCache.per_chip_bytes(h, layout, kw.get(
            "n_lanes", D)) == RefCache.per_chip_bytes(ref_h, layout, kw.get(
                "n_lanes", D))
    assert DeviceDatasetCache.per_sample_bytes(h) == \
        RefCache.per_sample_bytes(ref_h)


@pytest.mark.parametrize("layout", ["sharded", "replicated"])
def test_from_arrays_equals_reference(layout):
    """A cache built straight from host arrays: the same slabs, lane
    starts, resident bytes and signature as the reference's at D = 3."""
    from kubeml_tpu.data.device_cache import \
        DeviceDatasetCache as RefCache
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    x, y = _images()[:2]
    ref = RefCache.from_arrays(make_mesh(n_data=3), {"x": x, "y": y},
                               layout=layout)
    got = DeviceDatasetCache.from_arrays("cpu", {"x": x, "y": y},
                                         layout=layout, n_lanes=3)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got.arrays[k].numpy(),
                                      np.asarray(ref.arrays[k]))
    assert got.device_bytes == ref.device_bytes
    assert got.signature == ref.signature
    if layout == "sharded":
        np.testing.assert_array_equal(got.lane_starts, ref.lane_starts)
    else:
        assert got.lane_starts is None and ref.lane_starts is None


def test_shuffled_epochs_refuse_lane_local_indices(images):
    from kubeml_tpu.api.errors import DataError as RefDataError
    from kubeml_tpu.data.loader import RoundLoader as RefLoader
    from kubeml_tpu_torch.api.errors import DataError
    from kubeml_tpu_torch.data.loader import RoundLoader

    ref_h, h = _handles()
    starts = np.zeros(1, np.int64)
    ref_loader = RefLoader(ref_h, _dataset("ref", "identity"), 1,
                           shuffle=True)
    with pytest.raises(RefDataError, match="replicated cache"):
        next(ref_loader.epoch_index_rounds(ref_loader.plan(2, 2, 8), 0,
                                           starts))
    loader = RoundLoader(h, _dataset("port", "identity"), 1, shuffle=True)
    with pytest.raises(DataError, match="replicated cache"):
        next(loader.epoch_index_rounds(loader.plan(2, 2, 8), 0, starts))


# (device_cache, dataset kind, shuffle, device_cache_mb)
DECISIONS = {
    "auto_identity": ("auto", "identity", False, 512),
    "auto_shuffle": ("auto", "identity", True, 512),
    "auto_twin": ("auto", "twin", False, 512),
    "auto_host_only": ("auto", "host_only", False, 512),
    "auto_over_budget": ("auto", "twin", False, 0),
    "on_host_only": ("on", "host_only", False, 512),
    "on_over_budget": ("on", "twin", True, 0),
    "off": ("off", "identity", False, 512),
}


def _decision(job, call):
    """(status, message) of the 400, or (layout, has device transform)."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 — both packages' KubeMLException
        return (e.status_code, e.message)
    cache = job._device_cache
    return None if cache is None else (cache.layout,
                                       cache.device_transform is not None)


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_cache_decision_equals_reference_job(images, case):
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train.job import TrainJob as RefJob
    from kubeml_tpu_torch.api import types
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.train.job import TrainJob

    mode, kind, shuffle, mb = DECISIONS[case]
    out = {}
    for pkg, t in (("ref", ref_types), ("port", types)):
        opts = t.TrainOptions(device_cache=mode, shuffle=shuffle,
                              device_cache_mb=mb)
        task = t.TrainTask(job_id=f"{pkg}-{case}", parameters=t.TrainRequest(
            model_type="mlp", batch_size=8, epochs=1, dataset="images",
            lr=0.1, options=opts), parallelism=2)
        if pkg == "ref":
            job = RefJob(task, get_builtin("mlp")(), _dataset(pkg, kind),
                         make_mesh(n_data=1))
            job._manual_tp = job._pp = job._continual = False
            handle = job.registry.get("images")
            out[pkg] = _decision(job, lambda: job._init_device_cache(
                handle, opts, "kavg", 1))
        else:
            job = TrainJob(task, get_model("mlp")(), _dataset(pkg, kind),
                           device="cpu")
            handle = job.registry.get("images")
            out[pkg] = _decision(job, lambda: job._init_device_cache(
                handle, opts))
    assert out["port"] == out["ref"], out
    if case == "on_host_only":
        assert out["port"][0] == 400


# ------------------------------------------------- index-fed == host-staged

def _narrow():
    """A narrow f32 ResNet (one BasicBlock per stage, two stages, width
    8): BatchNorm state at a size the CPU trains in seconds."""
    from kubeml_tpu_torch.models import resnet

    class Narrow(resnet._ResNetBase):
        name = "resnet-narrow"
        stage_sizes, width = (1, 1), 8

        def build(self, dtype=torch.float32, device=None):
            return super().build(dtype=dtype, device=device)

    return Narrow()


def _engine(n_lanes):
    from kubeml_tpu_torch.models.base import module_state
    from kubeml_tpu_torch.parallel.kavg import KAvgEngine

    model = _narrow()
    module = model.init_module({"x": np.zeros((1, HW, HW, 3), np.uint8)},
                               torch.Generator().manual_seed(0),
                               device="cpu")
    engine = KAvgEngine(module, model.loss, model.metrics,
                        model.configure_optimizers, n_lanes=n_lanes,
                        merge_bucket_mb=0.01)
    state = {k: v.detach().clone() for k, v in module_state(module).items()}
    return engine, state


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("layout,n_lanes", [("sharded", 2),
                                            ("replicated", 1)])
def test_index_fed_rounds_equal_host_staged_bit_for_bit(images, layout,
                                                        n_lanes):
    """A narrow ResNet (BatchNorm) over one epoch's rounds: each
    index-fed round (gather + the device twin of the host transform)
    gives the host-staged round's state and loss sums bit for bit, and
    two index-fed rounds grouped give the two single rounds' results."""
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache
    from kubeml_tpu_torch.data.loader import RoundLoader

    _, h = _handles()
    loader = RoundLoader(h, _dataset("port", "twin"), n_lanes=n_lanes,
                         seed=1)
    plan = loader.plan(2, 2, 8)
    W = loader.round_geometry(plan)[0]
    cache = DeviceDatasetCache(h, "cpu", n_lanes=n_lanes, layout=layout,
                               device_transform=_device)
    cache.ensure(plan, W)
    host = list(loader.epoch_rounds(plan, 0))
    idx = list(loader.epoch_index_rounds(plan, 0, cache.lane_starts))
    assert len(host) == len(idx) >= 2
    e_host, s_host = _engine(n_lanes)
    e_idx, s_idx = _engine(n_lanes)
    for hb, ib in zip(host, idx):
        for a, b in ((hb.sample_mask, ib.sample_mask),
                     (hb.step_mask, ib.step_mask), (hb.rngs, ib.rngs)):
            np.testing.assert_array_equal(a, b)
        s_host, st_h = e_host.train_round(
            s_host, hb.batch, hb.sample_mask, hb.step_mask, hb.worker_mask,
            hb.rngs, lr=0.1, epoch=0)
        s_idx, st_i = e_idx.train_round_indexed(
            s_idx, cache, ib.batch["idx"], ib.sample_mask, ib.step_mask,
            ib.worker_mask, ib.rngs, lr=0.1, epoch=0)
        _assert_states_equal(s_idx, s_host)
        assert torch.equal(st_i.loss_sum_device, st_h.loss_sum_device)
        np.testing.assert_array_equal(st_i.step_count, st_h.step_count)
    # two rounds grouped == the same two rounds one by one
    e_grp, s_grp = _engine(n_lanes)
    e_one, s_one = _engine(n_lanes)
    pair = idx[:2]
    stack = {k: np.stack([getattr(r, k) for r in pair])
             for k in ("sample_mask", "step_mask", "worker_mask", "rngs")}
    s_grp, st_g = e_grp.train_rounds_indexed(
        s_grp, cache, np.stack([r.batch["idx"] for r in pair]),
        lr=0.1, epoch=0, **stack)
    sums = []
    for r in pair:
        s_one, st = e_one.train_round_indexed(
            s_one, cache, r.batch["idx"], r.sample_mask, r.step_mask,
            r.worker_mask, r.rngs, lr=0.1, epoch=0)
        sums.append(st.loss_sum_device)
    _assert_states_equal(s_grp, s_one)
    assert torch.equal(st_g.loss_sum_device, torch.stack(sums))


@pytest.mark.parametrize("rounds_per_dispatch", [1, 2])
def test_job_from_the_cache_equals_host_staged_job(images,
                                                   rounds_per_dispatch):
    """The same narrow-ResNet job twice on the CPU, device_cache auto
    (sharded, the device twin) and off: equal histories and final state
    (parameters and running statistics) bit for bit."""
    from kubeml_tpu_torch.api import types
    from kubeml_tpu_torch.train.job import TrainJob

    out = {}
    for mode in ("auto", "off"):
        task = types.TrainTask(
            job_id=f"job-{mode}", parallelism=2,
            parameters=types.TrainRequest(
                model_type="resnet-narrow", batch_size=8, epochs=2,
                dataset="images", lr=0.1, options=types.TrainOptions(
                    device_cache=mode, k=2, static_parallelism=True,
                    rounds_per_dispatch=rounds_per_dispatch,
                    merge_bucket_mb=0.01)))
        job = TrainJob(task, _narrow(), _dataset("port", "twin"),
                       device="cpu")
        rec = job.train()
        out[mode] = (job, rec.data)
    (cached, hist_c), (staged, hist_s) = out["auto"], out["off"]
    assert cached._device_cache is not None and \
        cached._device_cache.layout == "sharded"
    assert staged._device_cache is None
    assert hist_c.train_loss == hist_s.train_loss
    assert hist_c.validation_loss == hist_s.validation_loss
    assert hist_c.accuracy == hist_s.accuracy
    _assert_states_equal(cached.state, staged.state)
    assert any("running_mean" in k for k in cached.state)
