"""Port parity: the continual mode (mirrors tests/test_continual.py's
ingest, device-cache, sliding-window, publish and CLI cases).

- the registry: ``append`` (generation tags, monotonic check, validation
  before any write, versioned files, retention) and the windowed ``get``
  give the JAX package's manifests, files and arrays exactly, and each
  package reads what the other wrote;
- the storage and controller append routes end to end, against the JAX
  package's deployment: the same documents and status codes;
- the device cache: the incremental refresh equals a cold layout bit for
  bit on grow and slide, and equals the JAX package's slabs and stats;
  the replicated layout re-uploads after a refresh;
- the job: the freshness sequence, the registry-failure survival, the
  ``stale_data`` fault and the ``data_staleness`` rule (through the PS
  too), the window, the option 400s and the publish cadence equal the
  JAX job's; a mid-window restart resumes the weights bit for bit
  within the port, in process and in a job-server child;
- serving: a continual job's publishes hot-swap a CPU fleet through the
  PS, one weight generation per new stamp;
- the CLI: ``train`` flag validation and ``dataset append`` print what
  the JAX package's CLI prints; ``top``'s continual pane is its pane.

Tolerances: exact for generations, counts, manifests, arrays and slabs;
the mlp jobs (SGD, f32) within 1e-5 of the JAX job's losses and weights
(the frameworks sum in other orders); a restart within the port bit for
bit (one process, one torch thread count).
"""

import json
import os
import threading
import time

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

DIM, CLASSES, SUBSET = 8, 4, 16
PKGS = ("ref", "port")


def _split(n, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, CLASSES, n).astype(np.int32)
    x = rng.randn(n, DIM).astype(np.float32) * 2.0
    x[np.arange(n), y % DIM] += 3.0
    return x, y


def _registry(pkg, root=None):
    if pkg == "ref":
        from kubeml_tpu.data.registry import DatasetRegistry
    else:
        from kubeml_tpu_torch.data.registry import DatasetRegistry
    return DatasetRegistry(root=None if root is None else str(root))


def _blobs(reg, n_train=256, n_test=64, seed=0):
    xtr, ytr = _split(n_train, seed)
    xte, yte = _split(n_test, seed + 1)
    return reg.create("blobs", xtr, ytr, xte, yte, subset_size=SUBSET)


def _manifest(reg):
    with open(os.path.join(reg.root, "blobs", "manifest.json")) as f:
        m = json.load(f)
    m.pop("created")
    m.pop("appended", None)
    return m


def _handle_fields(h):
    return (h.generation, h.train_samples, h.test_samples, h.train_base,
            h.train_offset, h.files, h.num_train_docs, h.num_test_docs)


def _arrays(h):
    return [np.asarray(a) for a in (*h.train_arrays(), *h.test_arrays())]


def _assert_same_handle(a, b):
    assert _handle_fields(a) == _handle_fields(b)
    for x, y in zip(_arrays(a), _arrays(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- ingest

def _append_sequence(reg):
    """create (256) -> append 128 -> append 64 with retention 2: the
    handles after each step."""
    out = [_blobs(reg)]
    out.append(reg.append("blobs", *_split(128, seed=7)))
    out.append(reg.append("blobs", *_split(64, seed=8),
                          retention_generations=2))
    return out


def test_append_and_retention_give_the_references_manifests(tmp_path):
    """The same create/append/retention sequence in both packages: equal
    handles, manifests (but their timestamps), file names and arrays."""
    regs = {pkg: _registry(pkg, tmp_path / pkg) for pkg in PKGS}
    steps = {pkg: _append_sequence(regs[pkg]) for pkg in PKGS}
    for a, b in zip(steps["ref"], steps["port"]):
        assert _handle_fields(a) == _handle_fields(b)
    assert _manifest(regs["port"]) == _manifest(regs["ref"])
    assert sorted(os.listdir(os.path.join(regs["port"].root, "blobs"))) == \
        sorted(os.listdir(os.path.join(regs["ref"].root, "blobs")))
    h3 = steps["port"][2]
    # generation 1's 256 samples expired from the front
    assert (h3.generation, h3.train_samples, h3.train_base) == (3, 192, 256)
    x, y = (np.asarray(a) for a in h3.train_arrays())
    xa, ya = _split(128, seed=7)
    xb, yb = _split(64, seed=8)
    np.testing.assert_array_equal(x, np.concatenate([xa, xb]))
    np.testing.assert_array_equal(y, np.concatenate([ya, yb]))
    _assert_same_handle(steps["port"][2], steps["ref"][2])


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("window", [0, 1, 2, 9])
def test_windowed_views_read_alike_across_packages(tmp_path, writer,
                                                   window):
    """A dataset one package created and appended to opens identically in
    both, whole or as a window of the newest generations (doc-aligned;
    a window wider than the history is the whole dataset)."""
    reg = _registry(writer, tmp_path)
    _blobs(reg)
    xa, ya = _split(120, seed=7)                # ends inside a doc
    reg.append("blobs", xa, ya)
    reg.append("blobs", *_split(40, seed=9))
    views = {pkg: _registry(pkg, tmp_path).get(
        "blobs", window_generations=window) for pkg in PKGS}
    _assert_same_handle(views["port"], views["ref"])
    h = views["port"]
    # the newest generation alone starts inside a doc: the view takes
    # that doc's 8 samples of generation 2 too
    want = {0: (416, 0), 1: (40 + 8, 368), 2: (160, 256), 9: (416, 0)}
    assert (h.train_samples, h.train_offset) == want[window]
    assert h.train_base == h.train_offset
    if window == 2:
        np.testing.assert_array_equal(np.asarray(h.train_arrays()[0])[:120],
                                      xa)


def test_append_validation_400s_commit_nothing(tmp_path):
    """Shape/dtype drift, an empty chunk, a length mismatch and a stale
    producer tag are 400s with the JAX package's messages; nothing is
    committed."""
    x, y = _split(64, seed=7)
    bad = [
        dict(x_train=x[:, :4], y_train=y),          # sample shape drift
        dict(x_train=x.astype(np.float64), y_train=y),
        dict(x_train=x, y_train=y.astype(np.int64)),
        dict(x_train=x[:0], y_train=y[:0]),         # empty chunk
        dict(x_train=x, y_train=y[:32]),            # length mismatch
        dict(x_train=x, y_train=y, generation=1),   # stale producer
    ]
    msgs = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / pkg)
        _blobs(reg)
        msgs[pkg] = []
        for kw in bad:
            with pytest.raises(Exception) as ei:   # each package's class
                reg.append("blobs", **kw)
            assert type(ei.value).__name__ == "InvalidFormatError"
            msgs[pkg].append((ei.value.status_code, ei.value.message))
        h = reg.get("blobs")
        assert (h.generation, h.train_samples) == (1, 256)
        assert _manifest(reg)["windows"] == [{"generation": 1,
                                              "samples": 256}]
    assert msgs["port"] == msgs["ref"]
    assert {code for code, _ in msgs["port"]} == {400}
    with pytest.raises(Exception) as ei:
        _registry("port", tmp_path / "port").append("nosuch", x, y)
    assert ei.value.status_code == 404


def test_append_files_reads_npy_and_pkl(tmp_path, tmp_home):
    import pickle

    from kubeml_tpu_torch.data.ingest import append_files

    reg = _registry("port")
    _blobs(reg)
    xa, ya = _split(32, seed=5)
    np.save(tmp_path / "x.npy", xa)
    with open(tmp_path / "y.pkl", "wb") as f:
        pickle.dump(ya, f)
    h = append_files("blobs", str(tmp_path / "x.npy"),
                     str(tmp_path / "y.pkl"), generation=5,
                     retention_generations=1)
    assert (h.generation, h.train_samples, h.train_base) == (5, 32, 256)
    with pytest.raises(Exception) as ei:
        append_files("blobs", str(tmp_path / "nope.npy"),
                     str(tmp_path / "y.pkl"))
    assert ei.value.status_code == 400


@pytest.fixture()
def plane(tmp_path, tmp_home, mesh8):
    """A JAX deployment and a port deployment (CPU) over one home."""
    from kubeml_tpu.control.client import KubemlClient as RefClient
    from kubeml_tpu.control.deployment import start_deployment as ref_start
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    ref = ref_start(mesh=mesh8)
    port = start_deployment(device="cpu")
    paths = {}
    for name, arr in zip(("xtr", "ytr", "xte", "yte", "xa", "ya"),
                         (*_split(256, 0), *_split(64, 1),
                          *_split(128, 7))):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    paths["x64"] = str(tmp_path / "x64.npy")
    np.save(paths["x64"], _split(128, 7)[0].astype(np.float64))
    try:
        yield {"ref": (ref, RefClient(ref.controller_url).v1()),
               "port": (port, KubemlClient(port.controller_url).v1()),
               "paths": paths}
    finally:
        port.stop()
        ref.stop()


def test_append_routes_answer_as_the_references(plane):
    """Client -> controller -> storage over HTTP in both deployments (one
    after the other on the same home): the same documents and status
    codes for an append, a stale tag, dtype drift and an unknown
    dataset; the storage route answers alike when called directly."""
    from kubeml_tpu_torch.control.httpd import http_json

    p = plane["paths"]
    out = {}
    for pkg in PKGS:
        dep, client = plane[pkg]
        client.datasets().create("blobs", p["xtr"], p["ytr"], p["xte"],
                                 p["yte"])
        got = [client.datasets().append("blobs", p["xa"], p["ya"],
                                        retention=4)]
        for args, kw in (((p["xa"], p["ya"]), dict(generation=1)),
                         ((p["x64"], p["ya"]), {}),
                         ((p["xa"], p["ya"]), dict(name="nosuch"))):
            name = kw.pop("name", "blobs")
            with pytest.raises(Exception) as ei:
                client.datasets().append(name, *args, **kw)
            got.append((ei.value.status_code, ei.value.message))
        got.append([s.train_set_size for s in client.datasets().list()])
        # storage directly: a body that is not multipart
        with pytest.raises(Exception) as ei:
            http_json("POST", f"{dep.storage.url}/dataset/blobs/append", {})
        got.append((ei.value.status_code, ei.value.message))
        out[pkg] = got
        client.datasets().delete("blobs")
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"name": "blobs", "train_set_size": 384,
                              "test_set_size": 64, "generation": 2}
    assert [c for c, _ in out["port"][1:4]] == [400, 400, 404]


# ----------------------------------------------------------- device cache

def _plan(h, W):
    from kubeml_tpu_torch.data.sharding import plan_epoch
    return plan_epoch(h.train_samples, W, 1, 16, h.subset_size)


def _cache_steps(reg):
    """The registry's handles: grown by an append, slid by retention, and
    unchanged."""
    yield reg.get("blobs")
    reg.append("blobs", *_split(128, seed=7))
    yield reg.get("blobs")
    reg.append("blobs", *_split(64, seed=8), retention_generations=2)
    yield reg.get("blobs")
    yield reg.get("blobs")


@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_incremental_cache_equals_cold_and_the_references(tmp_home, lanes):
    """On grow and slide the incremental slabs equal a cold layout of the
    same handle bit for bit, and the JAX package's incremental slabs;
    uploads/lanes_reused/lanes_refreshed equal its stats; an unchanged
    window is a no-op; a refresh sends only what slid in."""
    from kubeml_tpu.data.device_cache import DeviceDatasetCache as RefCache
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    reg = _registry("port")
    _blobs(reg)
    W, mesh = 2, make_mesh(n_data=lanes)
    inc = ref = None
    for step, h in enumerate(_cache_steps(reg)):
        ref_h = _registry("ref").get("blobs")
        if inc is None:
            inc = DeviceDatasetCache(h, "cpu", n_lanes=lanes,
                                     incremental=True, grow_quantum=64)
            ref = RefCache(ref_h, mesh, incremental=True, grow_quantum=64)
        else:
            inc.refresh(h)
            ref.refresh(ref_h)
        sent = inc.stats["h2d_bytes"]
        moved = inc.ensure(_plan(h, W), W)
        assert moved == ref.ensure(_plan(ref_h, W), W) == (step < 3)
        cold = DeviceDatasetCache(h, "cpu", n_lanes=lanes, grow_quantum=64)
        cold.ensure(_plan(h, W), W)
        for key in ("x", "y"):
            assert inc.arrays[key].shape == cold.arrays[key].shape
            assert bool((inc.arrays[key] == cold.arrays[key]).all())
            np.testing.assert_array_equal(inc.arrays[key].numpy(),
                                          np.asarray(ref.arrays[key]))
        assert inc.signature[1] == cold.signature[1]
        assert inc.stats == {**ref.stats,
                             "h2d_bytes": inc.stats["h2d_bytes"]}
        # a lane sends what its previous range did not hold: on one lane
        # the grown tail (128) and the slid-in tail (64); on two, the
        # lane boundary moves too (a lane reuses only its own slab)
        per_sample = DIM * 4 + 4
        if step in (1, 2):
            want = {1: (128, 64), 2: (192, 160), 8: (192, 160)}[lanes]
            assert inc.stats["h2d_bytes"] - sent == \
                want[step - 1] * per_sample
    assert inc.stats["uploads"] == 3
    assert cold.stats["h2d_bytes"] == 192 * per_sample


def test_grow_within_the_quantum_keeps_the_signature(tmp_home):
    """A continual job's slabs round up to 512 samples a lane: growth
    within the quantum re-lays out without changing ``signature`` (the
    engine's program key), as in the JAX package."""
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    reg = _registry("port")
    _blobs(reg)
    cache = DeviceDatasetCache(reg.get("blobs"), "cpu", n_lanes=2,
                               incremental=True, grow_quantum=512)
    cache.ensure(_plan(reg.get("blobs"), 2), 2)
    sig = cache.signature
    reg.append("blobs", *_split(128, seed=7))
    cache.refresh(reg.get("blobs"))
    assert cache.ensure(_plan(reg.get("blobs"), 2), 2)
    assert cache.signature == sig
    assert cache.arrays["x"].shape[:2] == (2, 512)


def test_replicated_cache_reuploads_after_refresh(tmp_home):
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    reg = _registry("port")
    _blobs(reg)
    cache = DeviceDatasetCache(reg.get("blobs"), "cpu", layout="replicated")
    assert cache.ensure()
    assert cache.ensure() is False          # unchanged window: no-op
    reg.append("blobs", *_split(64, seed=7))
    cache.refresh(reg.get("blobs"))
    assert cache.ensure()                   # window moved: re-upload
    x, _ = (np.asarray(a) for a in reg.get("blobs").train_arrays())
    np.testing.assert_array_equal(cache.arrays["x"].numpy(), x)
    # a slide that keeps the length still moves the absolute window
    reg.append("blobs", *_split(64, seed=8), retention_generations=1)
    reg.append("blobs", *_split(64, seed=9), retention_generations=1)
    cache.refresh(reg.get("blobs"))
    assert cache.ensure()
    np.testing.assert_array_equal(cache.arrays["x"].numpy(),
                                  _split(64, seed=9)[0])
    assert cache.stats["uploads"] == 3


@pytest.mark.gpu
def test_incremental_cache_on_the_card_equals_cold(tmp_path):
    """On the card: the incremental slabs equal a cold upload bit for bit
    (torch.equal on the device) after grow and slide."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kubeml_tpu_torch.data.device_cache import DeviceDatasetCache

    reg = _registry("port", tmp_path)
    _blobs(reg)
    inc = None
    for h in _cache_steps(reg):
        if inc is None:
            inc = DeviceDatasetCache(h, "cuda", n_lanes=2,
                                     incremental=True, grow_quantum=64)
        inc.refresh(h)
        inc.ensure(_plan(h, 2), 2)
        cold = DeviceDatasetCache(h, "cuda", n_lanes=2, grow_quantum=64)
        cold.ensure(_plan(h, 2), 2)
        for key in ("x", "y"):
            assert inc.arrays[key].is_cuda
            assert torch.equal(inc.arrays[key], cold.arrays[key])


# ------------------------------------------------------- sliding window

def _job(pkg, reg, job_id, *, epochs, callbacks=None, resume=False,
         warm=True, **opts):
    """The reference's continual mlp job (N=2, K=1, B=16: 8 rounds an
    epoch over 256 samples), warm-started from one JAX checkpoint."""
    from test_torch_job import _tasks

    tasks = _tasks(job_id, "mlp", "blobs", epochs=epochs, k=1, batch=16,
                   goal=200.0, resume_from="seedckpt" if warm else "",
                   continual=opts.pop("continual", True), **opts)
    task = tasks[pkg]
    task.job_id = job_id
    if resume:
        task.parameters.resume_from = job_id
    if pkg == "ref":
        from kubeml_tpu.models import get_builtin
        from kubeml_tpu.models.base import KubeDataset
        from kubeml_tpu.parallel.mesh import make_mesh
        from kubeml_tpu.train.job import TrainJob
        return TrainJob(task, get_builtin("mlp")(hidden=16, num_classes=4),
                        KubeDataset("blobs"), make_mesh(n_data=1),
                        registry=reg, callbacks=callbacks)
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import TrainJob
    return TrainJob(task, get_model("mlp")(hidden=16, num_classes=4),
                    KubeDataset("blobs"), device="cpu", registry=reg,
                    callbacks=callbacks)


def _callbacks(pkg, publish):
    if pkg == "ref":
        from kubeml_tpu.train.job import JobCallbacks
    else:
        from kubeml_tpu_torch.train.job import JobCallbacks
    return JobCallbacks(publish_metrics=publish)


def _weights(job_id):
    from kubeml_tpu_torch.train.checkpoint import _flatten, load_checkpoint

    tree, _ = load_checkpoint(job_id)
    return _flatten(tree)


@pytest.mark.parametrize("cache", ["off", "on"])
def test_continual_job_follows_appends_as_the_reference(tmp_path, tmp_home,
                                                        cache):
    """Appends land between epochs; both jobs report the reference's
    freshness sequence, train the same windows (losses and final weights
    within 1e-5) and stay checkpointed."""
    from test_torch_job import _seed_mlp_checkpoint

    _seed_mlp_checkpoint()
    out = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / f"reg-{pkg}")
        _blobs(reg)
        seen = []

        def publish(m, reg=reg, seen=seen):
            seen.append((m.dataset_generation, m.data_lag_generations))
            if len(seen) <= 2:
                reg.append("blobs", *_split(64, seed=10 + len(seen)))

        job = _job(pkg, reg, f"ctfollow-{pkg}", epochs=4,
                   callbacks=_callbacks(pkg, publish), device_cache=cache)
        record = job.train()
        out[pkg] = (seen, record.data.train_loss,
                    job._handle.train_samples)
    assert out["port"][0] == out["ref"][0] == [(1, 0), (2, 0), (3, 0),
                                               (3, 0)]
    assert out["port"][2] == out["ref"][2] == 384
    np.testing.assert_allclose(out["port"][1], out["ref"][1], rtol=1e-5)
    have, want = _weights("ctfollow-port"), _weights("ctfollow-ref")
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=1e-5)


def test_continual_refresh_survives_registry_failure(tmp_path, tmp_home):
    out = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / pkg)
        _blobs(reg)
        seen = []
        real_get = reg.get

        def flaky_get(name, window_generations=0, seen=seen,
                      real_get=real_get):
            if len(seen) == 1:
                raise OSError("registry briefly unreadable")
            return real_get(name, window_generations=window_generations)

        def publish(m, seen=seen):
            seen.append((m.dataset_generation, m.data_lag_generations))

        reg.get = flaky_get
        job = _job(pkg, reg, f"ctflaky-{pkg}", epochs=3, warm=False,
                   callbacks=_callbacks(pkg, publish))
        job.train()
        out[pkg] = (job.task.state, seen)
    assert out["port"] == out["ref"] == ("finished", [(1, 0)] * 3)


def _stale_run(pkg, reg, job_id):
    seen, updates = [], []

    def publish(m):
        seen.append((m.dataset_generation, m.data_lag_generations))
        updates.append(m.to_dict())
        if len(seen) <= 3:
            reg.append("blobs", *_split(64, seed=10 + len(seen)))

    job = _job(pkg, reg, job_id, epochs=5, warm=False,
               callbacks=_callbacks(pkg, publish),
               fault_plan=json.dumps([{"kind": "stale_data"}]))
    job.train()
    return job, seen, updates


def test_stale_data_fault_drives_the_staleness_rule(tmp_path, tmp_home):
    """The ``stale_data`` fault pins the trained generation while the
    registry moves on (the reference's sequence); the data_staleness
    rule fires past the lag limit with the reference's detail."""
    from kubeml_tpu.control.health import default_rules as ref_rules
    from kubeml_tpu_torch.control.health import default_rules

    out = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / pkg)
        _blobs(reg)
        job, seen, _ = _stale_run(pkg, reg, f"ctstale-{pkg}")
        out[pkg] = (seen, job._fault_plan.injected["stale_data"])
    assert out["port"] == out["ref"] == (
        [(1, 0), (1, 1), (1, 2), (1, 3), (1, 3)], 5)
    samples = [[{"dataset_generation": 1, "data_lag_generations": 3}],
               [{"data_lag_generations": 2}],
               [{"data_lag_generations": -1}], [{}]]
    got = [{r.name: r for r in rules()}["data_staleness"].check(s)
           for rules in (default_rules, ref_rules) for s in samples]
    assert got[:4] == got[4:]
    assert "3 generation(s) ahead" in got[0] and got[1:4] == [None] * 3


def test_the_ps_feeds_data_staleness_from_a_jobs_updates(tmp_path,
                                                         tmp_home, mesh8):
    """A stale continual job's MetricUpdates, posted to each package's PS
    as a job process posts them: the same health verdict (the
    data_staleness rule fired), the same freshness gauges and the same
    `top` screen with its continual pane."""
    from kubeml_tpu.cli.main import _render_top as ref_render
    from kubeml_tpu.control.ps import ParameterServer as RefPS
    from kubeml_tpu_torch.cli.main import _render_top
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.control.ps import ParameterServer

    reg = _registry("port", tmp_path)
    _blobs(reg)
    _, _, updates = _stale_run("port", reg, "ctstaleps")
    out = {}
    for pkg, ps, render in (
            ("ref", RefPS(mesh=mesh8, port=0), ref_render),
            ("port", ParameterServer(device="cpu", port=0), _render_top)):
        ps.start()
        try:
            for m in updates:
                http_json("POST", f"{ps.url}/metrics/ctstaleps", m)
            verdict = http_json("GET", f"{ps.url}/health?id=ctstaleps")
            text = _get_text(f"{ps.url}/metrics")
        finally:
            ps.stop()
        gauges = sorted(ln for ln in text.splitlines() if ln.startswith((
            "kubeml_dataset_generation{", "kubeml_data_lag_generations{")))
        out[pkg] = ([(r["rule"], r["severity"], r["detail"])
                     for r in verdict["reasons"]], verdict["state"], gauges,
                    render(verdict))
    assert out["port"] == out["ref"]
    # top's continual pane, from the live verdict
    assert "continual: trained gen 1" in out["port"][3]
    assert "registry lag 3 gen" in out["port"][3]
    assert ("data_staleness" in [r for r, _, _ in out["port"][0]])
    assert out["port"][2] == [
        'kubeml_data_lag_generations{jobid="ctstaleps"} 3',
        'kubeml_dataset_generation{jobid="ctstaleps"} 1']


def _get_text(url):
    import urllib.request
    return urllib.request.urlopen(url, timeout=30).read().decode()


def test_window_generations_slides_the_training_window(tmp_path, tmp_home):
    out = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / pkg)
        _blobs(reg)
        reg.append("blobs", *_split(128, seed=7))
        job = _job(pkg, reg, f"ctwin-{pkg}", epochs=1, warm=False,
                   window_generations=1)
        job.train()
        out[pkg] = (job._handle.train_samples, job._handle.train_offset,
                    job._handle.train_base)
    assert out["port"] == out["ref"] == (128, 256, 256)


CASES = {
    "window_negative": dict(continual=True, window_generations=-1),
    "publish_negative": dict(continual=True, publish_every_rounds=-1),
    "window_without_continual": dict(continual=False, window_generations=2),
    "publish_without_continual": dict(continual=False,
                                      publish_every_rounds=2),
    "publish_with_syncdp": dict(continual=True, publish_every_rounds=2,
                                engine="syncdp"),
    "publish_with_unknown_engine": dict(continual=True,
                                        publish_every_rounds=2,
                                        engine="sgd"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_continual_option_400s_equal_the_references(tmp_path, tmp_home,
                                                    case):
    """Misconfigured continual options 400 before any data loads, with
    the JAX job's message word for word."""
    msgs = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / pkg)
        _blobs(reg)
        job = _job(pkg, reg, f"ctbad-{pkg}", epochs=2, warm=False,
                   **dict(CASES[case]))
        with pytest.raises(Exception) as ei:
            job.train()
        msgs[pkg] = (ei.value.status_code, ei.value.message)
        assert job.task.state == "failed"
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"][0] == 400


def _restart_run(tmp_path, tag, interrupt):
    """create -> train gen 1 -> append gen 2 -> train gen 2, with a
    preempt event at epoch 1 round 3 when ``interrupt``."""
    from kubeml_tpu_torch.api.errors import JobPreemptedError
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint

    reg = _registry("port", tmp_path / f"reg-{tag}")
    _blobs(reg)
    job_id = f"ctres{tag}"
    opts = dict(checkpoint_every_rounds=2)
    if interrupt:
        opts["fault_plan"] = json.dumps(
            [{"kind": "preempt", "epoch": 1, "round": 3}])

    def publish(m):
        if reg.get("blobs").generation == 1:
            reg.append("blobs", *_split(64, seed=77))

    cb = _callbacks("port", publish)
    job = _job("port", reg, job_id, epochs=2, callbacks=cb, warm=False,
               **dict(opts))
    if not interrupt:
        job.train()
        return job_id
    with pytest.raises(JobPreemptedError):
        job.train()
    assert job.task.state == "preempted"
    _, manifest = load_checkpoint(job_id)
    ts = manifest["train_state"]
    assert (ts["epoch"], ts["round"]) == (1, 4)
    resumed = _job("port", reg, job_id, epochs=2, callbacks=cb, warm=False,
                   resume=True, **dict(opts))
    resumed.train()
    assert resumed.task.state == "finished"
    assert resumed._handle.generation == 2
    return job_id


def test_mid_window_restart_resumes_bit_identical(tmp_path, tmp_home):
    """A continual job preempted mid-window (after its window slid)
    resumes at its round cursor and ends with the weights of an
    uninterrupted run over the same generations, bit for bit."""
    clean = _weights(_restart_run(tmp_path, "a", interrupt=False))
    resumed = _weights(_restart_run(tmp_path, "b", interrupt=True))
    assert clean.keys() == resumed.keys()
    for k in clean:
        np.testing.assert_array_equal(clean[k], resumed[k])


def test_publish_every_rounds_saves_mid_epoch(tmp_path, tmp_home):
    """publish_every_rounds saves the round cursor on its own cadence, the
    reference's rounds (2/4/6/8 of 8), one round per dispatch even when
    more are asked for."""
    out = {}
    for pkg in PKGS:
        reg = _registry(pkg, tmp_path / pkg)
        _blobs(reg)
        saves = []
        job = _job(pkg, reg, f"ctpub-{pkg}", epochs=1, warm=False,
                   publish_every_rounds=2, rounds_per_dispatch=4)
        real_save = job._checkpointer.save

        def spy(job_id, variables, manifest, *rest, saves=saves,
                real_save=real_save):
            saves.append(manifest.get("train_state", {}).get("round"))
            return real_save(job_id, variables, manifest, *rest)

        job._checkpointer.save = spy
        job.train()
        out[pkg] = [r for r in saves if r is not None]
    assert out["port"] == out["ref"] == [2, 4, 6, 8]


# --------------------------------------------------- the job-server child

def _await(pred, what, timeout=180.0):
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        tick.wait(0.05)


def test_a_continual_child_is_preempted_mid_window_and_resumes(tmp_path,
                                                               tmp_home):
    """A continual job in a job-server child, over a window of its
    dataset's newest generation (1024 samples in docs of 64: 8 rounds an
    epoch at N=2, B=16), is preempted at epoch 1 round 3 (a
    ``preempt`` event: drain, cursor, /preempted), restarted by the PS
    and resumed at its cursor: preemptions 1, and the weights of an
    uninterrupted in-process job bit for bit."""
    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import TrainJob

    def request(**opts):
        return TrainRequest(
            model_type="mlp", batch_size=16, epochs=2, dataset="blobs",
            lr=0.1, options=TrainOptions(
                default_parallelism=2, k=1, static_parallelism=True,
                goal_accuracy=200.0, continual=True, window_generations=1,
                checkpoint_every_rounds=2, **opts))

    dep = start_deployment(device="cpu", standalone_jobs=True)
    try:
        client = KubemlClient(dep.controller_url).v1()
        paths = []
        for name, arr in zip(("xtr", "ytr", "xte", "yte", "xa", "ya"),
                             (*_split(64, 0), *_split(64, 1),
                              *_split(1024, 7))):
            paths.append(str(tmp_path / f"{name}.npy"))
            np.save(paths[-1], arr)
        client.datasets().create("blobs", *paths[:4])
        client.datasets().append("blobs", *paths[4:])
        job_id = client.networks().train(request(fault_plan=json.dumps(
            [{"kind": "preempt", "epoch": 1, "round": 3}])))
        _await(lambda: any(h.id == job_id
                           for h in client.histories().list()),
               "the job's end")
        assert dep.ps.wait_for_job(job_id, timeout=60)
        assert dep.ps.errors == {}
        tick = threading.Event()
        deadline = time.monotonic() + 60
        hist = client.histories().get(job_id).data
        while hist.preemptions != 1 and time.monotonic() < deadline:
            tick.wait(0.05)
            hist = client.histories().get(job_id).data
        assert (hist.restarts, hist.preemptions) == (0, 1)
        assert len(hist.train_loss) == 2
        TrainJob(TrainTask(job_id="direct", parameters=request(),
                           parallelism=2),
                 get_model("mlp")(), KubeDataset("blobs"),
                 device="cpu").train()
        have, want = _weights(job_id), _weights("direct")
        for k in want:
            np.testing.assert_array_equal(have[k], want[k])
    finally:
        dep.stop()


# ----------------------------------------------------------------- serving

def test_a_continual_jobs_publishes_hot_swap_a_cpu_fleet(tmp_home):
    """A continual gpt-nano job publishes every 2 rounds; after each epoch
    the PS's fleet for the job (built on the first publish) installs the
    newest stamp: one weight generation per new stamp, the same engine
    object, and greedy tokens equal to a direct DecodeEngine on the
    published weights."""
    import torch

    from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                            TrainTask)
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.control.ps import ParameterServer
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.models.gpt import GPTNano
    from kubeml_tpu_torch.serve.engine import DecodeEngine
    from kubeml_tpu_torch.serve.slots import GenerateRequest
    from kubeml_tpu_torch.train.checkpoint import (checkpoint_saved_at,
                                                   load_checkpoint)
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    start = rng.integers(1, 500, (320, 1))
    x = ((start + np.arange(16) - 1) % 511 + 1).astype(np.int32)
    reg = _registry("port")
    # docs of 16 windows: 4 rounds an epoch at N=2, 6 after the append
    reg.create("tokens", x[:128], np.zeros(128, np.int32), x[256:],
               np.zeros(64, np.int32), subset_size=16)

    class Windows(KubeDataset):
        def transform_train(self, data, labels):
            return {"x": np.asarray(data).astype(np.int32)}
        transform_test = transform_train

    ps = ParameterServer(device="cpu", port=0, serve_slots=2)
    ps.start()
    seen, stamps, jobs = [], [], []
    prompt = [11, 12, 13, 14, 15]

    def publish(m):
        jobs[0]._checkpointer.wait()    # the epoch's publishes are on disk
        stamp = checkpoint_saved_at("ctnano")
        fleet = ps._serve_service("ctnano")
        (_, engine), = fleet.engines()
        resp = http_json("POST", f"{ps.url}/generate", {
            "model_id": "ctnano", "prompt": prompt, "max_new_tokens": 6,
            "stream": False})
        seen.append((engine, engine.weight_generation,
                     m.dataset_generation, resp["tokens"]))
        stamps.append(stamp)
        if len(seen) == 1:
            reg.append("tokens", x[128:192], np.zeros(64, np.int32))

    req = TrainRequest(model_type="gpt-nano", batch_size=16, epochs=3,
                       dataset="tokens", lr=1e-3, function_name="gpt-nano",
                       options=TrainOptions(
                           default_parallelism=2, k=2,
                           static_parallelism=True, goal_accuracy=200.0,
                           validate_every=0, continual=True,
                           publish_every_rounds=2))
    try:
        jobs.append(TrainJob(
            TrainTask(job_id="ctnano", parameters=req, parallelism=2),
            GPTNano(dtype=torch.float32), Windows("tokens"), device="cpu",
            callbacks=JobCallbacks(publish_metrics=publish)))
        jobs[0].train()
        engines = {id(e) for e, _, _, _ in seen}
        assert len(engines) == 1                # installed, not rebuilt
        gens = [g for _, g, _, _ in seen]
        assert gens == list(range(1, len(set(stamps)) + 1))
        assert len(set(stamps)) == len(stamps) == 3
        assert [d for _, _, d, _ in seen] == [1, 2, 2]
        # the last generation's tokens are a direct engine's on the
        # weights it published
        tree, _ = load_checkpoint("ctnano")
        module = GPTNano().module_from_flax(tree, device="cpu")
        module.eval()
        engine = DecodeEngine(module, slots=2, device="cpu")
        r = GenerateRequest(list(prompt), max_new_tokens=6)
        engine.attach(r)
        while engine.active():
            engine.step()
        assert r.tokens == seen[-1][3]
    finally:
        ps.stop()


# --------------------------------------------------------------------- CLI

BAD_TRAIN = [
    ["-e", "0"],
    ["-e", "2", "--window-generations", "2"],
    ["-e", "2", "--publish-every-rounds", "4"],
    ["-e", "2", "--continual", "--window-generations", "-1"],
    ["-e", "2", "--continual", "--publish-every-rounds", "-1"],
    ["-e", "0", "--continual", "--publish-every-rounds", "4",
     "--engine", "syncdp"],
]


@pytest.mark.parametrize("extra", BAD_TRAIN,
                         ids=[" ".join(a) for a in BAD_TRAIN])
def test_cli_train_continual_flags_fail_as_the_references(tmp_home, capsys,
                                                          extra):
    """The CLI gate: -e 0 needs --continual, the knobs need --continual,
    --publish-every-rounds needs the kavg engine: exit 1 before any
    network call, with the JAX CLI's message."""
    from kubeml_tpu.cli.main import build_parser as ref_parser
    from kubeml_tpu.cli.main import cmd_train as ref_train
    from kubeml_tpu_torch.cli.main import build_parser, cmd_train

    base = ["--controller", "http://127.0.0.1:1", "train", "-f", "m",
            "-d", "ds", "--lr", "0.1"]
    errs = []
    for parser, train in ((ref_parser, ref_train), (build_parser,
                                                     cmd_train)):
        with pytest.raises(SystemExit) as ei:
            train(parser().parse_args(base + extra))
        assert ei.value.code == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and errs[1].startswith("error: ")


def test_cli_dataset_append_parses_as_the_references():
    from kubeml_tpu.cli.main import build_parser as ref_parser
    from kubeml_tpu_torch.cli.main import build_parser, cmd_dataset_append

    argv = ["dataset", "append", "-n", "blobs", "--traindata", "x.npy",
            "--trainlabels", "y.npy", "--generation", "5", "--retention",
            "3"]
    args = build_parser().parse_args(argv)
    assert args.fn is cmd_dataset_append
    assert (args.name, args.generation, args.retention) == ("blobs", 5, 3)
    ref = vars(ref_parser().parse_args(argv))
    got = vars(args)
    assert got.pop("fn").__name__ == ref.pop("fn").__name__
    assert got == ref


@pytest.mark.parametrize("latest", [
    {"train_loss": 0.5, "dataset_generation": 4, "data_lag_generations": 1,
     "serve_weight_generation": 3},
    {"train_loss": 0.5, "dataset_generation": 2, "data_lag_generations": 0},
    {"train_loss": 0.5},
    {"train_loss": 0.5, "data_lag_generations": -1},
], ids=["served", "trained", "absent", "one_shot"])
def test_top_renders_the_continual_pane_as_the_reference(latest):
    from kubeml_tpu.cli.main import _render_top as ref_render
    from kubeml_tpu_torch.cli.main import _render_top

    doc = {"id": "job1", "state": "healthy", "reasons": [],
           "latest": latest}
    out = _render_top(doc)
    assert out == ref_render(doc)
    assert ("continual: trained gen" in out) == (
        latest.get("data_lag_generations", -1) >= 0)
    if "serve_weight_generation" in latest:
        assert "registry lag 1 gen" in out and "served gen 3" in out
