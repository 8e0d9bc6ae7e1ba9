"""Port parity: kubeml_tpu_torch's training control plane (client ->
controller -> scheduler -> PS -> TrainJob) against the JAX package's,
all over real HTTP on localhost.

One deployment of each package shares one KUBEML_TPU_HOME (each reads
the other's datasets, checkpoints and histories). Both run the same mlp
job on the blobs task through their own client, warm-started from one
checkpoint the JAX package wrote; the JAX deployment trains on a
one-device mesh, the port's with device="cpu", so both see W = N.

Tolerances: the history's parallelism (the scheduler's real throughput
policy) is equal; train loss, validation loss and accuracy agree within
1e-5 relative; /infer predictions are equal (argmax classes). Status
codes of bad requests, wire dicts and the grants of a scripted policy are
equal exactly.
"""

import os
import time
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

JOB = dict(model_type="mlp", batch_size=32, epochs=3, dataset="blobs",
           lr=0.1, resume_from="seedckpt")
OPTS = dict(default_parallelism=2, static_parallelism=False, k=2)


def _blob_arrays(n_train=600, n_test=120, dim=8, classes=3):
    """The JAX package's control-plane task (tests/test_control_plane.py)."""
    rng = np.random.RandomState(0)

    def split(n):
        y = rng.randint(0, classes, n).astype(np.int32)
        x = rng.randn(n, dim).astype(np.float32) * 1.5
        x[np.arange(n), y * 2] += 3.0
        return x, y
    return [a for s in (split(n_train), split(n_test)) for a in s]


def _write(tmp, prefix, arrays):
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        p = os.path.join(tmp, f"{prefix}{name}.npy")
        np.save(p, arr)
        paths.append(p)
    return paths


def _wait_history(client, job_id, ps, timeout=120):
    """The job's history (through either package's client); a job that
    finished without one fails here."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            return client.histories().get(job_id)
        except Exception as e:  # either package's KubeMLException
            if getattr(e, "status_code", None) != 404:
                raise
            with ps._jobs_lock:
                running = job_id in ps.jobs
            if not running and time.time() > deadline - timeout + 5:
                err = getattr(ps, "errors", {}).get(job_id)
                assert err is None, err
            time.sleep(0.1)
    raise TimeoutError(f"no history for {job_id}")


def _seed_checkpoint():
    """A JAX-initialised mlp (the PS builds the default: hidden 32, 10
    classes) saved by the JAX package."""
    import jax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.train.checkpoint import save_checkpoint

    variables = get_builtin("mlp")().init_variables(
        jax.random.PRNGKey(0), {"x": np.zeros((32, 8), np.float32)})
    save_checkpoint("seedckpt", jax.tree_util.tree_map(np.asarray, variables),
                    {"model": "mlp", "function": "mlp"})


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """Both deployments, the blobs dataset, and the same job run through
    each package's client: {"ref"|"port": (deployment, client, job_id,
    History)} plus the test arrays."""
    from kubeml_tpu.control.client import KubemlClient as RefClient
    from kubeml_tpu.control.deployment import start_deployment as ref_start
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu_torch.api import types
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    tmp = str(tmp_path_factory.mktemp("plane"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEML_TPU_HOME", os.path.join(tmp, "home"))
        _seed_checkpoint()
        arrays = _blob_arrays()
        deps = {"ref": ref_start(mesh=make_mesh(n_data=1)),
                "port": start_deployment(device="cpu")}
        clients = {"ref": RefClient(deps["ref"].controller_url).v1(),
                   "port": KubemlClient(deps["port"].controller_url).v1()}
        try:
            clients["port"].datasets().create("blobs",
                                              *_write(tmp, "", arrays))
            out = {"arrays": arrays, "tmp": tmp}
            for key in ("ref", "port"):
                if key == "ref":
                    from kubeml_tpu.api import types as t
                else:
                    t = types
                req = t.TrainRequest(**JOB, options=t.TrainOptions(**OPTS))
                job_id = clients[key].networks().train(req)
                hist = _wait_history(clients[key], job_id, deps[key].ps)
                assert deps[key].ps.wait_for_job(job_id, timeout=60)
                out[key] = (deps[key], clients[key], job_id, hist)
            yield out
        finally:
            for dep in deps.values():
                dep.stop()


def test_same_job_same_history(plane):
    ref, port = plane["ref"][3].data, plane["port"][3].data
    assert port.parallelism == ref.parallelism == [2, 3, 4]
    for field in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(getattr(port, field), getattr(ref, field),
                                   rtol=1e-5, atol=0, err_msg=field)
    assert plane["port"][3].task.to_dict() == plane["ref"][3].task.to_dict()


def test_same_job_same_predictions(plane):
    x = plane["arrays"][2][:20].tolist()
    preds = {key: plane[key][1].networks().infer(plane[key][2], x)
             for key in ("ref", "port")}
    assert len(preds["port"]) == 20
    np.testing.assert_allclose(preds["port"], preds["ref"], atol=1e-5)
    # the port's LRU serves the second call without reading the weights
    ps = plane["port"][0].ps
    hits = ps.metrics.infer_cache_hits_total.value("checkpoints")
    assert plane["port"][1].networks().infer(plane["port"][2], x) == \
        preds["port"]
    assert ps.metrics.infer_cache_hits_total.value("checkpoints") == hits + 1


def test_histories_round_trip_through_both_packages(plane):
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu_torch.api import types as port_types

    for key in ("ref", "port"):
        d = plane[key][3].to_dict()
        assert ref_types.History.from_dict(d).to_dict() == d
        assert port_types.History.from_dict(d).to_dict() == d
    # each controller lists both packages' records from the shared store
    ids = {h.id for h in plane["port"][1].histories().list()}
    assert {plane["ref"][2], plane["port"][2]} <= ids


def test_task_list_empty_after_completion(plane):
    for key in ("ref", "port"):
        assert plane[key][1].tasks().list() == []


@pytest.mark.parametrize("client_pkg", ["ref", "port"])
def test_clients_drive_the_other_package(plane, client_pkg):
    """The port's client against the JAX deployment and the JAX client
    against the port's: listing, history, inference, tasks."""
    from kubeml_tpu.control.client import KubemlClient as RefClient
    from kubeml_tpu_torch.control.client import KubemlClient

    server = "port" if client_pkg == "ref" else "ref"
    Client = RefClient if client_pkg == "ref" else KubemlClient
    c = Client(plane[server][0].controller_url).v1()
    assert [d.name for d in c.datasets().list()] == ["blobs"]
    assert c.datasets().get("blobs").train_set_size == 600
    h = c.histories().get(plane[server][2])
    assert h.data.parallelism == [2, 3, 4]
    x = plane["arrays"][2][:4].tolist()
    assert c.networks().infer(plane[server][2], x) == \
        plane[server][1].networks().infer(plane[server][2], x)
    assert c.tasks().list() == []


def test_reference_client_trains_on_the_port(plane):
    """A JAX-package client uploads (its own multipart body) and submits
    to the port's deployment."""
    from kubeml_tpu.api.types import TrainOptions, TrainRequest
    from kubeml_tpu.control.client import KubemlClient as RefClient

    dep = plane["port"][0]
    c = RefClient(dep.controller_url).v1()
    arrays = _blob_arrays(n_train=200, n_test=40)
    s = c.datasets().create("blobs-small",
                            *_write(plane["tmp"], "s", arrays))
    assert (s.train_set_size, s.test_set_size) == (200, 40)
    job_id = c.networks().train(TrainRequest(
        model_type="mlp", batch_size=32, epochs=1, dataset="blobs-small",
        lr=0.1, options=TrainOptions(default_parallelism=2,
                                     static_parallelism=True, k=2)))
    hist = _wait_history(plane["port"][1], job_id, dep.ps)
    assert hist.data.parallelism == [2]
    c.datasets().delete("blobs-small")
    assert "blobs-small" not in [d.name for d in c.datasets().list()]


BAD_REQUESTS = [
    ("POST", "/infer", {"model_id": "nonexist1", "data": [[1.0]]}),
    ("GET", "/history/nonexist1", None),
    ("DELETE", "/dataset/nonexist1", None),
    ("GET", "/dataset/nonexist1", None),
    ("DELETE", "/history/nonexist1", None),
    ("DELETE", "/tasks/nonexist1", None),
    ("GET", "/functions/nonexist1", None),
    ("DELETE", "/functions/nonexist1", None),
    ("POST", "/train", {"not": "a request"}),
    ("POST", "/infer", {"data": [[1.0]]}),
    ("POST", "/infer", {"model_id": "seedckpt"}),
    ("POST", "/infer", {"model_id": "seedckpt", "data": [[1.0], [1.0, 2.0]]}),
    ("POST", "/dataset/blobs", {"not": "multipart"}),
    ("GET", "/dataset/bad..name", None),
    ("GET", "/no/such/route", None),
]


@pytest.mark.parametrize("method,path,body", BAD_REQUESTS,
                         ids=[f"{m} {p}" for m, p, _ in BAD_REQUESTS])
def test_bad_requests_give_equal_status(plane, method, path, body):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.control.httpd import http_json

    codes = {}
    for key in ("ref", "port"):
        with pytest.raises(KubeMLException) as ei:
            http_json(method, plane[key][0].controller_url + path, body)
        codes[key] = ei.value.status_code
    assert codes["port"] == codes["ref"], codes
    assert codes["port"] >= 400


def test_duplicate_upload_fails_alike(plane):
    paths = _write(plane["tmp"], "d", _blob_arrays(n_train=64, n_test=64))
    codes = []
    for key in ("ref", "port"):
        with pytest.raises(Exception) as ei:  # each package's exception
            plane[key][1].datasets().create("blobs", *paths)
        codes.append(ei.value.status_code)
    assert codes[0] == codes[1] == 500


REFUSED = [
    ("controller", "GET", "/trace/x", 501, "ROADMAP A.13"),
    ("controller", "GET", "/cost/x", 501, "ROADMAP A.13"),
    ("controller", "GET", "/health/x", 501, "ROADMAP A.15"),
    ("controller", "GET", "/cluster", 501, "ROADMAP A.16"),
    ("controller", "POST", "/dataset/blobs/append", 400, "continual mode"),
    ("storage", "POST", "/dataset/blobs/append", 400, "continual mode"),
    ("scheduler", "GET", "/cluster", 501, "ROADMAP A.16"),
    ("scheduler", "POST", "/serve/resize", 501, "ROADMAP A.16"),
    ("scheduler", "POST", "/requeue", 501, "ROADMAP A.17"),
    ("ps", "POST", "/generate", 501, "ROADMAP A.1"),
    ("ps", "GET", "/flight?id=serve:m", 501, "ROADMAP A.1"),
    ("ps", "GET", "/trace?id=x", 501, "ROADMAP A.13"),
    ("ps", "GET", "/cost?id=x", 501, "ROADMAP A.13"),
    ("ps", "GET", "/health?id=x", 501, "ROADMAP A.15"),
    ("ps", "POST", "/cluster", 501, "ROADMAP A.16"),
    ("ps", "POST", "/preempt/x", 501, "ROADMAP A.17"),
    ("ps", "POST", "/preempted/x", 501, "ROADMAP A.17"),
]


@pytest.mark.parametrize("svc,method,path,status,brings", REFUSED,
                         ids=[f"{s} {m} {p}" for s, m, p, _, _ in REFUSED])
def test_unported_routes_are_refused_with_their_item(plane, svc, method,
                                                     path, status, brings):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.control.httpd import http_json

    url = getattr(plane["port"][0], svc).url + path
    with pytest.raises(KubeMLException) as ei:
        http_json(method, url, {})
    assert ei.value.status_code == status
    assert "is not ported yet to kubeml_tpu_torch" in ei.value.message
    assert brings in ei.value.message
    # liveness keeps answering
    assert http_json("GET", getattr(plane["port"][0], svc).url
                     + "/health") == {"ok": True}


def test_scheduler_grants_equal_under_a_scripted_policy():
    """Both schedulers, driven by one scripted policy, send the same
    /start and /update grants to a recording PS, in the same order."""
    from kubeml_tpu.control.scheduler import Scheduler as RefScheduler
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.control.httpd import JsonService, http_json
    from kubeml_tpu_torch.control.scheduler import Scheduler

    script = [(3, True), (5, False), (1, False), (4, False)]

    class Scripted:
        def __init__(self):
            self.calls = iter(script)

        def calculate_parallelism(self, task):
            return next(self.calls)

        def task_finished(self, job_id):
            pass

    grants = {}
    for key, cls in (("ref", RefScheduler), ("port", Scheduler)):
        seen = []
        ps = JsonService()
        ps.route("POST", "/start", lambda req, seen=seen: seen.append(
            ("start", req.body["parallelism"])) or {})
        ps.route("POST", "/update/{jobId}", lambda req, seen=seen:
                 seen.append(("update", req.body["parallelism"])) or {})
        ps.start()
        sched = cls(ps_url=ps.url, policy=Scripted())
        sched.start()
        try:
            req = TrainRequest(model_type="mlp", batch_size=8, epochs=4,
                               dataset="d", lr=0.1, options=TrainOptions())
            job_id = http_json("POST", f"{sched.url}/train",
                               req.to_dict())["id"]
            assert len(job_id) == 8
            from kubeml_tpu_torch.api.types import TrainTask
            for _ in script[1:]:
                n = len(seen)
                http_json("POST", f"{sched.url}/job", TrainTask(
                    job_id=job_id, parameters=req).to_dict())
                deadline = time.time() + 10
                while len(seen) == n and time.time() < deadline:
                    time.sleep(0.01)
            http_json("DELETE", f"{sched.url}/finish/{job_id}")
        finally:
            sched.stop()
            ps.stop()
        grants[key] = seen
    assert grants["port"] == grants["ref"] == [
        ("start", 3), ("update", 5), ("update", 1), ("update", 4)]


def test_scheduler_defers_a_task_the_ps_turns_away():
    """A 503 from the PS (every partition leased) parks the task with the
    capped, jittered backoff; it starts once the PS has room."""
    import random

    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.api.types import TrainRequest
    from kubeml_tpu_torch.control.httpd import JsonService, http_json
    from kubeml_tpu_torch.control.scheduler import Scheduler

    starts = []

    def start(req):
        starts.append(time.monotonic())
        if len(starts) < 3:
            raise KubeMLException("all device partitions are leased", 503)
        return {}

    ps = JsonService()
    ps.route("POST", "/start", start)
    ps.start()
    sched = Scheduler(ps_url=ps.url, rng=random.Random(0))
    sched.start()
    try:
        http_json("POST", f"{sched.url}/train", TrainRequest(
            model_type="mlp", batch_size=8, epochs=1, dataset="d",
            lr=0.1).to_dict())
        deadline = time.time() + 10
        while len(starts) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert len(starts) == 3
        gaps = np.diff(starts)
        # at least 0.25 s then 0.5 s less 25 % jitter (the loop re-admits
        # on its 0.5 s queue poll)
        assert gaps[0] > 0.18 and gaps[1] > 0.37, gaps
    finally:
        sched.stop()
        ps.stop()
    # the backoff schedule is the JAX package's, jitter from one seed
    from kubeml_tpu.control.scheduler import Scheduler as RefScheduler

    delays = [[s._defer_delay(n) for n in range(8)]
              for s in (Scheduler(rng=random.Random(7)),
                        RefScheduler(rng=random.Random(7)))]
    assert delays[0] == delays[1] and max(delays[0]) <= 5.0 * 1.25


def test_metrics_show_the_job_then_clear(plane):
    """/metrics carries a running job's families and drops them at its
    finish (ml/pkg/ps/metrics.go:90-106); a stop through the controller
    ends a long job early."""
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    dep, client = plane["port"][0], plane["port"][1]
    job_id = client.networks().train(TrainRequest(
        model_type="mlp", batch_size=16, epochs=500, dataset="blobs",
        lr=0.01, options=TrainOptions(default_parallelism=2,
                                      static_parallelism=True, k=1)))
    series = f'kubeml_job_train_loss{{jobid="{job_id}"}}'
    seen = False
    for _ in range(300):
        text = urllib.request.urlopen(dep.ps.url + "/metrics").read().decode()
        if series in text:
            seen = True
            break
        time.sleep(0.05)
    assert seen, "per-job gauges never appeared on /metrics"
    assert any(t.job_id == job_id for t in client.tasks().list())
    client.tasks().stop(job_id)
    hist = _wait_history(client, job_id, dep.ps)
    assert len(hist.data.train_loss) < 500
    assert dep.ps.wait_for_job(job_id, timeout=30)
    text = urllib.request.urlopen(dep.ps.url + "/metrics").read().decode()
    assert f'jobid="{job_id}"' not in text
    assert 'kubeml_job_running_total{type="train"} 0.0' in text


def test_concurrent_infer_scatters_each_request_its_rows(plane):
    """More concurrent /infer callers than cores, with a short switch
    interval: the micro-batcher stacks them into shared calls and each
    caller must get exactly its own rows' predictions back."""
    import sys
    import threading

    dep, client, job_id, _ = plane["port"]
    x = plane["arrays"][2]
    want = client.networks().infer(job_id, x[:60].tolist())
    out, errors = {}, []

    def call(i):
        try:
            lo, n = (7 * i) % 50, 1 + i % 9
            out[i] = (lo, n, client.networks().infer(
                job_id, x[lo:lo + n].tolist()))
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(min(64, 4 * (os.cpu_count() or 2)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(out) == len(threads)
    for lo, n, preds in out.values():
        assert preds == want[lo:lo + n]


def test_infer_cache_follows_a_new_checkpoint(plane):
    """A re-written checkpoint (newer saved_at) replaces the cached
    module: all-zero weights predict class 0 everywhere."""
    from kubeml_tpu_torch.train.checkpoint import (checkpoint_saved_at,
                                                   load_checkpoint,
                                                   save_checkpoint)

    dep, client, job_id, _ = plane["port"]
    x = plane["arrays"][2][:6].tolist()
    before = client.networks().infer(job_id, x)
    variables, manifest = load_checkpoint(job_id)
    zeroed = {"params": {k: {n: a * 0.0 for n, a in v.items()}
                         for k, v in variables["params"].items()}}
    save_checkpoint(job_id, zeroed, manifest)
    try:
        assert client.networks().infer(job_id, x) == [0] * 6
        assert dep.ps._infer_cache[job_id][0] == checkpoint_saved_at(job_id)
    finally:
        save_checkpoint(job_id, variables, manifest)
    assert client.networks().infer(job_id, x) == before


USER_FN = '''
import numpy as np
from kubeml_tpu_torch.models.base import KubeDataset
from kubeml_tpu_torch.models.mlp import MLP


class Scaled(KubeDataset):
    def transform_train(self, data, labels):
        return {"x": np.asarray(data) * 0.5, "y": np.asarray(labels)}

    transform_test = transform_train


class Small(MLP):
    def __init__(self):
        super().__init__(hidden=8, num_classes=3)
'''


def test_user_function_trains_through_the_registry(plane):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    dep, client = plane["port"][0], plane["port"][1]
    path = os.path.join(plane["tmp"], "small.py")
    with open(path, "w") as f:
        f.write(USER_FN)
    client.functions().create("small-mlp", path)
    assert {"name": "small-mlp", "kind": "user"} in client.functions().list()
    assert {"name": "resnet18", "kind": "builtin"} in \
        client.functions().list()
    with pytest.raises(KubeMLException) as ei:
        client.functions().create("small-mlp", path)
    assert ei.value.status_code == 400
    job_id = client.networks().train(TrainRequest(
        model_type="mlp", function_name="small-mlp", batch_size=32,
        epochs=2, dataset="blobs", lr=0.1,
        options=TrainOptions(default_parallelism=2, static_parallelism=True,
                             k=2)))
    hist = _wait_history(client, job_id, dep.ps)
    assert hist.data.train_loss[-1] < hist.data.train_loss[0]
    preds = client.networks().infer(job_id,
                                    plane["arrays"][2][:5].tolist())
    assert len(preds) == 5 and max(preds) < 3
    client.functions().delete("small-mlp")
    with pytest.raises(KubeMLException) as ei:
        client.functions().get("small-mlp")
    assert ei.value.status_code == 404


@pytest.mark.parametrize("knob,value,brings", [
    ("serve_slots", 4, "ROADMAP A.1"),
    ("serve_kv_dtype", "int8", "ROADMAP A.1"),
    ("cluster_lanes", 4, "ROADMAP A.16"),
    ("cluster_tenants", ["prod=2"], "ROADMAP A.16"),
    ("control_durable", True, "ROADMAP A.16"),
])
def test_unported_deployment_knobs_raise(knob, value, brings):
    from kubeml_tpu_torch.control.deployment import start_deployment

    with pytest.raises(ValueError, match=brings):
        start_deployment(device="cpu", **{knob: value})


def test_deployment_checks_its_arguments(tmp_home):
    import torch

    from kubeml_tpu_torch.control.deployment import start_deployment

    with pytest.raises(TypeError):
        start_deployment(device="cpu", mesh=None)
    with pytest.raises(ValueError, match="names card"):
        start_deployment(device="cpu",
                         job_partitions=[{"CUDA_VISIBLE_DEVICES": "0"}])
    with pytest.raises(ValueError, match="env dict"):
        start_deployment(device="cpu", job_partitions=["0"])
    dep = start_deployment(device="cpu", standalone_jobs=True,
                           job_partitions=[{}, {"OTHER": "1"}],
                           serve_prefix_cache=False)
    try:
        assert dep.ps.standalone_jobs and len(dep.ps.job_partitions) == 2
    finally:
        dep.stop()
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU deployment
        with pytest.raises(RuntimeError, match="CUDA"):
            start_deployment()


@pytest.mark.gpu
def test_deployment_trains_on_the_card(tmp_path, monkeypatch):
    """The default deployment runs its jobs and /infer on CUDA."""
    import torch

    monkeypatch.setenv("KUBEML_TPU_HOME", str(tmp_path / "kubeml_home"))
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    dep = start_deployment()
    try:
        c = KubemlClient(dep.controller_url).v1()
        arrays = _blob_arrays()
        c.datasets().create("blobs", *_write(str(tmp_path), "", arrays))
        job_id = c.networks().train(TrainRequest(
            model_type="mlp", batch_size=32, epochs=2, dataset="blobs",
            lr=0.1, options=TrainOptions(**OPTS)))
        hist = _wait_history(c, job_id, dep.ps)
        assert hist.data.parallelism == [2, 3]
        assert dep.ps.device.type == "cuda"
        assert len(c.networks().infer(job_id, arrays[2][:8].tolist())) == 8
    finally:
        dep.stop()
