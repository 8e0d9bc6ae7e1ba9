"""Port parity: standalone jobs — the PS spawns one
``python -m kubeml_tpu_torch.train.jobserver`` child per job and speaks
the per-job REST surface to it (twin of tests/test_standalone_jobs.py).

A standalone job run as a ``--device cpu`` child must give the history a
threaded job gives for the same task and seed (the parallelism exactly,
the losses and accuracy within 1e-6 relative: the two processes may run
the CPU matmuls on different thread counts), and the parent must never
resolve a device in standalone mode — on the card, the children own it.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blob_arrays(n_train=600, n_test=120, dim=8, classes=3):
    """The JAX package's control-plane task (tests/test_control_plane.py)."""
    rng = np.random.RandomState(0)

    def split(n):
        y = rng.randint(0, classes, n).astype(np.int32)
        x = rng.randn(n, dim).astype(np.float32) * 1.5
        x[np.arange(n), y * 2] += 3.0
        return x, y
    return [a for s in (split(n_train), split(n_test)) for a in s]


def _write(tmp, arrays):
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"), arrays):
        paths.append(os.path.join(tmp, f"{name}.npy"))
        np.save(paths[-1], arr)
    return paths


def _wait_history(client, job_id, ps, timeout=240):
    """The job's history; a job that finishes without one fails here."""
    from kubeml_tpu_torch.api.errors import KubeMLException

    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            return client.histories().get(job_id)
        except KubeMLException as e:
            if e.status_code != 404:
                raise
        if not ps.wait_for_job(job_id, timeout=0) or \
                job_id not in ps.errors:
            time.sleep(0.1)
            continue
        raise AssertionError(ps.errors[job_id])
    raise TimeoutError(f"no history for {job_id}")


def _req(epochs=3, static=False, **opts):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return TrainRequest(model_type="mlp", batch_size=32, epochs=epochs,
                        dataset="blobs", lr=0.1,
                        options=TrainOptions(default_parallelism=2,
                                             static_parallelism=static, k=2,
                                             **opts))


@pytest.fixture()
def blobs_files(tmp_path, monkeypatch):
    # its own KUBEML_TPU_HOME (the card's run has no conftest); a loaded
    # CI host can push a child's torch import past the default timeout;
    # one intra-op thread per child: the tiny mlp gains nothing from more,
    # and beside other test workers more threads oversubscribe the cores
    monkeypatch.setenv("KUBEML_TPU_HOME", str(tmp_path / "kubeml_home"))
    monkeypatch.setenv("KUBEML_JOB_START_TIMEOUT", "300")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return _write(str(tmp_path), _blob_arrays())


def _run(client, dep, req):
    job_id = client.networks().train(req)
    hist = _wait_history(client, job_id, dep.ps, timeout=240)
    assert dep.ps.wait_for_job(job_id, timeout=60)
    return job_id, hist


def test_standalone_child_equals_threaded_job(blobs_files, monkeypatch):
    from kubeml_tpu_torch.control import ps as ps_mod
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.train import job as job_mod
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint

    resolved = []
    for mod in (ps_mod, job_mod):
        real = mod.resolve_device
        monkeypatch.setattr(mod, "resolve_device",
                            lambda d=None, real=real:
                            resolved.append(d) or real(d))
    out = {}
    for mode in ("standalone", "threaded"):
        dep = start_deployment(device="cpu",
                               standalone_jobs=mode == "standalone")
        try:
            c = KubemlClient(dep.controller_url).v1()
            if mode == "standalone":
                c.datasets().create("blobs", *blobs_files)
            job_id = c.networks().train(_req())
            if mode == "standalone":
                # the job runs as a child process, not a thread
                deadline = time.time() + 120
                while time.time() < deadline:
                    with dep.ps._jobs_lock:
                        rec = dep.ps.jobs.get(job_id)
                    if rec is None or rec.url is not None:
                        break
                    time.sleep(0.05)
                assert rec is None or (rec.proc is not None
                                       and rec.job is None)
            hist = _wait_history(c, job_id, dep.ps, timeout=240)
            assert dep.ps.wait_for_job(job_id, timeout=60)
            if mode == "standalone":
                # the parent resolved no device: the child owns it
                assert resolved == []
                assert f'jobid="{job_id}"' not in \
                    dep.ps.metrics.exposition()
            out[mode] = (hist.data, load_checkpoint(job_id)[0])
        finally:
            dep.stop()
    (a, wa), (b, wb) = out["standalone"], out["threaded"]
    assert a.parallelism == b.parallelism == [2, 3, 4]
    for field in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(getattr(a, field), getattr(b, field),
                                   rtol=1e-6, err_msg=field)
    for layer in wa["params"]:
        for leaf in wa["params"][layer]:
            np.testing.assert_allclose(wa["params"][layer][leaf],
                                       wb["params"][layer][leaf],
                                       rtol=1e-6, atol=1e-7)


def test_crashed_child_restarts_from_its_checkpoint(blobs_files):
    """A child killed mid-job restarts from its own checkpoint (history,
    epoch and parallelism restored) and the history counts the restart."""
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.train.checkpoint import checkpoint_saved_at

    dep = start_deployment(device="cpu", standalone_jobs=True)
    try:
        c = KubemlClient(dep.controller_url).v1()
        c.datasets().create("blobs", *blobs_files)
        job_id = c.networks().train(_req(epochs=12, static=True,
                                         max_restarts=1))
        deadline = time.time() + 120
        while checkpoint_saved_at(job_id) is None and \
                time.time() < deadline:
            time.sleep(0.02)
        with dep.ps._jobs_lock:
            rec = dep.ps.jobs.get(job_id)
        assert rec is not None, "the job ended before the test killed it"
        first = rec.proc
        first.kill()
        _wait_history(c, job_id, dep.ps, timeout=240)
        assert dep.ps.wait_for_job(job_id, timeout=60)
        # read again once the PS has stamped the restarts at the finish
        hist = c.histories().get(job_id)
        assert hist.data.restarts == 1
        assert len(hist.data.train_loss) == 12
        assert hist.data.parallelism == [2] * 12
        assert rec.proc is not first
        assert dep.ps.metrics.restarts_total.value("standalone") == 1.0
    finally:
        dep.stop()


def test_partitions_lease_one_child_each(blobs_files):
    """With one partition, a second job is turned away with 503 (the
    scheduler's backoff keeps it) until the first child is gone."""
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.control.ps import ParameterServer
    from kubeml_tpu_torch.data.ingest import ingest_files

    ingest_files("blobs", *blobs_files)
    ps = ParameterServer(device="cpu", standalone_jobs=True,
                         job_partitions=[{"KUBEML_TEST_SLOT": "0"}])
    ps.start()
    try:
        ps.start_task(TrainTask(job_id="first", parameters=_req(
            epochs=1, static=True), parallelism=2))
        assert ps._busy_partitions == {0}
        with pytest.raises(KubeMLException) as ei:
            ps.start_task(TrainTask(job_id="second", parameters=_req(
                epochs=1, static=True), parallelism=2))
        assert ei.value.status_code == 503
        assert "second" not in ps.jobs
        assert ps.wait_for_job("first", timeout=120)
        assert ps.history_store.get("first").data.parallelism == [2]
        deadline = time.time() + 30
        while ps._busy_partitions and time.time() < deadline:
            time.sleep(0.05)
        assert ps._busy_partitions == set()
    finally:
        ps.stop()


class _FakePS:
    """A recording PS/scheduler for a JobServer driven in-process."""

    def __init__(self):
        from kubeml_tpu_torch.control.httpd import JsonService

        self.seen = []
        self.finished = threading.Event()
        self.svc = JsonService()
        for path in ("/metrics/{jobId}", "/heartbeat/{jobId}"):
            self.svc.route("POST", path, self._record(path))
        self.svc.route("POST", "/finish/{jobId}", self._finish)
        self.svc.start()

    def _record(self, path):
        def handler(req):
            self.seen.append((path, req.body))
            return {"ok": True}
        return handler

    def _finish(self, req):
        self.seen.append(("/finish/{jobId}", req.body))
        self.finished.set()
        return {"ok": True}


def test_jobserver_routes_and_callbacks(blobs_files, monkeypatch):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.data.ingest import ingest_files
    from kubeml_tpu_torch.train.jobserver import JobServer

    ingest_files("blobs", *blobs_files)
    monkeypatch.setenv("KUBEML_HEARTBEAT_INTERVAL", "0.02")
    ps = _FakePS()
    server = JobServer("job1", ps_url=ps.svc.url, device="cpu")
    server.start()
    try:
        with pytest.raises(KubeMLException) as ei:
            http_json("DELETE", f"{server.url}/stop")
        assert ei.value.status_code == 400
        task = TrainTask(job_id="other", parameters=_req(epochs=500,
                                                         static=True))
        with pytest.raises(KubeMLException) as ei:
            http_json("POST", f"{server.url}/start", task.to_dict())
        assert ei.value.status_code == 400
        task.job_id = "job1"
        assert http_json("POST", f"{server.url}/start",
                         task.to_dict()) == {"job_id": "job1"}
        with pytest.raises(KubeMLException) as ei:
            http_json("POST", f"{server.url}/start", task.to_dict())
        assert ei.value.status_code == 400
        deadline = time.time() + 60
        while not any(p.startswith("/heartbeat") for p, _ in ps.seen) \
                and time.time() < deadline:
            time.sleep(0.01)
        assert http_json("DELETE", f"{server.url}/stop") == {"ok": True}
        assert ps.finished.wait(60)
        assert server.finished.wait(10) and server.exit_error is None
    finally:
        server.stop()
        ps.svc.stop()
    # a heartbeat may land after the finish (its loop stops on the
    # job's end), nothing else does
    calls = [(p, b) for p, b in ps.seen if p != "/heartbeat/{jobId}"]
    assert calls[-1] == ("/finish/{jobId}", {"error": None})
    epochs = [b for p, b in ps.seen if p == "/metrics/{jobId}"]
    assert 1 <= len(epochs) < 500
    assert all(b["job_id"] == "job1" and b["parallelism"] == 2
               for b in epochs)
    beats = [b for p, b in ps.seen if p == "/heartbeat/{jobId}"]
    assert beats and all(set(b) == {"epoch", "round"} for b in beats)


def test_callback_retry_schedule_is_the_references(monkeypatch):
    """Bounded, jittered backoff seeded from the job id: the same delays
    as the JAX package's job server for the same job id."""
    from kubeml_tpu.train import jobserver as ref
    from kubeml_tpu_torch.control.httpd import JsonService
    from kubeml_tpu_torch.train import jobserver as port

    dead = JsonService()
    dead.start()
    url = dead.url
    dead.stop()
    delays = {}
    for key, mod in (("ref", ref), ("port", port)):
        got = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        server = mod.JobServer("a1b2c3d4", ps_url=url)
        assert not server._post_with_retry("finish", f"{url}/finish/x", {})
        assert not server._post_with_retry("beat", f"{url}/heartbeat/x",
                                           {}, attempts=3, max_delay=0.5)
        delays[key] = got
    assert delays["port"] == delays["ref"] and len(delays["port"]) == 6


def test_jobserver_without_device_needs_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is present; its twin below runs there")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "kubeml_tpu_torch.train.jobserver",
         "--job-id", "j", "--port-file", str(tmp_path / "port")],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not (tmp_path / "port").exists()   # never bound its port


@pytest.mark.gpu
def test_standalone_child_trains_on_the_card(blobs_files, monkeypatch):
    """Without --device the child runs its job on CUDA; the parent
    resolves no device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    from kubeml_tpu_torch.control import ps as ps_mod
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment

    resolved = []
    monkeypatch.setattr(ps_mod, "resolve_device",
                        lambda d=None: resolved.append(d))
    dep = start_deployment(standalone_jobs=True)
    try:
        c = KubemlClient(dep.controller_url).v1()
        c.datasets().create("blobs", *blobs_files)
        _, hist = _run(c, dep, _req(epochs=2))
        assert hist.data.parallelism == [2, 3]
        assert resolved == []
    finally:
        dep.stop()
