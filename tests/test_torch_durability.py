"""Port parity: the durable control plane of kubeml_tpu_torch (the
scheduler's state file and recover(), the PS's manifests and recover(),
grant fencing, build_allocator, the jobserver's re-grant) against the JAX
package's, after the reference's tests/test_control_durability.py.

- given the same journal, state file and live-task list, the port's
  scheduler recover() adopts, requeues and re-parks exactly as the JAX
  scheduler's, whichever package wrote the files; a stale epoch on /job
  answers 409;
- a PS recover() re-adopts a live ``--device cpu`` jobserver child (never
  started a second time), drops a dead one, and notices the adopted
  child's death through its pid watchdog;
- the cluster and control Prometheus text, the control-flapping rule and
  ``kubeml top``'s control line equal the reference's;
- POST /cluster and POST /preempt on the PS; /preempt of an unknown
  training job is 404 in both packages;
- end to end: ``kubeml serve --role all --standalone-jobs --cluster-lanes
  4 --control-dir D`` on the CPU is killed with SIGKILL and started again
  on D: the live child is re-adopted under a bumped fencing epoch, the
  dead one requeued with its restart budget untouched, and the old epoch
  is refused with 409.

Every wait on a child process is bounded.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("port", "ref")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _pkg(pkg: str):
    """The package's modules this file drives, by short name."""
    import importlib

    root = "kubeml_tpu_torch" if pkg == "port" else "kubeml_tpu"
    names = ("api.errors", "api.types", "control.cluster",
             "control.journal", "control.scheduler", "control.ps",
             "control.httpd", "control.deployment", "metrics.prom",
             "train.jobserver")
    return types.SimpleNamespace(**{
        n.split(".")[-1]: importlib.import_module(f"{root}.{n}")
        for n in names})


def _task(pkg: str, job_id: str, restarts: int = 0):
    t = _pkg(pkg).types
    return t.TrainTask(
        job_id=job_id,
        parameters=t.TrainRequest(
            model_type="mlp", batch_size=16, epochs=1, dataset="blobs",
            lr=0.1, options=t.TrainOptions(default_parallelism=2)),
        restarts=restarts)


def _req(pkg: str, body: dict):
    return _pkg(pkg).httpd.Request("/job", {}, {}, body, b"")


def _write_prior_state(pkg: str, jdir: str, sdir: str):
    """The reference test's pre-crash control plane, written by `pkg`:
    two granted jobs, one parked, one queued."""
    m = _pkg(pkg)
    journal = m.journal.DecisionJournal(jdir)
    alloc = m.cluster.ClusterAllocator(4, clock=FakeClock(50.0),
                                       journal=journal)
    alloc.submit("aaaa0001", lanes=2)
    alloc.submit("bbbb0002", lanes=2)
    alloc.submit("cccc0003", lanes=4)         # parks: pool full
    sched = m.scheduler.Scheduler(ps_url=None, allocator=alloc,
                                  state_dir=sdir, rng=random.Random(7))
    sched._track(_task(pkg, "aaaa0001"), "granted", 2, 1)
    sched._track(_task(pkg, "bbbb0002", restarts=1), "granted", 2, 1)
    sched._track(_task(pkg, "cccc0003"), "parked")
    sched._track(_task(pkg, "dddd0004"), "queued")
    journal.close()


def _recover_scheduler(pkg: str, jdir: str, sdir: str):
    m = _pkg(pkg)
    alloc = m.cluster.ClusterAllocator.recover(
        m.journal.DecisionJournal(jdir), 4, clock=FakeClock(50.0))
    sched = m.scheduler.Scheduler(ps_url=None, allocator=alloc,
                                  state_dir=sdir, rng=random.Random(7))
    summary = sched.recover(ps_tasks=[{"job_id": "aaaa0001"}])
    queued = {}
    while len(sched.queue):
        t = sched.queue.pop(timeout=0)
        queued[t.job_id] = (t.restarts, t.grant_epoch, t.elapsed_time_s,
                            t.state)
    return sched, alloc, summary, queued


@pytest.mark.parametrize("writer", PKGS)
def test_scheduler_recovery_adopts_requeues_and_reparks_alike(
        tmp_path, tmp_home, writer):
    """The same state (written by either package) recovers alike: the
    surviving child is re-adopted at its width under epoch 2, the dead
    one requeued with its restart count and a reset epoch, the parked
    one re-parked, the queued one re-queued; /job with the pre-crash
    epoch answers 409 and the relayed epoch passes."""
    outs = {}
    for reader in PKGS:
        jdir = str(tmp_path / reader / "j")
        sdir = str(tmp_path / reader / "s")
        _write_prior_state(writer, jdir, sdir)
        sched, alloc, summary, queued = _recover_scheduler(reader, jdir,
                                                           sdir)
        assert summary.pop("recovery_s") >= 0.0
        with open(os.path.join(sdir, "scheduler.state.json")) as f:
            phases = {j: (e["phase"], e["lanes"], e["epoch"])
                      for j, e in json.load(f)["tasks"].items()}
        task_a = _task(reader, "aaaa0001")
        task_a.grant_epoch = 1
        with pytest.raises(_pkg(reader).errors.KubeMLException) as ei:
            sched._h_job(_req(reader, task_a.to_dict()))
        assert ei.value.status_code == 409
        task_a.grant_epoch = 2
        assert sched._h_job(_req(reader, task_a.to_dict())) == {"ok": True}
        snap = alloc.snapshot(now=60.0)
        outs[reader] = (summary, queued, phases, snap,
                        sorted(sched._parked), sched.recoveries)
    assert outs["port"] == outs["ref"]
    summary, queued, phases, snap, parked, recoveries = outs["port"]
    assert summary == {"adopted": ["aaaa0001"], "requeued": ["bbbb0002"],
                       "parked": ["cccc0003"], "queued": ["dddd0004"],
                       "fencing_epoch": 2}
    assert queued["bbbb0002"] == (1, 0, -1.0, "queued")
    assert phases["aaaa0001"] == ("granted", 2, 2)
    assert snap["cluster_fencing_rejections_total"] == 1
    assert parked == ["cccc0003"] and recoveries == 1


def test_stale_grant_error_is_the_references():
    from kubeml_tpu.api.errors import StaleGrantError as Ref
    from kubeml_tpu_torch.api.errors import StaleGrantError

    for cls in (StaleGrantError, Ref):
        e = cls("j1", 1, 2)
        assert (e.status_code, e.presented, e.current) == (409, 1, 2)
    assert str(StaleGrantError("j1", 1, 2)) == str(Ref("j1", 1, 2))


@pytest.mark.parametrize("writer", PKGS)
def test_build_allocator_replays_a_prior_journal(tmp_path, writer):
    """A second build over the same directory replays what either
    package's first build journaled."""
    d = str(tmp_path / "control")
    a1 = _pkg(writer).deployment.build_allocator(
        4, ["prod=3:4", "batch=1"], journal_dir=d)
    a1.submit("j1", tenant="batch", lanes=2)
    a1._journal.close()
    snaps = []
    for reader in PKGS:
        shutil.copytree(d, str(tmp_path / reader))
        a2 = _pkg(reader).deployment.build_allocator(
            4, ["prod=3:4", "batch=1"], journal_dir=str(tmp_path / reader))
        assert a2.running_jobs() == {"j1": 2}
        assert a2.grant_epoch("j1") == 1
        snaps.append(a2.snapshot(now=0.0))
        assert _pkg(reader).deployment.build_allocator(
            0, journal_dir=str(tmp_path / reader)) is None
    assert snaps[0] == snaps[1]
    assert snaps[0]["cluster_tenant_quota"] == {"batch": 4, "prod": 4}


def test_jobserver_update_adopts_the_regrant_epoch():
    for pkg in PKGS:
        js = _pkg(pkg).jobserver.JobServer("epoch001")
        task = _task(pkg, "epoch001")
        task.grant_epoch = 1
        js._job = types.SimpleNamespace(task=task)
        assert js._h_update(_req(pkg, {"parallelism": 3,
                                       "grant_epoch": 4})) == {"ok": True}
        assert task.grant_epoch == 4
        assert js._next_parallelism == 3 and js._update_event.is_set()
        js._h_update(_req(pkg, {"parallelism": 2}))
        assert task.grant_epoch == 4


# ------------------------------------------------------------ PS recovery

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _alive(pid: int) -> bool:
    """A live, non-zombie process."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _until(pred, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.1)


def _child_env(home):
    env = dict(os.environ, KUBEML_TPU_HOME=str(home), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("KUBEML_CONTROLLER_URL", None)
    return env


def _manifest(sdir, live_url, live_pid, pkg):
    from kubeml_tpu_torch.control.journal import atomic_write_json

    os.makedirs(sdir, exist_ok=True)
    atomic_write_json(os.path.join(sdir, "ps.jobs.json"), {"jobs": {
        "live0001": {"task": _task(pkg, "live0001").to_dict(),
                     "url": live_url, "pid": live_pid, "partition": None},
        "dead0002": {"task": _task(pkg, "dead0002").to_dict(),
                     "url": f"http://127.0.0.1:{_free_port()}",
                     "pid": 999999, "partition": None}}})
    atomic_write_json(os.path.join(sdir, "ps.fleets.json"),
                      {"fleets": {"gpt-nano": {"stamp": None,
                                               "replicas": 0}}})


def test_ps_recovery_readopts_a_live_child_and_drops_a_dead_one(
        tmp_path, tmp_home):
    """A real `python -m kubeml_tpu_torch.train.jobserver --device cpu`
    child answers /health on its recorded URL: both PSs re-adopt it (no
    second start) and drop the dead entry alike; the port's pid watchdog
    then sees the child die and deregisters it."""
    from tools.check_metrics import parse_exposition

    port_file = str(tmp_path / "child.port")
    child = subprocess.Popen(
        [sys.executable, "-m", "kubeml_tpu_torch.train.jobserver",
         "--job-id", "live0001", "--device", "cpu", "--port-file",
         port_file], env=_child_env(tmp_home), cwd=REPO)
    pss = []
    try:
        _until(lambda: os.path.exists(port_file), "the child's port", 120)
        with open(port_file) as f:
            url = f"http://127.0.0.1:{int(json.load(f))}"
        summaries = {}
        for pkg in PKGS:
            sdir = str(tmp_path / pkg)
            _manifest(sdir, url, child.pid, pkg)
            kw = {"device": "cpu"} if pkg == "port" else {}
            ps = _pkg(pkg).ps.ParameterServer(
                port=0, standalone_jobs=True, state_dir=sdir, **kw)
            pss.append(ps)
            summary = ps.recover()
            assert summary.pop("recovery_s") >= 0.0
            summaries[pkg] = summary
            assert ps.recoveries == 1
            assert sorted(ps.jobs) == ["live0001"]
            assert ps.jobs["live0001"].adopted_pid == child.pid
            with open(os.path.join(sdir, "ps.jobs.json")) as f:
                assert sorted(json.load(f)["jobs"]) == ["live0001"]
            fams = parse_exposition(ps.metrics.exposition())
            samples = {(n, tuple(sorted(lab.items()))): v
                       for fam in fams.values()
                       for n, lab, v in fam["samples"]}
            assert samples[("kubeml_control_recoveries_total",
                            (("role", "ps"),))] == 1.0
            assert samples[("kubeml_control_recovery_seconds_count",
                            (("role", "ps"),))] == 1.0
        assert summaries["port"] == summaries["ref"] == {
            "adopted": ["live0001"], "dropped": ["dead0002"], "fleets": {}}
        # the re-grant's epoch reaches the adopted child's task record
        port_ps = pss[0]
        port_ps.jobs["live0001"].push_update(2, grant_epoch=3)
        assert port_ps.jobs["live0001"].task.grant_epoch == 3
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
        _until(lambda: "live0001" not in port_ps.jobs,
               "the watchdog to notice the adopted child's death", 30)
        assert "live0001" in port_ps.errors
        with open(os.path.join(str(tmp_path / "port"), "ps.jobs.json")) as f:
            assert json.load(f)["jobs"] == {}
    finally:
        for ps in pss:
            ps._stopping = True        # stands the pid watchdogs down
            ps.stop()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


# ---------------------------------------------------------- PS routes

def test_ps_cluster_route_feeds_metrics_and_health_alike(tmp_home):
    """POST /cluster: the snapshot lands on the cluster families and on
    GET /health?id=cluster, as on the JAX PS."""
    from kubeml_tpu_torch.control.httpd import http_json

    outs = []
    for pkg in PKGS:
        m = _pkg(pkg)
        alloc = m.cluster.ClusterAllocator(4, clock=FakeClock(0.0))
        alloc.submit("j1", lanes=2)
        snap = alloc.snapshot()
        snap.update(control_recovery_s=0.5, control_role="scheduler")
        kw = {"device": "cpu"} if pkg == "port" else {}
        ps = m.ps.ParameterServer(port=0, **kw)
        ps.start()
        try:
            assert http_json("POST", f"{ps.url}/cluster", snap) == \
                {"ok": True}
            verdict = http_json("GET", f"{ps.url}/health?id=cluster")
            with pytest.raises(Exception) as ei:
                http_json("POST", f"{ps.url}/cluster", {"x": 1})
            assert ei.value.status_code == 400
            reg = ps.metrics
            text = "\n".join(f.collect() for f in reg._cluster_gauges
                             + reg._cluster_counters
                             + [reg.control_recovery_seconds])
        finally:
            ps.stop()
        outs.append((verdict["state"], verdict["latest"]["cluster_pool_lanes"],
                     text))
    assert outs[0] == outs[1]
    assert outs[0][0] == "healthy"


def test_ps_preempt_drains_a_serving_gang_and_refuses_a_training_job(
        tmp_path, tmp_home):
    """POST /preempt/serve:<model> drains the fleet to zero and persists
    the fleet manifest at 0 replicas, as the JAX PS does; an unknown
    fleet and an unknown training job are 404 in both packages (a
    training victim's drain is held in tests/test_torch_elastic.py)."""
    from kubeml_tpu_torch.control.httpd import http_json
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    nano = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
                ffn=64)
    save_checkpoint("prenano", {"params": random_flax_params(**nano,
                                                             seed=4)},
                    {"model": "gpt-nano", "function": "gpt-nano",
                     "parallelism": 1, "epoch": 0})
    manifests = []
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == "port" else {}
        sdir = str(tmp_path / pkg)
        ps = _pkg(pkg).ps.ParameterServer(port=0, serve_slots=2,
                                          state_dir=sdir, **kw)
        ps.start()
        try:
            fleet = ps._serve_service("prenano")
            assert fleet.replica_count == 1
            with open(os.path.join(sdir, "ps.fleets.json")) as f:
                assert json.load(f)["fleets"]["prenano"]["replicas"] == 1
            assert http_json("POST", f"{ps.url}/preempt/serve:prenano") \
                == {"ok": True}
            assert fleet.replica_count == 0
            with pytest.raises(Exception) as ei:
                http_json("POST", f"{ps.url}/preempt/serve:ghost")
            assert ei.value.status_code == 404
            with open(os.path.join(sdir, "ps.fleets.json")) as f:
                manifests.append(json.load(f)["fleets"]["prenano"]
                                 ["replicas"])
            with pytest.raises(Exception) as ei:
                http_json("POST", f"{ps.url}/preempt/abcd0001")
            assert ei.value.status_code == 404
            assert "abcd0001" in ei.value.message
        finally:
            ps.stop()
    assert manifests == [0, 0]


# ---------------------------------------------------------- telemetry

def _recovered_alloc(pkg: str, directory):
    m = _pkg(pkg)
    alloc = m.cluster.ClusterAllocator(
        8, tenant_quotas={"a": 6}, clock=FakeClock(0.0),
        journal=m.journal.DecisionJournal(str(directory)))
    alloc.submit("j1", tenant="a", lanes=2)
    rec = m.cluster.ClusterAllocator.recover(
        m.journal.DecisionJournal(str(directory)), 8,
        tenant_quotas={"a": 6}, clock=FakeClock(0.0))
    rec.mark_recovered()
    rec.regrant("j1")
    with pytest.raises(m.errors.StaleGrantError):
        rec.fence_check("j1", 1)
    return rec


def test_control_prometheus_text_equals_the_references(tmp_path):
    from tools.check_metrics import validate_exposition

    texts = []
    for pkg in PKGS:
        rec = _recovered_alloc(pkg, tmp_path / pkg)
        reg = _pkg(pkg).prom.MetricsRegistry()
        reg.update_cluster(rec.snapshot(now=0.0))
        reg.update_cluster(rec.snapshot(now=0.0))     # a replay
        snap = rec.snapshot(now=0.0)
        snap.update(control_recovery_s=0.25, control_role="scheduler")
        reg.update_cluster(snap)
        reg.note_control_recovery("ps", 0.125)
        assert validate_exposition(reg.exposition()) == []
        texts.append("\n".join(f.collect() for f in reg._cluster_gauges
                               + reg._cluster_counters
                               + [reg.control_recovery_seconds]))
    assert texts[0] == texts[1]
    assert 'kubeml_control_recoveries_total{role="allocator"} 1' in texts[0]
    assert 'kubeml_control_fencing_epoch{pool="shared"} 2' in texts[0]


def test_control_flapping_rule_and_top_line_alike(tmp_path):
    from kubeml_tpu.cli.main import _render_top as ref_render
    from kubeml_tpu.control.health import HealthEvaluator as RefEval
    from kubeml_tpu_torch.cli.main import _render_top
    from kubeml_tpu_torch.control.health import HealthEvaluator

    base = {"job_id": "cluster", "cluster_pool_lanes": 4,
            "cluster_lanes_in_use": 2, "cluster_queue_depth": 0,
            "cluster_oldest_wait_s": 0.0, "cluster_fencing_epoch": 2,
            "cluster_recoveries_total": 1}
    verdicts = []
    for ev in (HealthEvaluator(clock=FakeClock(0.0)),
               RefEval(clock=FakeClock(0.0))):
        assert ev.observe(dict(base)) == []
        fired = ev.observe(dict(base, cluster_recoveries_total=3,
                                cluster_fencing_epoch=4))
        assert [r["rule"] for r in fired] == ["control_flapping"]
        verdicts.append(ev.verdict("cluster"))
    assert verdicts[0] == verdicts[1]
    assert verdicts[0]["state"] == "critical"
    rec = _recovered_alloc("port", tmp_path)
    doc = {"id": "cluster", "state": "healthy", "reasons": [],
           "latest": rec.snapshot(now=0.0)}
    assert _render_top(doc) == ref_render(doc)
    assert "control: epoch 2" in _render_top(doc)


# ------------------------------------------- a deployment killed, restarted

def _blobs(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for name, n in (("xtr", 256), ("ytr", 256), ("xte", 64), ("yte", 64)):
        if name[0] == "x":
            arr = rng.normal(size=(n, 8)).astype(np.float32)
        else:
            arr = rng.integers(0, 3, n).astype(np.int32)
        paths.append(str(tmp_path / f"{name}.npy"))
        np.save(paths[-1], arr)
    return paths


class _Serve:
    """`python -m kubeml_tpu_torch.cli serve --role all` on the CPU on
    fixed ports (the re-adopted children post to the same URLs)."""

    def __init__(self, env, control_dir):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "serve",
             "--role", "all", "--device", "cpu", "--standalone-jobs",
             "--cluster-lanes", "4", "--cluster-tenant", "prod=3:4",
             "--cluster-tenant", "batch=1", "--control-dir", control_dir],
            env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()   # after recovery, if any
        assert line.startswith("controller:"), (line, self.proc.poll())
        self.url = line.split()[-1]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.kill()


def test_a_killed_deployment_restarts_on_its_control_dir(tmp_path,
                                                         tmp_home):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.httpd import http_json

    ports = {k: _free_port() for k in ("CONTROLLER", "SCHEDULER", "PS",
                                       "STORAGE")}
    env = _child_env(tmp_home)
    env.update({f"KUBEML_{k}_PORT": str(v) for k, v in ports.items()})
    env["KUBEML_JOB_START_TIMEOUT"] = "300"
    control = str(tmp_path / "control")
    sched_url = f"http://127.0.0.1:{ports['SCHEDULER']}"
    serve = _Serve(env, control)
    pids = {}
    try:
        client = KubemlClient(serve.url).v1()
        client.datasets().create("blobs", *_blobs(tmp_path))

        def long_job(tenant):
            # runs until stopped: one tiny epoch after another
            return client.networks().train(TrainRequest(
                model_type="mlp", batch_size=32, epochs=100000,
                dataset="blobs", lr=0.1, tenant=tenant,
                options=TrainOptions(default_parallelism=2, k=2,
                                     static_parallelism=True,
                                     validate_every=0,
                                     checkpoint_every=-1)))
        live, dead = long_job("batch"), long_job("prod")
        manifest = os.path.join(control, "ps.jobs.json")

        def children():
            try:
                with open(manifest) as f:
                    return {j: e["pid"] for j, e in
                            json.load(f)["jobs"].items() if e.get("url")}
            except (OSError, ValueError):
                return {}
        _until(lambda: set(children()) == {live, dead}, "both children",
               180)
        pids = children()
        before = http_json("GET", f"{serve.url}/cluster")
        assert before["cluster_fencing_epoch"] == 1
        assert {g["job_id"]: g["lanes"]
                for g in before["cluster_running_gangs"]} == \
            {live: 2, dead: 2}
        # the crash: the control plane and one child die at once
        serve.kill()
        os.kill(pids[dead], signal.SIGKILL)
        _until(lambda: not _alive(pids[dead]), "the dead child", 30)
        assert _alive(pids[live])

        serve = _Serve(env, control)
        after = http_json("GET", f"{serve.url}/cluster")
        assert after["cluster_fencing_epoch"] == 2
        assert after["cluster_recoveries_total"] == 1
        gangs = {g["job_id"]: g for g in after["cluster_running_gangs"]}
        assert gangs[live]["epoch"] == 2 and gangs[live]["lanes"] == 2
        # re-adopted, not started again: the same child, no restart spent
        _until(lambda: set(children()) == {live, dead}
               and children()[dead] != pids[dead], "the requeued child",
               180)
        now = children()
        assert now[live] == pids[live] and _alive(pids[live])
        tasks = {t["job_id"]: t for t in http_json(
            "GET", f"{serve.url}/tasks")}
        assert tasks[live]["restarts"] == 0
        assert tasks[dead]["restarts"] == 0
        assert tasks[live]["grant_epoch"] == 2
        # the pre-crash epoch is fenced
        stale = dict(tasks[live], grant_epoch=1)
        with pytest.raises(Exception) as ei:
            http_json("POST", f"{sched_url}/job", stale)
        assert ei.value.status_code == 409
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports['PS']}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        assert 'kubeml_control_recoveries_total{role="ps"} 1' in metrics
        assert 'kubeml_control_recoveries_total{role="scheduler"} 1' \
            in metrics
        for job in (live, dead):
            http_json("DELETE", f"{serve.url}/tasks/{job}")
        _until(lambda: http_json("GET", f"{serve.url}/tasks") == [],
               "both jobs to stop", 120)
        _until(lambda: not _alive(pids[live]), "the adopted child to exit",
               60)
    finally:
        serve.stop()
        for pid in pids.values():
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


def test_a_cold_started_fleet_is_recorded_at_one_replica(tmp_path,
                                                          tmp_home):
    """A fleet with no replica floor cold-starts on its first /generate;
    the resize offer records the count it granted, so the manifest says 1
    before the replica exists: a restart would rebuild the fleet at 1,
    not 0."""
    from kubeml_tpu_torch.control.ps import ParameterServer
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    nano = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
                ffn=64)
    save_checkpoint("coldnano", {"params": random_flax_params(**nano,
                                                              seed=2)},
                    {"model": "gpt-nano", "function": "gpt-nano",
                     "parallelism": 1, "epoch": 0})
    sdir = str(tmp_path / "ps")
    ps = ParameterServer(device="cpu", port=0, serve_slots=2,
                         serve_replicas_min=0, state_dir=sdir)
    ps.start()
    path = os.path.join(sdir, "ps.fleets.json")

    def recorded():
        try:
            with open(path) as f:
                return json.load(f)["fleets"]["coldnano"]["replicas"]
        except (OSError, KeyError, ValueError):
            return None
    try:
        req = urllib.request.Request(
            f"{ps.url}/generate", method="POST",
            data=json.dumps({"model_id": "coldnano", "prompt": [1, 2, 3],
                             "max_new_tokens": 2,
                             "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert len(json.loads(r.read())["tokens"]) == 2
        _until(lambda: recorded() == 1, "the manifest at 1 replica", 30)
    finally:
        ps.stop()


class _CountedFleet:
    def __init__(self, n: int):
        self.replica_count = n


def test_a_resize_offer_records_the_count_the_fleet_runs(tmp_path,
                                                         tmp_home):
    """The fleet's resize offer goes to the scheduler first; the manifest
    then records the count the fleet runs: the allocator's grant (2 of
    the 4 asked on a 2-lane pool; 0 for a scale to zero), except that a
    cold start keeps its floor of one replica on a zero grant (the pool
    is held by a training gang). A manifest write that fails is logged:
    the fleet still gets the grant, never the count it asked for."""
    from kubeml_tpu_torch.control.cluster import ClusterAllocator
    from kubeml_tpu_torch.control.ps import ParameterServer
    from kubeml_tpu_torch.control.scheduler import Scheduler

    alloc = ClusterAllocator(2, clock=FakeClock())
    sched = Scheduler(ps_url=None, allocator=alloc)
    sched.start()
    sdir = str(tmp_path / "ps")
    ps = ParameterServer(device="cpu", port=0, state_dir=sdir,
                         scheduler_url=sched.url)

    def recorded():
        with open(os.path.join(sdir, "ps.fleets.json")) as f:
            return json.load(f)["fleets"]["m"]
    try:
        ps._serve["m"] = ("s0", _CountedFleet(0))
        offer = ps._serve_resize_cb("m")
        assert offer(4) == 2
        assert recorded() == {"stamp": "s0", "replicas": 2}
        assert offer(0) == 0 and recorded()["replicas"] == 0
        alloc.submit("busy", lanes=2)
        assert offer(1) == 0 and recorded()["replicas"] == 1
        ps._fleet_manifest_path = str(tmp_path / "gone" / "ps.fleets.json")
        assert offer(1) == 0
    finally:
        sched.stop()


def test_concurrent_manifest_writers_leave_whole_files(tmp_path, tmp_home):
    """Every manifest write stages through the same <name>.tmp; writers
    from many threads (resize offers, hot swaps, job starts and ends)
    take turns, so none raises and each file parses."""
    import threading

    from kubeml_tpu_torch.control.ps import ParameterServer

    sdir = str(tmp_path / "ps")
    ps = ParameterServer(device="cpu", port=0, state_dir=sdir)
    for i in range(8):
        ps._serve[f"m{i}"] = (f"s{i}", _CountedFleet(i))
    errors = []

    def write(k: int):
        try:
            for _ in range(40):
                if k % 2:
                    ps._persist_fleets(resized=(f"m{k}", k + 1))
                else:
                    ps._persist_jobs()
        except Exception as e:   # noqa: BLE001 — collected and asserted
            errors.append(e)
    threads = [threading.Thread(target=write, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    with open(os.path.join(sdir, "ps.fleets.json")) as f:
        assert sorted(json.load(f)["fleets"]) == [f"m{i}" for i in range(8)]
    with open(os.path.join(sdir, "ps.jobs.json")) as f:
        assert json.load(f) == {"jobs": {}}
