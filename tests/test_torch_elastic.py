"""Port parity: the degraded mode's round cursor and makeup rounds, and the
preemption of training jobs (mirrors tests/test_elastic.py).

- the loader: ``start_round`` rounds equal the tail of a full epoch, and
  ``makeup_rounds`` (ids, masks, keys) equal the JAX package's;
- within the port: a crash at every round resumes at its cursor with the
  weights of an uninterrupted run bit for bit; a ``preempt`` event drains,
  checkpoints and resumes likewise, mid-epoch and at an epoch boundary; a
  cursor whose membership no longer fits is discarded;
- across the packages: a cursor written by the JAX job resumes in the
  port and the other way round, the weights within 1e-5 of the other
  package's uninterrupted run (mlp, SGD, f32), the cursor's keys equal;
- the PS's /heartbeat, /preempted and /preempt (503 for a threaded job),
  the liveness reaper, the watchdog's budget-free reschedule and requeue,
  and the scheduler's /requeue answer as the JAX package's;
- end to end on the CPU: a ``crash`` FaultPlan event in a standalone
  child restarted by the watchdog from its cursor; an allocator
  preemption in cluster mode (SIGTERM -> drain -> /preempted ->
  /requeue -> re-place -> resume). Both end with the uninterrupted job's
  weights.

Waits on children poll a condition with a deadline (Event.wait, never a
bare sleep), as tools/check_fault_tests.py requires of a file that names
preemption.
"""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_job import (_blobs, _blobs_dataset, _final_params,
                            _mlp, _seed_mlp_checkpoint, _tasks)

pytestmark = pytest.mark.torch_port

N_TRAIN, SUBSET, NUM_ROUNDS = 256, 16, 8   # N=2, K=1, B=16: 8 rounds


@pytest.fixture()
def small_blobs(tmp_home):
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    DatasetRegistry().create("blobs", *_blobs(n_train=N_TRAIN, n_test=64),
                             subset_size=SUBSET)
    _seed_mlp_checkpoint()


def _job(job_id, resume=False, round_hook=None, pkg="port", epochs=2,
         parallelism=2, **opts):
    """An mlp job at 8 rounds an epoch, warm-started from the JAX
    checkpoint (or resuming its own with ``resume``)."""
    tasks = _tasks(job_id, "mlp", "blobs", epochs=epochs,
                   parallelism=parallelism, k=1, batch=16, goal=200.0,
                   device_cache=opts.pop("device_cache", "off"), **opts)
    task = tasks[pkg]
    task.job_id = job_id
    if resume:
        task.parameters.resume_from = job_id
    if pkg == "port":
        from kubeml_tpu_torch.train.job import TrainJob
        return TrainJob(task, _mlp(pkg), _blobs_dataset(pkg), device="cpu",
                        round_hook=round_hook)
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train.job import TrainJob
    return TrainJob(task, _mlp(pkg), _blobs_dataset(pkg),
                    make_mesh(n_data=1), round_hook=round_hook)


def _weights(job_id):
    from kubeml_tpu_torch.train.checkpoint import _flatten, load_checkpoint

    tree, manifest = load_checkpoint(job_id)
    return _flatten(tree), manifest


def _assert_same_weights(a, b, tol=0.0):
    wa, _ = _weights(a)
    wb, _ = _weights(b)
    assert wa.keys() == wb.keys()
    for k in wa:
        if tol:
            np.testing.assert_allclose(wa[k], wb[k], rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(wa[k], wb[k])


def _loaders(handle_subset=SUBSET):
    from kubeml_tpu.data.loader import RoundLoader as RefLoader
    from kubeml_tpu.data.registry import DatasetRegistry as RefRegistry
    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu_torch.data.loader import RoundLoader
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models.base import KubeDataset

    return (RoundLoader(DatasetRegistry().get("blobs"),
                        KubeDataset("blobs"), n_lanes=1, seed=3),
            RefLoader(RefRegistry().get("blobs"), RefDataset("blobs"),
                      n_lanes=1, seed=3))


def _rounds_equal(a, b):
    assert a.round_index == b.round_index and a.num_rounds == b.num_rounds
    assert a.batch.keys() == b.batch.keys()
    for k in a.batch:
        np.testing.assert_array_equal(a.batch[k], b.batch[k])
    for f in ("sample_mask", "step_mask", "worker_mask", "rngs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("start", [0, 3, NUM_ROUNDS])
def test_start_round_rounds_are_the_tail_of_the_epoch(small_blobs, start,
                                                      indexed):
    port, ref = _loaders()
    plan, rplan = port.plan(2, 1, 16), ref.plan(2, 1, 16)
    src = "epoch_index_rounds" if indexed else "epoch_rounds"
    full = list(getattr(port, src)(plan, 1))
    tail = list(getattr(port, src)(plan, 1, start_round=start))
    want = list(getattr(ref, src)(rplan, 1, start_round=start))
    assert len(full) == NUM_ROUNDS and len(tail) == NUM_ROUNDS - start
    for a, b, c in zip(tail, full[start:], want):
        _rounds_equal(a, b)
        _rounds_equal(a, c)


@pytest.mark.parametrize("index_mode", [False, True])
@pytest.mark.parametrize("since", [{1: 2}, {0: 0, 3: 1}, {2: 3}])
def test_makeup_rounds_equal_the_references(small_blobs, since, index_mode):
    port, ref = _loaders()
    plan, rplan = port.plan(4, 1, 16), ref.plan(4, 1, 16)
    got = list(port.makeup_rounds(plan, 2, since, index_mode=index_mode))
    want = list(ref.makeup_rounds(rplan, 2, since, index_mode=index_mode))
    assert got and len(got) == len(want)
    for a, b in zip(got, want):
        _rounds_equal(a, b)
        assert all(a.worker_mask[w] == 0 for w in since)


def test_makeup_rounds_cover_orphans_exactly_once(small_blobs):
    """The planned rounds minus the quarantined worker's chunks from its
    round on, plus the makeup rounds, cover every sample once."""
    port, _ = _loaders()
    plan = port.plan(4, 1, 16)
    since = {1: 2}
    seen = np.zeros(N_TRAIN, np.int64)
    for rb in port.epoch_index_rounds(plan, 0):
        for w in range(4):
            if w == 1 and rb.round_index >= since[1]:
                continue
            np.add.at(seen, rb.batch["idx"][w][rb.sample_mask[w] > 0], 1)
    makeups = list(port.makeup_rounds(plan, 0, since, index_mode=True))
    assert makeups[0].round_index == len(plan.rounds)
    for rb in makeups:
        for w in range(4):
            np.add.at(seen, rb.batch["idx"][w][rb.sample_mask[w] > 0], 1)
    np.testing.assert_array_equal(seen, np.ones(N_TRAIN, np.int64))


class _Crash(Exception):
    """A process death after the previous round, in-process: raised from
    the round hook, it unwinds train() through the failure path."""


def test_crash_at_every_round_resumes_bit_identical(small_blobs):
    _job("clean", checkpoint_every_rounds=1).train()
    for r in range(1, NUM_ROUNDS):
        job_id = f"crash{r}"
        fired = []

        def hook(rb, r=r, fired=fired):
            if not fired and rb.round_index == r:
                fired.append(r)
                raise _Crash(r)
            return rb

        job = _job(job_id, round_hook=hook, checkpoint_every_rounds=1)
        with pytest.raises(_Crash):
            job.train()
        assert job.task.state == "failed"
        _, manifest = _weights(job_id)
        assert (manifest["train_state"]["epoch"],
                manifest["train_state"]["round"]) == (0, r)
        record = _job(job_id, resume=True, checkpoint_every_rounds=1).train()
        assert len(record.data.train_loss) == 2
        _assert_same_weights(job_id, "clean")


def test_preempt_event_drains_and_resumes_bit_identical(small_blobs):
    from kubeml_tpu_torch.api.errors import JobPreemptedError

    _job("pclean").train()
    plan = json.dumps([{"kind": "preempt", "epoch": 0, "round": 3}])
    job = _job("pre", fault_plan=plan, checkpoint_every_rounds=2)
    with pytest.raises(JobPreemptedError) as ei:
        job.train()
    assert job.task.state == "preempted"
    assert (ei.value.epoch, ei.value.round, ei.value.status_code) == \
        (0, 4, 503)
    assert job._fault_plan.injected["preempt"] == 1
    _, manifest = _weights("pre")
    assert manifest["train_state"]["round"] == 4
    resumed = _job("pre", resume=True, fault_plan=plan,
                   checkpoint_every_rounds=2)
    record = resumed.train()
    assert resumed._fault_plan.injected["preempt"] == 0   # a restart
    assert resumed.task.state == "finished"
    assert len(record.data.train_loss) == 2
    _assert_same_weights("pre", "pclean")


def test_epoch_boundary_preempt_checkpoints_the_next_epoch(small_blobs):
    """Grouped dispatch has no per-round host control: the notice drains
    at the epoch's end, the checkpoint holds the completed epoch, and the
    resume runs the rest."""
    from kubeml_tpu_torch.api.errors import JobPreemptedError

    _job("bclean", rounds_per_dispatch=4).train()
    job = _job("bpre", rounds_per_dispatch=4)
    job.preempt()
    with pytest.raises(JobPreemptedError) as ei:
        job.train()
    assert (ei.value.epoch, ei.value.round) == (1, 0)
    _, manifest = _weights("bpre")
    assert manifest["epoch"] == 1 and "train_state" not in manifest
    record = _job("bpre", resume=True, rounds_per_dispatch=4).train()
    assert len(record.data.train_loss) == 2
    _assert_same_weights("bpre", "bclean")


def test_membership_change_discards_the_round_cursor(small_blobs):
    from kubeml_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    _job("stale", epochs=1).train()
    tree, _ = load_checkpoint("stale")
    save_checkpoint("stale", tree, {
        "model": "mlp", "function": "mlp", "parallelism": 2, "epoch": 0,
        "train_state": {"epoch": 0, "round": 3, "step_counts": [1.0] * 5,
                        "loss_sums": [0.0] * 5, "dropped": 0.0,
                        "all_dropped_rounds": 0, "reassigned": 0}})
    logs = []
    resumed = _job("stale", epochs=1, resume=True)
    real = resumed._log
    resumed._log = lambda msg, *a, **k: logs.append(msg % a) or \
        real(msg, *a, **k)
    record = resumed.train()
    assert resumed.task.state == "finished"
    assert len(record.data.train_loss) == 1
    assert any("discarding round cursor" in line for line in logs)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_cursor_resumes_in_the_other_package(small_blobs, writer):
    """A preempt event at round 3 in one package's job; the other
    package's job resumes the cursor and ends within 1e-5 of the writer's
    own uninterrupted run. The two cursors carry the same keys."""
    reader = "port" if writer == "ref" else "ref"
    plan = json.dumps([{"kind": "preempt", "epoch": 0, "round": 3}])
    _job(f"{writer}clean", pkg=writer).train()
    for pkg in ("ref", "port"):
        job = _job(f"{pkg}cur", pkg=pkg, fault_plan=plan,
                   checkpoint_every_rounds=2)
        with pytest.raises(Exception) as ei:
            job.train()
        assert type(ei.value).__name__ == "JobPreemptedError"
    keys = {pkg: set(_weights(f"{pkg}cur")[1]["train_state"])
            for pkg in ("ref", "port")}
    assert keys["port"] == keys["ref"]
    # the reader takes over the writer's checkpoint under the writer's id
    _job(f"{writer}cur", pkg=reader, resume=True, fault_plan=plan,
         checkpoint_every_rounds=2).train()
    want, _ = _final_params(f"{writer}clean")
    have, _ = _final_params(f"{writer}cur")
    for a, b in zip(have, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5)


# ----------------------------------------------- the PS and the scheduler


def _ps(pkg, records):
    """A ParameterServer with planted standalone records (no threads
    started): (ps, kills)."""
    if pkg == "ref":
        from kubeml_tpu.api.types import (TrainOptions, TrainRequest,
                                          TrainTask)
        from kubeml_tpu.control.ps import ParameterServer, _JobRecord
        ps = ParameterServer(standalone_jobs=True)
    else:
        from kubeml_tpu_torch.api.types import (TrainOptions, TrainRequest,
                                                TrainTask)
        from kubeml_tpu_torch.control.ps import ParameterServer, _JobRecord
        ps = ParameterServer(device="cpu", standalone_jobs=True)
    ps.heartbeat_timeout = 60.0
    kills = []
    for job_id, beat, state in records:
        task = TrainTask(job_id=job_id, parameters=TrainRequest(
            model_type="mlp", batch_size=16, epochs=1, dataset="blobs",
            lr=0.1, options=TrainOptions()), parallelism=2)
        rec = _JobRecord(task)
        rec.proc = SimpleNamespace(
            pid=4242, kill=lambda j=job_id: kills.append(j),
            terminate=lambda j=job_id: kills.append(f"term:{j}"))
        rec.task.state = state
        rec.last_heartbeat = beat
        ps.jobs[job_id] = rec
    return ps, kills


def _both_ps(records):
    return {pkg: _ps(pkg, records) for pkg in ("ref", "port")}


def test_heartbeat_reaper_kills_only_stale_running_children():
    now = 1000.0
    out = {}
    for pkg, (ps, kills) in _both_ps([
            ("hbnever", None, "running"),
            ("hbfresh", now - 10.0, "running"),
            ("hbstale", now - 60.0, "running"),
            ("hbstop", now - 500.0, "stopping")]).items():
        sweeps = [ps._scan_heartbeats(now), ps._scan_heartbeats(now + 1.0)]
        ps.jobs["hbstale"].last_heartbeat = now + 1.0
        ps.jobs["hbfresh"].last_heartbeat = now + 30.0
        sweeps.append(ps._scan_heartbeats(now + 61.0))
        ps.heartbeat_timeout = 0.0
        sweeps.append(ps._scan_heartbeats(1e9))
        out[pkg] = (sweeps, list(kills),
                    [line for line in ps.metrics.exposition().splitlines()
                     if "wedged" in line])
    assert out["port"] == out["ref"]
    assert out["port"][0] == [["hbstale"], [], ["hbstale"], []]


def test_heartbeat_preempted_and_tasks_answer_as_the_references():
    out = {}
    for pkg, (ps, _) in _both_ps([("hbwire", None, "running")]).items():
        rec = ps.jobs["hbwire"]
        req = SimpleNamespace(params={"jobId": "hbwire"}, query={},
                              body={"epoch": 2, "round": 5})
        ps._h_heartbeat(req)
        ps._h_preempted(req)
        errs = []
        for h in (ps._h_heartbeat, ps._h_preempted):
            with pytest.raises(Exception) as ei:
                h(SimpleNamespace(params={"jobId": "ghost"}, body={}))
            errs.append(ei.value.status_code)
        tasks = ps._h_tasks(SimpleNamespace(params={}, body=None))
        expo = ps.metrics.exposition().splitlines()
        out[pkg] = (rec.heartbeat_progress, rec.preempted, rec.preemptions,
                    rec.restarts, errs,
                    [(t["preemptions"], t["restarts"]) for t in tasks],
                    [line for line in expo
                     if "preempt" in line or "heartbeat" in line])
    assert out["port"] == out["ref"]
    assert out["port"][:5] == ((2, 5), True, 1, 0, [404, 404])


def test_preempt_signals_a_child_and_refuses_a_threaded_job():
    out = {}
    for pkg, (ps, kills) in _both_ps([("vic", 5.0, "running")]).items():
        got = ps._h_preempt(SimpleNamespace(params={"jobId": "vic"},
                                            body={}))
        threaded = ps.jobs["vic"]
        threaded.proc, threaded.job = None, object()
        with pytest.raises(Exception) as ei:
            ps._h_preempt(SimpleNamespace(params={"jobId": "vic"}, body={}))
        with pytest.raises(Exception) as missing:
            ps._h_preempt(SimpleNamespace(params={"jobId": "nope"},
                                          body={}))
        out[pkg] = (got, list(kills), threaded.requeue_on_exit,
                    ei.value.status_code, str(ei.value),
                    missing.value.status_code)
    assert out["port"] == out["ref"]
    assert out["port"][1] == ["term:vic"] and out["port"][3] == 503


@pytest.mark.parametrize("case", ["preempted", "requeue", "crash",
                                  "crash_over_budget"])
def test_the_watchdog_reschedules_as_the_references(tmp_home, case):
    """_on_child_exit over a planted record: a /preempted child respawns
    without spending the budget, an allocator-preempted one goes to the
    scheduler's /requeue, a crash spends a restart (or fails the job
    over budget); the spawns, requeues and finishes are recorded."""
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint("wd", {"params": {"w": np.ones(2, np.float32)}},
                    {"model": "mlp", "function": "mlp", "epoch": 1})
    out = {}
    for pkg, (ps, _) in _both_ps([("wd", 5.0, "running")]).items():
        base = "kubeml_tpu" if pkg == "ref" else "kubeml_tpu_torch"
        mod = __import__(f"{base}.control.ps", fromlist=["ps"])
        calls = []
        ps.scheduler_url = "http://scheduler"
        ps._spawn_standalone = lambda rec, calls=calls: calls.append(
            ("spawn", rec.restarts, rec.preemptions,
             rec.task.parameters.resume_from))
        ps._finish = lambda job_id, error=None, calls=calls: calls.append(
            ("finish", job_id, error))
        real_http = mod.http_json
        mod.http_json = lambda method, url, body=None, calls=calls, **kw: \
            calls.append(("http", method, url, body["job_id"],
                          body["state"], body["preemptions"]))
        try:
            rec = ps.jobs["wd"]
            if case == "preempted":
                ps._h_preempted(SimpleNamespace(params={"jobId": "wd"},
                                                body={}))
            elif case == "requeue":
                rec.requeue_on_exit = True
                ps._h_preempted(SimpleNamespace(params={"jobId": "wd"},
                                                body={}))
            elif case == "crash_over_budget":
                rec.restarts = rec.task.parameters.options.max_restarts
            ps._on_child_exit("wd", rec, 23)
        finally:
            mod.http_json = real_http
        out[pkg] = (calls, rec.restarts, rec.preemptions, "wd" in ps.jobs)
    assert out["port"] == out["ref"]
    assert out["port"][0][0][0] == {"preempted": "spawn", "requeue": "http",
                                    "crash": "spawn",
                                    "crash_over_budget": "finish"}[case]


def test_scheduler_requeue_frees_the_lanes_and_requeues(tmp_home):
    """POST /requeue on a cluster-mode scheduler: the victim's lanes free,
    the parked arrival places on them, the victim queues again with its
    grant epoch cleared."""
    out = {}
    for pkg in ("ref", "port"):
        base = "kubeml_tpu" if pkg == "ref" else "kubeml_tpu_torch"
        sched_mod = __import__(f"{base}.control.scheduler",
                               fromlist=["x"])
        cluster = __import__(f"{base}.control.cluster", fromlist=["x"])
        types = __import__(f"{base}.api.types", fromlist=["x"])
        t = [0.0]
        sched = sched_mod.Scheduler(allocator=cluster.ClusterAllocator(
            2, clock=lambda: t[0], aging_s=0.0))
        sched._push_cluster_state = lambda extra=None: None

        def task(job_id, priority):
            return types.TrainTask(job_id=job_id, parameters=types.
                                   TrainRequest(model_type="mlp",
                                                batch_size=16, epochs=1,
                                                dataset="blobs", lr=0.1,
                                                options=types.TrainOptions(
                                                    default_parallelism=2,
                                                    static_parallelism=True)),
                                   parallelism=2, priority=priority)
        sched._parked["vic"] = task("vic", 0)
        sched._apply_decisions(sched.allocator.submit("vic", lanes=2))
        t[0] = 1.0
        sched._parked["hi"] = task("hi", 2)
        decisions = sched.allocator.submit("hi", priority=2, lanes=2)
        back = task("vic", 0)
        back.preemptions, back.grant_epoch = 1, 3
        t[0] = 2.0
        sched._h_requeue(SimpleNamespace(params={}, body=back.to_dict()))
        queued = []
        while len(sched.queue):
            got = sched.queue.pop(timeout=1.0)
            queued.append((got.job_id, got.state, got.grant_epoch,
                           got.preemptions))
        snap = sched.allocator.snapshot()
        out[pkg] = ([d.action for d in decisions], queued,
                    snap["cluster_lanes_in_use"],
                    sorted(g["job_id"]
                           for g in snap["cluster_running_gangs"]))
    assert out["port"] == out["ref"]
    assert out["port"][1][-1] == ("vic", "queued", 0, 1)


def test_preemption_families_equal_the_references():
    from kubeml_tpu.metrics.prom import MetricsRegistry as Ref
    from kubeml_tpu_torch.metrics.prom import MetricsRegistry as Port

    texts = []
    for cls in (Ref, Port):
        reg = cls()
        reg.note_preemption("job-a")
        reg.note_preemption("job-a")
        reg.note_wedged("job-a")
        reg.note_restart("job-b")
        reg.clear_job("job-b")
        text = reg.exposition().splitlines()
        texts.append([line for line in text if any(
            n in line for n in ("kubeml_job_preemptions",
                                "kubeml_ps_preemptions_total",
                                "kubeml_ps_wedged_kills_total",
                                "kubeml_ps_restarts_total"))])
    assert texts[1] == texts[0]
    assert 'kubeml_job_preemptions{jobid="job-a"} 2' in "\n".join(texts[1])


# ------------------------------------------------------ end to end (CPU)


def _await(pred, what, timeout=180.0):
    """Poll ``pred`` at 20 Hz until it holds or the deadline passes."""
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        tick.wait(0.05)


def _stamped(client, job_id, want, timeout=60.0):
    """The job's history once the PS has stamped its (restarts,
    preemptions): the job writes the history, then the PS stamps the
    counts just after it deregisters the job. Returns the last read."""
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while True:
        hist = client.histories().get(job_id).data
        if (hist.restarts, hist.preemptions) == want or \
                time.monotonic() > deadline:
            return hist
        tick.wait(0.05)


def _request(epochs, n, **opts):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

    return TrainRequest(
        model_type="mlp", batch_size=16, epochs=epochs, dataset="blobs",
        lr=0.1, options=TrainOptions(default_parallelism=n, k=1,
                                     static_parallelism=True,
                                     goal_accuracy=200.0,
                                     device_cache="off", **opts))


def _direct(job_id, req, n):
    from kubeml_tpu_torch.api.types import TrainTask
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import TrainJob

    TrainJob(TrainTask(job_id=job_id, parameters=req, parallelism=n),
             get_model("mlp")(), KubeDataset("blobs"), device="cpu").train()


def _upload(tmp_path, client):
    """1024 + 64 blobs through the client: 16 docs of 64 samples, so 8
    rounds an epoch at N=2, K=1, B=16 (four steps a round)."""
    paths = []
    for name, arr in zip(("xtr", "ytr", "xte", "yte"),
                         _blobs(n_train=1024, n_test=64)):
        paths.append(str(tmp_path / f"{name}.npy"))
        np.save(paths[-1], arr)
    client.datasets().create("blobs", *paths)


def test_crash_event_in_a_child_restarts_from_its_cursor(tmp_path,
                                                         tmp_home):
    """A standalone child dies (os._exit(23)) at round 5 of epoch 0; the
    watchdog restarts it from the round cursor (checkpoint_every_rounds
    2); restarts = 1 and the weights equal an uninterrupted direct job."""
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.faults import CRASH_EXIT_CODE

    dep = start_deployment(device="cpu", standalone_jobs=True)
    try:
        client = KubemlClient(dep.controller_url).v1()
        _upload(tmp_path, client)
        plan = json.dumps([{"kind": "crash", "epoch": 0, "round": 5}])
        req = _request(2, 2, fault_plan=plan, checkpoint_every_rounds=2)
        job_id = client.networks().train(req)
        # the history is written at the job's end (the PS registers the
        # job only once the scheduler has started it)
        _await(lambda: any(h.id == job_id
                           for h in client.histories().list()),
               "the job's end")
        assert dep.ps.wait_for_job(job_id, timeout=60)
        assert dep.ps.errors == {}
        hist = _stamped(client, job_id, (1, 0))
        assert (hist.restarts, hist.preemptions) == (1, 0)
        assert len(hist.train_loss) == 2
        assert CRASH_EXIT_CODE == 23
        _direct("direct", _request(2, 2, checkpoint_every_rounds=2), 2)
        _assert_same_weights(job_id, "direct")
    finally:
        dep.stop()


def test_allocator_preemption_drains_requeues_and_resumes(tmp_path,
                                                          tmp_home,
                                                          monkeypatch):
    """Cluster mode over 2 lanes with standalone children: a priority-1
    N=2 arrival preempts a running N=2 job; the victim drains at a round
    (SIGTERM), posts /preempted, goes back through /requeue, re-places
    after the arrival, resumes from its cursor and ends with the weights
    of an uninterrupted direct job; restarts 0, preemptions 1."""
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json

    # beats every 0.2 s carry the victim's cursor; no reaping here
    monkeypatch.setenv("KUBEML_HEARTBEAT_INTERVAL", "0.2")
    monkeypatch.setenv("KUBEML_HEARTBEAT_MISS_BUDGET", "1000")
    dep = start_deployment(device="cpu", standalone_jobs=True,
                           cluster_lanes=2)
    try:
        client = KubemlClient(dep.controller_url).v1()
        _upload(tmp_path, client)
        # the victim's rounds slow to a crawl from round 4 of epoch 1, so
        # the arrival finds it mid-epoch
        plan = json.dumps([{"kind": "slow", "epoch": 1, "round": r,
                            "duration_s": 0.5} for r in range(4, 8)])
        victim = client.networks().train(_request(3, 2, fault_plan=plan))

        def progress():
            rec = dep.ps.jobs.get(victim)
            return rec is not None and rec.heartbeat_progress >= (1, 4)
        _await(progress, "the victim's round 4 of epoch 1")
        urgent = _request(1, 2)
        urgent.priority = 1
        arrival = client.networks().train(urgent)
        _await(lambda: arrival not in dep.ps.jobs and any(
            h.id == arrival for h in client.histories().list()),
            "the arrival's end")
        _await(lambda: victim not in dep.ps.jobs and any(
            h.id == victim for h in client.histories().list()),
            "the victim's end")
        assert dep.ps.errors == {}
        snap = http_json("GET", f"{dep.controller_url}/cluster")
        assert snap["cluster_preemptions_total"] == 1
        hist = _stamped(client, victim, (0, 1))
        assert (hist.restarts, hist.preemptions) == (0, 1)
        assert len(hist.train_loss) == 3
        _direct("direct", _request(3, 2), 2)
        _assert_same_weights(victim, "direct")
    finally:
        dep.stop()
