"""Port parity: kubeml_tpu_torch's tracer (utils/trace.py) against the JAX
package's.

- ``Tracer`` under a fake clock: the same span trees, summaries, event
  caps, resets and instants, equal event for event, for each of the
  reference's test_trace.py scenarios; thread safety under 8 threads;
- ``TraceSink`` files: the port's merged by the reference's
  ``merge_job_trace`` and the reverse, equal documents either way, torn
  files skipped;
- ``torch_profile`` on the CPU lands a ``*.trace.json`` that the merge
  lists, and degrades with a warning when the profiler cannot start;
- a port job and the reference's job on the same blobs task publish the
  same ``phase_times`` keys and write the same epoch log line (numbers
  masked), and the port job's timeline nests round > epoch, dispatch >
  round under one trace id.
"""

import json
import os
import re
import sys
import threading

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port


def _modules():
    from kubeml_tpu.utils import trace as ref
    from kubeml_tpu_torch.utils import trace as port
    return {"ref": ref, "port": port}


class FakeClock:
    """Advances 1.0 s on every read: span trees become exact."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _nested(tr):
    with tr.span("epoch", epoch=0):
        with tr.span("round", round=0):
            with tr.span("dispatch") as sp:
                sp["workers"] = 4
        with tr.span("round", round=1) as sp:
            with tr.span("data_wait"):
                pass
            sp["tail"] = True


def _summary_and_add(tr):
    for _ in range(2):
        with tr.span("a"):
            pass
    tr.add("b", 0.5)
    with tr.span("outer"):
        tr.add("inner", 0.25, note="x")


def _reset(tr):
    with tr.span("a"):
        pass
    tr.reset()
    with tr.span("b"):
        pass


def _cap(tr):
    for _ in range(3):
        with tr.span("a"):
            pass
    tr.instant("late")


def _instants(tr):
    tr.instant("first_token", ttft=0.5)
    tr.instant("decision", ts=7.0, parent="round", lanes=2)
    tr.add_span("request", 2.0, 5.5, parent="serve", rid=3)
    tr.add_span("neg", 5.0, 4.0)


SCENARIOS = {
    "nested_span_tree": (_nested, {}),
    "summary_and_add": (_summary_and_add, {}),
    "reset_keeps_timeline": (_reset, {}),
    "event_cap": (_cap, {"max_events": 2}),
    "instants_and_add_span": (_instants, {"max_events": 3}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("trace_id", [None, "aaaa000011112222"])
def test_tracer_matches_reference_under_a_fake_clock(name, trace_id):
    drive, kw = SCENARIOS[name]
    out = {}
    for key, mod in _modules().items():
        tr = mod.Tracer(clock=FakeClock(), trace_id=trace_id, **kw)
        drive(tr)
        out[key] = (tr.events(), tr.summary(), tr.format_summary(),
                    tr.durations(), tr.dropped_events, tr.event_count())
    assert out["port"] == out["ref"]


def test_tracer_exact_tree():
    """The reference's exact tree: ts/dur in microseconds from the fake
    clock, parents from the per-thread nesting, args attached mid-span."""
    port = _modules()["port"]
    tr = port.Tracer(clock=FakeClock(), trace_id="t1")
    with tr.span("epoch", epoch=0):
        with tr.span("round", round=0):
            with tr.span("dispatch") as sp:
                sp["workers"] = 4
    ev = {e["name"]: e for e in tr.events()}
    assert (ev["dispatch"]["ts"], ev["dispatch"]["dur"]) == (3_000_000,
                                                             1_000_000)
    assert (ev["epoch"]["ts"], ev["epoch"]["dur"]) == (1_000_000, 5_000_000)
    assert ev["dispatch"]["args"] == {"trace_id": "t1", "parent": "round",
                                      "workers": 4}
    assert tr.summary()["epoch"] == {"count": 1, "total_s": 5.0,
                                     "mean_s": 5.0}


def test_tracer_thread_safety_matches_reference():
    """Eight threads of nested spans: no lost update in either package,
    and parent links never cross threads."""
    counts = {}
    for key, mod in _modules().items():
        tr = mod.Tracer()

        def work(tr=tr):
            for _ in range(200):
                with tr.span("outer"):
                    with tr.span("inner"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        inner = [e for e in tr.events() if e["name"] == "inner"]
        assert all(e["args"]["parent"] == "outer" for e in inner)
        counts[key] = ({n: s["count"] for n, s in tr.summary().items()},
                       len(tr.events()))
    assert counts["port"] == counts["ref"] == ({"outer": 1600,
                                                "inner": 1600}, 3200)


def test_trace_context_matches_reference():
    for mod in _modules().values():
        assert mod.get_trace_context() is None
        with mod.trace_context("aaaa000011112222"):
            with mod.trace_context("bbbb000011112222"):
                assert mod.get_trace_context() == "bbbb000011112222"
            assert mod.get_trace_context() == "aaaa000011112222"
        assert mod.get_trace_context() is None
        assert len(mod.make_trace_id()) == 16
    mods = _modules()
    assert mods["port"].TRACE_HEADER == mods["ref"].TRACE_HEADER
    assert mods["port"].TRACE_ENV == mods["ref"].TRACE_ENV


def _write_sinks(mod, job_id, tid, process_names):
    for i, process in enumerate(process_names):
        tr = mod.Tracer(clock=FakeClock(), trace_id=tid, max_events=2)
        for _ in range(3):  # one dropped per file
            with tr.span(f"{process}.span{i}"):
                pass
        mod.TraceSink(job_id, process).write(tr)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("mixed", "ref"),
                                           ("mixed", "port")])
def test_each_package_merges_the_others_sinks(tmp_home, writer, reader):
    mods = _modules()
    tid = "cafe000011112222"
    if writer == "mixed":
        _write_sinks(mods["ref"], "mjob", tid, ["client", "ps"])
        _write_sinks(mods["port"], "mjob", tid, ["scheduler", "job"])
    else:
        _write_sinks(mods[writer], "mjob", tid,
                     ["client", "scheduler", "ps", "job"])
    with open(os.path.join(mods[writer if writer != "mixed" else "port"]
                           .trace_dir("mjob"), "torn.trace.json"), "w") as f:
        f.write("{not json")
    docs = {key: mod.merge_job_trace("mjob") for key, mod in mods.items()}
    assert docs[reader] == docs["port"] == docs["ref"]
    meta = docs[reader]["metadata"]
    pid = os.getpid()
    assert sorted(meta["sources"]) == sorted(
        f"{p}-{pid}.trace.json" for p in ("client", "scheduler", "ps",
                                          "job"))
    assert meta["trace_ids"] == [tid] and meta["dropped_events"] == 4
    procs = {e["args"]["name"] for e in docs[reader]["traceEvents"]
             if e["ph"] == "M"}
    assert procs == {f"{p}:mjob" for p in ("client", "scheduler", "ps",
                                           "job")}
    with pytest.raises(FileNotFoundError):
        mods[reader].merge_job_trace("nosuchjob")


def test_sink_files_equal_the_references(tmp_home):
    """One tracer's events written by each package's sink: the same
    document (the port's file is the reference's format)."""
    mods = _modules()
    docs = {}
    for key, mod in mods.items():
        tr = mods["ref"].Tracer(clock=FakeClock(), trace_id="t2")
        _nested(tr)
        path = mod.TraceSink(f"sink-{key}", "job").write(tr)
        with open(path) as f:
            docs[key] = json.load(f)
    for doc in docs.values():
        doc["metadata"].pop("job_id")
        doc["traceEvents"][0]["args"].pop("name")
    assert docs["port"] == docs["ref"]


def test_two_sinks_on_one_path_flush_from_threads_without_loss(tmp_home):
    """Two sinks of one process on one path (a fleet that lost the PS's
    build race flushes as it stops, while the winner flushes), each
    flushed from three threads at once: no write raises, a reader only
    ever sees a whole document of one of the sinks, and no staging file
    is left behind."""
    from kubeml_tpu_torch.utils.trace import TraceSink, Tracer

    sinks = [TraceSink("serve:m", "fleet") for _ in range(2)]
    assert sinks[0].path == sinks[1].path
    tracers = []
    for i in range(2):
        tr = Tracer(clock=FakeClock(), trace_id=f"t{i}")
        for _ in range(50 * (i + 1)):
            with tr.span("decode"):
                pass
        tracers.append(tr)
    errors, seen, done = [], set(), threading.Event()

    def flush(i):
        try:
            for _ in range(40):
                sinks[i].write(tracers[i])
        except Exception as e:  # noqa: BLE001 — the assertion reports it
            errors.append(e)

    def read():
        while not done.is_set():
            try:
                with open(sinks[0].path) as f:
                    doc = json.load(f)
            except FileNotFoundError:
                continue
            except ValueError as e:     # a torn document
                errors.append(e)
                return
            seen.add((doc["metadata"]["trace_id"], len(doc["traceEvents"])))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)       # interleave the threads finely
    try:
        reader = threading.Thread(target=read)
        reader.start()
        writers = [threading.Thread(target=flush, args=(i,))
                   for i in (0, 1) for _ in range(3)]
        for t in writers:
            t.start()
        for t in writers:
            t.join(60)
        done.set()
        reader.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in writers + [reader])
    assert errors == []
    assert seen <= {("t0", 51), ("t1", 101)} and seen
    assert os.listdir(sinks[0].dir) == [os.path.basename(sinks[0].path)]


def test_torch_profile_capture_is_merged(tmp_home):
    import torch

    from kubeml_tpu_torch.utils.trace import (merge_job_trace, torch_profile,
                                              trace_dir)

    with torch_profile(trace_dir("profjob")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    doc = merge_job_trace("profjob")
    name = f"torch-{os.getpid()}.trace.json"
    assert doc["metadata"]["sources"] == [name]
    assert any("mm" in str(e.get("name", "")) for e in doc["traceEvents"])


def test_torch_profile_degrades_when_the_profiler_cannot_start(
        tmp_path, monkeypatch, caplog):
    import torch

    from kubeml_tpu_torch.utils.trace import torch_profile

    def boom(*a, **k):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(torch.profiler, "profile", boom)
    ran = []
    with caplog.at_level("WARNING", logger="kubeml_tpu_torch.trace"):
        with torch_profile(str(tmp_path / "prof")):
            ran.append(True)
    assert ran and "could not start trace" in caplog.text
    assert not os.listdir(tmp_path / "prof")


# ------------------------------------------------------------- the job


def _blobs(n_train=600, n_test=120, dim=8, classes=4):
    rng = np.random.RandomState(0)

    def split(n):
        y = rng.randint(0, classes, n).astype(np.int32)
        x = rng.randn(n, dim).astype(np.float32) * 2.0
        x[np.arange(n), y % dim] += 3.0
        return x, y
    return (*split(n_train), *split(n_test))


def _mask(line: str) -> str:
    """An epoch log line with its timestamp, job id and numbers masked."""
    line = line.split(" INFO ", 1)[1]
    line = re.sub(r"^job \S+", "job J", line)
    return re.sub(r"\d+(\.\d+)?|nan", "#", line)


@pytest.mark.parametrize("group", [1, 2])
def test_job_phase_times_and_log_line_match_reference(tmp_home, tmp_path,
                                                      group):
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train import job as ref_job
    from kubeml_tpu_torch.api import types as port_types
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train import job as port_job
    from kubeml_tpu_torch.utils.trace import merge_job_trace

    DatasetRegistry().create("blobs", *_blobs())
    runs = {}
    for key, types, mod, model, ds, where in (
            ("ref", ref_types, ref_job, get_builtin("mlp"), RefDataset,
             make_mesh(n_data=1)),
            ("port", port_types, port_job, get_model("mlp"), KubeDataset,
             "cpu")):
        task = types.TrainTask(
            job_id=f"{key}trace{group}", parallelism=2,
            parameters=types.TrainRequest(
                model_type="mlp", batch_size=32, epochs=2, dataset="blobs",
                lr=0.1, options=types.TrainOptions(
                    default_parallelism=2, static_parallelism=True, k=2,
                    rounds_per_dispatch=group)))
        published = []
        log = str(tmp_path / f"{key}.log")
        job = mod.TrainJob(task, model(hidden=16, num_classes=4), ds("blobs"),
                           where, log_file=log,
                           callbacks=mod.JobCallbacks(
                               publish_metrics=published.append))
        job.train()
        with open(log) as f:
            lines = [ln for ln in f if " epoch " in ln and "loss=" in ln]
        runs[key] = (job, published, lines)
    (job, pub, lines), (_, ref_pub, ref_lines) = runs["port"], runs["ref"]
    assert [sorted(m.phase_times) for m in pub] == \
        [sorted(m.phase_times) for m in ref_pub]
    assert ("merge_overlap" in pub[0].phase_times) == (group > 1)
    assert [m.trace_events_dropped for m in pub] == [0, 0]
    assert len(lines) == len(ref_lines) == 2
    assert [_mask(ln) for ln in lines] == [_mask(ln) for ln in ref_lines]
    assert "epoch 2/2" in lines[1] and "round=" in lines[1]

    doc = merge_job_trace(job.task.job_id)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert doc["metadata"]["trace_ids"] == [job.task.trace_id]
    assert [e["args"]["epoch"] for e in spans if e["name"] == "epoch"] \
        == [0, 1]
    rounds = [e for e in spans if e["name"] == "round"]
    assert all(e["args"]["parent"] == "epoch" for e in rounds)
    assert [e for e in rounds if e["args"].get("tail")]
    key = "rounds" if group > 1 else "workers"
    assert [e for e in rounds if e["args"].get(key)]
    assert all(e["args"]["parent"] == "round" for e in spans
               if e["name"] in ("dispatch", "data_wait"))
