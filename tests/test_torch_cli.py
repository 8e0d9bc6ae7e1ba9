"""Port parity: the kubeml CLI of kubeml_tpu_torch (cli/main.py) against
the JAX package's (kubeml_tpu/cli/main.py).

- the parser: every verb's argv gives the same Namespace as the
  reference's (but the port-only ``serve --device``), and every option
  the same flags, default, choices and help (but the few help strings
  that describe the port);
- ``_render_top``: the same screen for the same verdict documents;
- the reference's CLI flow (tests/test_cli.py) against a CPU port
  deployment: dataset, fn, train, history, infer, logs, prune; its
  validation errors; ``trace --out`` with client, scheduler, PS and job
  spans under one trace id; ``health`` and ``top --iterations 1`` on a
  running job;
- every flag of a landed ROADMAP item reaches the job or the runtime,
  and a refused flag combination exits non-zero with the reference's
  words; ``serve`` without ``--device`` needs a card;
- the four roles as separate ``serve --role`` processes train a job;
- a ``gpu`` twin: ``serve --role all`` on the card, driven by CLI
  processes.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    ["train", "-f", "mlp", "-d", "blobs", "-e", "2", "--lr", "0.1"],
    ["train", "-f", "gpt-mini", "-d", "toks", "-e", "1", "--lr", "0.001",
     "-b", "8", "-p", "3", "--static", "-K", "4", "--sparse-avg",
     "--goal-accuracy", "90", "--resume-from", "abc",
     "--checkpoint-every", "-1", "--engine", "syncdp", "--shuffle",
     "--tensor-parallel", "2", "--seq-parallel", "2",
     "--expert-parallel", "2", "--pipeline-parallel", "2",
     "--pp-microbatches", "4", "--fsdp", "--rounds-per-dispatch", "3",
     "--merge-dtype", "bf16", "--merge-compress", "int8",
     "--merge-bucket-mb", "4", "--seq-impl", "ulysses", "--tp-impl",
     "manual", "--max-parallelism", "4", "--max-restarts", "2",
     "--checkpoint-every-rounds", "5", "--quarantine-after", "2",
     "--priority", "1", "--tenant", "prod", "--continual",
     "--window-generations", "2", "--publish-every-rounds", "3",
     "--reassign-on-quarantine"],
    ["infer", "-n", "abc", "--datafile", "x.npy"],
    ["dataset", "create", "-n", "d", "--traindata", "a", "--trainlabels",
     "b", "--testdata", "c", "--testlabels", "e"],
    ["dataset", "append", "-n", "d", "--traindata", "a", "--trainlabels",
     "b", "--generation", "3", "--retention", "2"],
    ["dataset", "delete", "-n", "d"],
    ["dataset", "list"],
    ["fn", "create", "-n", "f", "--code", "f.py"],
    ["fn", "delete", "-n", "f"],
    ["fn", "list"],
    ["task", "list"],
    ["task", "stop", "--id", "abc"],
    ["task", "prune"],
    ["history", "get", "--id", "abc"],
    ["history", "delete", "--id", "abc"],
    ["history", "list"],
    ["history", "prune"],
    ["logs", "--id", "abc"],
    ["logs", "--id", "abc", "-f"],
    ["trace", "--id", "abc"],
    ["trace", "--id", "abc", "-o", "t.json"],
    ["cost", "--id", "abc", "--json"],
    ["health", "--id", "abc"],
    ["top", "--id", "abc"],
    ["top", "--id", "abc", "--interval", "0.5", "--iterations", "1"],
    ["--controller", "http://h:1", "task", "list"],
    ["serve"],
    ["serve", "--role", "ps", "--port", "9999", "--scheduler-url",
     "http://h:1", "--ps-url", "http://h:2", "--storage-url", "http://h:3",
     "--standalone-jobs", "--job-partition", "CUDA_VISIBLE_DEVICES=0",
     "--job-partition", "CUDA_VISIBLE_DEVICES=1;X=2",
     "--infer-cache-size", "2", "--free-ports"],
    ["serve", "--coordinator", "h:1", "--num-processes", "2",
     "--process-id", "1", "--mesh-data", "4", "--serve-slots", "4",
     "--serve-queue-depth", "8", "--serve-prefill-chunk", "0",
     "--serve-kv-dtype", "int8", "--serve-decode-steps", "2",
     "--serve-draft-model", "m", "--serve-prefix-cache", "off",
     "--serve-drain-grace-s", "1", "--serve-replicas-min", "0",
     "--serve-replicas-max", "2", "--serve-scale-to-zero-s", "3",
     "--serve-replica-restart-budget", "1", "--serve-probe-requests", "1",
     "--serve-hedge-after-s", "0.5", "--serve-slo-ttft-ms", "100",
     "--serve-slo-tpot-ms", "10", "--serve-slo-target", "0.9",
     "--cluster-lanes", "4", "--cluster-tenant", "prod=2:3",
     "--cluster-tenant", "batch=1", "--cluster-aging-s", "10",
     "--control-durable", "--control-dir", "/tmp/x"],
]


def _parsers(monkeypatch):
    from kubeml_tpu.cli.main import build_parser as ref_parser
    from kubeml_tpu_torch.cli.main import build_parser

    monkeypatch.setenv("KUBEML_CONTROLLER_URL", "http://env:1")
    return build_parser(), ref_parser()


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a[:3]) + f" #{i}"
                                             for i, a in enumerate(ARGVS)])
def test_parser_gives_the_references_namespace(argv, monkeypatch):
    port, ref = _parsers(monkeypatch)
    got, want = vars(port.parse_args(argv)), vars(ref.parse_args(argv))
    assert got.pop("fn").__name__ == want.pop("fn").__name__
    if argv[0] == "serve":
        assert got.pop("device") is None
    assert got == want


# help strings that describe the port (its job role, its card variable,
# its home, the multi-host flags it refuses, no TPU measurement, its
# eager multi-step program)
PORT_HELP = {("serve", "--role"), ("serve", "--job-partition"),
             ("serve", "--control-dir"), ("serve", "--coordinator"),
             ("serve", "--num-processes"), ("serve", "--process-id"),
             ("serve", "--mesh-data"), ("train", "--rounds-per-dispatch"),
             ("serve", "--serve-decode-steps")}


def _options(parser, path=()):
    """{(verb path, first flag): (flags, dest, default, choices, required,
    metavar, help)} over every subparser."""
    import argparse

    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_options(sub, path + (name,)))
        elif not isinstance(action, argparse._HelpAction):
            key = (" ".join(path), (action.option_strings or
                                    [action.dest])[-1])
            out[key] = (tuple(action.option_strings), action.dest,
                        action.default, action.choices, action.required,
                        action.metavar, action.help)
    return out


def test_options_and_help_equal_the_references(monkeypatch):
    port, ref = _parsers(monkeypatch)
    got, want = _options(port), _options(ref)
    assert got.pop(("serve", "--device"))[1] == "device"
    assert set(got) == set(want)
    for key in got:
        if key in PORT_HELP:
            assert got[key][:-1] == want[key][:-1], key
        else:
            assert got[key] == want[key], key


TOP_DOCS = {
    "training": {
        "id": "j1", "state": "critical",
        "reasons": [{"rule": "worker_divergence", "severity": "critical",
                     "detail": "dropped 1"},
                    {"rule": "straggler", "severity": "warning",
                     "detail": "slow"}],
        "latest": {"parallelism": 3, "train_loss": 0.25,
                   "epoch_duration": 1.5, "worker_losses": [0.2, 0.3],
                   "grad_norms": [0.5, 0.6, 0.7], "update_ratios": [1e-3],
                   "loss_spread": 0.05,
                   "phase_times": {"dispatch": [0.1, 0.3],
                                   "merge_wait": [0.01],
                                   "merge_overlap": [0.02, 0.03]},
                   "hbm_peak_bytes": 3 << 30, "hbm_in_use_bytes": 5 << 20,
                   "jit_compiles": 2, "dropped_workers": 1.0,
                   "quarantined_workers": 0}},
    "unknown": {"id": "j2", "state": "unknown", "reasons": [], "latest": {}},
    "serving": {
        "id": "serve:m", "state": "warning", "reasons": [],
        "latest": {"serve_slot_cap": 8, "serve_active_slots": 3,
                   "serve_queue_depth": 1, "serve_queue_cap": 16,
                   "serve_kv_page_utilization": 0.25,
                   "serve_ttft_p50": 0.05, "serve_ttft_p99": 0.2,
                   "serve_rejected_total": 2,
                   "serve_prefill_backlog_tokens": 40,
                   "serve_prefix_hit_pct": 12.5,
                   "serve_ttft_queue_s": 0.01, "serve_ttft_prefill_s": 0.03,
                   "serve_ttft_interleave_s": 0.01,
                   "serve_kv_bytes_per_token": 2048,
                   "serve_kv_dtype": "int8",
                   "serve_dispatches_per_token": 0.5,
                   "serve_accepted_per_dispatch": 2.5,
                   "serve_engine_restarts": 1, "serve_poisoned_total": 0,
                   "serve_deadline_total": 3, "fleet_replicas": 2,
                   "fleet_replicas_min": 1, "fleet_replicas_max": 4,
                   "serve_slo_attainment": 0.97, "serve_slo_target": 0.99,
                   "serve_slo_burn_fast": 1.5, "serve_slo_burn_slow": 0.5,
                   "fleet_ejections_total": 1, "fleet_probation": 1}},
    "continual_and_cluster": {
        "id": "cluster", "state": "healthy", "reasons": [],
        "latest": {"data_lag_generations": 1, "dataset_generation": 4,
                   "serve_weight_generation": 3, "cluster_pool_lanes": 8,
                   "cluster_lanes_in_use": 6, "cluster_running_jobs": 2,
                   "cluster_queue_depth": 3, "cluster_oldest_wait_s": 12.5,
                   "cluster_queue_by_priority": {"0": 2, "2": 1},
                   "cluster_tenant_lanes": {"prod": 4, "batch": 2},
                   "cluster_tenant_quota": {"prod": 6},
                   "cluster_journal_records_total": 10,
                   "cluster_recoveries_total": 1}},
}


@pytest.mark.parametrize("name", sorted(TOP_DOCS))
def test_top_screen_equals_the_references(name):
    from kubeml_tpu.cli.main import _render_top as ref_render
    from kubeml_tpu_torch.cli.main import _render_top

    assert _render_top(TOP_DOCS[name]) == ref_render(TOP_DOCS[name])


_COST_ENTRY = {"program": "kavg.train", "plane": "train", "flops": 5.0,
               "hbm_bytes": 9.0, "transcendentals": 0.0,
               "peak_temp_bytes": 0, "argument_bytes": 0,
               "output_bytes": 0, "source": "fallback", "dispatches": 4,
               "flops_total": 2.5e9, "hbm_bytes_total": 7.5e8,
               "transcendentals_total": 0.0, "samples": 640, "tokens": 0,
               "recaptures": 0}
COST_DOCS = {
    "train": {"cost_programs": {"kavg.train": _COST_ENTRY}},
    "serve": {"serve_cost_programs": {"serve.decode": dict(
        _COST_ENTRY, program="serve.decode", plane="serve", samples=0,
        tokens=288)}},
    "records_only": {"cost_programs": {"merge.bucketed": dict(
        _COST_ENTRY, program="merge.bucketed", plane="kernel",
        dispatches=0, samples=0)}},
}


@pytest.mark.parametrize("name", sorted(COST_DOCS))
def test_top_cost_pane_equals_the_references(name):
    """The cost pane attributes a verdict's ledger snapshot per sample and
    per token as the reference's does (a snapshot with no samples and no
    tokens prints no pane)."""
    from kubeml_tpu.cli.main import _render_top as ref_render
    from kubeml_tpu_torch.cli.main import _render_top

    doc = {"id": "j", "state": "healthy", "reasons": [],
           "latest": dict(COST_DOCS[name])}
    got = _render_top(doc)
    assert got == ref_render(doc)
    assert ("cost: " in got) == (name != "records_only")
    assert "cost:" not in _render_top(TOP_DOCS["training"])


@pytest.mark.parametrize("spec", ["CUDA_VISIBLE_DEVICES=0,1",
                                  "A=1;B=2,3; C = x=y ;", ""])
def test_env_spec_parser_equals_the_references(spec):
    from kubeml_tpu.utils.env import parse_env_spec as ref_parse
    from kubeml_tpu_torch.cli.main import parse_env_spec

    assert parse_env_spec(spec) == ref_parse(spec)
    with pytest.raises(ValueError):
        parse_env_spec("novalue")


# ------------------------------------------------------- a CPU deployment


def _blob_paths(tmp_path):
    rng = np.random.RandomState(0)
    y = rng.randint(0, 3, 600).astype(np.int32)
    x = rng.randn(600, 8).astype(np.float32) * 1.5
    x[np.arange(600), y * 2] += 3.0
    paths = {}
    for name, arr in (("xtr", x), ("ytr", y), ("xte", x[:100]),
                      ("yte", y[:100])):
        p = tmp_path / f"{name}.npy"
        np.save(p, arr)
        paths[name] = str(p)
    return paths


@pytest.fixture()
def stack(tmp_path, tmp_home, monkeypatch):
    from kubeml_tpu_torch.control.deployment import start_deployment

    dep = start_deployment(device="cpu")
    monkeypatch.setenv("KUBEML_CONTROLLER_URL", dep.controller_url)
    yield dep, _blob_paths(tmp_path), tmp_path
    dep.stop()


def run_cli(dep, *argv):
    from kubeml_tpu_torch.cli.main import main
    return main(["--controller", dep.controller_url] + list(argv))


def _create_blobs(dep, paths):
    run_cli(dep, "dataset", "create", "-n", "blobs",
            "--traindata", paths["xtr"], "--trainlabels", paths["ytr"],
            "--testdata", paths["xte"], "--testlabels", paths["yte"])


def _wait_history(job_id, timeout=120):
    from kubeml_tpu_torch.train.history import HistoryStore

    deadline = time.time() + timeout
    while time.time() < deadline:
        if any(h.id == job_id for h in HistoryStore().list()):
            return
        time.sleep(0.2)
    raise TimeoutError(job_id)


def test_cli_full_flow(stack, capsys):
    dep, paths, tmp_path = stack
    _create_blobs(dep, paths)
    assert "created dataset blobs" in capsys.readouterr().out

    run_cli(dep, "dataset", "list")
    assert "blobs" in capsys.readouterr().out

    run_cli(dep, "fn", "list")
    assert "mlp" in capsys.readouterr().out

    run_cli(dep, "train", "-f", "mlp", "-d", "blobs", "-e", "2", "-b", "32",
            "--lr", "0.1", "-p", "2", "--static")
    job_id = capsys.readouterr().out.strip()
    assert len(job_id) == 8
    _wait_history(job_id)
    assert dep.ps.wait_for_job(job_id, timeout=60)

    run_cli(dep, "history", "list")
    assert job_id in capsys.readouterr().out

    run_cli(dep, "history", "get", "--id", job_id)
    h = json.loads(capsys.readouterr().out)
    assert len(h["data"]["train_loss"]) == 2

    df = tmp_path / "in.npy"
    np.save(df, np.zeros((3, 8), np.float32))
    run_cli(dep, "infer", "-n", job_id, "--datafile", str(df))
    assert len(json.loads(capsys.readouterr().out)) == 3

    # the job's log file holds the epochs with the tracer's summary
    run_cli(dep, "logs", "--id", job_id)
    out = capsys.readouterr().out
    assert "epoch 1/2" in out and "epoch 2/2" in out
    assert "dispatch=" in out and "merge_wait=" in out

    run_cli(dep, "task", "list")
    assert "HEALTH" in capsys.readouterr().out

    run_cli(dep, "history", "delete", "--id", job_id)
    capsys.readouterr()
    run_cli(dep, "task", "prune")
    assert "pruned 1 orphaned" in capsys.readouterr().out
    run_cli(dep, "history", "prune")
    assert "pruned 0 histories" in capsys.readouterr().out


def test_cli_validation_errors(stack, capsys):
    dep, paths, _ = stack
    _create_blobs(dep, paths)
    capsys.readouterr()
    with pytest.raises(SystemExit):
        run_cli(dep, "train", "-f", "mlp", "-d", "nope", "-e", "1",
                "--lr", "0.1")
    assert "nope" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_cli(dep, "train", "-f", "nope", "-d", "blobs", "-e", "1",
                "--lr", "0.1")
    assert "nope" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_cli(dep, "train", "-f", "mlp", "-d", "blobs", "-e", "1",
                "-b", "4096", "--lr", "0.1")
    assert "batch" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_cli(dep, "train", "-f", "mlp", "-d", "blobs", "-e", "1",
                "--lr", "0.1", "--tensor-parallel", "0")
    assert ">= 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_cli(dep, "logs", "--id", "nosuchjob")
    assert "no logs for job nosuchjob" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        run_cli(dep, "trace", "--id", "nosuchjob")
    assert "no trace recorded" in capsys.readouterr().err


TRAIN = ["train", "-f", "mlp", "-d", "blobs", "-e", "1", "--lr", "0.1"]
# item None: the degraded-mode and continual flags and ``dataset append``
# (ROADMAP A.4.5, landed) and the SyncDP engine's (A.11, landed) reach the
# job and the storage service; item SERVED: serve's multi-process flags
# (A.7, landed) reach ``initialize`` and the deployment; an item that
# names no ROADMAP entry is the JAX package's own refusal of a flag
# combination
SERVED = "serve"
# --seq-parallel and --expert-parallel (ROADMAP A.6, landed),
# --tensor-parallel and --pipeline-parallel (A.12, landed) reach the job,
# which answers the reference's 400 in one process without a group
SEQ_400 = ("1 devices not divisible by the requested model x seq x stage "
           "x expert factor 2")
REFUSED = [
    (TRAIN + ["--engine", "syncdp"], None),
    (TRAIN + ["--engine", "syncdp", "--fsdp"], None),
    (TRAIN + ["--tensor-parallel", "2"], SEQ_400),
    (TRAIN + ["--seq-parallel", "2"], SEQ_400),
    (TRAIN + ["--expert-parallel", "2"], SEQ_400),
    (TRAIN + ["--pipeline-parallel", "2"], SEQ_400),
    (TRAIN + ["--continual"], None),
    (TRAIN + ["--quarantine-after", "2"], None),
    (TRAIN + ["--checkpoint-every-rounds", "3"], None),
    (["dataset", "append", "-n", "blobs", "--traindata", "{xtr}",
      "--trainlabels", "{ytr}"], None),
    (["serve", "--coordinator", "h:1"], SERVED),
    (["serve", "--num-processes", "2"], SERVED),
    (["serve", "--process-id", "0"], SERVED),
    (["serve", "--mesh-data", "2"], SERVED),
    (TRAIN + ["--continual", "--window-generations", "2"], None),
    (TRAIN + ["--continual", "--publish-every-rounds", "3"], None),
    (TRAIN + ["--quarantine-after", "2", "--reassign-on-quarantine"],
     None),
    (TRAIN + ["--engine", "syncdp", "--merge-compress", "int8"], None),
    (TRAIN + ["--engine", "syncdp", "--merge-bucket-mb", "4"], None),
    (TRAIN + ["--fsdp"], "--fsdp requires --engine syncdp"),
    (TRAIN + ["--continual", "--engine", "syncdp", "--publish-every-rounds",
              "3"], "--publish-every-rounds requires --engine kavg"),
]


def _assert_serve_flags_reach_the_runtime(monkeypatch, argv):
    """``serve`` with a multi-process flag: --coordinator, --num-processes
    and --process-id reach ``initialize`` (with the serve's device)
    before the deployment starts, and --mesh-data becomes its jobs'
    lanes. The services are stubbed: nothing binds, and the serve loop
    ends at its first sleep."""
    from kubeml_tpu_torch.cli import main as cli
    from kubeml_tpu_torch.control import deployment
    from kubeml_tpu_torch.parallel import distributed

    calls = []

    class _Svc:
        controller = scheduler = ps = storage = \
            type("S", (), {"url": "http://stub"})()

        def stop(self):
            calls.append(("stop",))

    def sleep(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(distributed, "initialize",
                        lambda *a, **k: calls.append(("init", a, k)))
    monkeypatch.setattr(deployment, "start_deployment",
                        lambda **k: calls.append(("deploy", k)) or _Svc())
    monkeypatch.setattr(cli.time, "sleep", sleep)
    monkeypatch.setattr(cli.signal, "signal", lambda *a: None)
    cli.main(list(argv) + ["--device", "cpu", "--free-ports"])
    flag, value = argv[1], argv[2]
    want = {"--coordinator": ("h:1", None, None),
            "--num-processes": (None, 2, None),
            "--process-id": (None, None, 0)}.get(flag, (None, None, None))
    assert calls[0] == ("init", want, {"device": "cpu"})
    assert calls[1][0] == "deploy" and calls[2] == ("stop",)
    assert calls[1][1]["n_lanes"] == (int(value) if flag == "--mesh-data"
                                      else 1)
    assert calls[1][1]["device"] == "cpu"


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[" ".join(a[:1] + a[8:] if a[0] == "train"
                                       else a[:4]) for a, _ in REFUSED])
def test_refused_verbs_and_flags_name_their_item(stack, capsys, monkeypatch,
                                                 argv, item):
    dep, paths, _ = stack
    if item == SERVED:
        _assert_serve_flags_reach_the_runtime(monkeypatch, argv)
        return
    _create_blobs(dep, paths)
    capsys.readouterr()
    if item is None and argv[0] == "dataset":
        # a generation of the continual mode, committed and reported
        from kubeml_tpu_torch.data.registry import DatasetRegistry

        run_cli(dep, *[a.format(**paths) for a in argv])
        n = len(np.load(paths["xtr"]))
        assert capsys.readouterr().out.strip() == (
            f"appended to dataset blobs (generation=2, train={2 * n})")
        assert DatasetRegistry().get("blobs").generation == 2
        return
    if item == SEQ_400:
        # submitted: the job fails with the reference's 400 in the PS
        run_cli(dep, *argv)
        job_id = capsys.readouterr().out.strip()
        deadline = time.monotonic() + 60   # the PS starts it after the reply
        while job_id not in dep.ps.errors:
            assert time.monotonic() < deadline, "the job did not fail"
            time.sleep(0.1)
        assert SEQ_400 in dep.ps.errors[job_id]
        assert "ROADMAP" not in dep.ps.errors[job_id]
        return
    if item is None:
        # submitted: the job runs with the options the flags set
        from kubeml_tpu_torch.train.history import HistoryStore

        run_cli(dep, *argv)
        job_id = capsys.readouterr().out.strip()
        _wait_history(job_id)
        assert dep.ps.wait_for_job(job_id, timeout=60)
        rec = HistoryStore().get(job_id)
        opts = rec.task.options
        assert (opts.quarantine_after, opts.checkpoint_every_rounds,
                opts.reassign_on_quarantine, opts.continual,
                opts.window_generations, opts.publish_every_rounds) == (
            2 if "--quarantine-after" in argv else 0,
            3 if "--checkpoint-every-rounds" in argv else 0,
            "--reassign-on-quarantine" in argv, "--continual" in argv,
            2 if "--window-generations" in argv else 0,
            3 if "--publish-every-rounds" in argv else 0)
        assert (opts.engine, opts.fsdp, opts.merge_compress,
                opts.merge_bucket_mb) == (
            "syncdp" if "syncdp" in argv else "kavg", "--fsdp" in argv,
            "int8" if "--merge-compress" in argv else "none",
            4.0 if "--merge-bucket-mb" in argv else 0.0)
        assert rec.data.quarantined_workers == [0]
        assert rec.data.reassigned_batches == [0]
        assert dep.ps.errors == {}
        return
    with pytest.raises(SystemExit) as ei:
        run_cli(dep, *[a.format(**paths) for a in argv])
    assert ei.value.code not in (0, None)
    err = capsys.readouterr().err
    assert err.startswith("error: ") and item in err, err
    assert dep.ps.jobs == {}  # nothing was submitted


@pytest.mark.parametrize("form", ["table", "json", "unknown id", "syncdp"])
def test_cost_verb_prints_the_references_output(stack, capsys, form):
    """``kubeml cost`` on the port's deployment prints what the JAX
    package's CLI prints against the same controller: the same table,
    the same JSON document, the same error for an id with no cost; a
    syncdp job's table shows the SyncDP engine's records."""
    from kubeml_tpu.cli.main import main as ref_main

    dep, paths, _ = stack
    _create_blobs(dep, paths)
    engine = (["--engine", "syncdp", "--merge-compress", "bf16"]
              if form == "syncdp" else [])
    run_cli(dep, "train", "-f", "mlp", "-d", "blobs", "-e", "1", "-b", "32",
            "--lr", "0.1", "-p", "2", "--static", *engine)
    job_id = capsys.readouterr().out.strip().splitlines()[-1]
    _wait_history(job_id)
    assert dep.ps.wait_for_job(job_id, timeout=60)
    argv = ["cost", "--id", "nosuch" if form == "unknown id" else job_id]
    if form == "json":
        argv.append("--json")
    outs = []
    for main in (run_cli, lambda dep, *a: ref_main(
            ["--controller", dep.controller_url] + list(a))):
        capsys.readouterr()
        if form == "unknown id":
            with pytest.raises(SystemExit) as ei:
                main(dep, *argv)
            assert ei.value.code not in (0, None)
        else:
            main(dep, *argv)
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out and outs[0].err == outs[1].err
    if form == "json":
        doc = json.loads(outs[0].out)
        assert doc["id"] == job_id
        # the mlp's rounds run from the device cache
        assert doc["programs"]["kavg.train_indexed"]["samples"] == 600
    elif form == "table":
        assert "kavg.train_indexed" in outs[0].out
        assert "fallback" in outs[0].out
    elif form == "syncdp":
        assert "syncdp.train_indexed" in outs[0].out
        assert "merge.ef_bf16" in outs[0].out
        assert "kavg.train" not in outs[0].out
    else:
        assert "nosuch" in outs[0].err


@pytest.mark.parametrize("argv", [["fn", "list"], ["history", "list"],
                                  ["task", "list"], ["--help"]])
def test_client_verbs_never_import_torch(argv, tmp_home):
    """A client verb only speaks HTTP to the controller: the package, the
    CLI and the verb's own imports leave torch unloaded (a cold ``kubeml``
    call pays no torch import). Nothing listens, so a verb may fail."""
    code = ("import sys\n"
            "from kubeml_tpu_torch.cli.main import main\n"
            "try:\n"
            f"    main({argv!r})\n"
            "except SystemExit:\n"
            "    pass\n"
            "assert 'torch' not in sys.modules, 'the CLI imported torch'\n"
            "print('no torch')\n")
    env = dict(os.environ, KUBEML_CONTROLLER_URL="http://127.0.0.1:9")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "no torch" in res.stdout, res.stderr


def test_serve_without_device_needs_a_card(tmp_home, capsys):
    import torch

    from kubeml_tpu_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("the card is present")
    for role in ("all", "ps"):
        with pytest.raises(SystemExit) as ei:
            main(["serve", "--role", role, "--free-ports"])
        assert ei.value.code not in (0, None)
        assert "CUDA" in capsys.readouterr().err


def test_trace_out_lists_the_four_processes(stack, capsys):
    dep, paths, tmp_path = stack
    _create_blobs(dep, paths)
    run_cli(dep, "train", "-f", "mlp", "-d", "blobs", "-e", "2", "-b", "32",
            "--lr", "0.1", "-p", "2", "--static")
    job_id = capsys.readouterr().out.strip().splitlines()[-1]
    _wait_history(job_id)
    assert dep.ps.wait_for_job(job_id, timeout=60)
    out = tmp_path / "trace.json"
    run_cli(dep, "trace", "--id", job_id, "-o", str(out))
    line = capsys.readouterr().out
    doc = json.loads(out.read_text())
    meta = doc["metadata"]
    assert len(meta["trace_ids"]) == 1
    assert f"from 4 file(s), trace_id(s) {meta['trace_ids'][0]}" in line
    assert sorted(s.split("-")[0] for s in meta["sources"]) == [
        "client", "job", "ps", "scheduler"]
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"client.train", "scheduler.enqueue", "ps.start_task", "epoch",
            "round", "dispatch", "data_wait", "merge_wait"} <= names
    # stdout form: the same document
    run_cli(dep, "trace", "--id", job_id)
    assert json.loads(capsys.readouterr().out)["metadata"] == meta


def test_health_and_top_on_a_running_job(stack, capsys):
    from tests.test_torch_health import wait_health

    dep, paths, _ = stack
    _create_blobs(dep, paths)
    run_cli(dep, "train", "-f", "mlp", "-d", "blobs", "-e", "500", "-b",
            "32", "--lr", "0.1", "-p", "2", "--static")
    job_id = capsys.readouterr().out.strip().splitlines()[-1]
    try:
        wait_health(dep.ps.url, job_id,
                    want=("healthy", "warning", "critical"))
        run_cli(dep, "health", "--id", job_id)
        doc = json.loads(capsys.readouterr().out)
        assert doc["id"] == job_id and doc["state"] != "unknown"
        assert doc["latest"]["parallelism"] == 2
        run_cli(dep, "top", "--id", job_id, "--iterations", "1")
        out = capsys.readouterr().out
        assert f"job {job_id}  state=" in out and "state=unknown" not in out
        assert "WORKER" in out and "GRAD_NORM" in out
        assert "dispatch: n=" in out and "merge: wait=" in out
        run_cli(dep, "task", "list")
        row = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith(job_id)]
        assert row and "running" in row[0]
        run_cli(dep, "task", "stop", "--id", job_id)
        assert f"stop requested for {job_id}" in capsys.readouterr().out
        assert dep.ps.wait_for_job(job_id, timeout=120)
    finally:
        if job_id in dep.ps.jobs:
            dep.ps.jobs[job_id].request_stop()
    run_cli(dep, "health", "--id", job_id)
    assert json.loads(capsys.readouterr().out)["state"] == "unknown"


# ------------------------------------------------ processes of the CLI


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_up(url, proc, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"role process died with {proc.returncode}")
        try:
            urllib.request.urlopen(url + "/health", timeout=2)
            return
        except (urllib.error.URLError, OSError):
            time.sleep(0.3)
    raise AssertionError(f"{url} never became healthy")


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _env(home):
    env = dict(os.environ, KUBEML_TPU_HOME=str(home), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("KUBEML_CONTROLLER_URL", None)
    return env


def test_four_roles_as_processes_train_a_job(tmp_home, tmp_path):
    from kubeml_tpu_torch.cli.main import main

    env = _env(tmp_home)
    ports = {r: _free_port() for r in ("storage", "ps", "scheduler",
                                       "controller")}
    urls = {r: f"http://127.0.0.1:{p}" for r, p in ports.items()}

    def serve(role, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "serve", "--role",
             role, "--port", str(ports[role]), *extra], env=env, cwd=REPO)

    procs = [serve("storage"),
             serve("ps", "--device", "cpu", "--scheduler-url",
                   urls["scheduler"]),
             serve("scheduler", "--ps-url", urls["ps"]),
             serve("controller", "--scheduler-url", urls["scheduler"],
                   "--ps-url", urls["ps"], "--storage-url", urls["storage"])]
    try:
        for role, proc in zip(("storage", "ps", "scheduler", "controller"),
                              procs):
            _wait_up(urls[role], proc)
        paths = _blob_paths(tmp_path)
        cli = ["--controller", urls["controller"]]
        main(cli + ["dataset", "create", "-n", "blobs", "--traindata",
                    paths["xtr"], "--trainlabels", paths["ytr"],
                    "--testdata", paths["xte"], "--testlabels",
                    paths["yte"]])
        from kubeml_tpu_torch.control.client import KubemlClient
        from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest

        client = KubemlClient(urls["controller"]).v1()
        job_id = client.networks().train(TrainRequest(
            model_type="mlp", batch_size=32, epochs=2, dataset="blobs",
            lr=0.1, options=TrainOptions(default_parallelism=2,
                                         static_parallelism=True, k=2)))
        deadline, hist = time.time() + 240, None
        while time.time() < deadline and hist is None:
            try:
                hist = client.histories().get(job_id)
            except Exception as e:  # 404 until the job ends
                assert getattr(e, "status_code", None) == 404, e
                time.sleep(0.3)
        assert hist is not None and len(hist.data.train_loss) == 2
        assert hist.data.train_loss[-1] < hist.data.train_loss[0]
        doc = client.traces().get(job_id)
        assert sorted(s.split("-")[0] for s in doc["metadata"]["sources"]) \
            == ["client", "job", "ps", "scheduler"]
    finally:
        _stop(procs)
    assert all(p.returncode is not None for p in procs)


@pytest.mark.gpu
def test_cli_drives_a_deployment_on_the_card(tmp_path):
    """``serve --role all`` without --device on the card, driven by CLI
    processes: a job trains there, its live verdict is read by
    ``health``, and ``trace`` lists the four processes."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    home = tmp_path / "home"
    env = _env(home)
    server = subprocess.Popen(
        [sys.executable, "-m", "kubeml_tpu_torch.cli", "serve", "--role",
         "all", "--free-ports"], env=env, cwd=REPO, stdout=subprocess.PIPE,
        text=True)

    def cli(*argv):
        res = subprocess.run(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "--controller",
             url, *argv], env=env, cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr
        return res.stdout
    try:
        url = server.stdout.readline().split()[-1]
        paths = _blob_paths(tmp_path)
        cli("dataset", "create", "-n", "blobs", "--traindata", paths["xtr"],
            "--trainlabels", paths["ytr"], "--testdata", paths["xte"],
            "--testlabels", paths["yte"])
        job_id = cli("train", "-f", "mlp", "-d", "blobs", "-e", "400", "-b",
                     "32", "--lr", "0.1", "-p", "2", "--static").strip()
        from kubeml_tpu_torch.control.httpd import http_json
        deadline = time.time() + 120
        while http_json("GET", f"{url}/health/{job_id}")["state"] == \
                "unknown":
            assert time.time() < deadline
            time.sleep(0.1)
        assert json.loads(cli("health", "--id", job_id))["state"] != \
            "unknown"
        cli("task", "stop", "--id", job_id)
        out = tmp_path / "t.json"
        cli("trace", "--id", job_id, "-o", str(out))
        meta = json.loads(out.read_text())["metadata"]
        assert len(meta["trace_ids"]) == 1
        assert sorted(s.split("-")[0] for s in meta["sources"]) == [
            "client", "job", "ps", "scheduler"]
    finally:
        _stop([server])


@pytest.mark.parametrize("role", ["all", "ps"])
def test_serve_passes_the_serve_knobs_through(role, monkeypatch, capsys):
    """`kubeml serve --serve-...` hands every serving knob to the
    deployment (--role all) or the PS (--role ps); unset ones stay None
    (their KUBEML_SERVE_* variable or default)."""
    from kubeml_tpu_torch.cli import main as cli
    from kubeml_tpu_torch.control import deployment, ps

    got = {}

    class Stopped:
        url = controller_url = "http://h:1"

        def __init__(self, **kw):
            got.update(kw)
            self.controller = self.scheduler = self.ps = self.storage = self

        def start(self):
            pass

        def stop(self):
            got["stopped"] = True

    def interrupt(_seconds):
        raise KeyboardInterrupt

    monkeypatch.setattr(deployment, "start_deployment",
                        lambda **kw: Stopped(**kw))
    monkeypatch.setattr(ps, "ParameterServer", Stopped)
    monkeypatch.setattr(cli.time, "sleep", interrupt)
    cli.main(["serve", "--role", role, "--device", "cpu", "--free-ports",
              "--serve-slots", "4", "--serve-kv-dtype", "int8",
              "--serve-prefix-cache", "off", "--serve-replicas-max", "2",
              "--serve-slo-ttft-ms", "250", "--serve-decode-steps", "1"])
    assert got["stopped"]
    assert (got["serve_slots"], got["serve_kv_dtype"],
            got["serve_prefix_cache"], got["serve_replicas_max"],
            got["serve_slo_ttft_ms"], got["serve_decode_steps"]) == \
        (4, "int8", False, 2, 250.0, 1)
    assert got["serve_queue_depth"] is None and got["serve_draft_model"] \
        is None


@pytest.mark.parametrize("role", ["all", "scheduler"])
def test_serve_passes_the_cluster_flags_through(role, monkeypatch, capsys,
                                                tmp_path):
    """`kubeml serve --cluster-*` (ROADMAP A.16, landed) builds the
    deployment's allocator (--role all, with --control-dir) or the
    scheduler's (--role scheduler), as the JAX package's CLI does."""
    from kubeml_tpu_torch.cli import main as cli
    from kubeml_tpu_torch.control import deployment, scheduler

    got = {}

    class Stopped:
        url = controller_url = "http://h:1"

        def __init__(self, **kw):
            got.update(kw)
            self.controller = self.scheduler = self.ps = self.storage = self

        def start(self):
            pass

        def stop(self):
            got["stopped"] = True

    def interrupt(_seconds):
        raise KeyboardInterrupt

    monkeypatch.setattr(deployment, "start_deployment",
                        lambda **kw: Stopped(**kw))
    monkeypatch.setattr(scheduler, "Scheduler", Stopped)
    monkeypatch.setattr(cli.time, "sleep", interrupt)
    argv = ["serve", "--role", role, "--device", "cpu", "--free-ports",
            "--cluster-lanes", "4", "--cluster-tenant", "prod=3:4",
            "--cluster-tenant", "batch=1", "--cluster-aging-s", "10"]
    if role == "all":
        argv += ["--control-dir", str(tmp_path / "control")]
    cli.main(argv)
    assert got["stopped"]
    if role == "all":
        assert (got["cluster_lanes"], got["cluster_tenants"],
                got["cluster_aging_s"], got["control_dir"]) == \
            (4, ["prod=3:4", "batch=1"], 10.0, str(tmp_path / "control"))
    else:
        alloc = got["allocator"]
        assert (alloc.pool_lanes, alloc.tenant_weights, alloc.tenant_quotas,
                alloc.aging_s) == (4, {"prod": 3.0, "batch": 1.0},
                                   {"prod": 4}, 10.0)


def test_control_flags_need_role_all(capsys):
    """The durable control plane recovers the scheduler's and the PS's
    state together: a single role refuses --control-dir instead of
    dropping it."""
    from kubeml_tpu_torch.cli.main import main

    for argv in (["serve", "--role", "scheduler", "--control-dir", "/x"],
                 ["serve", "--role", "ps", "--control-durable"]):
        with pytest.raises(SystemExit) as ei:
            main(argv + ["--device", "cpu", "--free-ports"])
        assert ei.value.code not in (0, None)
        assert "need --role all" in capsys.readouterr().err
