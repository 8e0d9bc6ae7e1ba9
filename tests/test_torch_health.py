"""Port parity: kubeml_tpu_torch's health evaluator (control/health.py),
its Prometheus families and the PS's ``GET /health?id=`` against the JAX
package's.

- every default rule, fired and not fired, over the same MetricUpdate
  sequences (dicts, with a fake clock): the same newly-fired reasons at
  every step (onsets and dedup), the same verdict after every step;
- ``kubeml_job_health`` and ``kubeml_health_alerts_total`` expose equal
  text for the same verdicts and alerts, and clear with the job;
- a CPU port deployment serves the live verdict of a long job on the PS
  and through the controller, publishes the families, and reads
  ``unknown`` once the job has finished.
"""

import time
import urllib.request

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _sample(job_id="j1", **kw):
    """A benign epoch update: no rule fires on these values."""
    base = dict(job_id=job_id, train_loss=0.5, validation_loss=0.5,
                accuracy=50.0, parallelism=2, epoch_duration=1.0,
                dropped_workers=0.0, quarantined_workers=0,
                grad_norms=[0.5, 0.6], update_ratios=[1e-3, 2e-3],
                worker_losses=[0.5, 0.5], loss_spread=0.01,
                phase_times={"dispatch": [0.1, 0.1, 0.1, 0.1]})
    base.update(kw)
    return base


def _serve(**kw):
    base = dict(serve_queue_cap=4, serve_queue_depth=1,
                serve_rejected_total=0)
    base.update(kw)
    return _sample(job_id="serve:m", **base)


def _cluster(**kw):
    base = dict(cluster_pool_lanes=8, cluster_lanes_in_use=8,
                cluster_queue_depth=0, cluster_oldest_wait_s=0.0)
    base.update(kw)
    return _sample(job_id="cluster", **base)


STALL = dict(update_ratios=[1e-9, 1e-9])
# name: a sequence of steps, each a sample dict or ("advance", seconds)
SEQUENCES = {
    "benign": [_sample(), _sample(), _sample()],
    "worker_divergence_dropped": [_sample(), _sample(dropped_workers=1.0)],
    "worker_divergence_quarantined": [_sample(quarantined_workers=2)],
    "worker_divergence_not_fired": [_sample(dropped_workers=0.0,
                                            quarantined_workers=0)],
    "grad_explosion_absolute": [_sample(grad_norms=[2e4])],
    "grad_explosion_relative": [_sample(grad_norms=[0.5]),
                                _sample(grad_norms=[0.6]),
                                _sample(grad_norms=[30.0])],
    "grad_explosion_not_fired": [_sample(grad_norms=[0.5]),
                                 _sample(grad_norms=[0.6]),
                                 _sample(grad_norms=[20.0]),
                                 _sample(grad_norms=[0.0, 0.0])],
    "loss_divergence": [_sample(loss_spread=1.0)],
    "loss_divergence_not_fired": [_sample(loss_spread=0.3)],
    "update_stall_then_reset": [_sample(**STALL), _sample(**STALL),
                                _sample(**STALL), _sample()],
    "update_stall_not_fired": [_sample(**STALL), _sample(),
                               _sample(**STALL), _sample(**STALL)],
    "straggler": [_sample(phase_times={"dispatch": [0.1, 0.1, 0.1, 2.0]})],
    "straggler_not_fired": [
        _sample(phase_times={"dispatch": [0.1, 0.1, 2.0]}),
        _sample(phase_times={"dispatch": [0.1, 0.1, 0.1, 0.45]})],
    "dedup_and_reonset": [_sample(dropped_workers=1.0),
                          _sample(dropped_workers=1.0), _sample(),
                          _sample(dropped_workers=1.0)],
    "worst_severity_wins": [_sample(dropped_workers=1.0, loss_spread=1.0)],
    "window_expiry": [_sample(dropped_workers=1.0), ("advance", 601.0),
                      _sample()],
    "sample_cap": [_sample(grad_norms=[float(i + 1)]) for i in range(40)],
    "serve_saturation_shed": [_serve(), _serve(serve_rejected_total=3)],
    "serve_saturation_full": [_serve(serve_queue_depth=4)],
    "serve_saturation_not_fired": [_serve(),
                                   _serve(serve_queue_depth=3)],
    "serve_ttft_slo": [_serve(serve_ttft_p99=2.5, serve_ttft_p50=0.4)],
    "serve_ttft_slo_not_fired": [_serve(serve_ttft_p99=1.5)],
    "slo_burn": [_serve(serve_slo_burn_fast=2.0, serve_slo_burn_slow=1.5,
                        serve_slo_attainment=0.9, serve_slo_target=0.99)],
    "slo_burn_not_fired": [_serve(serve_slo_burn_fast=3.0,
                                  serve_slo_burn_slow=0.5)],
    "serve_crash_loop": [_serve(serve_engine_restarts=0),
                         _serve(serve_engine_restarts=1),
                         _serve(serve_engine_restarts=2)],
    "serve_crash_loop_not_fired": [_serve(serve_engine_restarts=0),
                                   _serve(serve_engine_restarts=1)],
    "fleet_degraded": [_serve(fleet_ejections_total=0),
                       _serve(fleet_ejections_total=1,
                              fleet_migrated_streams_total=3,
                              fleet_probation=1)],
    "fleet_degraded_not_fired": [_serve(fleet_ejections_total=2),
                                 _serve(fleet_ejections_total=2)],
    "queue_starvation": [_cluster(cluster_queue_depth=2,
                                  cluster_oldest_wait_s=130.0)],
    "queue_starvation_not_fired": [_cluster(cluster_queue_depth=0,
                                            cluster_oldest_wait_s=500.0),
                                   _cluster(cluster_queue_depth=1,
                                            cluster_oldest_wait_s=60.0)],
    "data_staleness": [_sample(data_lag_generations=3,
                               dataset_generation=4)],
    "data_staleness_not_fired": [_sample(data_lag_generations=-1),
                                 _sample(data_lag_generations=2)],
    "control_flapping": [_cluster(cluster_recoveries_total=1),
                         _cluster(cluster_recoveries_total=3,
                                  cluster_fencing_epoch=4)],
    "control_flapping_not_fired": [_cluster(cluster_recoveries_total=1),
                                   _cluster(cluster_recoveries_total=2)],
}


def _drive(pkg, steps):
    if pkg == "ref":
        from kubeml_tpu.control.health import HealthEvaluator
    else:
        from kubeml_tpu_torch.control.health import HealthEvaluator
    clock = FakeClock()
    ev = HealthEvaluator(clock=clock)
    trail = []
    for step in steps:
        if isinstance(step, tuple):
            clock.t += step[1]
            trail.append(("verdict", ev.verdict(step_job)))
            continue
        step_job = step["job_id"]
        trail.append(("fired", ev.observe(dict(step))))
        trail.append(("verdict", ev.verdict(step_job)))
    trail.append(("ghost", ev.verdict("ghost")))
    ev.clear(step_job)
    trail.append(("cleared", ev.verdict(step_job)))
    return trail


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_verdicts_equal_the_references(name):
    port = _drive("port", SEQUENCES[name])
    assert port == _drive("ref", SEQUENCES[name])
    from kubeml_tpu_torch.control.health import default_rules

    fired = {r["rule"] for kind, x in port if kind == "fired" for r in x}
    rules = [r.name for r in default_rules() if name.startswith(r.name)]
    if name.endswith("_not_fired") or not rules:
        assert not fired or name in ("worst_severity_wins",
                                     "dedup_and_reonset", "window_expiry")
    else:
        assert max(rules, key=len) in fired, (rules, fired)
    assert port[-1][1]["state"] == "unknown"


def test_rule_sets_equal_the_references():
    from kubeml_tpu.control import health as ref
    from kubeml_tpu_torch.control import health as port

    def table(mod):
        return [(r.name, r.severity, r.description)
                for r in mod.default_rules()]
    assert table(port) == table(ref)
    assert port.STATES == ref.STATES
    assert port._SAMPLE_FIELDS == ref._SAMPLE_FIELDS
    # every default rule has a fired and a not-fired sequence above
    for name, _, _ in table(port):
        cases = [c for c in SEQUENCES if c.startswith(name)]
        assert any(c.endswith("_not_fired") for c in cases), name
        assert any(not c.endswith("_not_fired") for c in cases), name


def _health_text(pkg):
    if pkg == "ref":
        from kubeml_tpu.metrics.prom import MetricsRegistry
    else:
        from kubeml_tpu_torch.metrics.prom import MetricsRegistry
    reg = MetricsRegistry()
    texts = []
    reg.set_health("job-a", "healthy")
    reg.set_health("job-b", "unknown")
    texts.append(reg.exposition())
    reg.note_health_alert("job-a", "straggler")
    reg.note_health_alert("job-a", "straggler")
    reg.note_health_alert("job-a", "worker_divergence")
    reg.set_health("job-a", "critical")
    texts.append(reg.exposition())
    reg.clear_job("job-a")
    texts.append(reg.exposition())
    return texts


def _family(text, name):
    out, on = [], False
    for line in text.splitlines():
        if line.startswith("# HELP "):
            on = line.split()[2] == name
        if on:
            out.append(line)
    return "\n".join(out)


@pytest.mark.parametrize("family", ["kubeml_job_health",
                                    "kubeml_health_alerts_total"])
def test_health_families_expose_equal_text(family):
    port, ref = _health_text("port"), _health_text("ref")
    for p, r in zip(port, ref):
        assert _family(p, family) == _family(r, family)
        assert _family(p, family)
    assert 'state="critical"} 1.0' in _family(port[1], "kubeml_job_health")
    assert 'job-a' not in port[2]


def _blob_files(tmp):
    import os
    rng = np.random.RandomState(0)
    y = rng.randint(0, 3, 600).astype(np.int32)
    x = rng.randn(600, 8).astype(np.float32) * 1.5
    x[np.arange(600), y * 2] += 3.0
    paths = []
    for name, arr in (("xtr", x), ("ytr", y), ("xte", x[:100]),
                      ("yte", y[:100])):
        paths.append(os.path.join(tmp, f"{name}.npy"))
        np.save(paths[-1], arr)
    return paths


def wait_health(url, job_id, want=("healthy",), timeout=120.0):
    """Poll GET {url}/health?id= until the state is one of ``want``."""
    from kubeml_tpu_torch.control.httpd import http_json

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = http_json("GET", f"{url}/health?id={job_id}")
        if doc["state"] in want:
            return doc
        time.sleep(0.05)
    raise TimeoutError(f"{job_id} never reached {want}: {doc}")


def test_health_endpoint_serves_a_live_job_then_unknown(tmp_home, tmp_path):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.control.client import KubemlClient
    from kubeml_tpu_torch.control.deployment import start_deployment
    from kubeml_tpu_torch.control.httpd import http_json

    dep = start_deployment(device="cpu")
    try:
        c = KubemlClient(dep.controller_url).v1()
        c.datasets().create("blobs", *_blob_files(str(tmp_path)))
        job_id = c.networks().train(TrainRequest(
            model_type="mlp", batch_size=32, epochs=500, dataset="blobs",
            lr=0.1, options=TrainOptions(default_parallelism=2,
                                         static_parallelism=True, k=2)))
        doc = wait_health(dep.ps.url, job_id,
                          want=("healthy", "warning", "critical"))
        assert doc["id"] == job_id and doc["latest"]["grad_norms"]
        assert doc["latest"]["parallelism"] == 2
        via = c.health().get(job_id)  # the controller's /health/{id}
        assert via["id"] == job_id and via["state"] != "unknown"
        assert http_json("GET", f"{dep.ps.url}/health") == {"ok": True}
        text = urllib.request.urlopen(dep.ps.url + "/metrics").read() \
            .decode()
        assert f'kubeml_job_health{{jobid="{job_id}",state=' in text
        c.tasks().stop(job_id)
        assert dep.ps.wait_for_job(job_id, timeout=120)
        assert http_json("GET", f"{dep.ps.url}/health?id={job_id}") == {
            "id": job_id, "state": "unknown", "reasons": [], "latest": {}}
        assert c.health().get(job_id)["state"] == "unknown"
        text = urllib.request.urlopen(dep.ps.url + "/metrics").read() \
            .decode()
        assert f'kubeml_job_health{{jobid="{job_id}"' not in text
    finally:
        dep.stop()
