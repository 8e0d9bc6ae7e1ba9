"""Port parity: kubeml_tpu_torch's Prometheus families (metrics/prom.py)
against the JAX package's.

The same metric updates, applied to both packages' registries, must give
byte-equal exposition text for every family the port carries (the serving,
SLO, cluster, health-verdict and durable-control-plane families come
later and are not compared); the primitives and the per-service HTTP
series likewise.
"""

import math

import pytest

pytestmark = pytest.mark.torch_port


def _families(text: str) -> dict:
    """Exposition text -> {family name: its block of lines}."""
    out, name = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name = line.split()[2]
            out[name] = []
        if name is not None and line:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def _update(types, job_id, epoch, **kw):
    fields = dict(
        job_id=job_id, validation_loss=1.0 / (epoch + 1),
        accuracy=50.0 + epoch, train_loss=2.0 / (epoch + 1),
        parallelism=2 + epoch, epoch_duration=0.5 + epoch,
        dropped_workers=float(epoch % 2), quarantined_workers=0,
        reassigned_batches=epoch, checkpoint_drops=epoch // 2,
        phase_times={"data_wait": [0.0004, 0.02 * epoch],
                     "dispatch": [0.3, 1.7, 65.0],
                     "merge_wait": [0.011], "merge_overlap": [0.5],
                     "device_drain": [2.6]},
        grad_norms=[0.5 + epoch, 0.25], update_ratios=[1e-3, 2e-3],
        worker_losses=[1.0, 1.1], loss_spread=0.05 * epoch,
        jit_compiles=3 + epoch, hbm_peak_bytes=1 << 30,
        hbm_in_use_bytes=1 << 29, trace_events_dropped=epoch,
        dataset_generation=0, data_lag_generations=-1,
        cost_programs={"round": {"plane": "train", "flops_total": 1e9 * (
            epoch + 1), "hbm_bytes_total": 5e8, "dispatches": epoch + 1}})
    fields.update(kw)
    return types.MetricUpdate(**fields)


def _drive(pkg: str, scenario: str) -> str:
    if pkg == "ref":
        from kubeml_tpu.api import types
        from kubeml_tpu.metrics.prom import MetricsRegistry
    else:
        from kubeml_tpu_torch.api import types
        from kubeml_tpu_torch.metrics.prom import MetricsRegistry

    reg = MetricsRegistry()
    reg.running_total.inc("train")
    reg.running_total.inc("train")
    for epoch in range(3):
        reg.update_job(_update(types, "job-a", epoch))
        reg.note_heartbeat("job-a", epoch, 4 * epoch)
    if scenario in ("continual", "two_jobs", "cleared"):
        reg.update_job(_update(types, "job-b", 0, data_lag_generations=2,
                               dataset_generation=5, grad_norms=[],
                               update_ratios=[], hbm_peak_bytes=0,
                               validation_loss=math.nan))
    if scenario in ("restarts", "cleared"):
        reg.note_restart("job-a")
        reg.note_restart("job-a")
    if scenario in ("infer", "cleared"):
        reg.note_infer_cache(False)
        reg.note_infer_cache(True)
        reg.note_infer_cache(True)
        reg.set_infer_cache_entries(1)
    if scenario == "shrink":
        # a parallelism shrink re-keys the per-worker series
        reg.update_job(_update(types, "job-a", 3, grad_norms=[9.0],
                               update_ratios=[0.1]))
    if scenario == "cleared":
        reg.clear_job("job-a")
        reg.running_total.inc("train", -1.0)
        # a finished job's replayed update starts its deltas afresh
        reg.update_job(_update(types, "job-a", 0))
    return reg.exposition()


@pytest.mark.parametrize("scenario", ["epochs", "continual", "restarts",
                                      "infer", "shrink", "two_jobs",
                                      "cleared"])
def test_ported_families_expose_byte_equal_text(scenario):
    port = _families(_drive("port", scenario))
    ref = _families(_drive("ref", scenario))
    assert set(port) <= set(ref)
    for name, block in port.items():
        assert block == ref[name], name


def test_port_carries_the_training_families():
    from kubeml_tpu_torch.metrics.prom import MetricsRegistry

    names = set(_families(MetricsRegistry().exposition()))
    for want in ("kubeml_job_validation_loss", "kubeml_job_train_loss",
                 "kubeml_job_parallelism", "kubeml_job_running_total",
                 "kubeml_job_epoch_duration_seconds",
                 "kubeml_job_dropped_workers", "kubeml_job_restarts",
                 "kubeml_ps_restarts_total", "kubeml_job_merge_seconds",
                 "kubeml_infer_cache_hits_total"):
        assert want in names
    assert not any(n.startswith(("kubeml_serve_", "kubeml_cluster_",
                                 "kubeml_control_")) for n in names)


@pytest.mark.parametrize("values", [
    [0.0001, 0.5, 0.5, 3.0, 1e9],
    [],
    [0.001, 0.0025, 60.0, 61.0],
])
def test_histogram_and_http_series_match(values):
    from kubeml_tpu.metrics import prom as ref
    from kubeml_tpu_torch.metrics import prom as port

    texts = []
    for mod in (ref, port):
        h = mod.Histogram("t_seconds", "help", ("a", "b"))
        http = mod.HttpMetrics("ps")
        for i, v in enumerate(values):
            h.observe(("x", str(i % 2)), v)
            http.observe("POST", "/metrics/{jobId}", 200 + i % 2, v)
        c = mod.Counter("c_total", "help", "k")
        c.inc("q\"uote\\d\nx", 2.5)
        g = mod.MultiGauge("g", "help", ("jobid", "kind"))
        g.set(("j", "peak"), float("nan"))
        texts.append("\n".join([h.collect(), http.exposition(),
                                c.collect(), g.collect()]))
    assert texts[0] == texts[1]


def test_primitive_guards_match():
    from kubeml_tpu.metrics import prom as ref
    from kubeml_tpu_torch.metrics import prom as port

    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.Counter("c_total", "h", "k").inc("x", -1)
        with pytest.raises(ValueError):
            mod.Histogram("h", "h", "k", buckets=(1.0, 1.0))
        with pytest.raises(ValueError):
            mod.MultiGauge("g", "h", ("a", "b")).set(("only",), 1.0)
