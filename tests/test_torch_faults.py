"""Port parity: the training fault plan (kubeml_tpu_torch/faults.py), the
chaos hook (utils/chaos.py), the non-finite guard and the degraded-mode
jobs against the JAX package's (kubeml_tpu/faults.py, utils/chaos.py,
train/job.py; mirrors tests/test_faults.py).

Tolerances: parse errors, masks, poisoned batches, ``injected`` counts,
guard decisions, abort diagnostics and the history's counts are exact;
weights of a port job against the JAX job within 1e-5 (mlp, SGD, f32) or
AdamW's bound (gpt-nano: 2 x lr per local step, 99.5 % of the elements
within 1e-5); within the port, a NaN-dropped worker and a dropped-out
one give the same weights bit for bit.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_job import (_blobs_dataset, _final_params, _mlp,
                            _run_both, _tasks, _Windows)

pytestmark = pytest.mark.torch_port


def _pkgs():
    from kubeml_tpu import faults as ref
    from kubeml_tpu_torch import faults as port
    return {"ref": ref, "port": port}


BAD_SPECS = [
    '{"events": [{"kind": "meteor"}]}',
    '[{"kind": "quarantine", "round": 2}]',
    '{"events": 3}',
    '"just a string"',
    '{"events": [{"kind": "slow", "duration_s": "x"}]}',
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_errors_equal_the_references(spec):
    errs = {}
    for key, mod in _pkgs().items():
        with pytest.raises((ValueError, KeyError, TypeError)) as ei:
            mod.FaultPlan.parse(spec)
        errs[key] = (type(ei.value).__name__, str(ei.value))
    assert errs["port"] == errs["ref"]


def test_events_parse_alike():
    spec = [{"kind": "nan", "epoch": 0, "round": 2, "worker": 1},
            {"kind": "dropout", "round": 4},
            {"kind": "slow", "round": 1, "duration_s": 0.0},
            {"kind": "crash", "epoch": 1, "round": 0},
            {"kind": "preempt", "epoch": 0, "round": 3},
            {"kind": "quarantine", "round": 5, "worker": 2},
            {"kind": "stale_data", "epoch": 1},
            {"kind": "corrupt_checkpoint", "epoch": 2, "round": 0}]
    plans = {k: m.FaultPlan.parse({"events": spec})
             for k, m in _pkgs().items()}
    as_dicts = {k: [vars(e) for e in p.events] for k, p in plans.items()}
    assert as_dicts["port"] == as_dicts["ref"]
    assert plans["port"].injected == plans["ref"].injected
    assert _pkgs()["port"].KINDS == _pkgs()["ref"].KINDS
    assert _pkgs()["port"].CRASH_EXIT_CODE == _pkgs()["ref"].CRASH_EXIT_CODE
    for kind in ("nan", "quarantine", "crash"):
        assert plans["port"].has(kind) == plans["ref"].has(kind)
    assert plans["port"].stale_at(1) == plans["ref"].stale_at(1) is True
    assert plans["port"].stale_at(0) == plans["ref"].stale_at(0) is False
    assert plans["port"].injected["stale_data"] == 1


class _FakeJob:
    """What a plan binds to: the task, the request, and the two hooks a
    plan calls, recorded."""

    def __init__(self, job_id="fj", resume_from=""):
        self.task = SimpleNamespace(job_id=job_id)
        self.req = SimpleNamespace(resume_from=resume_from)
        self.calls = []
        self._checkpointer = SimpleNamespace(wait=lambda: None)

    def preempt(self, at_round=None):
        self.calls.append(("preempt", at_round))

    def force_quarantine(self, worker, rnd):
        self.calls.append(("quarantine", worker, rnd))


def _round(mod_loader, rnd, W=4, S=2, B=3):
    rng = np.random.default_rng(rnd)
    return mod_loader.RoundBatch(
        batch={"x": rng.normal(size=(W, S, B, 5)).astype(np.float32),
               "y": rng.integers(0, 3, (W, S, B)).astype(np.int32)},
        sample_mask=np.ones((W, S, B), np.float32),
        step_mask=np.ones((W, S), np.float32),
        worker_mask=np.ones(W, np.float32),
        rngs=np.zeros((W, S, 2), np.uint32), round_index=rnd,
        num_rounds=6)


@pytest.mark.parametrize("restart", [False, True])
def test_hook_and_batch_injection_equal_the_references(restart):
    """The same plan over the same six rounds of two epochs: the NaN
    bursts, the masks, the job calls (preempt and quarantine only in a
    first incarnation for preempt) and the injected counts."""
    from kubeml_tpu.data import loader as ref_loader
    from kubeml_tpu_torch.data import loader as port_loader

    spec = json.dumps([
        {"kind": "nan", "epoch": 0, "round": 1, "worker": 2},
        {"kind": "nan", "epoch": 1, "round": 4},
        {"kind": "dropout", "round": 2, "worker": 0},
        {"kind": "dropout", "epoch": 1, "round": 3},
        {"kind": "slow", "round": 5, "duration_s": 0.0},
        {"kind": "preempt", "epoch": 1, "round": 2},
        {"kind": "quarantine", "epoch": 0, "round": 3, "worker": 3}])
    out = {}
    for key, mod, ld in (("ref", _pkgs()["ref"], ref_loader),
                         ("port", _pkgs()["port"], port_loader)):
        plan = mod.FaultPlan.parse(spec)
        job = _FakeJob(resume_from="fj" if restart else "")
        plan.bind(job)
        seen = []
        for epoch in (0, 1):
            plan.epoch = epoch
            for rnd in range(6):
                rb = plan(plan.inject_batch(_round(ld, rnd)))
                seen.append((np.isnan(rb.batch["x"]).any(axis=(1, 2, 3)),
                             rb.batch["y"].copy(), rb.worker_mask.copy()))
        out[key] = (seen, job.calls, dict(plan.injected), plan.is_restart)
    (ref_seen, *ref_rest), (port_seen, *port_rest) = out["ref"], out["port"]
    assert port_rest == ref_rest
    for a, b in zip(port_seen, ref_seen):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert out["port"][2]["nan"] == 2 and out["port"][2]["dropout"] == 3
    assert out["port"][2]["preempt"] == (0 if restart else 1)


def test_corrupt_checkpoint_event_overwrites_the_weights(tmp_home):
    from kubeml_tpu_torch.faults import FaultPlan
    from kubeml_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from kubeml_tpu_torch.data import loader

    save_checkpoint("fj", {"params": {"w": np.ones(3, np.float32)}},
                    {"model": "mlp"})
    plan = FaultPlan.parse([{"kind": "corrupt_checkpoint", "round": 1}])
    plan.bind(_FakeJob())
    plan(_round(loader, 0))
    assert plan.injected["corrupt_checkpoint"] == 0
    plan(_round(loader, 1))
    assert plan.injected["corrupt_checkpoint"] == 1
    with pytest.raises(Exception):
        load_checkpoint("fj")


@pytest.mark.parametrize("seed,p", [(0, 0.2), (3, 0.5), (7, 0.9)])
def test_worker_loss_injector_masks_equal_the_references(seed, p):
    from kubeml_tpu.data import loader as ref_loader
    from kubeml_tpu.utils.chaos import WorkerLossInjector as Ref
    from kubeml_tpu_torch.data import loader as port_loader
    from kubeml_tpu_torch.utils.chaos import WorkerLossInjector as Port

    ref, port = Ref(p=p, seed=seed), Port(p=p, seed=seed)
    for rnd in range(20):
        a = ref(_round(ref_loader, rnd, W=6)).worker_mask
        b = port(_round(port_loader, rnd, W=6)).worker_mask
        np.testing.assert_array_equal(a, b)
        assert b.sum() >= 1
    assert (port.rounds, port.degraded_rounds, port.workers_lost) == \
        (ref.rounds, ref.degraded_rounds, ref.workers_lost)


# (quarantine_after, abort_after, [W] drop flags per round, worker masks)
GUARD_CASES = {
    "quarantine_after_2": (2, 0, [[0, 1, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1],
                                  [0, 0, 1, 1], [0, 0, 1, 1]], None),
    "streak_broken": (2, 0, [[1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0],
                             [0, 1, 0, 0]], None),
    "abort_after_2": (0, 2, [[1, 1, 1, 1], [1, 1, 1, 1]], None),
    "abort_with_masked_worker": (0, 2, [[1, 1, 1, 0], [1, 1, 1, 0]],
                                 [1, 1, 1, 0]),
    "abort_streak_reset": (0, 2, [[1, 1, 1, 1], [1, 0, 1, 1],
                                  [1, 1, 1, 1]], None),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_decisions_equal_the_references(case):
    """The guard over the same per-round drop flags: the masks it applies,
    the quarantine rounds, the drop total, the streak, the abort
    diagnostic."""
    from kubeml_tpu.data import loader as ref_loader
    from kubeml_tpu.train import job as ref_job
    from kubeml_tpu_torch.data import loader as port_loader
    from kubeml_tpu_torch.train import job as port_job

    q, a, flags, wmask = GUARD_CASES[case]
    out = {}
    for key, mod, ld in (("ref", ref_job, ref_loader),
                         ("port", port_job, port_loader)):
        job = SimpleNamespace(task=SimpleNamespace(job_id="gj"),
                              _all_dropped_rounds=0, logs=[])
        job._log = lambda *args, job=job: job.logs.append(args[0] % args[1:])
        guard = mod._NonFiniteGuard(job, q, a)
        if case == "quarantine_after_2":
            guard.force(0, 4)     # a quarantine event for worker 0
        masks, err = [], None
        for rnd, f in enumerate(flags):
            rb = _round(ld, rnd)
            if wmask is not None:
                rb.worker_mask = np.asarray(wmask, np.float32)
            try:
                rb = guard.apply(rb)
                masks.append(rb.worker_mask.copy())
                guard.observe(SimpleNamespace(
                    dropped=np.asarray(f, np.float32)), rb)
            except Exception as e:  # noqa: BLE001 — compared below
                err = (type(e).__name__, str(e),
                       getattr(e, "status_code", None))
                break
        out[key] = (np.asarray(masks).tolist(), err,
                    dict(guard.quarantined_since), guard.quarantined_count,
                    guard.dropped_total, job._all_dropped_rounds, job.logs)
    assert out["port"] == out["ref"]
    if case.startswith("abort") and case != "abort_streak_reset":
        assert out["port"][1][2] == 500


# ------------------------------------------------------------ the jobs


@pytest.fixture()
def small_blobs(tmp_home):
    """test_torch_job's blobs at 16-sample docs (8 rounds an epoch at
    N = 2, K = 1, B = 16), from the JAX package's checkpoint."""
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from tests.test_torch_job import _blobs, _seed_mlp_checkpoint

    DatasetRegistry().create("blobs", *_blobs(n_train=256, n_test=64),
                             subset_size=16)
    _seed_mlp_checkpoint()


def _both(case, plan=None, parallelism=2, epochs=2, hooks=None, **opts):
    tasks = _tasks(case, "mlp", "blobs", epochs=epochs,
                   parallelism=parallelism, k=1, batch=16, goal=200.0,
                   device_cache=opts.pop("device_cache", "off"),
                   fault_plan=json.dumps(plan) if plan else "", **opts)
    return tasks, _run_both(tasks, _mlp, _blobs_dataset, round_hooks=hooks)


def _assert_weights_close(tasks, tol=1e-5):
    want, _ = _final_params(tasks["ref"].job_id)
    have, _ = _final_params(tasks["port"].job_id)
    assert len(want) == len(have)
    for a, b in zip(have, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol)


def test_mlp_nan_drop_job_matches_reference(small_blobs):
    tasks, out = _both("nandrop", [{"kind": "nan", "epoch": 0, "round": 2,
                                    "worker": 1}])
    r, g = out["ref"][0].data, out["port"][0].data
    assert g.dropped_workers == r.dropped_workers == [1.0, 0.0]
    assert g.quarantined_workers == r.quarantined_workers == [0, 0]
    _assert_weights_close(tasks)


def test_mlp_quarantine_reassignment_job_matches_reference(small_blobs):
    """N = 4, quarantine_after 2, NaN on worker 2 at rounds 1 and 2 of
    epoch 0: worker 2 quarantined from round 3, its orphaned samples
    re-dealt in makeup rounds; the counts and the weights."""
    plan = [{"kind": "nan", "epoch": 0, "round": r, "worker": 2}
            for r in (1, 2)]
    tasks, out = _both("reassign", plan, parallelism=4, quarantine_after=2,
                       reassign_on_quarantine=True)
    r, g = out["ref"][0].data, out["port"][0].data
    assert g.quarantined_workers == r.quarantined_workers == [1, 0]
    assert g.reassigned_batches == r.reassigned_batches
    assert g.reassigned_batches[0] > 0
    assert g.dropped_workers == r.dropped_workers == [2.0, 0.0]
    _assert_weights_close(tasks)


def test_mlp_chaos_job_on_the_device_cache_matches_reference(small_blobs):
    """WorkerLossInjector over a job fed from the device cache (on): the
    same masks every round, so the same weights."""
    from kubeml_tpu.utils.chaos import WorkerLossInjector as Ref
    from kubeml_tpu_torch.utils.chaos import WorkerLossInjector as Port

    hooks = {"ref": Ref(p=0.3, seed=5), "port": Port(p=0.3, seed=5)}
    tasks, out = _both("chaos", parallelism=4, device_cache="on",
                       hooks=hooks)
    assert hooks["port"].degraded_rounds > 0
    assert (hooks["port"].rounds, hooks["port"].workers_lost) == \
        (hooks["ref"].rounds, hooks["ref"].workers_lost)
    _assert_weights_close(tasks)


class _WeightedWindows(_Windows):
    """Token windows with a float per-sequence loss weight ``w`` (all
    ones): token ids are integers, which a NaN burst leaves alone, so the
    weight is the float leaf the burst poisons."""

    def transform_train(self, data, labels):
        x = np.asarray(data).astype(np.int32)
        return {"x": x, "w": np.ones(len(x), np.float32)}


def test_gpt_nano_nan_drop_job_matches_reference(tmp_home):
    """gpt-nano (f32, dropout 0, AdamW) with its per-sequence loss scaled
    by the batch's ``w`` (ones, so the loss is gpt-nano's), one epoch of
    two rounds at N = 2, NaN on worker 0 in round 1: the drop counted
    alike, the weights within AdamW's bound."""
    import jax.numpy as jnp
    import torch

    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu.models.gpt import GPTModule as JaxGPT
    from kubeml_tpu.models.gpt import GPTNano as JaxNano
    from kubeml_tpu.train.checkpoint import save_checkpoint
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.data.registry import DatasetRegistry
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.models.gpt import GPT_CONFIGS, GPTNano

    cfg = GPT_CONFIGS["gpt-nano"]
    rng = np.random.default_rng(0)
    start = rng.integers(1, 500, (320, 1))
    x = ((start + np.arange(16) - 1) % 511 + 1).astype(np.int32)
    DatasetRegistry().create("tokens", x[:256], np.zeros(256, np.int32),
                             x[256:], np.zeros(64, np.int32))
    save_checkpoint("seedckpt", {"params": random_flax_params(**cfg, seed=2)},
                    {"model": "gpt-nano", "function": "gpt-nano"})
    lr, B, K = 1e-3, 32, 2
    tasks = _tasks("nanonan", "gpt-nano", "tokens", epochs=1, batch=B, k=K,
                   lr=lr, fault_plan=json.dumps(
                       [{"kind": "nan", "round": 1, "worker": 0}]))

    class PortNano(GPTNano):
        def loss(self, module, batch, generator, sample_mask):
            return super().loss(module, batch, generator, sample_mask) \
                * batch["w"].to(module.device)

    class RefNano(JaxNano):
        def loss(self, variables, batch, rng, sample_mask):
            per_ex, state = super().loss(variables, batch, rng, sample_mask)
            return per_ex * batch["w"], state

    def model(key):
        if key == "port":
            return PortNano(dtype=torch.float32)
        m = RefNano()
        m._module = JaxGPT(**cfg, dropout=0.0, dtype=jnp.float32,
                           attn_impl="reference")
        return m

    def dataset(key):
        base = RefDataset if key == "ref" else KubeDataset
        return type("Windows", (_WeightedWindows, base), {})()

    out = _run_both(tasks, model, dataset)
    r, g = out["ref"][0].data, out["port"][0].data
    assert g.dropped_workers == r.dropped_workers == [1.0]
    want, _ = _final_params(tasks["ref"].job_id)
    have, _ = _final_params(tasks["port"].job_id)
    diffs = np.concatenate([np.abs(np.asarray(a) - np.asarray(b)).ravel()
                            for a, b in zip(have, want)])
    assert diffs.max() <= 2 * 2 * K * lr, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.995


def test_nan_drop_equals_dropout_bit_for_bit_in_the_port(small_blobs):
    """A NaN burst on worker 1 at round 2 and a dropout of it there give
    the same weights: the finite guard selects the worker out."""
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint
    from kubeml_tpu_torch.train.checkpoint import _flatten

    weights = []
    for kind in ("nan", "dropout"):
        tasks = _tasks(kind, "mlp", "blobs", epochs=1, k=1, batch=16,
                       goal=200.0, device_cache="off",
                       fault_plan=json.dumps([{"kind": kind, "round": 2,
                                               "worker": 1}]))
        out = _run_only_port(tasks)
        assert out.data.dropped_workers == ([1.0] if kind == "nan"
                                            else [0.0])
        weights.append(_flatten(load_checkpoint(tasks["port"].job_id)[0]))
    assert weights[0].keys() == weights[1].keys()
    for k in weights[0]:
        np.testing.assert_array_equal(weights[0][k], weights[1][k])


def _run_only_port(tasks, round_hook=None):
    from kubeml_tpu_torch.train.job import TrainJob

    return TrainJob(tasks["port"], _mlp("port"), _blobs_dataset("port"),
                    device="cpu", round_hook=round_hook).train()


def test_abort_diagnostic_equals_the_references(small_blobs):
    """NaN on every worker of every round with abort_after 2: both jobs
    fail after round 1 with the same diagnostic (500)."""
    tasks = _tasks("abort", "mlp", "blobs", epochs=1, k=1, batch=16,
                   goal=200.0, device_cache="off", abort_after=2,
                   fault_plan=json.dumps([{"kind": "nan"}]))
    errs = {}
    for key in ("ref", "port"):
        tasks[key].job_id = "abortjob"
        with pytest.raises(Exception) as ei:
            _run_both({key: tasks[key]}, _mlp, _blobs_dataset)
        errs[key] = (ei.value.status_code, str(ei.value))
    assert errs["port"] == errs["ref"]
    assert errs["port"][0] == 500 and "abort_after=2" in errs["port"][1]


# (options, what the 400 names)
BAD_OPTIONS = {
    "negative_quarantine": dict(quarantine_after=-1),
    "negative_rounds": dict(checkpoint_every_rounds=-1),
    "reassign_alone": dict(reassign_on_quarantine=True),
    "quarantine_event_alone": dict(fault_plan=json.dumps(
        [{"kind": "quarantine", "worker": 1}])),
    "bad_plan": dict(fault_plan='{"events": [{"kind": "meteor"}]}'),
    "nan_with_cache_on": dict(device_cache="on", fault_plan=json.dumps(
        [{"kind": "nan"}])),
}


@pytest.mark.parametrize("case", sorted(BAD_OPTIONS))
def test_bad_degraded_options_are_the_references_400(small_blobs, case):
    errs = {}
    for key in ("ref", "port"):
        opts = dict(BAD_OPTIONS[case])
        tasks = _tasks(case, "mlp", "blobs", epochs=1, k=1, batch=16,
                       **opts)
        with pytest.raises(Exception) as ei:
            _run_both({key: tasks[key]}, _mlp, _blobs_dataset)
        errs[key] = (ei.value.status_code, ei.value.message)
    assert errs["port"] == errs["ref"]
    assert errs["port"][0] == 400
