"""Port parity: kubeml_tpu_torch's TrainJob against the JAX package's.

Both jobs run the same task on the same registry dataset, warm-started
from one checkpoint the JAX package wrote (so they start from equal
weights; the port's own init draws flax's distributions from another
stream). The JAX job runs on a one-device mesh and the port's on one
lane, so both see W = N workers.

Tolerances:
  - ``mlp`` on the blobs task (SGD, f32): the per-epoch parallelism, the
    epoch count, the validation cadence, the goal-accuracy stop epoch and
    the stop signal are equal; train loss, validation loss and accuracy
    agree within 1e-5 relative; the final weights within 1e-5 (the two
    frameworks sum the matmuls and the merge in other orders);
  - ``gpt-nano`` (AdamW, f32, dropout 0): counts exactly, losses 1e-4
    relative, the final weights within AdamW's bound of 2 x lr per local
    step (its first steps divide each gradient element by its own
    magnitude, so an element near zero whose sign the summation order
    flips moves by up to 2 lr), 99.5 % of the elements within 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


def _blobs(n_train=800, n_test=200, dim=8, classes=4, seed=0):
    """The JAX package's job-test task (tests/test_job.py): noisy,
    linearly separable blobs."""
    rng = np.random.RandomState(seed)

    def split(n):
        y = rng.randint(0, classes, n).astype(np.int32)
        x = rng.randn(n, dim).astype(np.float32) * 2.0
        x[np.arange(n), y % dim] += 3.0
        return x, y
    return (*split(n_train), *split(n_test))


def _tasks(job_id, model_type, dataset, epochs=3, parallelism=2, k=2,
           batch=32, lr=0.1, static=True, validate_every=1, goal=100.0,
           resume_from="seedckpt", **opts):
    """The same task for both packages: {package: TrainTask}."""
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu_torch.api import types as port_types

    out = {}
    for key, types in (("ref", ref_types), ("port", port_types)):
        req = types.TrainRequest(
            model_type=model_type, batch_size=batch, epochs=epochs,
            dataset=dataset, lr=lr, resume_from=resume_from,
            options=types.TrainOptions(
                default_parallelism=parallelism, static_parallelism=static,
                validate_every=validate_every, k=k, goal_accuracy=goal,
                **opts))
        out[key] = types.TrainTask(job_id=f"{key}-{job_id}", parameters=req,
                                   parallelism=parallelism)
    return out


def _seed_mlp_checkpoint():
    """A JAX-initialised mlp (hidden 16, 4 classes) saved by the JAX
    package: the common starting point of both jobs."""
    import jax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.train.checkpoint import save_checkpoint

    ref = get_builtin("mlp")(hidden=16, num_classes=4)
    variables = ref.init_variables(jax.random.PRNGKey(0),
                                   {"x": np.zeros((32, 8), np.float32)})
    save_checkpoint("seedckpt", jax.tree_util.tree_map(np.asarray, variables),
                    {"model": "mlp", "function": "mlp"})


@pytest.fixture()
def blobs(tmp_home):
    from kubeml_tpu_torch.data.registry import DatasetRegistry

    DatasetRegistry().create("blobs", *_blobs())
    _seed_mlp_checkpoint()


class _Stopper:
    """publish_metrics that asks its job to stop after the 2nd epoch."""

    def __init__(self):
        self.job, self.calls = None, 0

    def __call__(self, m):
        self.calls += 1
        if self.calls == 2:
            self.job.stop()


def _run_both(tasks, make_model, make_dataset, dynamic=False, stop=False,
              round_hooks=None):
    """Run the JAX job and the port's job (those of ``tasks``' keys, each
    with its round hook from ``round_hooks``); returns {key: (record,
    asked, published MetricUpdates)}."""
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train import job as ref_job
    from kubeml_tpu_torch.train import job as port_job

    out = {}
    for key, mod in (("ref", ref_job), ("port", port_job)):
        if key not in tasks:
            continue
        asked, published = [], []
        stopper = _Stopper()

        def publish(m, stopper=stopper, published=published):
            published.append(m)
            if stop:
                stopper(m)

        def request(task, asked=asked):
            asked.append(task.parallelism)
            return task.parallelism + 1 if dynamic else None
        callbacks = mod.JobCallbacks(request_parallelism=request,
                                     publish_metrics=publish)
        where = make_mesh(n_data=1) if key == "ref" else "cpu"
        job = mod.TrainJob(tasks[key], make_model(key), make_dataset(key),
                           where, callbacks=callbacks,
                           round_hook=(round_hooks or {}).get(key))
        stopper.job = job
        out[key] = (job.train(), asked, published)
    return out


def _mlp(key):
    from kubeml_tpu.models import get_builtin
    from kubeml_tpu_torch.models import get_model

    return (get_builtin("mlp") if key == "ref" else get_model("mlp"))(
        hidden=16, num_classes=4)


def _blobs_dataset(key):
    from kubeml_tpu.models.base import KubeDataset as RefDataset
    from kubeml_tpu_torch.models.base import KubeDataset

    return (RefDataset if key == "ref" else KubeDataset)("blobs")


def _assert_close(got, want, rtol):
    got, want = np.asarray(got, float), np.asarray(want, float)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=0)


def _final_params(job_id):
    from kubeml_tpu.train.checkpoint import load_checkpoint

    import jax

    tree, manifest = load_checkpoint(job_id)
    return jax.tree_util.tree_leaves(tree), manifest


MLP_CASES = {
    # name: (task knobs, run knobs)
    "dynamic": (dict(epochs=3, static=False), dict(dynamic=True)),
    "goal_accuracy": (dict(epochs=20, goal=70.0), {}),
    "validate_every": (dict(epochs=4, validate_every=2), {}),
    "stop_signal": (dict(epochs=50), dict(stop=True)),
    "rounds_per_dispatch": (dict(epochs=2, rounds_per_dispatch=3), {}),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_job_matches_reference(blobs, case):
    task_kw, run_kw = MLP_CASES[case]
    tasks = _tasks(case, "mlp", "blobs", **task_kw)
    out = _run_both(tasks, _mlp, _blobs_dataset, **run_kw)
    (ref, ref_asked, ref_pub), (got, asked, pub) = out["ref"], out["port"]
    r, g = ref.data, got.data
    assert g.parallelism == r.parallelism
    assert len(g.train_loss) == len(r.train_loss)
    assert asked == ref_asked
    assert len(pub) == len(ref_pub) == len(g.train_loss)
    _assert_close(g.train_loss, r.train_loss, 1e-5)
    _assert_close(g.validation_loss, r.validation_loss, 1e-5)
    _assert_close(g.accuracy, r.accuracy, 1e-5)
    assert g.dropped_workers == r.dropped_workers
    assert len(g.grad_norm_summary) == len(r.grad_norm_summary)
    for a, b in zip(g.grad_norm_summary, r.grad_norm_summary):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    # the spread is sqrt(E[l^2] - E[l]^2) in f32 over losses near 1: the
    # difference cancels, so it keeps ~4 digits, not the losses' 6
    for a, b in zip(g.loss_spread, r.loss_spread):
        assert abs(a - b) <= 1e-4, (a, b)
    for m, rm in zip(pub, ref_pub):
        assert m.parallelism == rm.parallelism
        # the tracer's span names: the reference job's keys, and at least
        # the single-round phases
        assert sorted(m.phase_times) == sorted(rm.phase_times)
        assert {"data_wait", "dispatch", "merge_wait"} <= set(m.phase_times)
        # the cost ledger and the compile count equal the reference's
        # (KUBEML_COST_LEDGER=0: its closed-form records) exactly
        assert m.jit_compiles == rm.jit_compiles
        assert m.cost_programs == rm.cost_programs
        np.testing.assert_allclose(m.worker_losses, rm.worker_losses,
                                   rtol=1e-5)
    if case == "dynamic":
        assert g.parallelism == [2, 3, 4] and asked == [2, 3]
    if case == "goal_accuracy":
        assert len(g.train_loss) < 20 and g.accuracy[-1] >= 70.0
    if case == "validate_every":
        assert np.isnan(g.accuracy[0]) and not np.isnan(g.accuracy[1])
    if case == "stop_signal":
        assert len(g.train_loss) == 2
    want, ref_manifest = _final_params(tasks["ref"].job_id)
    have, manifest = _final_params(tasks["port"].job_id)
    for a, b in zip(have, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert manifest["completed"] and ref_manifest["completed"]
    assert manifest["history"]["parallelism"] == \
        ref_manifest["history"]["parallelism"]


class _Windows:
    """Token windows, no labels (the GPT example's TextWindows)."""

    def transform_train(self, data, labels):
        return {"x": np.asarray(data).astype(np.int32)}

    transform_test = transform_train


def test_gpt_nano_job_matches_reference_with_bucketed_merge(tmp_home):
    """gpt-nano (f32, dropout 0) for one epoch of two rounds, AdamW,
    merge_bucket_mb set (several buckets), N = 2: counts and losses equal,
    weights within AdamW's bound."""
    import jax
    import jax.numpy as jnp

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
    x[::3, 11:] = 0
    DatasetRegistry().create("tokens", x[:256], np.zeros(256, np.int32),
                             x[256:], np.zeros(64, np.int32))
    save_checkpoint("seedckpt", {"params": random_flax_params(**cfg, seed=2)},
                    {"model": "gpt-nano", "function": "gpt-nano"})
    lr, B, K = 1e-3, 32, 2
    tasks = _tasks("nano", "gpt-nano", "tokens", epochs=1, batch=B, k=K,
                   lr=lr, merge_bucket_mb=0.02)

    def model(key):
        if key == "port":
            return GPTNano(dtype=torch.float32)
        m = JaxNano()
        m._module = JaxGPT(**cfg, dropout=0.0, dtype=jnp.float32,
                           attn_impl="reference")
        return m

    def dataset(key):
        base = RefDataset if key == "ref" else KubeDataset
        return type("Windows", (_Windows, base), {})()

    out = _run_both(tasks, model, dataset)
    r, g = out["ref"][0].data, out["port"][0].data
    assert g.parallelism == r.parallelism == [2]
    _assert_close(g.train_loss, r.train_loss, 1e-4)
    _assert_close(g.validation_loss, r.validation_loss, 1e-4)
    assert abs(g.accuracy[0] - r.accuracy[0]) <= 0.1   # percent
    want, _ = _final_params(tasks["ref"].job_id)
    have, _ = _final_params(tasks["port"].job_id)
    # 128 samples per worker = 2 docs of 64 = 2 rounds of 2 steps of 32
    steps = 2 * K
    diffs = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(have, want)])
    assert diffs.max() <= 2 * steps * lr, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.995, (diffs <= 1e-5).mean()
    assert len(jax.tree_util.tree_leaves(want)) == len(have)


REJECTED = {
    "engine": "syncdp", "fsdp": True, "n_model": 2, "n_seq": 2,
    "n_stage": 2, "n_expert": 2, "device_cache": "on", "continual": True,
    "window_generations": 2, "publish_every_rounds": 3,
    "fault_plan": '{"events": []}', "quarantine_after": 1,
    "abort_after": 1, "reassign_on_quarantine": True,
    "checkpoint_every_rounds": 2,
}
# the degraded mode's options (ROADMAP A.4.5, landed): the job runs them
# (reassign_on_quarantine alone is the JAX package's 400: it needs
# quarantine_after)
DEGRADED = ("fault_plan", "quarantine_after", "abort_after",
            "reassign_on_quarantine", "checkpoint_every_rounds",
            "round_hook")
# the continual mode's options (ROADMAP A.4.5, landed): ``continual``
# trains; the two knobs without it are the JAX package's 400
CONTINUAL_KNOBS = ("window_generations", "publish_every_rounds")
# the SyncDP engine (ROADMAP A.11, landed): engine='syncdp' and fsdp train
SYNCDP_OPTIONS = ("engine", "fsdp")


def _port_job(job_id="p1", callbacks=None, round_hook=None, dataset=None,
              **task_kw):
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import TrainJob

    task = _tasks(job_id, "mlp", "blobs", **task_kw)["port"]
    task.job_id = job_id
    return TrainJob(task, get_model("mlp")(hidden=16, num_classes=4),
                    dataset or KubeDataset("blobs"), device="cpu",
                    callbacks=callbacks, round_hook=round_hook)


def _host_only_blobs():
    """The blobs dataset behind a host transform with no device twin:
    not eligible for the device cache."""
    from kubeml_tpu_torch.models.base import KubeDataset

    class HostOnly(KubeDataset):
        def transform_train(self, data, labels):
            return {"x": np.asarray(data) * 1.0, "y": labels}

    return HostOnly("blobs")


@pytest.mark.parametrize("option", sorted(REJECTED) + ["round_hook"])
def test_unported_options_are_rejected_with_400(blobs, option):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.train.job import JobCallbacks

    finished = []
    callbacks = JobCallbacks(
        on_finish=lambda jid, err: finished.append((jid, err)))
    if option in SYNCDP_OPTIONS:
        _syncdp_option_trains(option)
        return
    if option == "continual" or (option in DEGRADED
                                 and option != "reassign_on_quarantine"):
        hooked = []
        job = _port_job(callbacks=callbacks,
                        round_hook=(lambda rb: hooked.append(rb) or rb)
                        if option == "round_hook" else None,
                        **({} if option == "round_hook"
                           else {option: REJECTED[option]}))
        record = job.train()
        assert job.task.state == "finished" and finished == [("p1", None)]
        epochs = len(record.data.train_loss)
        assert epochs >= 1
        assert record.data.quarantined_workers == [0] * epochs
        assert record.data.reassigned_batches == [0] * epochs
        if option == "round_hook":
            # once per round, every round dispatched alone
            assert [rb.round_index for rb in hooked[:2]] == [0, 1]
        return
    if option == "device_cache":
        # the cache is ported: 'on' refuses only an ineligible dataset,
        # with the JAX package's message
        job = _port_job(callbacks=callbacks, dataset=_host_only_blobs(),
                        device_cache="on")
    else:
        job = _port_job(callbacks=callbacks, **{option: REJECTED[option]})
    with pytest.raises(KubeMLException) as e:
        job.train()
    assert e.value.status_code == 400
    if option == "device_cache":
        assert "transform_train_device hook" in e.value.message
    elif option == "reassign_on_quarantine":
        assert "requires the kavg engine with quarantine_after > 0" \
            in e.value.message
    elif option in ("n_model", "n_seq", "n_stage", "n_expert"):
        # tensor, sequence, pipeline and expert parallelism are ported:
        # one process without a group is one device, the reference's 400
        assert e.value.message == (
            "1 devices not divisible by the requested model x seq x stage "
            "x expert factor 2")
    elif option in CONTINUAL_KNOBS:
        assert e.value.message.startswith(
            "window_generations / publish_every_rounds require "
            "--continual")
    else:
        assert "not ported yet" in e.value.message
    assert option.split("_")[0] in e.value.message
    assert job.task.state == "failed" and finished[0][1] == e.value.message


def _syncdp_option_trains(option):
    """engine='syncdp' reaches the job and trains as the JAX package's
    syncdp job (tests/test_job.py's syncdp job): counts, losses and
    accuracy within 1e-5, the cost ledger and compile count exactly, the
    final weights within 1e-5, the loss falls. fsdp: the same job with
    fsdp equals the replicated one bit for bit (one device lays nothing
    out differently) and the reference's fsdp job within 1e-5."""
    knobs = dict(epochs=3, lr=0.05, engine="syncdp")
    if option == "fsdp":
        knobs["fsdp"] = True
    tasks = _tasks(option, "mlp", "blobs", **knobs)
    out = _run_both(tasks, _mlp, _blobs_dataset)
    (ref, _, ref_pub), (got, _, pub) = out["ref"], out["port"]
    r, g = ref.data, got.data
    assert len(g.train_loss) == len(r.train_loss) == 3
    _assert_close(g.train_loss, r.train_loss, 1e-5)
    _assert_close(g.validation_loss, r.validation_loss, 1e-5)
    _assert_close(g.accuracy, r.accuracy, 1e-5)
    assert g.train_loss[-1] < g.train_loss[0]
    assert g.dropped_workers == r.dropped_workers == [0.0] * 3
    for m, rm in zip(pub, ref_pub):
        assert m.jit_compiles == rm.jit_compiles
        assert m.cost_programs == rm.cost_programs
        assert "syncdp.train_indexed" in m.cost_programs
        assert sorted(m.phase_times) == sorted(rm.phase_times)
    want, _ = _final_params(tasks["ref"].job_id)
    have, manifest = _final_params(tasks["port"].job_id)
    assert manifest["completed"]
    for a, b in zip(have, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    if option == "fsdp":
        plain = _tasks("replicated", "mlp", "blobs", epochs=3, lr=0.05,
                       engine="syncdp")
        rec = _run_both({"port": plain["port"]}, _mlp,
                        _blobs_dataset)["port"][0].data
        assert rec.train_loss == g.train_loss
        assert rec.accuracy == g.accuracy
        again, _ = _final_params(plain["port"].job_id)
        for a, b in zip(have, again):
            np.testing.assert_array_equal(a, b)


# syncdp jobs held against the JAX package's: (task knobs, round hook)
SYNCDP_CASES = {
    # tests/test_job.py's straggler case: random worker loss every round
    "straggler": (dict(epochs=3, parallelism=4), "chaos"),
    "ef_bf16": (dict(epochs=2, merge_compress="bf16"), None),
    "bucketed": (dict(epochs=2, merge_bucket_mb=0.001), None),
    "host_staged": (dict(epochs=2, device_cache="off"), None),
    # a NaN in one worker's batch: its round's global steps are skipped
    "nan_skip": (dict(epochs=2, fault_plan=json.dumps({"events": [
        {"kind": "nan", "epoch": 0, "round": 1, "worker": 1}]})), None),
}


@pytest.mark.parametrize("case", sorted(SYNCDP_CASES))
def test_syncdp_job_matches_reference(blobs, case):
    """A syncdp job (mlp, SGD) against the JAX package's: epochs, losses,
    accuracy and the skipped-step counts, the cost ledger and the compile
    count, the final weights within 1e-5 (the EF-bf16 merge: its loss and
    weights within the quantum bound, 1e-4 of a loss near 1 and 1e-4
    absolute over two epochs of SGD at lr 0.05); the loss falls."""
    knobs, hook = SYNCDP_CASES[case]
    tasks = _tasks(case, "mlp", "blobs", lr=0.05, engine="syncdp", **knobs)
    hooks = None
    if hook == "chaos":
        from kubeml_tpu.utils.chaos import WorkerLossInjector as RefChaos
        from kubeml_tpu_torch.utils.chaos import WorkerLossInjector
        hooks = {"ref": RefChaos(p=0.4, seed=7),
                 "port": WorkerLossInjector(p=0.4, seed=7)}
    out = _run_both(tasks, _mlp, _blobs_dataset, round_hooks=hooks)
    (ref, _, ref_pub), (got, _, pub) = out["ref"], out["port"]
    r, g = ref.data, got.data
    tol = 1e-4 if case == "ef_bf16" else 1e-5
    assert len(g.train_loss) == len(r.train_loss) == knobs["epochs"]
    _assert_close(g.train_loss, r.train_loss, tol)
    _assert_close(g.accuracy, r.accuracy, tol)
    assert g.dropped_workers == r.dropped_workers
    assert g.train_loss[-1] < g.train_loss[0]
    if hook == "chaos":
        assert hooks["port"].workers_lost == hooks["ref"].workers_lost > 0
    if case == "nan_skip":
        # the burst poisons worker 1's whole round: both of its K steps
        assert g.dropped_workers == [2.0, 0.0]
    for m, rm in zip(pub, ref_pub):
        assert m.jit_compiles == rm.jit_compiles
        assert m.cost_programs == rm.cost_programs
    want, _ = _final_params(tasks["ref"].job_id)
    have, _ = _final_params(tasks["port"].job_id)
    for a, b in zip(have, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


# syncdp's option combinations the JAX package refuses, in its order
SYNCDP_400 = {
    "fsdp_kavg": dict(fsdp=True),
    "fsdp_bucketed": dict(engine="syncdp", fsdp=True, merge_bucket_mb=4.0),
    "fsdp_compress": dict(engine="syncdp", fsdp=True, merge_compress="int8"),
    "merge_dtype": dict(engine="syncdp", merge_dtype="bf16"),
    "checkpoint_every_rounds": dict(engine="syncdp",
                                    checkpoint_every_rounds=2),
    "reassign": dict(engine="syncdp", quarantine_after=1,
                     reassign_on_quarantine=True),
    "quarantine_event": dict(engine="syncdp", quarantine_after=1,
                             fault_plan=json.dumps({"events": [
                                 {"kind": "quarantine", "epoch": 0,
                                  "round": 0, "worker": 0}]})),
    "publish_every_rounds": dict(engine="syncdp", continual=True,
                                 publish_every_rounds=2),
    # the first refusal wins: checkpoint_every_rounds before fsdp's
    "order": dict(checkpoint_every_rounds=2, fsdp=True, merge_dtype="bf16",
                  engine="syncdp"),
}


@pytest.mark.parametrize("case", sorted(SYNCDP_400))
def test_syncdp_option_400s_match_reference(blobs, case):
    """Every syncdp option combination the JAX package's job refuses is a
    400 here with the same message; kavg-only options name syncdp's
    persistent optimizer state."""
    from kubeml_tpu.api.errors import KubeMLException as RefError
    from kubeml_tpu.parallel.mesh import make_mesh
    from kubeml_tpu.train import job as ref_job
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.train import job as port_job

    tasks = _tasks(case, "mlp", "blobs", epochs=1, **SYNCDP_400[case])
    with pytest.raises(RefError) as want:
        ref_job.TrainJob(tasks["ref"], _mlp("ref"), _blobs_dataset("ref"),
                         make_mesh(n_data=1)).train()
    with pytest.raises(KubeMLException) as got:
        port_job.TrainJob(tasks["port"], _mlp("port"),
                          _blobs_dataset("port"), "cpu").train()
    assert got.value.status_code == want.value.status_code == 400
    assert got.value.message == want.value.message


@pytest.mark.parametrize("knobs,match", [
    (dict(engine="sgd"), "unknown training engine"),
    (dict(merge_dtype="fp8"), "merge_dtype"),
    (dict(merge_compress="fp4"), "merge_compress"),
    (dict(merge_dtype="bf16", merge_compress="int8"), "mutually exclusive"),
    (dict(device_cache="maybe"), "device_cache"),
    (dict(max_parallelism=-1), "max_parallelism"),
])
def test_invalid_options_are_rejected_like_the_reference(blobs, knobs, match):
    from kubeml_tpu_torch.api.errors import KubeMLException

    with pytest.raises(KubeMLException, match=match) as e:
        _port_job(**knobs).train()
    assert e.value.status_code == 400


def test_resume_from_own_checkpoint_continues_and_completes(blobs):
    """Crash recovery (resume_from == own id): a mid-job manifest resumes
    at its epoch with its history and parallelism; a completed one
    finishes without training."""
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from kubeml_tpu_torch.train.job import TrainJob

    first = _port_job("own", epochs=2).train()
    tree, manifest = load_checkpoint("own")
    assert manifest["completed"] is True and manifest["epoch"] == 2
    crafted = dict(manifest, epoch=2, history=first.data.to_dict(),
                   parallelism=3)
    crafted.pop("completed")
    save_checkpoint("own", tree, crafted)
    task = _tasks("own", "mlp", "blobs", epochs=4,
                  resume_from="own")["port"]
    task.job_id = "own"
    job = TrainJob(task, get_model("mlp")(hidden=16, num_classes=4),
                   KubeDataset("blobs"), device="cpu")
    rec = job.train()
    assert job._start_epoch == 2
    assert rec.data.train_loss[:2] == first.data.train_loss
    assert rec.data.parallelism == [2, 2, 3, 3]
    assert rec.data.train_loss[2] < first.data.train_loss[0]

    done = TrainJob(task, get_model("mlp")(hidden=16, num_classes=4),
                    KubeDataset("blobs"), device="cpu")
    published = []
    done.callbacks.publish_metrics = published.append
    again = done.train()
    assert done._start_epoch == 4 and published == []
    assert again.data.train_loss == rec.data.train_loss


def test_warm_start_checks_function_and_shapes(blobs):
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint
    from kubeml_tpu_torch.train.job import TrainJob

    task = _tasks("ws", "mlp", "blobs")["port"]
    save_checkpoint("other", {"params": {}}, {"function": "gpt-nano"})
    task.parameters.resume_from = "other"
    with pytest.raises(KubeMLException, match="holds function"):
        TrainJob(task, get_model("mlp")(hidden=16, num_classes=4),
                 KubeDataset("blobs"), device="cpu").train()
    task.parameters.resume_from = "seedckpt"
    with pytest.raises(KubeMLException, match="shaped for a different"):
        TrainJob(task, get_model("mlp")(hidden=32, num_classes=4),
                 KubeDataset("blobs"), device="cpu").train()


def test_checkpoint_cadence_and_history_store(blobs, monkeypatch):
    """checkpoint_every=1 saves every epoch (the last one stamped
    completed instead of a redundant final save); -1 saves only the
    final; the history lands in the store the JAX package reads."""
    from kubeml_tpu.train.history import HistoryStore as RefStore
    from kubeml_tpu_torch.train import checkpoint as ckpt
    from kubeml_tpu_torch.train import job as job_mod
    from kubeml_tpu_torch.train.history import HistoryStore

    saved = []
    real = ckpt.save_checkpoint
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        lambda jid, v, m, root=None: saved.append(m)
                        or real(jid, v, m, root=root))
    monkeypatch.setattr(job_mod, "save_checkpoint", ckpt.save_checkpoint)
    job = _port_job("every", epochs=2, checkpoint_every=1)
    job.history_store = HistoryStore()
    rec = job.train()
    assert [m["epoch"] for m in saved] == [1, 2]
    assert not any(m.get("completed") for m in saved)
    _, manifest = ckpt.load_checkpoint("every")
    assert manifest["completed"] is True
    assert RefStore().get("every").data.train_loss == rec.data.train_loss
    saved.clear()
    _port_job("final", epochs=2, checkpoint_every=-1).train()
    assert [(m["epoch"], m.get("completed")) for m in saved] == [(2, True)]


def test_policy_time_leaves_out_kernel_builds(blobs, monkeypatch):
    """Seconds spent building kernels during an epoch are not part of the
    elapsed time the parallelism callback sees."""
    from kubeml_tpu_torch.ops import _build
    from kubeml_tpu_torch.train.job import JobCallbacks

    clock = {"t": 0.0}

    def fake_load_seconds():
        clock["t"] += 1000.0      # 1000 s of builds between two reads
        return clock["t"]
    monkeypatch.setattr(_build, "load_seconds", fake_load_seconds)
    seen = []
    job = _port_job(
        "policy", epochs=2, static=False,
        callbacks=JobCallbacks(request_parallelism=lambda t: seen.append(
            t.elapsed_time_s)))
    rec = job.train()
    assert seen == [0.0] and rec.data.epoch_duration[0] > 0


def test_failed_job_reports_and_default_device_is_cuda(blobs):
    from kubeml_tpu_torch.api.errors import DatasetNotFoundError
    from kubeml_tpu_torch.models import get_model
    from kubeml_tpu_torch.models.base import KubeDataset
    from kubeml_tpu_torch.train.job import JobCallbacks, TrainJob

    finished = []
    job = _port_job("nodata", callbacks=JobCallbacks(
        on_finish=lambda jid, err: finished.append((jid, err))))
    job.req.dataset = "missing"
    with pytest.raises(DatasetNotFoundError):
        job.train()
    assert finished == [("nodata", job.exit_err)] and job.exit_err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TrainJob(job.task, get_model("mlp")(), KubeDataset("blobs"))


def test_job_state_stays_on_its_device_and_infers(blobs):
    """The job's state lives on its device; its module infers argmax
    classes like the JAX package's ClassifierModel.infer; the history
    round-trips through JSON."""
    from kubeml_tpu.models import get_builtin
    from kubeml_tpu.train.checkpoint import load_checkpoint

    job = _port_job("dev", epochs=1)
    rec = job.train()
    assert all(t.device.type == "cpu" for t in job.state.values())
    x = _blobs(n_train=16, n_test=0, seed=3)[0]
    got = job.model.infer(job._engine.module, x)
    ref = get_builtin("mlp")(hidden=16, num_classes=4)
    want = ref.infer(load_checkpoint("dev")[0], x)
    assert got.shape == (16,)
    np.testing.assert_array_equal(got, want)
    back = json.loads(json.dumps(rec.to_dict()))
    assert back["data"]["parallelism"] == [2]
    assert os.path.isdir(os.path.join(os.environ["KUBEML_TPU_HOME"],
                                      "models", "dev"))
