"""Port parity: checkpoints, the history store, the throughput policy and
the wire types of kubeml_tpu_torch against the JAX package's.

Checkpoints are written in the JAX package's flax layout, so each
package's load_checkpoint reads the other's file and gets equal arrays;
the state dict <-> flax tree mapping round-trips bit for bit. History
records, policy outputs and to_dict/from_dict payloads are compared
exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port


def _model(name):
    from kubeml_tpu_torch.models import get_model

    if name == "mlp":
        model = get_model("mlp")(hidden=16, num_classes=4)
        sample = {"x": np.zeros((2, 8), np.float32)}
    else:
        model = get_model(name)(dtype=torch.float32)
        sample = {"x": np.zeros((2, 16), np.int32)}
    module = model.init_module(sample, torch.Generator().manual_seed(1),
                               device="cpu")
    return model, {n: p.detach().clone()
                   for n, p in module.named_parameters()}


def _trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("name", ["mlp", "gpt-nano"])
def test_flax_layout_round_trip(tmp_home, name):
    """state dict -> flax tree -> checkpoint file -> flax tree -> state
    dict, bit for bit; the file's keys are the flax paths the JAX model
    of the same configuration has, with the same shapes."""
    import jax

    from kubeml_tpu.models import get_builtin
    from kubeml_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    model, state = _model(name)
    save_checkpoint("rt", {"params": model.params_to_flax(state)},
                    {"model": name})
    tree, manifest = load_checkpoint("rt")
    assert manifest["model"] == name and manifest["job_id"] == "rt"
    back = model.params_from_flax(tree["params"])
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    if name == "mlp":
        ref = get_builtin("mlp")(hidden=16, num_classes=4)
        sample = np.zeros((2, 8), np.float32)
    else:
        ref = get_builtin(name)()
        sample = np.zeros((2, 16), np.int32)
    ref_vars = ref.init_variables(jax.random.PRNGKey(0), {"x": sample})
    flat = {"/".join(str(p.key) for p in path): np.shape(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(ref_vars)[0]}
    with np.load(os.path.join(str(tmp_home), "models", "rt",
                              "weights.npz")) as z:
        assert {k: z[k].shape for k in z.files} == flat


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_loads_the_others_checkpoint(tmp_home, writer):
    from kubeml_tpu.train import checkpoint as ref_ckpt
    from kubeml_tpu_torch.train import checkpoint as port_ckpt

    model, state = _model("gpt-nano")
    tree = {"params": model.params_to_flax(state)}
    mods = {"port": port_ckpt, "reference": ref_ckpt}
    mods[writer].save_checkpoint("shared", tree,
                                 {"model": "gpt-nano", "epoch": 2})
    reader = mods["reference" if writer == "port" else "port"]
    got, manifest = reader.load_checkpoint("shared")
    want, want_manifest = mods[writer].load_checkpoint("shared")
    _trees_equal(got, want)
    _trees_equal(got, tree)
    assert manifest == want_manifest and manifest["epoch"] == 2


def test_old_fallback_and_completed_stamp_match_reference(tmp_home):
    """A crash between the two publish renames leaves only <job>.old:
    both packages read it; mark_checkpoint_completed stamps the same
    manifest (saved_at kept) in both."""
    from kubeml_tpu.api.errors import JobNotFoundError as RefNotFound
    from kubeml_tpu.train import checkpoint as ref_ckpt
    from kubeml_tpu_torch.api.errors import JobNotFoundError
    from kubeml_tpu_torch.train import checkpoint as port_ckpt

    model, state = _model("mlp")
    tree = {"params": model.params_to_flax(state)}
    root = os.path.join(str(tmp_home), "models")
    for name, mod in (("p", port_ckpt), ("r", ref_ckpt)):
        mod.save_checkpoint(name, tree, {"model": "mlp"})
        mod.save_checkpoint(name, tree, {"model": "mlp", "epoch": 1})
        assert not os.path.exists(os.path.join(root, name + ".old"))
        os.rename(os.path.join(root, name), os.path.join(root, name + ".old"))
    for reader in (port_ckpt, ref_ckpt):
        for name in ("p", "r"):
            got, manifest = reader.load_checkpoint(name)
            _trees_equal(got, tree)
            assert manifest["epoch"] == 1
    port_ckpt.mark_checkpoint_completed("r")
    ref_ckpt.mark_checkpoint_completed("p")
    for name in ("p", "r"):
        with open(os.path.join(root, name + ".old", "manifest.json")) as f:
            m = json.load(f)
        assert m["completed"] is True and m["epoch"] == 1 and "saved_at" in m
    with pytest.raises(JobNotFoundError):
        port_ckpt.load_checkpoint("absent")
    with pytest.raises(RefNotFound):
        ref_ckpt.load_checkpoint("absent")


def test_async_checkpointer_latest_wins_and_surfaces_errors(tmp_home):
    from kubeml_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                                   load_checkpoint)

    model, state = _model("mlp")
    ck = AsyncCheckpointer()
    to_tree = lambda sd: {"params": model.params_to_flax(sd)}  # noqa: E731
    for epoch in range(1, 4):
        ck.save("job", {k: v + epoch for k, v in state.items()},
                {"epoch": epoch}, to_tree)
    ck.wait()
    tree, manifest = load_checkpoint("job")
    assert manifest["epoch"] == 3
    _trees_equal(tree, to_tree({k: v + 3 for k, v in state.items()}))

    def broken(sd):
        raise OSError("disk full")
    ck.save("bad", state, {}, broken)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.close()
    with pytest.raises(RuntimeError, match="closed"):
        ck.save("job", state, {}, to_tree)


def _history_record(mod):
    opts = mod.TrainOptions(default_parallelism=3, k=4, merge_bucket_mb=4.0,
                            max_parallelism=6, shuffle=True)
    req = mod.TrainRequest(model_type="gpt-mini", batch_size=8, epochs=3,
                           dataset="tokens", lr=1e-3, options=opts,
                           resume_from="seed")
    data = mod.JobHistory(validation_loss=[1.5, float("nan")],
                          accuracy=[10.0, 20.5], train_loss=[2.0, 1.0],
                          parallelism=[2, 3], epoch_duration=[0.5, 0.25],
                          dropped_workers=[0.0, 1.0],
                          quarantined_workers=[0, 0],
                          reassigned_batches=[0, 0],
                          grad_norm_summary=[[1.0, 2.0, 3.0]] * 2,
                          update_ratio_summary=[[0.1, 0.2, 0.3]] * 2,
                          loss_spread=[0.01, 0.02])
    return mod.History(id="hist1", task=req, data=data)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_history_store_records_equal(tmp_home, writer):
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu.train.history import HistoryStore as RefStore
    from kubeml_tpu_torch.api import types as port_types
    from kubeml_tpu_torch.train.history import HistoryStore

    stores = {"port": (HistoryStore(), port_types),
              "reference": (RefStore(), ref_types)}
    store, types = stores[writer]
    store.save(_history_record(types))
    for other, _ in stores.values():
        got = other.get("hist1")
        assert json.dumps(got.to_dict()) == \
            json.dumps(_history_record(ref_types).to_dict())
        assert [h.id for h in other.list()] == ["hist1"]
    reader = stores["reference" if writer == "port" else "port"][0]
    reader.delete("hist1")
    assert store.list() == []


def test_throughput_policy_equals_reference():
    """The same scripted sequence of elapsed times, parallelism fed back,
    through both policies: equal outputs at every call."""
    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu.control.policy import ThroughputBasedPolicy as RefPolicy
    from kubeml_tpu_torch.api import types as port_types
    from kubeml_tpu_torch.control.policy import ThroughputBasedPolicy

    # every branch: first call, second call, slower (-1, floored at 1),
    # faster (+1), in between (kept)
    elapsed = [10.0, 10.0, 13.0, 16.0, 20.0, 25.0, 31.0, 31.5, 36.0, 5.0]
    out = {}
    for key, policy, types in (("port", ThroughputBasedPolicy(), port_types),
                               ("ref", RefPolicy(), ref_types)):
        req = types.TrainRequest(model_type="mlp", batch_size=32, epochs=9,
                                 dataset="blobs", lr=0.1,
                                 options=types.TrainOptions(
                                     default_parallelism=3))
        task = types.TrainTask(job_id="p", parameters=req)
        seq = []
        for t in elapsed:
            task.elapsed_time_s = t
            p, new = policy.calculate_parallelism(task)
            task.parallelism = p
            seq.append((p, new))
        policy.task_finished("p")
        seq.append(policy.calculate_parallelism(task))
        out[key] = seq
    assert out["port"] == out["ref"]
    assert {p for p, _ in out["port"]} >= {1, 2, 3, 4}


@pytest.mark.parametrize("cls", ["TrainOptions", "TrainRequest", "TrainTask",
                                 "JobHistory", "History", "MetricUpdate",
                                 "DatasetSummary"])
def test_api_types_round_trip_equal_across_packages(cls):
    """to_dict of equal values is equal in both packages, and each
    package's from_dict of the other's dict gives it back."""
    import dataclasses

    from kubeml_tpu.api import types as ref_types
    from kubeml_tpu_torch.api import types as port_types

    def build(types):
        rec = _history_record(types)
        return {
            "TrainOptions": rec.task.options,
            "TrainRequest": rec.task,
            "TrainTask": types.TrainTask(job_id="t1", parameters=rec.task,
                                         parallelism=3, elapsed_time_s=1.5,
                                         state="running", trace_id="abc",
                                         priority=2, tenant="prod"),
            "JobHistory": rec.data,
            "History": rec,
            "MetricUpdate": types.MetricUpdate(
                job_id="t1", validation_loss=1.0, accuracy=50.0,
                train_loss=2.0, parallelism=3, epoch_duration=4.0,
                phase_times={"dispatch": [0.1, 0.2]}, grad_norms=[1.0],
                hbm_peak_bytes=7, jit_compiles=0),
            "DatasetSummary": types.DatasetSummary(name="d",
                                                   train_set_size=5,
                                                   test_set_size=6),
        }[cls]

    port, ref = build(port_types), build(ref_types)
    assert [f.name for f in dataclasses.fields(type(port))] == \
        [f.name for f in dataclasses.fields(type(ref))]
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    back = getattr(port_types, cls).from_dict(ref.to_dict())
    assert json.dumps(back.to_dict()) == json.dumps(ref.to_dict())
    again = getattr(ref_types, cls).from_dict(port.to_dict())
    assert json.dumps(again.to_dict()) == json.dumps(port.to_dict())
    default_fields = {f.name: f.default for f in
                      dataclasses.fields(getattr(port_types, cls))}
    assert default_fields == {f.name: f.default for f in
                              dataclasses.fields(getattr(ref_types, cls))}


def test_errors_and_constants_equal_reference():
    from kubeml_tpu.api import const as ref_const
    from kubeml_tpu.api import errors as ref_errors
    from kubeml_tpu_torch.api import const, errors

    for name in ("MergeError", "DataError", "InvalidFormatError",
                 "StorageError", "DatasetNotFoundError", "InvalidArgsError",
                 "JobNotFoundError"):
        got, want = getattr(errors, name)(), getattr(ref_errors, name)()
        assert isinstance(got, errors.KubeMLException)
        assert got.to_dict() == want.to_dict(), name
    for name in ("STORAGE_SUBSET_SIZE", "POLICY_UPPER_BOUND",
                 "POLICY_LOWER_BOUND"):
        assert getattr(const, name) == getattr(ref_const, name)
    assert const.kubeml_home() == ref_const.kubeml_home()
