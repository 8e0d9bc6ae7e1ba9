"""Port parity: the decision journal (control/journal.py, a copy) and the
control fault kinds of kubeml_tpu_torch against the JAX package's.

- the same ops under the same fake clock give byte-equal journal files
  in both packages, and a journal written by either replays in the other
  to an equal snapshot — after every journaled op (the crash-at-every-
  index sweep), across compactions;
- torn tails are dropped and repaired alike; mid-file corruption raises
  JournalCorruptError in both; a compaction whose truncate never reached
  disk skips the stale records alike;
- the three ControlFaultPlan kinds fire once at their indices and leave
  equal files and states in both packages.

Coordinate-driven: fake clocks and named journal indices only.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import pytest

pytestmark = pytest.mark.torch_port

_HEADER = struct.Struct("<II")
PKGS = ("port", "ref")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _mods(pkg: str):
    """(cluster, journal, faults, errors) of one package."""
    if pkg == "ref":
        from kubeml_tpu import faults
        from kubeml_tpu.api import errors
        from kubeml_tpu.control import cluster, journal
    else:
        from kubeml_tpu_torch import faults
        from kubeml_tpu_torch.api import errors
        from kubeml_tpu_torch.control import cluster, journal
    return cluster, journal, faults, errors


def _journaled(pkg, directory, clock, compact_every=0, fault_plan=None):
    cluster, journal, _, _ = _mods(pkg)
    j = journal.DecisionJournal(str(directory), fault_plan=fault_plan)
    alloc = cluster.ClusterAllocator(
        8, tenant_weights={"a": 1.0, "b": 3.0}, tenant_quotas={"a": 6},
        clock=clock, journal=j, compact_every=compact_every)
    return alloc, j


def _recover(pkg, directory, clock):
    cluster, journal, _, _ = _mods(pkg)
    return cluster.ClusterAllocator.recover(
        journal.DecisionJournal(str(directory)), 8,
        tenant_weights={"a": 1.0, "b": 3.0}, tenant_quotas={"a": 6},
        clock=clock)


def _snap(alloc, now):
    """snapshot() minus the torn-drop counter: a property of each
    process's journal handle, not of the journaled history."""
    s = alloc.snapshot(now=now)
    s.pop("cluster_journal_torn_drops_total", None)
    return s


def _files(directory) -> dict:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def _ops(alloc, pkg):
    """The sweep's workload: placements, a park, displacement of cheaper
    work, resizes, releases, a serving gang, a recovery bump and a
    fencing rejection."""
    stale = _mods(pkg)[3].StaleGrantError

    def stale_probe():
        with pytest.raises(stale):
            alloc.fence_check("j1", 999)

    return [
        lambda: alloc.submit("j1", tenant="a", lanes=3),
        lambda: alloc.submit("j2", tenant="b", lanes=4),
        lambda: alloc.submit("j3", tenant="a", lanes=3),
        lambda: alloc.submit("hi", tenant="b", priority=5, lanes=4),
        lambda: alloc.resize("j1", 1),
        lambda: alloc.release("j2"),
        lambda: alloc.submit("sv", tenant="b", lanes=2, kind="serving"),
        lambda: alloc.mark_recovered(),
        stale_probe,
        lambda: alloc.release("j1"),
        lambda: alloc.resize("sv", 3),
        lambda: alloc.release("hi"),
        lambda: alloc.regrant("j3"),
    ]


@pytest.mark.parametrize("compact_every", [0, 4])
def test_journal_files_are_byte_equal_and_replay_across_packages(
        tmp_path, compact_every):
    """After every op: the port's and the JAX package's journal and
    snapshot files are byte-equal, and each package's files recover in
    BOTH packages to the live snapshot."""
    clocks = {p: FakeClock(100.0) for p in PKGS}
    dirs = {p: tmp_path / p for p in PKGS}
    allocs = {p: _journaled(p, dirs[p], clocks[p], compact_every)[0]
              for p in PKGS}
    ops = {p: _ops(allocs[p], p) for p in PKGS}
    for i in range(len(ops["port"])):
        for p in PKGS:
            clocks[p].advance(1.0)
            ops[p][i]()
        assert _files(dirs["port"]) == _files(dirs["ref"]), i
        now = clocks["port"].t
        live = _snap(allocs["port"], now)
        assert live == _snap(allocs["ref"], now)
        for writer in PKGS:
            for reader in PKGS:
                twin = _recover(reader, dirs[writer], FakeClock(now))
                assert _snap(twin, now) == live, (i, writer, reader)
    snap = allocs["port"].snapshot(now=clocks["port"].t)
    assert snap["cluster_recoveries_total"] == 1
    assert snap["cluster_fencing_rejections_total"] == 1
    assert snap["cluster_fencing_epoch"] == 2
    assert snap["cluster_journal_compactions_total"] == \
        (3 if compact_every else 0)


def test_verify_journal_roundtrip_equals_the_references(tmp_path):
    outs = []
    for p in PKGS:
        clock = FakeClock(5.0)
        alloc, _ = _journaled(p, tmp_path / p, clock)
        for op in _ops(alloc, p)[:6]:
            clock.advance(2.0)
            op()
        outs.append(_mods(p)[0].verify_journal_roundtrip(alloc))
    assert outs[0] == outs[1]


def test_append_replay_roundtrip_alike(tmp_path):
    for p in PKGS:
        journal = _mods(p)[1]
        j = journal.DecisionJournal(str(tmp_path / p))
        assert [j.append({"op": n}) for n in ("a", "b", "c")] == [0, 1, 2]
        j.close()
        j2 = journal.DecisionJournal(str(tmp_path / p))
        state, tail = j2.replay()
        assert state is None
        assert [(r["op"], r["i"]) for r in tail] == \
            [("a", 0), ("b", 1), ("c", 2)]
        assert j2.next_index == 3 and j2.append({"op": "d"}) == 3
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


@pytest.mark.parametrize("cut", [1, 5, _HEADER.size + 3])
def test_torn_tail_is_dropped_and_repaired_alike(tmp_path, cut):
    results = []
    for p in PKGS:
        journal = _mods(p)[1]
        j = journal.DecisionJournal(str(tmp_path / p))
        j.append({"op": "a"})
        j.append({"op": "b"})
        j.close()
        size = os.path.getsize(j.journal_path)
        with open(j.journal_path, "r+b") as f:
            f.truncate(size - cut)
        j2 = journal.DecisionJournal(str(tmp_path / p))
        _, tail = j2.replay()
        j3 = journal.DecisionJournal(str(tmp_path / p))
        _, tail3 = j3.replay()
        results.append(([r["op"] for r in tail], j2.torn_drops,
                        j2.next_index, [r["op"] for r in tail3],
                        j3.torn_drops, os.path.getsize(j.journal_path)))
    assert results[0] == results[1]
    assert results[0][:5] == (["a"], 1, 1, ["a"], 0)


def test_a_journal_torn_by_either_package_repairs_in_the_other(tmp_path):
    """A torn tail left by one package is repaired by the other, which
    then appends where the writer would have."""
    for writer, reader in (("port", "ref"), ("ref", "port")):
        d = tmp_path / writer
        j = _mods(writer)[1].DecisionJournal(str(d))
        j.append({"op": "a"})
        j.append({"op": "b"})
        j.close()
        with open(j.journal_path, "r+b") as f:
            f.truncate(os.path.getsize(j.journal_path) - 4)
        j2 = _mods(reader)[1].DecisionJournal(str(d))
        assert j2.append({"op": "c"}) == 1
        j2.close()
        _, tail = _mods(writer)[1].DecisionJournal(str(d)).replay()
        assert [(r["op"], r["i"]) for r in tail] == [("a", 0), ("c", 1)]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def _write_frames(path, payloads):
    with open(path, "wb") as f:
        for payload in payloads:
            f.write(_HEADER.pack(len(payload), zlib.crc32(payload)) + payload)


@pytest.mark.parametrize("damage", ["bad_crc", "not_json"])
def test_midfile_corruption_fails_loudly_in_both(tmp_path, damage):
    for p in PKGS:
        journal = _mods(p)[1]
        d = tmp_path / p
        j = journal.DecisionJournal(str(d))
        for n in ("a", "b", "c"):
            j.append({"op": n})
        j.close()
        if damage == "bad_crc":
            with open(j.journal_path, "r+b") as f:
                f.seek(_HEADER.size + 2)
                f.write(b"\xff")
        else:
            good = json.dumps({"op": "z", "i": 0}, sort_keys=True).encode()
            _write_frames(j.journal_path, [b"not json", good])
        with pytest.raises(journal.JournalCorruptError):
            journal.DecisionJournal(str(d)).replay()
        # the port's error is the port's own class, not the reference's
        assert journal.JournalCorruptError.__module__.startswith(
            "kubeml_tpu_torch" if p == "port" else "kubeml_tpu.")


def test_compaction_snapshot_plus_tail_alike(tmp_path):
    for p in PKGS:
        journal = _mods(p)[1]
        j = journal.DecisionJournal(str(tmp_path / p))
        j.append({"op": "a"})
        j.append({"op": "b"})
        j.compact({"folded": 2})
        j.append({"op": "c"})
        j.close()
        state, tail = journal.DecisionJournal(str(tmp_path / p)).replay()
        assert state == {"folded": 2}
        assert [(r["op"], r["i"]) for r in tail] == [("c", 2)]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_compaction_racing_append_skips_stale_records_alike(tmp_path):
    """A crash between the snapshot write and the journal truncate leaves
    stale records behind; replay skips every i <= snapshot.index."""
    for p in PKGS:
        journal = _mods(p)[1]
        j = journal.DecisionJournal(str(tmp_path / p))
        j.append({"op": "a"})
        j.append({"op": "b"})
        j.close()
        with open(j.journal_path, "rb") as f:
            stale = f.read()
        j.compact({"folded": 2})
        with open(j.journal_path, "wb") as f:
            f.write(stale)
        j.append({"op": "c"})
        j.close()
        state, tail = journal.DecisionJournal(str(tmp_path / p)).replay()
        assert state == {"folded": 2}
        assert [r["op"] for r in tail] == ["c"]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_atomic_write_json_alike(tmp_path):
    for p in PKGS:
        journal = _mods(p)[1]
        path = str(tmp_path / f"{p}.json")
        journal.atomic_write_json(path, {"k": [1, 2], "a": None})
        assert journal.read_json(path) == {"k": [1, 2], "a": None}
        assert journal.read_json(str(tmp_path / "missing.json")) is None
        assert not os.path.exists(path + ".tmp")
    with open(tmp_path / "port.json", "rb") as a, \
            open(tmp_path / "ref.json", "rb") as b:
        assert a.read() == b.read()


# ----------------------------------------------------- control fault kinds

def test_control_kinds_equal_the_references():
    port, ref = _mods("port")[2], _mods("ref")[2]
    assert port.CONTROL_KINDS == ref.CONTROL_KINDS == (
        "control_crash", "control_torn_write", "control_slow_recover")
    for spec in ([{"kind": "bogus_kind"}], {"events": "x"}, "7"):
        msgs = []
        for mod in (port, ref):
            with pytest.raises(ValueError) as ei:
                mod.ControlFaultPlan.parse(spec)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_torn_write_loses_the_op_but_never_misreplays_alike(tmp_path):
    """control_torn_write kills the allocator mid-append: the op is lost,
    recovery drops the torn tail once and reconstructs the pre-op state;
    the files and states are the JAX package's."""
    outs = []
    for p in PKGS:
        _, _, faults, _ = _mods(p)
        clock = FakeClock(0.0)
        plan = faults.ControlFaultPlan.parse(
            [{"kind": "control_torn_write", "index": 2}])
        alloc, _ = _journaled(p, tmp_path / p, clock, fault_plan=plan)
        alloc.submit("j1", tenant="a", lanes=3)
        clock.advance(1.0)
        alloc.submit("j2", tenant="b", lanes=4)
        pre = _snap(alloc, clock.t)
        with pytest.raises(faults.ControlCrash):
            alloc.submit("j3", tenant="a", lanes=1)
        assert plan.injected["control_torn_write"] == 1
        torn = _files(tmp_path / p)
        twin = _recover(p, tmp_path / p, clock)
        assert twin._journal.torn_drops == 1
        assert _snap(twin, clock.t) == pre
        assert "j3" not in twin.running_jobs()
        twin.submit("j3", tenant="a", lanes=1)
        outs.append((torn, _files(tmp_path / p), _snap(twin, clock.t)))
    assert outs[0] == outs[1]
    assert "control_torn_write" in _mods("port")[2].CONTROL_KINDS


def test_crash_after_durable_append_keeps_the_op_alike(tmp_path):
    outs = []
    for p in PKGS:
        _, _, faults, _ = _mods(p)
        clock = FakeClock(0.0)
        plan = faults.ControlFaultPlan.parse(
            [{"kind": "control_crash", "index": 1}])
        alloc, _ = _journaled(p, tmp_path / p, clock, fault_plan=plan)
        alloc.submit("j1", tenant="a", lanes=3)
        clock.advance(1.0)
        with pytest.raises(faults.ControlCrash):
            alloc.submit("j2", tenant="b", lanes=4)
        assert plan.injected == {"control_crash": 1,
                                 "control_torn_write": 0,
                                 "control_slow_recover": 0}
        twin = _recover(p, tmp_path / p, clock)
        assert twin.running_jobs() == {"j1": 3, "j2": 4}
        assert twin._journal.torn_drops == 0
        outs.append((_files(tmp_path / p), _snap(twin, clock.t)))
    assert outs[0] == outs[1]
    assert "control_crash" in _mods("port")[2].CONTROL_KINDS


def test_slow_recover_dilates_replay_once_alike(tmp_path):
    for p in PKGS:
        journal, faults = _mods(p)[1], _mods(p)[2]
        j = journal.DecisionJournal(str(tmp_path / p))
        j.append({"op": "a"})
        j.close()
        plan = faults.ControlFaultPlan.parse(
            json.dumps([{"kind": "control_slow_recover",
                         "duration_s": 0.0}]))
        assert plan.has("control_slow_recover")
        j2 = journal.DecisionJournal(str(tmp_path / p), fault_plan=plan)
        j2.replay()
        j2.replay()
        assert plan.injected["control_slow_recover"] == 1
    assert "control_slow_recover" in _mods("port")[2].CONTROL_KINDS


def test_wildcard_events_fire_at_the_first_index_alike():
    for p in PKGS:
        faults = _mods(p)[2]
        plan = faults.ControlFaultPlan.parse(
            {"events": [{"kind": "control_crash"},
                        {"kind": "control_torn_write", "index": 3}]})
        assert [plan.crash_at(i) for i in range(3)] == [True, False, False]
        assert [plan.torn_at(i) for i in (2, 3, 3)] == [False, True, False]
