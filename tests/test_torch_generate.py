"""Port parity: serving through the PS — POST /generate, /flight, the
serve:<model> traces and health — against the JAX package's PS, over
real HTTP on localhost.

One JAX ParameterServer and one port PS (device="cpu"), 2 slots + a
queue of 1 each, serve the same gpt-nano checkpoint the port's writer
saved in the JAX package's format. Greedy tokens, status codes, error
bodies and Retry-After headers compare exactly. Where a test must hold
streams in their slots, a serve_slow_step plan (each package's own
faults module) slows every engine step; every wait polls state with a
deadline.

(The serving cases of the port's control plane, kept out of
tests/test_torch_control_plane.py: tools/check_fault_tests.py holds any
test file that names a fault plan to coordinate-driven waits, and the
training waits of that file read the wall clock.)
"""

import os
import time
import urllib.request

import pytest

pytestmark = pytest.mark.torch_port

NANO = dict(vocab_size=512, max_len=64, hidden=32, layers=2, heads=2,
            ffn=64)


def _save_nano(model_id, seed):
    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(model_id, {"params": random_flax_params(**NANO,
                                                            seed=seed)},
                    {"model": "gpt-nano", "function": "gpt-nano",
                     "parallelism": 1, "epoch": 0})


def _post(url, body, timeout=120.0):
    """(status, headers, body bytes) of a POST, error answers included."""
    import json
    import urllib.error

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _lines(raw):
    import json
    return [json.loads(line) for line in raw.splitlines()]


@pytest.fixture(scope="module")
def serve_pair(tmp_path_factory):
    """{"ref"|"port": ParameterServer} over one KUBEML_TPU_HOME holding
    the gpt-nano checkpoints "servenano" and "swapnano"."""
    from kubeml_tpu.control.ps import ParameterServer as RefPS
    from kubeml_tpu_torch.control.ps import ParameterServer

    tmp = str(tmp_path_factory.mktemp("serve"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEML_TPU_HOME", os.path.join(tmp, "home"))
        _save_nano("servenano", seed=5)
        _save_nano("swapnano", seed=6)
        pss = {"ref": RefPS(serve_slots=2, serve_queue_depth=1),
               "port": ParameterServer(device="cpu", serve_slots=2,
                                       serve_queue_depth=1)}
        for ps in pss.values():
            ps.start()
        try:
            yield pss
        finally:
            for ps in pss.values():
                ps.stop()


def _slow(ps, model_id, seconds):
    """Slow every step of the model's replicas (a serve_slow_step plan in
    the package's own faults module), so streams hold their slots."""
    import importlib

    pkg = type(ps).__module__.split(".")[0]
    faults = importlib.import_module(f"{pkg}.faults")
    for _, engine in ps._serve[model_id][1].engines():
        engine.fault_plan = faults.ServeFaultPlan.parse(
            [{"kind": "serve_slow_step", "duration_s": seconds}])


def _unslow(ps, model_id):
    for _, engine in ps._serve[model_id][1].engines():
        engine.fault_plan = None


def test_generate_streams_the_references_tokens(serve_pair):
    """The ndjson stream ({"token": id} per token, then {"done": ...})
    and the stream=false document carry the JAX PS's greedy tokens; each
    answer echoes its trace id header."""
    out = {}
    for key, ps in serve_pair.items():
        body = {"model_id": "servenano", "prompt": [5, 6, 7, 8, 9],
                "max_new_tokens": 6}
        status, hdrs, raw = _post(f"{ps.url}/generate", body)
        assert status == 200
        assert hdrs["Content-Type"] == "application/x-ndjson"
        assert hdrs.get("X-KubeML-Trace-Id")
        events = _lines(raw)
        status, _, doc = _post(f"{ps.url}/generate",
                               dict(body, stream=False, prompt=[9, 8, 7]))
        assert status == 200
        out[key] = (events, doc)
    assert out["port"] == out["ref"]
    events, _ = out["port"]
    tokens = [e["token"] for e in events[:-1]]
    assert len(tokens) == 6 and events[-1] == {"done": True,
                                               "tokens": tokens}


BAD_GENERATE = [
    {"prompt": [5, 6]},                                     # no model_id
    {"model_id": "servenano"},                              # no prompt
    {"model_id": "servenano", "prompt": [0, 0]},            # all pads
    {"model_id": "servenano", "prompt": ["x"]},             # not ids
    {"model_id": "servenano", "prompt": [5], "max_new_tokens": 0},
    {"model_id": "servenano", "prompt": [5], "max_new_tokens": 64},
    {"model_id": "servenano", "prompt": [5], "deadline_ms": -1},
    {"model_id": "servenano", "prompt": [5], "deadline_ms": "soon"},
    {"model_id": "nosuchmodel", "prompt": [5]},
]


@pytest.mark.parametrize("body", BAD_GENERATE,
                         ids=[str(i) for i in range(len(BAD_GENERATE))])
def test_generate_rejects_like_the_reference(serve_pair, body):
    statuses = {key: _post(f"{ps.url}/generate", body)[0]
                for key, ps in serve_pair.items()}
    assert statuses["port"] == statuses["ref"]
    assert statuses["port"] in (400, 404)


def test_generate_sheds_with_the_references_retry_after(serve_pair):
    """Two streams hold both slots and a 40-token prompt waits in the
    queue (39 prompt tokens of backlog): a deadline the backlog makes
    infeasible and a request past capacity both answer 429 with the
    JAX PS's body and Retry-After."""
    import json
    import threading

    out = {}
    for key, ps in serve_pair.items():
        _post(f"{ps.url}/generate", {"model_id": "servenano",
                                     "prompt": [5], "max_new_tokens": 2})
        _slow(ps, "servenano", 0.05)
        fleet = ps._serve["servenano"][1]
        held = []

        def hold(prompt, n):
            t = threading.Thread(target=lambda: held.append(_post(
                f"{ps.url}/generate", {"model_id": "servenano",
                                       "prompt": prompt,
                                       "max_new_tokens": n})))
            t.start()
            return t

        threads = [hold([5], 40), hold([6], 40)]
        assert _until(lambda: sum(e.active() for _, e in fleet.engines())
                      == 2)
        threads.append(hold(list(range(1, 41)), 8))
        assert _until(lambda: fleet.snapshot()["serve_queue_depth"] == 1)
        probes = []
        for extra in ({"deadline_ms": 100}, {}):
            status, hdrs, raw = _post(f"{ps.url}/generate", dict(
                {"model_id": "servenano", "prompt": [7, 8],
                 "max_new_tokens": 4}, **extra))
            probes.append((status, hdrs.get("Retry-After"),
                           json.loads(raw)))
        _unslow(ps, "servenano")
        for t in threads:
            t.join(120)
        assert [s for s, _, _ in held] == [200, 200, 200]
        out[key] = probes
    assert out["port"] == out["ref"]
    infeasible, full = out["port"]
    assert infeasible[:2] == (429, "1")
    assert "deadline_ms=100 is infeasible: ~0.15s" in infeasible[2]["error"]
    assert full[:2] == (429, "1")
    assert "capacity" in full[2]["error"]


def _until(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_generate_hot_swaps_to_a_newer_checkpoint(serve_pair):
    """A stream attached before a newer checkpoint of the model is saved
    finishes on the old weights; the next request decodes the new ones;
    the weight generation gauge reads 2 and the old generation retires.
    Both generations' tokens equal the JAX PS's."""
    import threading

    from kubeml_tpu_torch.convert import random_flax_params
    from kubeml_tpu_torch.train.checkpoint import save_checkpoint

    prompt = [11, 12, 13, 14, 15]
    out = {}
    for key, ps in serve_pair.items():
        _post(f"{ps.url}/generate", {"model_id": "swapnano",
                                     "prompt": prompt, "max_new_tokens": 2})
        fleet = ps._serve["swapnano"][1]
        _slow(ps, "swapnano", 0.02)
        first = []
        t = threading.Thread(target=lambda: first.append(_post(
            f"{ps.url}/generate", {"model_id": "swapnano", "prompt": prompt,
                                   "max_new_tokens": 12})))
        t.start()
        assert _until(lambda: sum(e.active() for _, e in fleet.engines())
                      == 1)
        save_checkpoint("swapnano",
                        {"params": random_flax_params(**NANO, seed=7)},
                        {"model": "gpt-nano", "function": "gpt-nano"})
        status, _, raw = _post(f"{ps.url}/generate", {
            "model_id": "swapnano", "prompt": prompt, "max_new_tokens": 12})
        t.join(120)
        _unslow(ps, "swapnano")
        assert status == 200 and first[0][0] == 200
        old, new = _lines(first[0][2])[-1], _lines(raw)[-1]
        assert _until(lambda: fleet.snapshot()[
            "serve_active_generations"] == 1)
        snap = fleet.snapshot()
        text = urllib.request.urlopen(f"{ps.url}/metrics").read().decode()
        gauge = [ln for ln in text.splitlines() if ln.startswith(
            'kubeml_serve_weight_generation{model="swapnano"}')]
        out[key] = (old, new, snap["serve_weight_generation"], gauge)
        _save_nano("swapnano", seed=6)      # the next package's gen 1
    assert out["port"] == out["ref"]
    old, new, gen, gauge = out["port"]
    assert old["done"] and new["done"] and old["tokens"] != new["tokens"]
    assert gen == 2 and gauge == [
        'kubeml_serve_weight_generation{model="swapnano"} 2.0']


def test_generate_disconnect_cancels_and_frees_pages(serve_pair):
    """A client that closes its connection mid-stream cancels its
    request: the stream ends "cancelled" and its slot and KV pages go
    back to the pool."""
    import http.client
    import json

    ps = serve_pair["port"]
    _post(f"{ps.url}/generate", {"model_id": "servenano", "prompt": [5],
                                 "max_new_tokens": 2})
    cancelled0 = _cancelled(ps)
    fleet = ps._serve["servenano"][1]
    (_, engine), = fleet.engines()
    _slow(ps, "servenano", 0.02)
    host, port = ps.url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/generate", body=json.dumps(
        {"model_id": "servenano", "prompt": list(range(30, 42)),
         "max_new_tokens": 40}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert "token" in json.loads(resp.readline())
    assert engine.active() == 1
    conn.close()
    try:
        assert _until(lambda: engine.active() == 0)
        assert _until(lambda: fleet.snapshot()["serve_active_slots"] == 0)
        assert engine.pager.check_invariants() == []
        # only cache-registered prompt pages may stay (unreferenced)
        assert engine.pager.free_pages + engine.pager.cached_pages == \
            engine.geom.usable_pages
        assert _until(lambda: _cancelled(ps) == cancelled0 + 1)
    finally:
        _unslow(ps, "servenano")


def _cancelled(ps):
    """kubeml_serve_requests_total{outcome="cancelled"} of servenano."""
    text = urllib.request.urlopen(f"{ps.url}/metrics").read().decode()
    key = 'kubeml_serve_requests_total{model="servenano",outcome="cancelled"}'
    return sum(float(ln.split()[-1]) for ln in text.splitlines()
               if ln.startswith(key))


def test_generate_observability_routes(serve_pair):
    """/flight returns the engines' records, /trace?id=serve:<model>
    holds one "generate" tree per request under the trace id of its
    response header, /health?id=serve:<model> gives a verdict with the
    JAX PS's fields, and /metrics carries the serve families."""
    from kubeml_tpu_torch.control.httpd import http_json

    docs = {}
    for key, ps in serve_pair.items():
        status, hdrs, _ = _post(f"{ps.url}/generate", {
            "model_id": "servenano", "prompt": list(range(20, 29)),
            "max_new_tokens": 5})
        assert status == 200
        tid = hdrs["X-KubeML-Trace-Id"]
        flight = http_json("GET", f"{ps.url}/flight?id=serve:servenano")
        trace = http_json("GET", f"{ps.url}/trace?id=serve:servenano")
        mine = [e for e in trace["traceEvents"]
                if e.get("args", {}).get("trace_id") == tid]
        roots = [e for e in mine if e["name"] == "generate"]
        assert len(roots) == 1 and roots[0]["ph"] == "X"
        assert all(e["args"].get("parent") == "generate"
                   for e in mine if e is not roots[0])
        verdict = http_json("GET", f"{ps.url}/health?id=serve:servenano")
        text = urllib.request.urlopen(f"{ps.url}/metrics").read().decode()
        docs[key] = (sorted(flight), sorted(flight["records"][-1]),
                     flight["replicas"], sorted({e["name"] for e in mine}),
                     sorted(verdict), sorted(verdict["latest"]),
                     verdict["state"] in ("healthy", "warning"),
                     sorted({ln.split()[2] for ln in text.splitlines()
                             if ln.startswith("# TYPE kubeml_serve_")}))
    ref, port = docs["ref"], docs["port"]
    assert port[:5] == ref[:5]
    # the serving snapshot carries the same fields, the cost ledger's
    # serve_cost_programs included
    assert set(ref[5]) == set(port[5])
    assert port[6] and ref[6]
    # the same serve families, the speculative-decode counters included
    assert set(ref[7]) == set(port[7])
    assert {"generate", "route", "admit", "first_token", "finish"} <= \
        set(port[3])


def test_generate_scale_to_zero_cold_start_round_trip_e2e(tmp_home):
    """A fleet with serve_replicas_min=0 scales itself to zero after the
    idle budget (its autoscale thread), and the next POST /generate
    cold-starts a replica and returns the same tokens."""
    from kubeml_tpu_torch.control.ps import ParameterServer

    _save_nano("zeronano", seed=9)
    ps = ParameterServer(device="cpu", serve_slots=2, serve_queue_depth=1,
                         serve_replicas_min=0, serve_replicas_max=1,
                         serve_scale_to_zero_s=0.2)
    ps.start()
    try:
        body = {"model_id": "zeronano", "prompt": [5, 6, 7, 8],
                "max_new_tokens": 4, "stream": False}
        status, _, first = _post(f"{ps.url}/generate", body)
        assert status == 200
        fleet = ps._serve["zeronano"][1]
        assert fleet.path_counts["cold_start"] == 1
        # the count moves once the retired replica has stopped, after
        # replica_count already reads 0
        assert _until(lambda: fleet.scale_to_zero_total >= 1), \
            "fleet never scaled to zero"
        assert fleet.replica_count == 0
        status, _, second = _post(f"{ps.url}/generate", body)
        assert status == 200 and second == first
        assert fleet.cold_starts_total == 2
    finally:
        ps.stop()


def test_top_renders_the_serving_pane_from_a_live_ps(tmp_home, capsys):
    """`kubeml top --id serve:<model>` against a live port deployment
    prints the serving pane (slots, queue, TTFT) and the fleet line from
    the PS's merged snapshot."""
    from kubeml_tpu_torch.cli.main import main
    from kubeml_tpu_torch.control.deployment import start_deployment

    _save_nano("topnano", seed=10)
    dep = start_deployment(device="cpu", serve_slots=2, serve_queue_depth=1)
    try:
        status, _, _ = _post(f"{dep.ps.url}/generate", {
            "model_id": "topnano", "prompt": [5, 6, 7], "max_new_tokens": 3})
        assert status == 200
        capsys.readouterr()
        main(["--controller", dep.controller_url, "top", "--id",
              "serve:topnano", "--iterations", "1"])
        out = capsys.readouterr().out
    finally:
        dep.stop()
    assert out.startswith("job serve:topnano  state=")
    assert "serve: slots 0/2  queue 0/1" in out
    assert "ttft breakdown: queue" in out
    assert "fleet: replicas 1 [1..1]" in out


@pytest.mark.parametrize("budget_mb,kept", [(0.0, ["lru1"]),
                                            (512.0, ["lru0", "lru1"])])
def test_infer_cache_yields_to_the_serving_budget(tmp_home, budget_mb, kept):
    """Cached checkpoints and the serving fleets share one device budget
    (serve_hbm_budget_mb): with it exhausted the LRU keeps only the
    freshest module, as the JAX PS's does; with room both stay."""
    from kubeml_tpu.control.ps import ParameterServer as RefPS
    from kubeml_tpu_torch.control.ps import ParameterServer

    for i in range(2):
        _save_nano(f"lru{i}", seed=i)
    caches = []
    for ps in (RefPS(infer_cache_size=4, serve_hbm_budget_mb=budget_mb),
               ParameterServer(device="cpu", infer_cache_size=4,
                               serve_hbm_budget_mb=budget_mb)):
        ps._load_for_infer("lru0")
        ps._load_for_infer("lru1")
        caches.append(list(ps._infer_cache))
    assert caches[1] == caches[0] == kept


def test_infer_cache_yields_to_a_live_fleets_kv_slabs_alike(tmp_home):
    """With a live CPU fleet in each PS, the /infer cache yields to the
    fleet's KV slabs only, as the JAX PS's does: a budget that holds the
    slab and the three cached modules keeps all three in both (a
    footprint that also counted the replica's params would evict the
    oldest)."""
    import numpy as np

    from kubeml_tpu.control.ps import ParameterServer as RefPS
    from kubeml_tpu_torch.control.ps import ParameterServer
    from kubeml_tpu_torch.train.checkpoint import load_checkpoint

    for name, seed in (("lrufleet", 3), ("lru0", 0), ("lru1", 1)):
        _save_nano(name, seed=seed)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return np.asarray(tree).nbytes
    module_bytes = nbytes(load_checkpoint("lru0")[0])
    caches = []
    pss = [RefPS(infer_cache_size=4, serve_slots=2),
           ParameterServer(device="cpu", infer_cache_size=4, serve_slots=2)]
    try:
        slabs = []
        for ps in pss:
            fleet = ps._serve_service("lrufleet")
            slabs.append(sum(svc.engine.slab.device_bytes
                             for svc in fleet.replicas()))
        assert slabs[0] == slabs[1] > 0
        budget = slabs[0] + 3 * module_bytes + module_bytes // 2
        for ps in pss:
            ps.serve_hbm_budget_bytes = budget
            ps._load_for_infer("lru0")
            ps._load_for_infer("lru1")
            caches.append(list(ps._infer_cache))
    finally:
        for ps in pss:
            ps.stop()
    assert caches[1] == caches[0] == ["lrufleet", "lru0", "lru1"]
