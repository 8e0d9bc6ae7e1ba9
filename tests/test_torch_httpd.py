"""Port parity: kubeml_tpu_torch's HTTP base (control/httpd.py), error
envelope (api/errors.py) and multipart parsing (control/storage.py)
against the JAX package's.

Two JsonServices, one from each package, carry the same handlers and
answer the same requests; status, body (the ``{code, error}`` envelope
included), content type and the trace id a handler sees must be equal.
One difference is intended: the port records a request's HTTP metrics
before its response is written, so a scrape right after a response
always counts it (the JAX package's may not, ROADMAP C.2).
"""

import json
import urllib.error
import urllib.request

import pytest

pytestmark = pytest.mark.torch_port


def _service(pkg: str):
    """A started JsonService of the package with the test's handlers."""
    if pkg == "ref":
        from kubeml_tpu.api.errors import InvalidArgsError, KubeMLException
        from kubeml_tpu.control.httpd import JsonService, Raw, Stream
        from kubeml_tpu.utils.trace import get_trace_context
    else:
        from kubeml_tpu_torch.api.errors import (InvalidArgsError,
                                                 KubeMLException)
        from kubeml_tpu_torch.control.httpd import JsonService, Raw, Stream
        from kubeml_tpu_torch.utils.trace import get_trace_context

    def boom(req):
        raise ValueError("handler blew up")

    def missing(req):
        raise KubeMLException(f"no such thing: {req.params['x']}", 404)

    svc = JsonService()
    svc.route("GET", "/echo/{x}", lambda req: {
        "x": req.params["x"], "query": req.query,
        "trace": get_trace_context()})
    svc.route("POST", "/body", lambda req: {"body": req.body})
    svc.route("POST", "/raw", lambda req: {"len": len(req.raw)})
    svc.route("GET", "/none", lambda req: None)
    svc.route("GET", "/text", lambda req: Raw(b"plain\n", "text/plain",
                                              201, {"X-Extra": "1"}))
    svc.route("GET", "/stream", lambda req: Stream(
        iter([b'{"a": 1}\n', b"", b'{"b": 2}\n'])))
    svc.route("GET", "/missing/{x}", missing)
    svc.route("GET", "/bad", lambda req: (_ for _ in ()).throw(
        InvalidArgsError("bad arguments")))
    svc.route("GET", "/boom", boom)
    svc.start()
    return svc


@pytest.fixture(scope="module")
def services():
    svcs = {pkg: _service(pkg) for pkg in ("ref", "port")}
    yield svcs
    for svc in svcs.values():
        svc.stop()


def _call(url, method="GET", data=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return (resp.status, resp.read(),
                    resp.headers.get("Content-Type"),
                    resp.headers.get("X-Extra"))
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type"), None


REQUESTS = [
    ("GET", "/health", None, {}),
    ("GET", "/echo/abc?k=v&n=2", None, {}),
    ("GET", "/echo/t1", None, {"X-KubeML-Trace-Id": "feedbeef00112233"}),
    ("POST", "/body", b'{"a": [1, 2]}', {"Content-Type": "application/json"}),
    ("POST", "/body", b"\x93NUMPY not json", {}),
    ("POST", "/raw", b"x" * 1000, {}),
    ("GET", "/none", None, {}),
    ("GET", "/text", None, {}),
    ("GET", "/stream", None, {}),
    ("GET", "/missing/zz", None, {}),
    ("GET", "/bad", None, {}),
    ("GET", "/boom", None, {}),
    ("GET", "/nowhere", None, {}),
    ("DELETE", "/echo/abc", None, {}),
    ("PUT", "/body", b"{}", {}),
]


@pytest.mark.parametrize("method,path,data,headers", REQUESTS,
                         ids=[f"{m} {p}" for m, p, _, h in REQUESTS])
def test_same_handlers_answer_alike(services, method, path, data, headers):
    got = {pkg: _call(svc.url + path, method, data, headers)
           for pkg, svc in services.items()}
    assert got["port"] == got["ref"]


def test_trace_header_propagates_through_http_json(services):
    """A handler that calls on with http_json sends its thread's trace id
    on, in both packages; an explicit trace_id wins."""
    from kubeml_tpu.control import httpd as ref_httpd
    from kubeml_tpu_torch.control import httpd as port_httpd
    from kubeml_tpu_torch.utils.trace import trace_context

    for pkg, mod in (("ref", ref_httpd), ("port", port_httpd)):
        target = services["ref" if pkg == "port" else "port"].url
        hop = mod.JsonService()
        hop.route("GET", "/hop", lambda req, mod=mod, target=target:
                  mod.http_json("GET", f"{target}/echo/h"))
        hop.start()
        try:
            out = port_httpd.http_json(
                "GET", f"{hop.url}/hop", trace_id="0123456789abcdef")
            assert out["trace"] == "0123456789abcdef"
            with trace_context("aaaabbbbccccdddd"):
                assert port_httpd.http_json(
                    "GET", f"{hop.url}/hop")["trace"] == "aaaabbbbccccdddd"
        finally:
            hop.stop()


@pytest.mark.parametrize("path,status", [
    ("/missing/q", 404), ("/bad", 400), ("/boom", 500), ("/nowhere", 404)])
def test_http_json_raises_the_envelope(services, path, status):
    from kubeml_tpu.api.errors import KubeMLException as RefExc
    from kubeml_tpu.control.httpd import http_json as ref_http_json
    from kubeml_tpu_torch.api.errors import KubeMLException as PortExc
    from kubeml_tpu_torch.control.httpd import http_json as port_http_json

    seen = []
    for fn, exc in ((ref_http_json, RefExc), (port_http_json, PortExc)):
        with pytest.raises(exc) as ei:
            fn("GET", services["port"].url + path)
        seen.append((ei.value.status_code, ei.value.message))
    assert seen[0] == seen[1] and seen[1][0] == status


def test_http_json_unreachable_is_a_503():
    from kubeml_tpu_torch.api.errors import KubeMLException
    from kubeml_tpu_torch.control.httpd import JsonService, http_json

    svc = JsonService()
    svc.start()
    url = svc.url
    svc.stop()
    with pytest.raises(KubeMLException) as ei:
        http_json("GET", f"{url}/health", timeout=5)
    assert ei.value.status_code == 503
    assert ei.value.message.startswith("cannot reach")


@pytest.mark.parametrize("status,body", [
    (200, b"ignored"), (404, b'{"code": 404, "error": "gone"}'),
    (400, b'{"error": "no code"}'), (500, b"not json"), (503, b""),
    (418, b"\xff\xfe broken utf-8"), (409, b'{"code": 409}')])
def test_check_error_decodes_like_the_reference(status, body):
    from kubeml_tpu.api import errors as ref
    from kubeml_tpu_torch.api import errors as port

    def outcome(mod):
        try:
            mod.check_error(status, body)
            return None
        except mod.KubeMLException as e:
            return e.status_code, e.message, e.to_json()
    assert outcome(port) == outcome(ref)


@pytest.mark.parametrize("name", ["", "fn1"])
def test_error_types_match(name):
    from kubeml_tpu.api import errors as ref
    from kubeml_tpu_torch.api import errors as port

    for cls in ("FunctionNotFoundError", "JobNotFoundError",
                "DatasetNotFoundError"):
        a, b = getattr(ref, cls)(name), getattr(port, cls)(name)
        assert (a.status_code, a.to_json()) == (b.status_code, b.to_json())


def test_not_ported_wording_is_the_jobs():
    """Every refusal reads as the job's refusal of an unported option."""
    from kubeml_tpu_torch.api.errors import NotPortedError
    from kubeml_tpu_torch.api.types import TrainOptions
    from kubeml_tpu_torch.train.job import _reject_unported

    with pytest.raises(NotPortedError) as ei:
        _reject_unported(TrainOptions(continual=True), None)
    assert ei.value.status_code == 400
    assert ei.value.message == NotPortedError("continual",
                                              "the continual mode").message
    assert NotPortedError("GET /x", "y", 501).status_code == 501


def test_metrics_count_a_request_before_its_response():
    """The port counts a request before writing its response: /metrics
    read right after a /health always shows it (repeated, as a race
    would show only sometimes)."""
    from kubeml_tpu_torch.control.httpd import JsonService

    svc = JsonService()
    svc.start()
    try:
        series = ('kubeml_http_requests_total{service="service",'
                  'method="GET",endpoint="/health",status="200"} ')
        for i in range(1, 41):
            _call(svc.url + "/health")
            text = _call(svc.url + "/metrics")[1].decode()
            line = next(ln for ln in text.splitlines()
                        if ln.startswith(series))
            assert float(line.split()[-1]) == i, (i, line)
    finally:
        svc.stop()


def test_unmatched_and_stream_requests_are_counted():
    from kubeml_tpu_torch.control.httpd import JsonService, Stream

    svc = JsonService()
    svc.route("GET", "/s", lambda req: Stream(iter([b"x\n"])))
    svc.start()
    try:
        _call(svc.url + "/s")
        _call(svc.url + "/nope")
        text = svc.http_metrics.exposition()
        assert ('endpoint="/s",status="200"} 1.0' in text)
        assert ('endpoint="<unmatched>",status="404"} 1.0' in text)
    finally:
        svc.stop()


def _bodies():
    import numpy as np

    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (40, 32, 32, 3)).astype(np.uint8)
    npy = arr.tobytes()   # raw bytes holding every value incl. CR/LF
    return [
        {"x-train": ("xtr.npy", npy), "y-train": ("ytr.npy", b"\r\n--"),
         "x-test": ("a b.npy", b""), "y-test": ("yte.pkl", b"\n\r\n\r\n")},
        {"only": ("f.npy", b"payload\r\n")},
        {"x-train": ("", npy[:999])},
    ]


@pytest.mark.parametrize("files", _bodies(), ids=["four", "one", "nofname"])
def test_multipart_parse_matches_the_reference(files):
    """The port's bytes.find parser gives the email parser's result on
    both clients' bodies."""
    from kubeml_tpu.control import client as ref_client
    from kubeml_tpu.control.storage import parse_multipart as ref_parse
    from kubeml_tpu_torch.control import client as port_client
    from kubeml_tpu_torch.control.storage import parse_multipart

    for mod in (ref_client, port_client):
        body, ctype = mod._multipart_body(files)
        assert parse_multipart(ctype, body) == ref_parse(ctype, body) \
            == files


def test_multipart_rejects_what_the_reference_rejects():
    from kubeml_tpu_torch.api.errors import InvalidFormatError
    from kubeml_tpu_torch.control.storage import parse_multipart

    with pytest.raises(InvalidFormatError):
        parse_multipart("application/json", b"{}")
    with pytest.raises(InvalidFormatError):
        parse_multipart("multipart/form-data; boundary=abc",
                        b"--abc\r\nContent-Disposition: form-data; "
                        b'name="x"\r\n\r\npayload without an end')


def test_wire_helpers_match():
    from kubeml_tpu.api import types as ref
    from kubeml_tpu_torch.api import types as port

    a = port.InferRequest(model_id="m1", data=[[1.0, 2.0]])
    b = ref.InferRequest(model_id="m1", data=[[1.0, 2.0]])
    assert a.to_dict() == b.to_dict()
    assert port.InferRequest.from_dict(b.to_dict()) == a
    summaries = [port.DatasetSummary("d", 3, 1),
                 port.DatasetSummary("e", 0, 0)]
    assert port.dumps(summaries) == ref.dumps(
        [ref.DatasetSummary("d", 3, 1), ref.DatasetSummary("e", 0, 0)])
    assert port.dumps({"k": 1}) == ref.dumps({"k": 1})
    assert json.loads(port.dumps(a)) == b.to_dict()
