"""Minimal JSON-over-HTTP service framework (copy of kubeml_tpu/control/
httpd.py; stdlib only): a ThreadingHTTPServer with pattern routes, the
shared error envelope (ml/pkg/error/error.go), the trace-id middleware,
per-endpoint HTTP metrics and the JSON client helper ``http_json``.

One change from the JAX package's: a request's HTTP metrics are recorded
before its response bytes go out (``_reply`` observes, then writes), so a
scrape that follows a response always counts it. The JAX package counts
in a ``finally`` after the write, where a scrape right after a response
can miss it. A streamed response is still counted when its last chunk
is written. ``not_ported`` is the port's own: the handler of a route
whose module is not ported yet.
"""

from __future__ import annotations

import http.client
import json
import logging
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from kubeml_tpu_torch.api.errors import (KubeMLException, NotPortedError,
                                         check_error)
from kubeml_tpu_torch.metrics.prom import HttpMetrics
from kubeml_tpu_torch.utils.trace import (TRACE_HEADER, get_trace_context,
                                          set_trace_context)

logger = logging.getLogger("kubeml_tpu_torch.http")


class Raw:
    """Non-JSON response (e.g. Prometheus text exposition).

    `headers` adds extra response headers — e.g. the serving plane's
    429s carry Retry-After so shed clients back off by contract."""

    def __init__(self, payload: bytes, content_type: str = "text/plain",
                 status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.payload = payload
        self.content_type = content_type
        self.status = status
        self.headers = headers


class Stream:
    """Chunked (streaming) response: `chunks` is an iterable of bytes,
    written as HTTP/1.1 chunked transfer encoding as they are produced —
    the serving plane's per-token /generate lines.

    If the client disconnects mid-stream the iterator is close()d (a
    generator sees GeneratorExit), which is the handler's cancellation
    hook — wrap the body in try/finally to release the stream's slot."""

    def __init__(self, chunks, content_type: str = "application/x-ndjson",
                 status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.chunks = chunks
        self.content_type = content_type
        self.status = status
        self.headers = headers


class Route:
    def __init__(self, method: str, pattern: str, handler: Callable):
        self.method = method
        self.pattern = pattern
        # '/train/{jobId}' -> ^/train/(?P<jobId>[^/]+)$
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self.regex = re.compile(f"^{regex}$")
        self.handler = handler


class JsonService:
    """Base class: subclasses call .route() then .start().

    Every request goes through a small middleware layer: the
    X-KubeML-Trace-Id header (if present) is bound to the handler thread
    so any `http_json` call the handler makes propagates it downstream,
    and request latency/status are recorded per endpoint *pattern* in
    `self.http_metrics` (exposed on GET /metrics; subclasses with their
    own /metrics route fold `http_metrics.exposition()` in themselves).
    The clock is injectable for deterministic latency tests.
    """

    name = "service"

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 clock: Optional[Callable[[], float]] = None):
        self._routes: List[Route] = []
        self._host = host
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._clock = clock or time.perf_counter
        self.http_metrics = HttpMetrics(self.name)
        self.route("GET", "/health", lambda req: {"ok": True})

    def route(self, method: str, pattern: str, handler: Callable):
        # re-registering a (method, pattern) replaces the earlier route
        # (matching is first-wins), so a subclass can extend a base
        # route — e.g. the PS folds a job-health verdict into /health
        # while keeping the bare-liveness behavior
        self._routes = [r for r in self._routes
                        if not (r.method == method
                                and r.pattern == pattern)]
        self._routes.append(Route(method, pattern, handler))

    def _h_default_metrics(self, req):
        return Raw(self.http_metrics.exposition().encode(),
                   "text/plain; version=0.0.4")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        service = self
        # default /metrics (HTTP middleware series only) unless the
        # subclass registered its own — deferred to start() so a
        # subclass route wins even though __init__ runs first
        if not any(r.method == "GET" and r.pattern == "/metrics"
                   for r in self._routes):
            self.route("GET", "/metrics", self._h_default_metrics)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("%s %s", service.name, fmt % args)

            def _dispatch(self, method):
                self._t0 = service._clock()
                self._method = method
                self._observed = False
                self._status = 0
                self._endpoint = "<unmatched>"
                trace_id = self.headers.get(TRACE_HEADER)
                prev_trace = get_trace_context()
                if trace_id:
                    set_trace_context(trace_id)
                try:
                    self._handle(method)
                finally:
                    if trace_id:
                        set_trace_context(prev_trace)
                    self._observe()   # a stream, or a reply that failed

            def _observe(self):
                """Record the request once: before a reply's bytes go out,
                or when a stream or a failed reply ends."""
                if self._observed:
                    return
                self._observed = True
                try:
                    service.http_metrics.observe(
                        self._method, self._endpoint, self._status,
                        service._clock() - self._t0)
                except Exception:
                    logger.exception("%s: http metrics observe failed",
                                     service.name)

            def _handle(self, method):
                path = self.path.split("?")[0]
                query = {}
                if "?" in self.path:
                    from urllib.parse import parse_qsl
                    query = dict(parse_qsl(self.path.split("?", 1)[1]))
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                if raw:
                    try:
                        body = json.loads(raw)
                    except ValueError:
                        body = raw
                for r in service._routes:
                    if r.method != method:
                        continue
                    m = r.regex.match(path)
                    if not m:
                        continue
                    self._endpoint = r.pattern
                    try:
                        req = Request(path=path, params=m.groupdict(),
                                      query=query, body=body, raw=raw,
                                      headers=dict(self.headers))
                        out = r.handler(req)
                        if isinstance(out, Stream):
                            self._reply_stream(out)
                        elif isinstance(out, Raw):
                            self._reply(out.status, out.payload,
                                        out.content_type, out.headers)
                        else:
                            payload = json.dumps(out if out is not None
                                                 else {}).encode()
                            self._reply(200, payload)
                    except KubeMLException as e:
                        self._reply(e.status_code, e.to_json().encode())
                    except Exception as e:  # 500 envelope
                        logger.exception("%s %s %s failed", service.name,
                                         method, path)
                        self._reply(500, json.dumps(
                            {"code": 500, "error": str(e)}).encode())
                    return
                self._reply(404, json.dumps(
                    {"code": 404, "error": f"no route {method} {path}"}
                ).encode())

            def _reply(self, code, payload: bytes,
                       content_type: str = "application/json",
                       headers: Optional[Dict[str, str]] = None):
                self._status = code
                self._observe()   # counted before the client can read it
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                for key, value in (headers or {}).items():
                    self.send_header(key, str(value))
                self.end_headers()
                self.wfile.write(payload)

            def _reply_stream(self, out: "Stream"):
                """Write a Stream as chunked transfer encoding. Once the
                status line is on the wire nothing can turn a mid-stream
                failure into a 500, so errors here only close the
                connection; handler-side errors must surface as in-band
                stream items instead."""
                self._status = out.status
                self.send_response(out.status)
                self.send_header("Content-Type", out.content_type)
                for key, value in (out.headers or {}).items():
                    self.send_header(key, str(value))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in out.chunks:
                        if not chunk:
                            continue
                        self.wfile.write(b"%x\r\n" % len(chunk)
                                         + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    # client went away mid-stream: the finally clause
                    # close()s the producer (its cancellation hook) and
                    # this connection cannot be reused
                    self.close_connection = True
                except Exception:
                    logger.exception("%s: stream producer failed",
                                     service.name)
                    self.close_connection = True
                finally:
                    close = getattr(out.chunks, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:
                            logger.exception("%s: stream close failed",
                                             service.name)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def do_PUT(self):
                self._dispatch("PUT")

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"{self.name}-http",
            daemon=True)
        self._thread.start()
        logger.info("%s listening on %s:%d", self.name, self._host,
                    self._port)
        return self._port

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    @property
    def port(self) -> int:
        return self._port


def not_ported(what: str, brings: str, status: int = 501) -> Callable:
    """A route handler that refuses with the not-ported envelope."""
    def handler(req: "Request"):
        raise NotPortedError(what, brings, status)
    return handler


class Request:
    def __init__(self, path: str, params: Dict[str, str],
                 query: Dict[str, str], body: Any, raw: bytes,
                 headers: Optional[Dict[str, str]] = None):
        self.path = path
        self.params = params
        self.query = query
        self.body = body
        self.raw = raw
        self.headers = headers or {}


# ------------------------------------------------------------------ client

def http_json(method: str, url: str, body: Any = None,
              timeout: float = 300.0, raw_body: Optional[bytes] = None,
              content_type: Optional[str] = None,
              trace_id: Optional[str] = None) -> Any:
    """JSON request helper with the shared error envelope.

    Pass raw_body/content_type instead of body for opaque payloads (e.g.
    multipart uploads); the response is still parsed as JSON.

    The thread's trace context (or an explicit trace_id) is attached as
    the X-KubeML-Trace-Id header, so a request handled inside a traced
    server thread propagates the id downstream without every call site
    knowing about tracing.
    """
    headers = {}
    trace_id = trace_id or get_trace_context()
    if trace_id:
        headers[TRACE_HEADER] = trace_id
    if raw_body is not None:
        data = raw_body
        if content_type:
            headers["Content-Type"] = content_type
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    else:
        data = None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = resp.read()
            return json.loads(payload) if payload else None
    except urllib.error.HTTPError as e:
        check_error(e.code, e.read())
    except urllib.error.URLError as e:
        raise KubeMLException(f"cannot reach {url}: {e.reason}", 503)
    except (http.client.HTTPException, OSError) as e:
        # transport-level failures urllib does not wrap (e.g.
        # RemoteDisconnected when the peer dies mid-request) must map to
        # the same retryable 503 envelope as unreachable hosts — the
        # PS's retried /start push (and every other caller with retry
        # logic) keys on KubeMLException, and a raw exception here would
        # escape those loops and fail the operation on one hiccup
        raise KubeMLException(f"cannot reach {url}: {e}", 503)
