"""The asyncio HTTP front end over :class:`BatchScheduler`.

Two layers, deliberately separable:

* :class:`LPFrontend` — the request handler.  ``await
  frontend.handle(Request)`` runs the whole admission pipeline
  (validation -> deadline -> backpressure -> quota -> submit -> await
  futures) and returns a :class:`Response`.  It never touches a
  socket, so tests drive it directly with synthetic requests;
* :class:`RpcServer` — a minimal HTTP/1.1 server (stdlib ``asyncio``
  streams, keep-alive, Content-Length framing; no framework
  dependency) that parses bytes into :class:`Request` and writes
  :class:`Response` back.

Why asyncio and not a thread pool: micro-batching *needs* many
requests concurrently in flight — a thread-per-request front end at
batch-128 concurrency costs 128 stacks and a scheduler fight, while
one event loop holds thousands of pending solves as cheap coroutines
awaiting their scheduler futures.  The two blocking edges are kept off
the loop: ``submit`` (which can run an inline size-triggered flush and
block on the ``max_inflight`` backpressure condition variable) runs on
the frontend's one submit thread, and result waiting awaits the wrapped
``concurrent.futures.Future`` with the request's deadline budget as
timeout — on expiry the futures are cancelled, and the scheduler drops
cancelled work at flush time instead of solving it.

The event-loop thread never touches CUDA: it parses, validates, routes
and awaits.  Device work happens only on the scheduler's side — the
submit thread (which feeds the scheduler and runs its size-triggered
flushes inline, as any producer thread does), the scheduler's timer
thread and its completion worker.  Answers reach the loop as numpy.

Endpoints::

    POST /v1/solve   single {"A","b","c"} or batch {"problems":[...]}
                     headers: X-Tenant (quota key),
                              X-Deadline-Ms (latency budget),
                              X-Trace-Id (trace context, echoed back)
    GET  /metrics    Prometheus text exposition (histograms + exemplars)
    GET  /healthz    process liveness (always 200 while serving)
    GET  /readyz     scheduler accepting work (503 once closed)
    GET  /debug/trace[?trace_id=][&format=spans]
                     Chrome trace_event JSON of the span ring (load it
                     in Perfetto), optionally filtered to one trace
    GET  /debug/flight[?name=]
                     flight-recorder spool index / one snapshot body

Tracing: a ``POST /v1/solve`` whose scheduler has an enabled tracer
gets an ``rpc.handle`` span (accepting the caller's ``X-Trace-Id``
context or minting a root one) and an ``admit`` child covering the
admission pipeline; the scheduler then parents each per-LP ``request``
span under the handle span.  The trace id is echoed on every solve
response so clients can pull ``/debug/trace?trace_id=`` afterwards.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import json
import math
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.obs.export import to_chrome_trace
from repro_torch.obs.trace import (TRACE_HEADER, new_trace_context,
                                   parse_trace_header, spans_for_trace,
                                   use_context)
from repro_torch.serve_lp.rpc.admission import (TENANT_HEADER,
                                                AdmissionPolicy, RpcError,
                                                check_backpressure,
                                                deadline_budget_s,
                                                parse_solve_payload)
from repro_torch.serve_lp.rpc.prometheus import (CONTENT_TYPE,
                                                 render_metrics)
from repro_torch.serve_lp.rpc.quota import DEFAULT_TENANT, QuotaManager
from repro_torch.serve_lp.rpc.slo import SLOController

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            422: "Unprocessable Entity", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}

# A header/request-line longer than this is hostile, not a client.
_MAX_HEADER_LINE = 16 << 10
_MAX_HEADERS = 64

# Lower-cased wire header for trace contexts (headers dict keys are
# lower-cased by the parser).
_TRACE_HDR = TRACE_HEADER.lower()


@dataclasses.dataclass
class Request:
    """One parsed HTTP request (header keys lower-cased; ``query``
    holds the decoded query-string parameters, last value wins)."""

    method: str
    path: str
    headers: Dict[str, str]
    body: bytes = b""
    query: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Response:
    """One HTTP response; ``json_response``/``text_response`` build it."""

    status: int
    body: bytes
    content_type: str = "application/json"
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)

    def encode(self, *, close: bool = False) -> bytes:
        reason = _REASONS.get(self.status, "Unknown")
        head = [f"HTTP/1.1 {self.status} {reason}",
                f"Content-Type: {self.content_type}",
                f"Content-Length: {len(self.body)}"]
        head += [f"{k}: {v}" for k, v in self.headers.items()]
        if close:
            head.append("Connection: close")
        return ("\r\n".join(head) + "\r\n\r\n").encode("ascii") + self.body


def json_response(status: int, obj: Any,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(status, json.dumps(obj).encode("utf-8"),
                    headers=dict(headers or {}))


def text_response(status: int, text: str) -> Response:
    return Response(status, text.encode("utf-8"),
                    content_type="text/plain; charset=utf-8")


def error_response(err: RpcError) -> Response:
    headers = {}
    body: Dict[str, Any] = {"error": {
        "code": err.code, "message": err.message, "status": err.status}}
    if err.retry_after_s is not None and math.isfinite(err.retry_after_s):
        # Retry-After is integer seconds on the wire; the body carries
        # the precise hint for clients that can back off sub-second.
        headers["Retry-After"] = str(max(1, math.ceil(err.retry_after_s)))
        body["error"]["retry_after_ms"] = round(err.retry_after_s * 1e3, 3)
    return json_response(err.status, body, headers)


class RpcCounters:
    """Thread-safe RPC-plane counters exported at /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests: Dict[Tuple[str, int], int] = {}
        self.shed: Dict[str, int] = {}
        self.inprogress = 0
        self.lps_accepted = 0

    def record_request(self, endpoint: str, status: int) -> None:
        with self._lock:
            key = (endpoint, int(status))
            self.requests[key] = self.requests.get(key, 0) + 1

    def record_shed(self, reason: str) -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def record_accepted(self, n_lps: int) -> None:
        with self._lock:
            self.lps_accepted += int(n_lps)

    def enter(self) -> None:
        with self._lock:
            self.inprogress += 1

    def exit(self) -> None:
        with self._lock:
            self.inprogress -= 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"requests": dict(self.requests),
                    "shed": dict(self.shed),
                    "inprogress": self.inprogress,
                    "lps_accepted": self.lps_accepted}


class LPFrontend:
    """The socket-free request handler: admission control + scheduler.

    Owns the admission policy, per-tenant quotas, the optional SLO
    controller, the RPC counters and the one submit thread.
    :meth:`start` installs the SLO plans and starts the scheduler's
    wait-trigger timer; :meth:`close` shuts the scheduler down (readyz
    goes 503, healthz stays 200 so orchestrators can tell "draining"
    from "dead") and the submit thread with it.
    """

    def __init__(self, scheduler, *,
                 policy: Optional[AdmissionPolicy] = None,
                 quotas: Optional[QuotaManager] = None,
                 slo: Optional[SLOController] = None):
        self.scheduler = scheduler
        self.policy = policy if policy is not None else AdmissionPolicy()
        self.quotas = quotas if quotas is not None else QuotaManager()
        self.slo = slo
        self.counters = RpcCounters()
        self._dtype = np.dtype(scheduler.spec.dtype)
        self._started = False
        self._submitter: Optional[concurrent.futures.ThreadPoolExecutor] \
            = None
        # Observability plumbing rides on whatever the scheduler was
        # built with — the RPC layer never owns a tracer of its own.
        self._tracer = getattr(scheduler, "tracer", None)
        self._recorder = getattr(scheduler, "recorder", None)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "LPFrontend":
        if not self._started:
            if self.slo is not None:
                self.slo.install(self.scheduler,
                                 m_max=self.policy.m_max)
            self._submitter = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-lp-submit")
            self.scheduler.start()
            self._started = True
        return self

    def close(self) -> None:
        if self._started:
            self._started = False
            self._submitter.shutdown(wait=True)
            self.scheduler.close()

    @property
    def ready(self) -> bool:
        return self._started and not self.scheduler.closed

    # -- routing ----------------------------------------------------------

    async def handle(self, req: Request) -> Response:
        """Route one request; always returns a Response (typed errors
        included) and records it in the RPC counters."""
        endpoint, resp = await self._route(req)
        self.counters.record_request(endpoint, resp.status)
        return resp

    async def _route(self, req: Request) -> Tuple[str, Response]:
        if req.path == "/v1/solve":
            if req.method != "POST":
                return "solve", error_response(RpcError(
                    405, "method_not_allowed", "use POST /v1/solve"))
            return "solve", await self._solve(req)
        if req.path == "/metrics":
            return "metrics", self._metrics()
        if req.path == "/healthz":
            return "healthz", text_response(200, "ok\n")
        if req.path == "/readyz":
            if self.ready:
                return "readyz", text_response(200, "ready\n")
            return "readyz", text_response(503, "not ready\n")
        if req.path == "/debug/trace":
            return "debug_trace", self._debug_trace(req)
        if req.path == "/debug/flight":
            return "debug_flight", self._debug_flight(req)
        return "other", error_response(RpcError(
            404, "not_found", f"no route for {req.method} {req.path}"))

    # -- the solve pipeline ----------------------------------------------

    async def _solve(self, req: Request) -> Response:
        t0 = time.perf_counter()
        tracer = self._tracer
        ctx = hspan = None
        tenant = req.headers.get(TENANT_HEADER, DEFAULT_TENANT)
        if tracer is not None and tracer.enabled:
            # Accept the caller's context (malformed values fall back
            # to a fresh root — tracing never rejects a request).
            ctx = (parse_trace_header(req.headers.get(_TRACE_HDR))
                   or new_trace_context())
            hspan = tracer.start_span(
                "rpc.handle", ctx.trace_id, parent_id=ctx.span_id,
                t_start=t0, endpoint="solve", tenant=tenant)
        self.counters.enter()
        status: int = 500
        code: Optional[str] = None
        try:
            with use_context(
                    trace_id=(ctx.trace_id if ctx is not None else None),
                    span_id=(hspan.span_id if hspan is not None
                             else None),
                    tenant=tenant):
                resp = await self._admit_and_solve(req, t0, ctx, hspan)
            status = resp.status
        except RpcError as e:
            if e.status in (429, 504):
                self.counters.record_shed(e.code)
            if e.status == 504 and self._recorder is not None:
                # An SLO violation (missed deadline) is a flight-
                # recorder trigger: capture the queue/flush state that
                # made the budget impossible.
                self._recorder.trigger(f"slo:{e.code}")
            status, code = e.status, e.code
            resp = error_response(e)
        except Exception as e:   # never leak internals to the wire
            self.scheduler.metrics.record_error(
                "rpc_internal",
                warn=f"serve_lp.rpc: internal error handling a "
                     f"request ({e!r})")
            status, code = 500, "internal"
            resp = error_response(RpcError(
                500, "internal", "internal server error"))
        finally:
            self.counters.exit()
        if tracer is not None:
            if code is not None:
                tracer.end(hspan, status=status, code=code)
            else:
                tracer.end(hspan, status=status)
        if ctx is not None:
            # Echo the trace id so the client can pull
            # /debug/trace?trace_id= for this exact request.
            resp.headers.setdefault(TRACE_HEADER, ctx.trace_id)
        return resp

    async def _admit_and_solve(
            self, req: Request, t0: float,
            ctx=None, hspan=None) -> Response:
        policy = self.policy
        tracer = self._tracer
        aspan = None
        if ctx is not None:
            aspan = tracer.start_span(
                "admit", ctx.trace_id,
                parent_id=(hspan.span_id if hspan is not None
                           else ctx.span_id),
                t_start=t0)
        try:
            # 1. validation — typed 4xx before any scheduler state
            # moves.
            problems, is_batch = parse_solve_payload(
                req.body, self._dtype, policy)
            payload_deadline = None
            if b"deadline_ms" in req.body:
                try:   # only re-parse when the field can exist
                    payload_deadline = json.loads(
                        req.body).get("deadline_ms")
                except ValueError:
                    payload_deadline = None
            # 2. deadline — an already-expired budget is rejected, not
            # solved.
            budget = deadline_budget_s(
                req.headers, payload_deadline, policy)
            # 3. backpressure — shed instead of queueing unboundedly.
            # Before quota: a request the server is about to 429/503
            # anyway must not also cost the tenant tokens.
            check_backpressure(self.scheduler, policy)
            if not self.ready:
                raise RpcError(503, "not_ready",
                               "scheduler is not accepting work")
            # 4. quota — per-tenant token bucket, priced Retry-After.
            tenant = req.headers.get(TENANT_HEADER, DEFAULT_TENANT)
            retry = self.quotas.admit(tenant, cost=float(len(problems)))
            if retry == math.inf:
                raise RpcError(
                    413, "batch_exceeds_burst",
                    f"{len(problems)} LPs exceeds tenant {tenant!r}'s "
                    "burst allowance; split the batch")
            if retry > 0.0:
                raise RpcError(
                    429, "quota_exhausted",
                    f"tenant {tenant!r} is over its rate quota",
                    retry_after_s=retry)
        except RpcError as e:
            if tracer is not None:
                tracer.end(aspan, rejected=e.code)
            raise
        if tracer is not None:
            tracer.end(aspan, n_lps=len(problems))
        # 5. submit — on the submit thread: an inline size-triggered
        # flush can block on the max_inflight condition variable (and
        # launches device work), and neither may happen on the event
        # loop.
        loop = asyncio.get_running_loop()
        sched = self.scheduler
        # Per-LP request spans parent under the rpc.handle span.
        sub_ctx = (ctx.child_of(hspan.span_id)
                   if ctx is not None and hspan is not None else ctx)

        def _submit_all():
            return [sched.submit(A, b, c, trace=sub_ctx)
                    for A, b, c in problems]

        try:
            futures = await loop.run_in_executor(self._submitter,
                                                 _submit_all)
        except RuntimeError as e:     # closed under our feet
            raise RpcError(503, "not_ready", str(e))
        self.counters.record_accepted(len(problems))
        # 6. await results within the remaining budget; on expiry the
        # futures are cancelled so still-queued work is dropped at
        # flush time instead of solved.
        timeout = None
        if budget is not None:
            timeout = budget - (time.perf_counter() - t0)
            if timeout <= 0.0:
                for f in futures:
                    f.cancel()
                raise RpcError(504, "deadline_exceeded",
                               "deadline expired before dispatch")
        gathered = asyncio.gather(
            *[asyncio.wrap_future(f) for f in futures])
        try:
            results = await asyncio.wait_for(gathered, timeout=timeout)
        except asyncio.TimeoutError:
            for f in futures:
                f.cancel()
            raise RpcError(
                504, "deadline_exceeded",
                f"deadline of {budget * 1e3:.0f}ms expired while "
                "solving")
        except asyncio.CancelledError:
            for f in futures:
                f.cancel()
            raise
        except Exception as e:
            self.scheduler.metrics.record_error(
                "rpc_solve", warn=f"serve_lp.rpc: solve failed ({e!r})")
            raise RpcError(500, "solve_failed",
                           "solve failed; details in server logs and "
                           "the repro_serve_errors_total counter")
        body = [{
            "x": [float(r.x[0]), float(r.x[1])],
            "feasible": bool(r.feasible),
            "objective": float(r.objective),
            "m": int(r.m),
            "bucket_m": int(r.bucket_m),
            "batch_size": int(r.batch_size),
            "latency_ms": round(r.latency_s * 1e3, 3),
        } for r in results]
        if is_batch:
            return json_response(200, {"results": body, "n": len(body)})
        return json_response(200, {"result": body[0]})

    # -- observability ----------------------------------------------------

    def _metrics(self) -> Response:
        snap = self.scheduler.metrics.snapshot(
            self.scheduler.cache.stats())
        tracer = self._tracer
        text = render_metrics(
            snap, rpc=self.counters.snapshot(),
            quotas=self.quotas.snapshot(),
            slo=self.slo.plans() if self.slo is not None else None,
            trace=(tracer.stats() if tracer is not None else None))
        return Response(200, text.encode("utf-8"),
                        content_type=CONTENT_TYPE)

    def _debug_trace(self, req: Request) -> Response:
        """The span ring as Chrome trace_event JSON (Perfetto-loadable)
        or raw span dicts (``format=spans``), optionally filtered to
        one trace id."""
        tracer = self._tracer
        if tracer is None or not tracer.enabled:
            return error_response(RpcError(
                404, "tracing_disabled",
                "the scheduler was built without an enabled tracer; "
                "start the server with --trace"))
        spans = tracer.spans()
        trace_id = req.query.get("trace_id")
        if trace_id:
            spans = spans_for_trace(spans, trace_id.strip().lower())
        if req.query.get("format") == "spans":
            return json_response(200, {
                "spans": [s.to_dict() for s in spans],
                "ring": tracer.stats()})
        return json_response(200, to_chrome_trace(spans))

    def _debug_flight(self, req: Request) -> Response:
        """Flight-recorder spool: the index (with recorder stats), or
        one snapshot body via ``?name=``."""
        rec = self._recorder
        if rec is None:
            return error_response(RpcError(
                404, "flight_recorder_disabled",
                "no flight recorder configured; start the server with "
                "--flight-spool"))
        name = req.query.get("name")
        if name:
            snap = rec.load_snapshot(name)
            if snap is None:
                return error_response(RpcError(
                    404, "snapshot_not_found",
                    f"no spool snapshot named {name!r}"))
            return json_response(200, snap)
        return json_response(200, {
            "snapshots": rec.list_snapshots(),
            "recorder": rec.stats()})


# -- the HTTP/1.1 byte layer ----------------------------------------------

async def _read_request(reader: asyncio.StreamReader,
                        body_max: int) -> Optional[Request]:
    """Parse one request off a keep-alive connection; None on clean
    EOF; raises RpcError(400/413) on malformed/oversized input."""
    try:
        line = await reader.readline()
    except ConnectionError:
        return None
    except (ValueError, asyncio.LimitOverrunError):
        # StreamReader.readline reports a line longer than the stream
        # limit as ValueError — answer 400, don't drop the connection
        # with an unhandled task exception.
        raise RpcError(400, "bad_request", "request line too long")
    if not line:
        return None
    if len(line) > _MAX_HEADER_LINE:
        raise RpcError(400, "bad_request", "request line too long")
    try:
        method, path, version = line.decode("ascii").split()
    except ValueError:
        raise RpcError(400, "bad_request",
                       f"malformed request line {line!r}")
    if not version.startswith("HTTP/1."):
        raise RpcError(400, "bad_request",
                       f"unsupported protocol {version!r}")
    headers: Dict[str, str] = {}
    for _ in range(_MAX_HEADERS):
        try:
            line = await reader.readline()
        except (ValueError, asyncio.LimitOverrunError):
            raise RpcError(400, "bad_request", "header line too long")
        if line in (b"\r\n", b"\n", b""):
            break
        if len(line) > _MAX_HEADER_LINE:
            raise RpcError(400, "bad_request", "header line too long")
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    else:
        raise RpcError(400, "bad_request", "too many headers")
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise RpcError(400, "bad_request", "bad Content-Length")
        if n < 0:
            raise RpcError(400, "bad_request", "bad Content-Length")
        if n > body_max:
            raise RpcError(413, "body_too_large",
                           f"request body {n}B exceeds {body_max}B")
        body = await reader.readexactly(n)
    elif headers.get("transfer-encoding"):
        raise RpcError(400, "bad_request",
                       "chunked bodies are not supported; send "
                       "Content-Length")
    path, _, qs = path.partition("?")
    query = dict(urllib.parse.parse_qsl(qs)) if qs else {}
    return Request(method=method.upper(), path=path,
                   headers=headers, body=body, query=query)


class RpcServer:
    """asyncio TCP server wrapping an :class:`LPFrontend`.

    ``await start()`` binds (``port=0`` picks a free port, re-read from
    ``self.port``) and starts the frontend; ``await aclose()`` stops
    accepting, then closes the frontend (final flush + drain).
    """

    def __init__(self, frontend: LPFrontend, host: str = "127.0.0.1",
                 port: int = 0):
        self.frontend = frontend
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "RpcServer":
        self.frontend.start()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # Scheduler close blocks on drain — keep it off the loop.
        await asyncio.get_running_loop().run_in_executor(
            None, self.frontend.close)

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        body_max = self.frontend.policy.body_max_bytes
        try:
            while True:
                try:
                    req = await _read_request(reader, body_max)
                except RpcError as e:
                    writer.write(error_response(e).encode(close=True))
                    await writer.drain()
                    break
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if req is None:
                    break
                resp = await self.frontend.handle(req)
                close = (req.headers.get("connection", "").lower()
                         == "close")
                writer.write(resp.encode(close=close))
                await writer.drain()
                if close:
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass


def run_in_thread(frontend: LPFrontend, host: str = "127.0.0.1",
                  port: int = 0) -> Tuple[int, Callable[[], None]]:
    """Run an :class:`RpcServer` on a daemon thread with its own event
    loop; returns ``(bound_port, stop)``.  ``chip_smoke.py``
    and the real-socket tests use this — production runs ``python -m
    repro_torch.serve_lp.rpc`` (see ``__main__``)."""
    started = threading.Event()
    state: Dict[str, Any] = {}

    async def _main():
        server = RpcServer(frontend, host, port)
        await server.start()
        state["port"] = server.port
        state["loop"] = asyncio.get_running_loop()
        state["stop"] = asyncio.Event()
        started.set()
        try:
            await state["stop"].wait()
        finally:
            await server.aclose()

    def _run():
        try:
            asyncio.run(_main())
        except Exception as e:   # surface bind errors to the waiter
            state["error"] = e
            started.set()

    thread = threading.Thread(target=_run, name="serve-lp-rpc",
                              daemon=True)
    thread.start()
    if not started.wait(timeout=30.0):
        raise RuntimeError("RPC server failed to start within 30s")
    if "error" in state:
        raise state["error"]

    def stop() -> None:
        state["loop"].call_soon_threadsafe(state["stop"].set)
        thread.join(timeout=60.0)

    return state["port"], stop


# -- one-call construction -------------------------------------------------

def make_frontend(spec=None, *,
                  devices=None,
                  max_batch: int = 256,
                  max_wait_s: float = 0.005,
                  max_inflight: int = 2,
                  pipeline: bool = True,
                  policy: Optional[AdmissionPolicy] = None,
                  quotas: Optional[QuotaManager] = None,
                  target_p99_s: Optional[float] = None,
                  metrics=None,
                  tracer=None,
                  recorder=None) -> LPFrontend:
    """Build scheduler + admission + quota + SLO in one call — the
    shared construction path of ``__main__``, ``chip_smoke.py`` and the
    tests.  ``devices`` goes to the :class:`BatchScheduler`: ``None``
    means every visible card (raising where there is none); the tests
    pass ``[torch.device("cpu")]``.  ``tracer``/``recorder`` are handed
    to the scheduler; the frontend picks them up from there."""
    from repro_torch.serve_lp.scheduler import BatchScheduler
    scheduler = BatchScheduler(
        spec, max_batch=max_batch, max_wait_s=max_wait_s,
        max_inflight=max_inflight, pipeline=pipeline, devices=devices,
        metrics=metrics, tracer=tracer, recorder=recorder)
    slo = (SLOController(target_p99_s)
           if target_p99_s is not None else None)
    return LPFrontend(scheduler, policy=policy, quotas=quotas, slo=slo)
