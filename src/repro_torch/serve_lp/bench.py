"""Open-loop serving benchmark for the LP scheduler.

Synthetic traffic is drawn from deterministic numpy generators (seeded,
pipeline-style): constraint counts are mixed across a log2 ladder and
each request is feasible, infeasible or degenerate (all constraints
tight at one point) per a fixed mix.  The generators are the reference
benchmark's (``repro.serve_lp.bench``), draw for draw, so request ``i`` of
seed ``s`` is the same LP in both packages, bit for bit.  Requests are
submitted open-loop at a target rate; the report covers throughput,
p50/p99 latency, padding waste, executable-cache hit rate and the
pipeline gauges (in-flight depth, overlapped dispatches, device-idle
estimate).

``--open-loop`` removes the rate throttle entirely (saturating burst).
Where a flush's solve outlasts the host's assembly of the next one, the
pipelined scheduler then keeps >= 2 flushes in flight, and
``--assert-overlap`` turns that claim into a hard check.  The port's
devices never give it: a CPU device solves a flush inside its dispatch,
and one H100 is done with each flush long before one producer thread has
assembled the next, so the flag is kept for the reference's command line
and fails there.
``--no-pipeline`` runs the same traffic through the stop-and-go loop for
an A/B of the overlap win.

``--sharding mesh`` is the flush path (uneven per-device shards and
cross-bucket fusing); ``--assert-fused`` turns "underfull buckets
actually fused into shared launches" into a hard check.  The reference's
legacy ``pmap`` mode is not ported: ``--sharding pmap`` raises its
``ValueError``.

``--trace-out trace.json`` runs the traffic under a ``repro_torch.obs``
tracer and writes the span ring as Chrome ``trace_event`` JSON (load it
at ui.perfetto.dev); the report's ``device_idle_frac`` / ``device_idle_s``
then come from the per-device ``device.solve`` spans.  Those spans are
host-observed dispatch-to-complete windows, so the idle fraction is a
lower bound.  ``--assert-trace`` hard-fails unless every completed
request has its full submit->scatter span chain and ``min(2, devices)``
devices show non-empty ``device.solve`` tracks (one card gives one
track; the reference asks for two on any host).  Without tracing the
bench asserts the scheduler's span path stayed a no-op (no span
started in the run).

Every entry point runs on the card unless ``devices`` names others
(``main(argv, devices=[torch.device("cpu")])`` on a CPU-only machine).
Failed checks raise ``AssertionError``.

    python -m repro_torch.serve_lp.bench --smoke --method kernel
    python -m repro_torch.serve_lp.bench --smoke --open-loop --assert-fused
    python -m repro_torch.serve_lp.bench --smoke --open-loop \\
        --trace-out trace.json --assert-trace
    python -m repro_torch.serve_lp.bench --smoke --rpc --assert-rpc
    python -m repro_torch.serve_lp.bench --requests 2000 --rate 5000 \\
        --method kernel --max-batch 128
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve_lp.scheduler import BatchScheduler
from repro_torch.solver import SolverSpec

KINDS = ("feasible", "infeasible", "degenerate")
SIZES = (8, 16, 32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass
class BenchConfig:
    requests: int = 2000
    rate: float = 5000.0          # target submit rate, LPs/s
    m_min: int = 8
    m_max: int = 1024
    kind_mix: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    method: str = "rgb"
    max_batch: int = 64
    max_wait_s: float = 0.02
    tile: int = 16
    chunk: int = 0
    seed: int = 0
    check: int = 8                # requests re-solved directly, 0 = off
    warmup: bool = True           # touch every flush shape, reset counters
    interpret: Optional[bool] = None
    pipeline: bool = True         # overlap assembly with in-flight solves
    max_inflight: int = 2         # dispatch backpressure bound
    open_loop: bool = False       # saturating burst: ignore `rate`
    assert_overlap: bool = False  # require >=2 flushes seen in flight
    sharding: str = "mesh"        # flush path; "pmap" raises ValueError
    assert_fused: bool = False    # require >=1 cross-bucket fused flush
    # --rpc mode: drive the HTTP front end instead of in-process submit
    rpc: bool = False
    rpc_clients: int = 8          # closed-loop client threads
    rpc_burst: int = 0            # open-loop overload posts (0 = 2x requests)
    rpc_target_p99_ms: Optional[float] = None   # enable SLO controller
    rpc_p99_bound_ms: float = 2500.0            # --assert-rpc bound
    assert_rpc: bool = False      # enforce p99 + shed-rate bounds
    trace: bool = False           # run under a repro_torch.obs tracer
    trace_out: Optional[str] = None   # write Chrome trace JSON here
    assert_trace: bool = False    # enforce span chains + device tracks


def smoke_config() -> BenchConfig:
    """CI-sized run: a few hundred LPs, m capped at 512."""
    return BenchConfig(requests=160, rate=2000.0, m_max=512,
                       max_batch=32, max_wait_s=0.01, check=8)


def _spec(cfg: BenchConfig) -> SolverSpec:
    return SolverSpec(backend=cfg.method, tile=cfg.tile, chunk=cfg.chunk,
                      interpret=cfg.interpret)


def _sizes(cfg: BenchConfig) -> List[int]:
    return [m for m in SIZES if cfg.m_min <= m <= cfg.m_max]


# -- deterministic request generators (the reference's, draw for draw) ---

def _feasible(rng: np.random.Generator, m: int, slack_lo: float = 0.1):
    xstar = rng.uniform(-50.0, 50.0, 2)
    theta = rng.uniform(0.0, 2.0 * np.pi, m)
    A = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    s = rng.uniform(slack_lo, 5.0, m)
    b = A @ xstar + s
    phi = rng.uniform(0.0, 2.0 * np.pi)
    c = np.array([np.cos(phi), np.sin(phi)])
    return (A.astype(np.float32), b.astype(np.float32),
            c.astype(np.float32))


def _degenerate(rng: np.random.Generator, m: int):
    """Every constraint tight at one point: the feasible set collapses to
    a single massively-degenerate vertex."""
    A, b, c = _feasible(rng, m)
    xstar = rng.uniform(-50.0, 50.0, 2).astype(np.float32)
    b = (A @ xstar).astype(np.float32)
    return A, b, c


def _infeasible(rng: np.random.Generator, m: int):
    A, b, c = _feasible(rng, m)
    A[0] = (1.0, 0.0)
    b[0] = -1.0
    A[1] = (-1.0, 0.0)
    b[1] = -1.0
    return A, b, c


_GEN = {"feasible": _feasible, "infeasible": _infeasible,
        "degenerate": _degenerate}


def make_request(cfg: BenchConfig, i: int):
    """Request #i of the stream — a pure function of (seed, i)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, i, 0x52E41]))
    sizes = _sizes(cfg)
    m = int(sizes[rng.integers(len(sizes))])
    kind = KINDS[rng.choice(3, p=np.asarray(cfg.kind_mix))]
    A, b, c = _GEN[kind](rng, max(m, 2))
    return A, b, c, kind


# -- the open-loop load generator ----------------------------------------

def _warmup(cfg: BenchConfig, sched: BatchScheduler,
            quiet: bool) -> None:
    """Run every (m-bucket, b_pad-rung) flush shape traffic can produce,
    wait-triggered partial flushes included (first touch of each shape's
    pooled pinned buffers and of the device), then zero all counters so
    the report shows warm serving behaviour."""
    from repro_torch.serve_lp.buckets import bucket_batch, bucket_m
    from repro_torch.serve_lp.metrics import ServeMetrics
    t0 = time.perf_counter()
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xAA]))
    buckets = sorted({bucket_m(m, base=sched.bucket_base)
                      for m in _sizes(cfg)})
    for bm in buckets:
        # b_pad ladder: a flush holds 1..max_batch requests, so its b_pad
        # is one of the unit*2^k rungs up to bucket_batch(max_batch,
        # unit), the unit being the tile pinned for this bucket.
        unit = sched._pin_for_bucket(bm, cfg.max_batch).tile
        rungs, b = set(), unit
        while b <= bucket_batch(cfg.max_batch, unit):
            rungs.add(min(b, cfg.max_batch))
            b *= 2
        for n in sorted(rungs):
            futs = [sched.submit(*_feasible(rng, min(bm, cfg.m_max)))
                    for _ in range(n)]
            sched.flush()
            for f in futs:
                f.result(timeout=300.0)
    sched.cache.reset_stats()
    sched.metrics = ServeMetrics()
    if not quiet:
        print(f"[serve_lp.bench] warmup ran {len(sched.cache)} "
              f"flush shapes in {time.perf_counter() - t0:.2f}s")


def run_traffic(cfg: BenchConfig, *, quiet: bool = False,
                devices: Optional[Sequence] = None
                ) -> Tuple[Dict, BatchScheduler]:
    traced = cfg.trace or cfg.trace_out is not None or cfg.assert_trace
    tracer = None
    if traced:
        from repro_torch.obs import Tracer
        # Ring sized so a full smoke run (6 spans per request upper
        # bound) survives without wraparound — dropped spans would break
        # the --assert-trace chain check.
        tracer = Tracer(enabled=True,
                        capacity=max(16384, 8 * cfg.requests))
    sched = BatchScheduler(_spec(cfg), max_batch=cfg.max_batch,
                           max_wait_s=cfg.max_wait_s,
                           pipeline=cfg.pipeline,
                           max_inflight=cfg.max_inflight,
                           sharding=cfg.sharding, devices=devices,
                           tracer=tracer)
    if cfg.warmup:
        _warmup(cfg, sched, quiet)
        if traced:
            sched.tracer.buffer.clear()   # measured phase only
    started = sched.tracer.spans_started
    futures: List = []
    t_wall0 = time.perf_counter()
    with sched:
        t0 = time.perf_counter()
        for i in range(cfg.requests):
            if not cfg.open_loop:
                target = t0 + i / cfg.rate
                now = time.perf_counter()
                if target > now:
                    time.sleep(target - now)
            A, b, c, _ = make_request(cfg, i)
            futures.append(sched.submit(A, b, c))
    # context exit stops the timer thread, flushes the tail and joins
    # every in-flight flush
    results = [f.result(timeout=60.0) for f in futures]
    wall = time.perf_counter() - t_wall0

    if cfg.check:
        _check_against_direct(cfg, results, sched.devices[0])
    snap = sched.metrics.snapshot(sched.cache.stats())
    snap["wall_s"] = wall
    snap["n_feasible"] = sum(r.feasible for r in results)
    if traced:
        snap.update(_trace_report(cfg, sched, quiet))
    else:
        # The no-trace contract: with tracing off (and no profiler
        # recording) the scheduler's span path must be a pure no-op —
        # no span ever started.
        n = sched.tracer.spans_started - started
        assert n == 0, (
            f"tracing disabled but the scheduler started {n} spans; "
            "the no-trace path is not free")
    if not quiet:
        print(f"[serve_lp.bench] {cfg.requests} requests "
              f"({snap['n_feasible']} feasible) wall={wall:.2f}s "
              f"pipeline={'on' if cfg.pipeline else 'off'}")
        print(sched.metrics.format_report(sched.cache.stats()))
        if cfg.check:
            print(f"[serve_lp.bench] check ok: {cfg.check} requests "
                  "match a direct solver-spec solve")
    if cfg.assert_overlap:
        assert cfg.pipeline, "--assert-overlap needs pipelining enabled"
        assert snap["inflight_max"] >= 2, (
            "pipelined serve loop never had 2 flushes in flight "
            f"(inflight_max={snap['inflight_max']}); assembly did not "
            "overlap an in-flight solve")
        assert snap["overlapped_dispatches"] >= 1, (
            "no dispatch ever overlapped an in-flight solve")
        if not quiet:
            print(f"[serve_lp.bench] overlap ok: max in-flight depth "
                  f"{snap['inflight_max']}, "
                  f"{snap['overlapped_dispatches']} overlapped "
                  "dispatches")
    if cfg.assert_fused:
        assert snap["fused_flushes"] >= 1, (
            "no flush ever fused multiple buckets "
            f"(fused_flushes={snap['fused_flushes']}); underfull "
            "buckets were launched separately")
        assert snap["fused_buckets"] >= 2, (
            f"fused flushes covered only {snap['fused_buckets']} "
            "buckets")
        if not quiet:
            print(f"[serve_lp.bench] fusing ok: {snap['fused_flushes']} "
                  f"fused flushes covering {snap['fused_buckets']} "
                  "buckets")
    return snap, sched


def _trace_report(cfg: BenchConfig, sched: BatchScheduler,
                  quiet: bool) -> Dict:
    """Post-run span analysis: write the Chrome trace, read device
    idleness from the ``device.solve`` tracks, and (``--assert-trace``)
    enforce the full-chain + device-track contract."""
    from repro_torch.obs import check_span_chains, device_idle
    from repro_torch.obs.export import write_chrome_trace
    spans = sched.tracer.spans()
    chains = check_span_chains(spans)
    idle = device_idle(spans)
    if cfg.trace_out:
        write_chrome_trace(spans, cfg.trace_out)
        if not quiet:
            print(f"[serve_lp.bench] wrote {len(spans)} spans to "
                  f"{cfg.trace_out} (load at ui.perfetto.dev)")
    dev_tracks = {d: v["n_solves"] for d, v in idle["devices"].items()
                  if v["n_solves"] > 0}
    if not quiet:
        print(f"[serve_lp.bench] trace: {chains['complete']} complete "
              f"request chains over {chains['flushes']} flushes, "
              f"{len(chains['problems'])} problems; device idle >= "
              f"{100 * idle['idle_frac']:.1f}% over "
              f"{len(dev_tracks)} device tracks")
    if cfg.assert_trace:
        assert chains["complete"] >= cfg.requests, (
            f"only {chains['complete']} of {cfg.requests} completed "
            "requests have request spans in the ring "
            f"(dropped={sched.tracer.stats()['ring_dropped']})")
        assert not chains["problems"], (
            "span chains incomplete or mis-ordered: "
            + "; ".join(chains["problems"][:5]))
        need = min(2, sched.n_devices)
        assert len(dev_tracks) >= need, (
            f"only {len(dev_tracks)} of the scheduler's "
            f"{sched.n_devices} device(s) show device.solve tracks; "
            f"--assert-trace needs {need}")
        if not quiet:
            print(f"[serve_lp.bench] trace ok: all {cfg.requests} "
                  f"chains complete, {len(dev_tracks)} device tracks "
                  "non-empty")
    return {
        # From per-device solve spans (host-observed windows, so a lower
        # bound) — supersedes the device_idle_s_est gauge when tracing.
        "device_idle_frac": idle["idle_frac"],
        "device_idle_is": "lower bound (host-observed solve windows)",
        "device_idle_s": idle["idle_s"],
        "device_busy_s": idle["busy_s"],
        "device_window_s": idle["window_s"],
        "device_tracks": dev_tracks,
        "trace_flushes": chains["flushes"],
        "trace_complete_chains": chains["complete"],
        "trace_problems": len(chains["problems"]),
        "trace_spans": len(spans),
    }


def _check_against_direct(cfg: BenchConfig, results: List,
                          device) -> None:
    """Re-solve a deterministic subset directly and compare."""
    from repro_torch.core import make_batch
    from repro_torch.solver import get_solver
    solver = get_solver(_spec(cfg), device)
    idxs = np.linspace(0, cfg.requests - 1, cfg.check).astype(int)
    for i in idxs:
        A, b, c, _ = make_request(cfg, int(i))
        sol = solver.solve(make_batch(A, b, c, device=device))
        r = results[int(i)]
        assert bool(sol.feasible[0]) == r.feasible, (
            f"request {i}: feasible mismatch")
        if r.feasible:
            np.testing.assert_allclose(sol.x[0].cpu().numpy(), r.x,
                                       rtol=1e-5, atol=1e-5)


# -- the RPC (HTTP) load generator ---------------------------------------

BURST_TENANT = "burst"          # overload-phase tenant: tiny quota
BURST_QUOTA = (200.0, 64.0)     # (rate LPs/s, burst) for that tenant


def _rpc_post(conn, obj, headers=None):
    """POST /v1/solve on a keep-alive connection; (status, parsed)."""
    import json
    conn.request("POST", "/v1/solve", json.dumps(obj),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read() or b"{}")


def _rpc_problem(cfg: BenchConfig, i: int):
    A, b, c, _ = make_request(cfg, i)
    return {"A": A.tolist(), "b": b.tolist(), "c": c.tolist()}


def run_rpc_traffic(cfg: BenchConfig, *, quiet: bool = False,
                    devices: Optional[Sequence] = None
                    ) -> Tuple[Dict, BatchScheduler]:
    """Drive the HTTP front end: closed-loop latency phase (N client
    threads, keep-alive), then an open-loop overload phase under a
    deliberately tiny tenant quota so shedding is observable, then a
    /metrics scrape validated as Prometheus text.  Returns the report
    and the front end's scheduler; ``cfg.assert_rpc`` turns the
    p99/shed/correctness claims into hard checks."""
    import http.client
    import threading as _threading

    from repro_torch.serve_lp.rpc import (AdmissionPolicy, QuotaManager,
                                          make_frontend,
                                          validate_exposition)
    from repro_torch.serve_lp.rpc.server import run_in_thread

    spec = _spec(cfg)
    frontend = make_frontend(
        spec, devices=devices, max_batch=cfg.max_batch,
        max_wait_s=cfg.max_wait_s, max_inflight=cfg.max_inflight,
        pipeline=cfg.pipeline,
        policy=AdmissionPolicy(
            m_max=max(cfg.m_max, 8), batch_max=max(4 * cfg.max_batch, 256),
            max_pending=1024, max_queue_age_s=0.5),
        quotas=QuotaManager(rate=1e6, burst=1e6,
                            per_tenant={BURST_TENANT: BURST_QUOTA}),
        target_p99_s=(cfg.rpc_target_p99_ms / 1e3
                      if cfg.rpc_target_p99_ms is not None else None))
    sched = frontend.scheduler
    port, stop = run_in_thread(frontend)
    t_wall0 = time.perf_counter()
    try:
        def connect():
            return http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)

        # Warmup: touch the bucket ladder through the network path (one
        # size-triggered full batch + one wait-triggered single per
        # bucket) so the measured phases see warm serving behaviour, as
        # the in-process bench does.
        if cfg.warmup:
            t0 = time.perf_counter()
            conn = connect()
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, 0xAB]))
            for m in _sizes(cfg):
                A, b, c = _feasible(rng, m)
                prob = {"A": A.tolist(), "b": b.tolist(), "c": c.tolist()}
                st, _ = _rpc_post(conn, {"problems":
                                         [prob] * cfg.max_batch})
                assert st == 200, f"warmup batch post failed: {st}"
                st, _ = _rpc_post(conn, prob)
                assert st == 200, f"warmup single post failed: {st}"
            conn.close()
            if not quiet:
                print(f"[serve_lp.bench --rpc] warmup over HTTP in "
                      f"{time.perf_counter() - t0:.2f}s")

        # Phase 1 — closed loop: client threads issue requests
        # back-to-back over keep-alive connections; per-request wall
        # latency measured client-side.
        n_clients = max(1, cfg.rpc_clients)
        lat_ms: List[float] = []
        closed_errors: List[int] = []
        lock = _threading.Lock()

        def client(worker: int) -> None:
            conn = connect()
            my_lat, my_err = [], []
            for i in range(worker, cfg.requests, n_clients):
                t = time.perf_counter()
                st, _body = _rpc_post(conn, _rpc_problem(cfg, i))
                dt = (time.perf_counter() - t) * 1e3
                if st == 200:
                    my_lat.append(dt)
                else:
                    my_err.append(st)
            conn.close()
            with lock:
                lat_ms.extend(my_lat)
                closed_errors.extend(my_err)

        threads = [_threading.Thread(target=client, args=(w,))
                   for w in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        closed_wall = time.perf_counter() - t0

        # Phase 2 — open-loop overload: hammer from a tiny-quota tenant
        # so admission demonstrably sheds with 429 instead of queueing.
        burst_n = cfg.rpc_burst or 2 * cfg.requests
        statuses: List[int] = []
        retry_after_seen: List[bool] = []

        def burster(worker: int) -> None:
            import json as _json
            conn = connect()
            my_st, my_ra = [], []
            for i in range(worker, burst_n, 16):
                conn.request("POST", "/v1/solve",
                             _json.dumps(_rpc_problem(cfg, i)),
                             {"X-Tenant": BURST_TENANT})
                resp = conn.getresponse()
                resp.read()
                my_st.append(resp.status)
                if resp.status == 429:
                    my_ra.append(resp.getheader("Retry-After")
                                 is not None)
            conn.close()
            with lock:
                statuses.extend(my_st)
                retry_after_seen.extend(my_ra)

        bursters = [_threading.Thread(target=burster, args=(w,))
                    for w in range(16)]
        for t in bursters:
            t.start()
        for t in bursters:
            t.join()
        accepted = sum(1 for s in statuses if s == 200)
        shed = sum(1 for s in statuses if s == 429)
        other = len(statuses) - accepted - shed

        # Phase 3 — scrape /metrics and validate the exposition.
        conn = connect()
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        metrics_text = resp.read().decode()
        assert resp.status == 200, f"/metrics answered {resp.status}"
        validate_exposition(metrics_text)

        # Correctness: a deterministic sample of closed-loop requests
        # re-posted and compared against a direct solver-spec solve.
        if cfg.check:
            from repro_torch.core import make_batch
            from repro_torch.solver import get_solver
            device = sched.devices[0]
            solver = get_solver(spec, device)
            reconn = connect()
            idxs = np.linspace(0, cfg.requests - 1,
                               cfg.check).astype(int)
            for i in idxs:
                A, b, c, _ = make_request(cfg, int(i))
                st, body = _rpc_post(reconn, _rpc_problem(cfg, int(i)))
                assert st == 200, f"check repost {i} failed: {st}"
                sol = solver.solve(make_batch(A, b, c, device=device))
                r = body["result"]
                assert bool(sol.feasible[0]) == r["feasible"], (
                    f"request {i}: feasible mismatch")
                if r["feasible"]:
                    np.testing.assert_array_equal(
                        sol.x[0].cpu().numpy(),
                        np.asarray(r["x"], np.float32).reshape(2))
            reconn.close()
        conn.close()
    finally:
        stop()

    lat = np.asarray(sorted(lat_ms)) if lat_ms else np.zeros(1)
    report = {
        "rpc_port": port,
        "wall_s": time.perf_counter() - t_wall0,
        "closed_loop": {
            "requests": cfg.requests,
            "ok": len(lat_ms),
            "errors": len(closed_errors),
            "wall_s": closed_wall,
            "rps": (len(lat_ms) / closed_wall if closed_wall > 0
                    else 0.0),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
        },
        "overload": {
            "requests": burst_n,
            "accepted": accepted,
            "shed_429": shed,
            "other": other,
            "shed_rate": shed / max(1, len(statuses)),
            "retry_after_on_429": (all(retry_after_seen)
                                   if retry_after_seen else False),
        },
        "slo": ({str(k): dataclasses.asdict(v)
                 for k, v in frontend.slo.plans().items()}
                if frontend.slo is not None else None),
        "metrics_valid": True,
        "metrics_bytes": len(metrics_text),
    }
    if not quiet:
        c, o = report["closed_loop"], report["overload"]
        print(f"[serve_lp.bench --rpc] closed-loop: {c['ok']}/"
              f"{c['requests']} ok at {c['rps']:.1f} req/s, "
              f"p50={c['p50_ms']:.1f}ms p99={c['p99_ms']:.1f}ms, "
              f"{c['errors']} errors")
        print(f"[serve_lp.bench --rpc] overload: {o['accepted']} "
              f"accepted, {o['shed_429']} shed with 429 "
              f"({100 * o['shed_rate']:.0f}%), {o['other']} other")
        print(f"[serve_lp.bench --rpc] /metrics: valid Prometheus "
              f"text, {report['metrics_bytes']} bytes")
    if cfg.assert_rpc:
        assert not closed_errors, (
            f"closed-loop phase had non-200 responses: "
            f"{sorted(set(closed_errors))}")
        assert report["closed_loop"]["p99_ms"] <= cfg.rpc_p99_bound_ms, (
            f"closed-loop p99 {report['closed_loop']['p99_ms']:.1f}ms "
            f"exceeds the bound {cfg.rpc_p99_bound_ms}ms")
        assert shed >= 1, "overload phase never shed with 429"
        assert accepted >= 1, "overload phase never admitted anything"
        assert other == 0, f"unexpected statuses in overload: {other}"
        assert report["overload"]["retry_after_on_429"], (
            "429 responses were missing Retry-After")
        if not quiet:
            print("[serve_lp.bench --rpc] assertions ok: p99 within "
                  "bound, overload shed with 429 + Retry-After, "
                  "answers match direct solves")
    return report, sched


def parse_config(argv=None) -> BenchConfig:
    """The :class:`BenchConfig` the command line names (the reference's
    flags and defaults)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized preset (overrides size args)")
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--rate", type=float, default=5000.0)
    ap.add_argument("--m-max", type=int, default=1024)
    ap.add_argument("--method", default="rgb",
                    choices=("rgb", "kernel", "naive"))
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--tile", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", type=int, default=8)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warmup pass over every flush shape")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="stop-and-go serve loop (A/B the overlap win)")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="dispatch backpressure bound (pipelined mode)")
    ap.add_argument("--open-loop", action="store_true",
                    help="saturating burst: submit with no rate throttle")
    ap.add_argument("--assert-overlap", action="store_true",
                    help="fail unless >=2 flushes were in flight at once")
    ap.add_argument("--sharding", default="mesh",
                    choices=("mesh", "pmap"),
                    help="flush path: mesh (uneven shards, cross-bucket "
                         "fusing); the reference's pmap is not ported "
                         "and raises ValueError")
    ap.add_argument("--assert-fused", action="store_true",
                    help="fail unless >=1 flush fused multiple "
                         "m-buckets into one launch")
    ap.add_argument("--trace", action="store_true",
                    help="run under a repro_torch.obs tracer (device-idle "
                         "lower bound in the report)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the span ring as Chrome trace_event "
                         "JSON to PATH (implies --trace)")
    ap.add_argument("--assert-trace", action="store_true",
                    help="fail unless every completed request has its "
                         "full span chain and min(2, devices) devices "
                         "show device.solve tracks (implies --trace)")
    ap.add_argument("--rpc", action="store_true",
                    help="drive the HTTP front end (closed-loop latency "
                         "phase + open-loop overload phase + /metrics "
                         "scrape) instead of in-process submit")
    ap.add_argument("--rpc-clients", type=int, default=8,
                    help="closed-loop client threads (--rpc)")
    ap.add_argument("--rpc-burst", type=int, default=0,
                    help="overload-phase posts (--rpc; 0 = 2x requests)")
    ap.add_argument("--rpc-target-p99-ms", type=float, default=None,
                    help="enable the SLO controller at this target "
                         "(--rpc)")
    ap.add_argument("--rpc-p99-bound-ms", type=float, default=2500.0,
                    help="closed-loop p99 bound --assert-rpc enforces")
    ap.add_argument("--assert-rpc", action="store_true",
                    help="fail unless p99 is within bound, overload "
                         "sheds with 429 + Retry-After, and answers "
                         "match direct solves (--rpc)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = smoke_config()
        cfg.method = args.method
        cfg.seed = args.seed
    else:
        cfg = BenchConfig(
            requests=args.requests, rate=args.rate, m_max=args.m_max,
            method=args.method, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1e3, tile=args.tile,
            chunk=args.chunk, seed=args.seed, check=args.check)
    cfg.warmup = not args.no_warmup
    cfg.pipeline = not args.no_pipeline
    cfg.max_inflight = args.max_inflight
    cfg.open_loop = args.open_loop
    cfg.assert_overlap = args.assert_overlap
    cfg.sharding = args.sharding
    cfg.assert_fused = args.assert_fused
    cfg.trace = args.trace
    cfg.trace_out = args.trace_out
    cfg.assert_trace = args.assert_trace
    cfg.rpc = args.rpc
    cfg.rpc_clients = args.rpc_clients
    cfg.rpc_burst = args.rpc_burst
    cfg.rpc_target_p99_ms = args.rpc_target_p99_ms
    cfg.rpc_p99_bound_ms = args.rpc_p99_bound_ms
    cfg.assert_rpc = args.assert_rpc
    return cfg


def main(argv=None, *, devices: Optional[Sequence] = None,
         quiet: bool = False) -> Tuple[Dict, BatchScheduler]:
    """Run the mode ``argv`` names on ``devices`` (default: every card;
    raises where there is none).  Returns the report and the
    scheduler."""
    cfg = parse_config(argv)
    if cfg.rpc:
        return run_rpc_traffic(cfg, quiet=quiet, devices=devices)
    return run_traffic(cfg, quiet=quiet, devices=devices)


if __name__ == "__main__":
    main()
