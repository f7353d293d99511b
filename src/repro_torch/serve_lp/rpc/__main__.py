"""CLI entry for the RPC server: ``python -m repro_torch.serve_lp.rpc``.

Serves on every visible CUDA card (and refuses to start without one).
The production launch path is ``scripts/serve_entrypoint_torch.sh``,
which sets the runtime environment (tcmalloc preload, JSON logs) and
then execs this module.
"""
from __future__ import annotations

import argparse
import asyncio
import os

from repro_torch.obs import FlightRecorder, Tracer, setup_logging
from repro_torch.obs.profiler import ProfileSession
from repro_torch.serve_lp.rpc.admission import AdmissionPolicy
from repro_torch.serve_lp.rpc.quota import QuotaManager
from repro_torch.serve_lp.rpc.server import RpcServer, make_frontend
from repro_torch.solver import SolverSpec


def _maybe_init_distributed() -> None:
    """Multi-host seam, not implemented: single-host serving only.

    The reference joins a multi-process runtime here when
    ``SERVE_COORDINATOR`` is set (companions ``SERVE_NUM_PROCESSES``,
    ``SERVE_PROCESS_ID``), after which flush layouts could span hosts
    through the reserved ``hosts`` mesh axis.  This package serves the
    cards of one host; asked for more, it raises instead of quietly
    serving a single host.  A multi-host port would call
    ``torch.distributed.init_process_group`` here with an explicit
    ``tcp://`` address, world size and rank.
    """
    if os.environ.get("SERVE_COORDINATOR"):
        raise RuntimeError(
            "SERVE_COORDINATOR is set, but multi-host serving is not "
            "implemented in repro_torch: unset it to serve the cards of "
            "this host")


def main(argv=None) -> None:
    _maybe_init_distributed()
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve_lp.rpc",
        description="HTTP front end for the batched 2-D LP solver "
                    "(PyTorch/CUDA)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--method", default="kernel",
                    choices=("kernel", "pdhg", "rgb", "naive"),
                    help="solver backend for every flush (kernel: the "
                         "CUDA kernel; rgb/naive are the plain PyTorch "
                         "Seidel path, slow on a card)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="scheduler-wide size trigger (the SLO "
                         "controller may cap it lower per bucket)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="scheduler-wide wait trigger")
    ap.add_argument("--max-inflight", type=int, default=2)
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--target-p99-ms", type=float, default=None,
                    help="enable the SLO controller: derive per-bucket "
                         "max_batch/max_wait from measured flush "
                         "latency to hold this p99")
    ap.add_argument("--m-max", type=int, default=4096,
                    help="reject LPs with more constraints than this")
    ap.add_argument("--batch-max", type=int, default=1024,
                    help="reject requests with more LPs than this")
    ap.add_argument("--max-pending", type=int, default=4096,
                    help="shed (429) when this many LPs are queued and "
                         "the in-flight depth is at its bound")
    ap.add_argument("--max-queue-age-ms", type=float, default=500.0,
                    help="shed (429) when the oldest queued request "
                         "has waited this long")
    ap.add_argument("--quota-rate", type=float, default=10_000.0,
                    help="per-tenant sustained LPs/s")
    ap.add_argument("--quota-burst", type=float, default=2_000.0,
                    help="per-tenant instantaneous LP burst")
    ap.add_argument("--log-format", default="text",
                    choices=("text", "json"),
                    help="stdout log format; json emits one structured "
                         "object per line with trace_id/tenant from "
                         "the active request context")
    ap.add_argument("--trace", action="store_true",
                    help="enable end-to-end span tracing (repro_torch."
                         "obs); spans are pullable at GET /debug/trace")
    ap.add_argument("--trace-capacity", type=int, default=16384,
                    help="span ring-buffer capacity (with --trace)")
    ap.add_argument("--flight-spool", default=None, metavar="DIR",
                    help="enable the flight recorder: dump ring + "
                         "scheduler state to DIR on errors / SLO "
                         "violations, browsable at GET /debug/flight")
    ap.add_argument("--flight-p99-ms", type=float, default=None,
                    help="also snapshot when request p99 exceeds this "
                         "(needs --flight-spool)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="run a torch.profiler session (CPU + CUDA, "
                         "every thread) for the server's lifetime and "
                         "write its Chrome trace into DIR at shutdown: "
                         "the device's work, the program's spans as "
                         "repro_torch.* ranges on the thread that ran "
                         "them (submit, flush.assemble/dispatch/scatter, "
                         "solve and its stages), and the request and "
                         "device.solve spans on the same clock")
    args = ap.parse_args(argv)

    setup_logging(fmt=args.log_format)

    # Without --trace the spans go to the process default tracer, which
    # records while the --profile-dir session does.
    tracer = None
    if args.trace:
        tracer = Tracer(enabled=True, capacity=args.trace_capacity)
    recorder = None
    if args.flight_spool:
        recorder = FlightRecorder(
            args.flight_spool, tracer=tracer,
            p99_threshold_s=(args.flight_p99_ms / 1e3
                             if args.flight_p99_ms is not None
                             else None))

    frontend = make_frontend(
        SolverSpec(backend=args.method),
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        max_inflight=args.max_inflight,
        pipeline=not args.no_pipeline,
        policy=AdmissionPolicy(
            m_max=args.m_max, batch_max=args.batch_max,
            max_pending=args.max_pending,
            max_queue_age_s=args.max_queue_age_ms / 1e3),
        quotas=QuotaManager(rate=args.quota_rate,
                            burst=args.quota_burst),
        target_p99_s=(args.target_p99_ms / 1e3
                      if args.target_p99_ms is not None else None),
        tracer=tracer,
        recorder=recorder,
    )

    profile = (ProfileSession(args.profile_dir, tracer=tracer)
               if args.profile_dir else None)
    if profile is not None:
        profile.start()

    async def _serve():
        server = RpcServer(frontend, args.host, args.port)
        await server.start()
        slo = ("off" if frontend.slo is None
               else f"p99<={args.target_p99_ms:.0f}ms")
        obs = "trace" if tracer is not None else "no-trace"
        if recorder is not None:
            obs += f"+flight:{args.flight_spool}"
        print(f"[serve_lp.rpc] listening on http://{args.host}:"
              f"{server.port}  backend={args.method} "
              f"devices={frontend.scheduler.n_devices} slo={slo} "
              f"obs={obs}",
              flush=True)
        try:
            await server.serve_forever()
        finally:
            await server.aclose()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    finally:
        if profile is not None:
            profile.stop()


if __name__ == "__main__":
    main()
