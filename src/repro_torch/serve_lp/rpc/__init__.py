"""Network front end for the LP serving layer.

Turns open-loop client traffic into well-formed, admission-controlled
scheduler flushes::

    HTTP/1.1 (asyncio, no framework)         server.RpcServer
        -> routing + solve pipeline          server.LPFrontend
            -> validation / deadline / 4xx   admission
            -> per-tenant token buckets      quota
            -> load shedding (429)           admission.check_backpressure
            -> SLO-derived batch limits      slo.SLOController
        -> BatchScheduler submit/futures     repro_torch.serve_lp.scheduler
            -> Solver -> rgb_cuda (or pdhg)
    GET /metrics                             prometheus (text exposition)

Quickstart on a machine with a card (production path is
``scripts/serve_entrypoint_torch.sh``)::

    python -m repro_torch.serve_lp.rpc --port 8080 --target-p99-ms 50
    curl -s localhost:8080/v1/solve -XPOST -H 'X-Tenant: me' \\
        -d '{"A": [[1,0],[0,1],[-1,-1]], "b": [1,1,-0.5], "c": [1,1]}'
"""
from repro_torch.serve_lp.rpc.admission import (AdmissionPolicy,
                                                RpcError,
                                                check_backpressure,
                                                deadline_budget_s,
                                                parse_solve_payload)
from repro_torch.serve_lp.rpc.prometheus import (render_metrics,
                                                 validate_exposition)
from repro_torch.serve_lp.rpc.quota import (DEFAULT_TENANT, QuotaManager,
                                            TokenBucket)
from repro_torch.serve_lp.rpc.server import (LPFrontend, Request,
                                             Response, RpcCounters,
                                             RpcServer, make_frontend,
                                             run_in_thread)
from repro_torch.serve_lp.rpc.slo import BucketPlan, SLOController

__all__ = [
    "AdmissionPolicy", "BucketPlan", "DEFAULT_TENANT", "LPFrontend",
    "QuotaManager", "Request", "Response", "RpcCounters", "RpcError",
    "RpcServer", "SLOController", "TokenBucket", "check_backpressure",
    "deadline_budget_s", "make_frontend", "parse_solve_payload",
    "render_metrics", "run_in_thread", "validate_exposition",
]
