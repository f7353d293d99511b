"""Batched LP serving subsystem.

Turns the batch 2-D LP solver stack into a service: callers submit
individual LPs of arbitrary constraint count and get futures back; a
scheduler aggregates them into shape-bucketed super-batches, solves each
flush through a cached executable (sharded across devices when more than
one is visible) and scatters results to the futures in submission order.

    scheduler (submit/flush policy, pipelined dispatch + completion,
               cross-bucket fused flush units)
        -> buckets (shape ladder + executable cache)
        -> mesh_layout (MeshLayout planner: uneven per-device shards,
           grouped launches, planner-owned padding)
        -> sharding (dispatch/complete Executables: pinned host buffers,
           one stream per device, event-based completion)
        -> futures (per-request LPResult)

The serve loop is pipelined by default: flush dispatch is asynchronous
(stream-ordered copies and kernel, no host sync) and a completion worker
scatters results, so the host assembles the next super-batch while the
device solves the current one; ``BatchScheduler(..., pipeline=False)``
restores the stop-and-go loop and ``max_inflight`` bounds the dispatch
depth (backpressure).

Use :class:`BatchScheduler` when requests arrive one at a time (serving,
simulation agents, RPC handlers); build a
:class:`~repro_torch.solver.SolverSpec` and call its Solver directly when
you already hold one uniform batch.  The scheduler takes the same spec —
``BatchScheduler(SolverSpec(...))`` — and embeds it in every flush's
:class:`ExecSpec` cache key.

The HTTP front end is :mod:`repro_torch.serve_lp.rpc`; the reference's
serving benchmark is :mod:`repro_torch.serve_lp.bench`.
"""
from repro_torch.serve_lp.buckets import (SHARDING_MODES, ExecSpec,
                                          ExecutableCache, bucket_batch,
                                          bucket_m, shape_ladder)
from repro_torch.serve_lp.mesh_layout import (LaunchGroup, MeshLayout,
                                              plan_layout)
from repro_torch.serve_lp.metrics import ServeMetrics
from repro_torch.serve_lp.scheduler import BatchScheduler, LPResult
from repro_torch.serve_lp.sharding import (Executable, as_executable,
                                           build_executable)
from repro_torch.solver import SolverSpec

__all__ = [
    "BatchScheduler", "Executable", "ExecSpec", "ExecutableCache",
    "LPResult", "LaunchGroup", "MeshLayout", "SHARDING_MODES",
    "ServeMetrics", "SolverSpec", "as_executable", "bucket_batch",
    "bucket_m", "build_executable", "plan_layout", "shape_ladder",
]
