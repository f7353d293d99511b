"""``batch_closed``: one caller, whole batches.  Each call is
``Solver.solve`` then a sync, rotating over the mix's ``rotate`` distinct
batches of ``batch`` problems; the answers of ``check_calls`` calls, drawn
from the seed, are judged; a traced run profiles ``trace_calls`` more calls
after the window."""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from lpbench import drivers, loadgen, peaks
from lpbench import trace as tr


def run(r: drivers.Run, seed: int, seconds: float, trace: bool,
        device: torch.device, clock: Callable[[], float]) -> drivers.Run:
    from repro_torch.core.lp import LPBatch
    from repro_torch.kernels.batch_lp import rgb_cuda
    from repro_torch.solver import SolverSpec

    cfg, mix = r.config, r.traffic
    inputs = loadgen.batch_inputs(cfg, mix, seed, device, r.problem)
    batches = [LPBatch(A=A, b=b, c=c, m_valid=mv) for A, b, c, mv in inputs]
    r.setup["inputs"] = clock()
    B, R = int(mix["batch"]), len(batches)
    solver = SolverSpec(backend=cfg["solver"]["backend"], M=float(cfg["M"]),
                        dtype=cfg["dtype"]).build(device=device)
    sync = drivers.sync_fn(device)
    solver.solve(batches[0])
    sync()
    r.setup["first_call"] = clock()
    for _ in range(2):
        for bt in batches:
            solver.solve(bt)
            sync()
    if trace:
        tr.warm(sync)
    r.setup["warm"] = clock()
    held = drivers.Reservoir(int(mix["check_calls"]), seed)
    launches = rgb_cuda.launches
    host: List[float] = []
    starts: List[float] = []
    t0 = drivers.open_window(r, clock)
    t_end = t0 + seconds
    i = 0
    with drivers.GCWatch() as gcw:
        while True:
            a = time.perf_counter()
            if i and a >= t_end:
                break
            sol = solver.solve(batches[i % R])
            h = time.perf_counter()
            sync()
            host.append(h - a)
            starts.append(a)
            held.offer((i % R, sol))
            i += 1
    r.window_s = time.perf_counter() - t0
    r.info["gc"] = gcw.summary(t0)
    r.lps_done = r.attempted = i * B
    r.call_host_s = np.asarray(host)
    r.info["calls_per_s"] = np.bincount(
        (np.asarray(starts) - t0).astype(int)).tolist()
    r.info["rgb_cuda.launches"] = rgb_cuda.launches - launches
    r.info["calls"] = i
    n_valid = int(inputs[0][3].sum())   # constraints a batch holds
    r.kernel_bytes = peaks.kernel_bytes(B, n_valid, cfg["dtype"])
    r.solve_bytes = peaks.solve_bytes(B, n_valid, cfg["dtype"])

    if trace:
        k = int(mix["trace_calls"])

        def traced() -> int:
            for j in range(k):
                with tr.span("lpbench.solve", True):
                    solver.solve(batches[j % R])
                with tr.span("lpbench.sync", True):
                    sync()
            return k
        r.slice = tr.profile(traced, sync)

    r.memory_peak_bytes = drivers.peak(device)
    del solver
    drivers.free(device)
    refs: Dict[int, Dict] = {}
    for k_batch, sol in held.items:
        A, b, c, mv = inputs[k_batch]
        if k_batch not in refs:
            refs[k_batch] = r.tally.classify(A, b, c, mv, cfg)
        r.tally.add(refs[k_batch], A, b, c, mv, sol.x, sol.feasible,
                    sol.objective, float(cfg["M"]))
    r.info["checked_calls"] = len(held.items)
    return r
