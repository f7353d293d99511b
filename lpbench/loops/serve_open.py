"""``serve_open``: single-LP requests to ``BatchScheduler.submit`` at due
times drawn for the mix's ``rate`` (Poisson gaps, the same set for every
seed); latency runs from the due time to the future's resolution.  Every
request due in the window is judged; a traced run profiles
``trace_seconds`` more of the same arrivals after the window."""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from lpbench import drivers, loadgen
from lpbench import trace as tr


def run(r: drivers.Run, seed: int, seconds: float, trace: bool,
        device: torch.device, clock: Callable[[], float]) -> drivers.Run:
    from repro_torch.kernels.batch_lp import rgb_cuda
    cfg, mix = r.config, r.traffic
    pool = loadgen.request_pool(cfg, mix, seed, r.problem)
    r.setup["inputs"] = clock()
    sched = drivers.scheduler(cfg, device)
    r.setup["scheduler"] = clock()
    r.info["warm_shapes"], r.setup["first_flush"] = drivers.warm_flushes(
        sched, pool, device, clock)
    sched.start()
    sync = drivers.sync_fn(device)
    if trace:
        tr.warm(sync)
    r.setup["warm"] = clock()
    rate = float(mix["rate"])
    n = int(round(rate * seconds))
    n_slice = int(round(rate * float(mix["trace_seconds"]))) if trace else 0
    arr = loadgen.arrivals(rate, n + n_slice, seed)
    book = drivers.Book(n + n_slice)
    before = drivers.counters(sched)
    launches = rgb_cuda.launches
    t0 = drivers.open_window(r, clock)
    due = t0 + arr

    def produce(lo: int, hi: int, spans: bool) -> int:
        for i in range(lo, hi):
            now = time.perf_counter()
            if due[i] > now:
                with tr.span("lpbench.sleep", spans):
                    time.sleep(due[i] - now)
            book.submit(i, sched, pool, spans)
        return hi - lo

    with drivers.GCWatch() as gcw:
        produce(0, n, False)
    r.info["gc"] = gcw.summary(t0)
    t_close = max(t0 + seconds, time.perf_counter())
    r.window_s = t_close - t0
    r.counters = drivers.counters_diff(before, drivers.counters(sched))
    r.info["rgb_cuda.launches"] = rgb_cuda.launches - launches
    if trace:
        r.slice = tr.profile(lambda: produce(n, n + n_slice, True), sync)
    drivers.finish_serve(r, sched, pool, book, device, t_close)
    lat = book.done[:n] - due[:n]
    lat[~book.ok[:n]] = np.inf
    r.latency_s = lat
    r.lps_done = int(np.count_nonzero(book.done[:n] <= t_close))
    r.submit_s = book.sub[:n]
    late = book.start[:n] - due[:n]
    r.info["late_ms"] = {"p50": float(np.percentile(late, 50)) * 1e3,
                         "p99": float(np.percentile(late, 99)) * 1e3,
                         "max": float(late.max()) * 1e3} if n else {}
    return r
