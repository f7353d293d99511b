"""``serve_closed``: single-LP requests to ``BatchScheduler.submit`` with
``outstanding`` requests in flight; each resolution lets the next request
in.  Every request of the window is judged; a traced run profiles
``trace_seconds`` more of the same load after the window."""
from __future__ import annotations

import threading
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
    k = int(mix["outstanding"])
    book = drivers.Book(int(mix["capacity"]))
    gate = threading.Semaphore(k)

    def mark(i: int, fut) -> None:
        book.mark(i, fut)
        gate.release()

    book.on_done = mark

    def produce(t_stop: float, spans: bool) -> int:
        first = book.n
        while book.n < book.cap:
            with tr.span("lpbench.wait", spans):
                got = gate.acquire(
                    timeout=max(0.0, t_stop - time.perf_counter()))
            if not got:
                break
            if time.perf_counter() >= t_stop:
                gate.release()
                break
            book.submit(book.n, sched, pool, spans)
        return book.n - first

    before = drivers.counters(sched)
    launches = rgb_cuda.launches
    t0 = drivers.open_window(r, clock)
    with drivers.GCWatch() as gcw:
        produce(t0 + seconds, False)
    r.info["gc"] = gcw.summary(t0)
    n = book.n
    r.window_s = time.perf_counter() - t0
    r.counters = drivers.counters_diff(before, drivers.counters(sched))
    r.info["rgb_cuda.launches"] = rgb_cuda.launches - launches
    if trace:
        t_stop = time.perf_counter() + float(mix["trace_seconds"])
        r.slice = tr.profile(lambda: produce(t_stop, True), sync)
    drivers.finish_serve(r, sched, pool, book, device, time.perf_counter())
    r.lps_done = int(np.count_nonzero(book.done[:n] <= t0 + r.window_s))
    r.submit_s = book.sub[:n]
    d = book.done[:n][book.ok[:n]] - t0
    r.info["answers_per_s"] = np.bincount(
        d[d < r.window_s].astype(int)).tolist()
    return r
