"""What the loops share (``lpbench/loops/<loop>.py``), and what a run
records for the readers.

A loop sets up, calls :func:`open_window` and measures ``seconds``; then, in
a traced run, it profiles a slice of the same load right after the window;
then it waits for every answer (a minute at most), reads the peak memory,
lets the program go, and judges the answers against the configuration's
reference.  The program is reached only through ``repro_torch``'s public
entry points.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import random
import threading
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from lpbench import judge, loadgen
from lpbench import trace as tr

ANSWER_WAIT_S = 60.0


@dataclasses.dataclass
class Run:
    """What one run leaves for the metric readers."""
    cell: str
    config: dict
    traffic: dict
    problem: Optional[ModuleType] = None     # lpbench/problems/<kind>.py
    reference: Optional[ModuleType] = None   # the configuration's reference
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    lps_done: int = 0                  # LPs whose answers came in the window
    latency_s: Optional[np.ndarray] = None    # due -> resolved; inf = never
    call_host_s: Optional[np.ndarray] = None  # enqueue time a call
    submit_s: Optional[np.ndarray] = None     # time in submit a request
    counters: Dict = dataclasses.field(default_factory=dict)
    slice: Optional[tr.Slice] = None
    kernel_bytes: int = 0              # a call's bytes (batch loops)
    solve_bytes: int = 0
    memory_peak_bytes: int = 0
    info: Dict = dataclasses.field(default_factory=dict)
    tally: Optional[judge.Tally] = None
    setup: Dict = dataclasses.field(default_factory=dict)  # phase -> s

    def __post_init__(self):
        if self.tally is None and self.reference is not None:
            self.tally = judge.Tally(self.reference)

    @classmethod
    def of(cls, cell) -> "Run":
        """A run of a :class:`lpbench.spec.Cell`."""
        return cls(cell.name, cell.config, cell.traffic, problem=cell.problem,
                   reference=cell.reference)


def open_window(run: Run, clock: Callable[[], float]) -> float:
    """End set-up and open the measured window: a full collection first,
    so that every run meets Python's automatic full collections at the same
    points of its work, as a service does every so many requests.  Returns
    the window's start on ``time.perf_counter``."""
    gc.collect()
    run.setup_s = clock()
    return time.perf_counter()


class GCWatch:
    """Python's garbage collections while installed: how many of each
    generation, how long they held the interpreter, and when each
    full one began."""

    def __init__(self):
        self.pauses: List = []
        self.full_at: List[float] = []
        self._t = 0.0

    def __call__(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
            if info["generation"] == 2:
                self.full_at.append(self._t)
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t))

    def __enter__(self) -> "GCWatch":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)

    def summary(self, t0: float = 0.0) -> Dict:
        out = {}
        for gen in (0, 1, 2):
            p = [t for g, t in self.pauses if g == gen]
            if p:
                out[f"gen{gen}"] = {"n": len(p), "total_ms": sum(p) * 1e3,
                                    "max_ms": max(p) * 1e3}
        if self.full_at:
            out["gen2"]["at_s"] = [t - t0 for t in self.full_at]
        return out


def sync_fn(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``k`` calls, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


# -- serving -------------------------------------------------------------------

def scheduler(cfg: dict, device: torch.device):
    from repro_torch.serve_lp import BatchScheduler
    from repro_torch.solver import SolverSpec
    sc = cfg["scheduler"]
    spec = SolverSpec(backend=cfg["solver"]["backend"], M=float(cfg["M"]),
                      dtype=cfg["dtype"])
    return BatchScheduler(spec, max_batch=int(sc["max_batch"]),
                          max_wait_s=float(sc["max_wait_s"]),
                          max_inflight=int(sc["max_inflight"]),
                          pipeline=bool(sc["pipeline"]),
                          sharding=sc["sharding"], devices=[device])


def warm_flushes(sched, pool: loadgen.Pool, device: torch.device,
                 clock: Optional[Callable[[], float]] = None):
    """Run each flush shape the pool's traffic can make: every m-bucket at
    every padded batch a flush of 1..max_batch requests rounds to.  Returns
    the number of shapes, and ``clock()`` after the first."""
    first = None
    from repro_torch.serve_lp import bucket_batch, bucket_m
    by_bucket: Dict[int, int] = {}
    for g, m in enumerate(pool.sizes):
        by_bucket[bucket_m(m, base=sched.bucket_base)] = g
    shapes = 0
    for bm, g in sorted(by_bucket.items()):
        rungs: Dict[int, int] = {}
        for n in range(1, sched.max_batch + 1):
            tile = sched.spec.resolve_for_shape(
                bm, n, platform=device.type).tile or 1
            rungs.setdefault(bucket_batch(n, tile), n)
        for n in sorted(rungs.values()):
            futs = [sched.submit(pool.A[g][j % pool.per],
                                 pool.b[g][j % pool.per],
                                 pool.c[g][j % pool.per]) for j in range(n)]
            sched.flush()
            for f in futs:
                f.result(timeout=300.0)
            shapes += 1
            if shapes == 1 and clock is not None:
                first = clock()
    return shapes, first


def counters(sched) -> Dict:
    s = sched.metrics.snapshot()
    return {"n_solved": s["n_solved"], "n_flushes": s["n_flushes"],
            "flush_reasons": dict(s["flush_reasons"])}


def counters_diff(a: Dict, b: Dict) -> Dict:
    reasons = {k: b["flush_reasons"].get(k, 0) - a["flush_reasons"].get(k, 0)
               for k in b["flush_reasons"]}
    return {"n_solved": b["n_solved"] - a["n_solved"],
            "n_flushes": b["n_flushes"] - a["n_flushes"],
            "flush_reasons": {k: v for k, v in reasons.items() if v}}


class Book:
    """Per-request records of a serving run, in preallocated arrays: the
    answer is copied out of each future as it resolves, so the run holds
    no future once it is answered."""

    def __init__(self, cap: int):
        self.done = np.full(cap, np.nan)
        self.ok = np.zeros(cap, dtype=bool)
        self.start = np.zeros(cap)
        self.sub = np.zeros(cap)
        self.x = np.zeros((cap, 2), dtype=np.float64)
        self.feasible = np.zeros(cap, dtype=bool)
        self.objective = np.zeros(cap, dtype=np.float64)
        self.cap = cap
        self.n = 0
        self.n_done = 0
        self._cv = threading.Condition()
        self.on_done: Optional[Callable] = None

    def submit(self, i: int, sched, pool: loadgen.Pool, spans: bool) -> None:
        s = time.perf_counter()
        with tr.span("lpbench.submit", spans):
            f = sched.submit(*pool.request(i))
        self.start[i] = s
        self.sub[i] = time.perf_counter() - s
        self.n = i + 1
        f.add_done_callback(functools.partial(self.on_done or self.mark, i))

    def mark(self, i: int, fut) -> None:
        self.done[i] = time.perf_counter()
        try:
            r = fut.result()
        except Exception:   # a failed or cancelled request stays not ok
            r = None
        if r is not None:
            self.x[i] = r.x
            self.feasible[i] = r.feasible
            self.objective[i] = r.objective
            self.ok[i] = True
        with self._cv:
            self.n_done += 1
            self._cv.notify_all()

    def wait_all(self, timeout: float) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self.n_done >= self.n,
                                     timeout=timeout)


def judge_serve(run: Run, pool: loadgen.Pool, book: Book,
                device: torch.device) -> None:
    """Every answered request against the reference, solved once for each
    pool row the run used."""
    cfg = run.config
    M = float(cfg["M"])
    idx = np.array([pool.index(i) for i in range(book.n)], dtype=np.int64)
    done = np.flatnonzero(book.ok[:book.n])
    for g, m in enumerate(pool.sizes):
        lo = g * pool.per
        mine = done[(idx[done] >= lo) & (idx[done] < lo + pool.per)]
        if not len(mine):
            continue
        rows = idx[mine] - lo
        used = np.unique(rows)
        where = np.searchsorted(used, rows)
        A = torch.from_numpy(pool.A[g][used]).to(device)
        b = torch.from_numpy(pool.b[g][used]).to(device)
        c = torch.from_numpy(pool.c[g][used]).to(device)
        mv = torch.full((len(used),), m, dtype=torch.int32, device=device)
        ref = run.tally.classify(A, b, c, mv, cfg)
        sel = torch.from_numpy(where).to(device)
        x = torch.from_numpy(book.x[mine])
        f = torch.from_numpy(book.feasible[mine])
        o = torch.from_numpy(book.objective[mine])
        run.tally.add({k: v[sel] for k, v in ref.items()}, A[sel], b[sel],
                      c[sel], mv[sel], x, f, o, M)


def finish_serve(run: Run, sched, pool, book: Book, device,
                 t_close: float) -> None:
    book.wait_all(max(0.0, t_close + ANSWER_WAIT_S - time.perf_counter()))
    run.memory_peak_bytes = peak(device)
    sched.close()
    run.attempted = book.n
    run.failed = int(np.count_nonzero(~book.ok[:book.n]))
    free(device)
    judge_serve(run, pool, book, device)
