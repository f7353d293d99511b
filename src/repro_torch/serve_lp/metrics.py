"""Serving metrics: latency percentiles, throughput, padding waste, and
pipeline observability (in-flight depth, dispatch/complete stage times,
device-idle-gap estimate, error counters).

Everything is recorded under one lock (submit, flush, timer and
completion threads all write here) and summarised by
:meth:`ServeMetrics.snapshot`.  Padding waste is tracked two ways
because they answer different questions:

* *problem* waste — neutral problems added to pad the batch dimension;
  these cost kernel time directly;
* *cell* waste — padded constraint rows (bucket_m - m per request) plus
  all cells of padding problems; this is the VMEM/bandwidth overhead of
  shape bucketing.

The pipelined serve loop adds a second family of questions — *is the
device actually kept busy?* — answered by:

* the **in-flight gauge** (``record_dispatch``/``record_complete``):
  current and maximum concurrently dispatched flushes, plus how many
  dispatches overlapped an already-in-flight solve;
* the **device-idle estimate**: summed gaps between one flush's
  completion and the next dispatch while nothing was in flight — the
  stop-and-go time the pipeline exists to remove;
* per-flush **assemble vs solve seconds** (host packing time vs
  dispatch-to-complete device service time).

Latencies are kept in a true bounded *reservoir*: once full, each new
sample replaces a reservoir slot with probability k/n via a
deterministic counter-seeded LCG (no ``random`` on the hot path), so
long runs stay uniformly represented instead of biased toward the
start; ``latency_seen`` vs ``latency_samples`` in the snapshot shows
how much sampling occurred.

Alongside the reservoir, four fixed log-spaced **histogram** families
(request latency, queue wait, per-flush solve and total flush
duration) accumulate cumulative bucket counters — the Prometheus
``_bucket``/``_sum``/``_count`` representation, mergeable across
scrapes and servers in ways a percentile gauge never is.  Reservoir
percentiles remain the *local* high-resolution view; histograms are
the *exported* view.  Each histogram keeps one exemplar (last
observed value + trace id) per bucket, surfaced as OpenMetrics-style
exemplars on the latency families.

Two observability hooks close the loop with ``repro_torch.obs``:
``set_error_hook`` routes every counted error kind to the flight
recorder, and :meth:`snapshot` now computes its percentiles from the
same lock-held copy as every other field — a ``/metrics`` scrape
racing the completion worker sees one consistent state, never a
reservoir mid-update or torn dispatch/complete pairs.
"""
from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

_MAX_LATENCIES = 200_000  # reservoir size; plenty for bench runs

# Knuth MMIX LCG constants — the deterministic index stream for
# reservoir replacement (cheap, lock-held, no `random` import).
_LCG_MUL = 6364136223846793005
_LCG_INC = 1442695040888963407
_LCG_MASK = (1 << 64) - 1


def log_bounds(lo: float, hi: float, per_decade: int = 3
               ) -> Tuple[float, ...]:
    """Log-spaced histogram bucket bounds from ``lo`` to at least
    ``hi``, ``per_decade`` bounds per decade.  Fixed at construction —
    Prometheus histograms must keep stable ``le`` labels across
    scrapes."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
    out = [round(lo * 10 ** (i / per_decade), 12) for i in range(n)]
    return tuple(out)


# 100µs .. ~100s, 3 buckets/decade: 19 bounds (+Inf implicit) covers
# sub-ms kernel solves through multi-second saturated-queue tails.
DEFAULT_DURATION_BOUNDS = log_bounds(1e-4, 100.0, per_decade=3)

# The four exported duration families.  Names are the *suffix-free*
# Prometheus family names; the exposition renderer adds the prefix.
HIST_FAMILIES = (
    "request_latency_seconds",   # submit -> result, per request
    "queue_wait_seconds",        # submit -> flush assembly, per request
    "solve_duration_seconds",    # dispatch -> complete, per flush
    "flush_duration_seconds",    # assemble start -> complete, per flush
)


class _Histogram:
    """Cumulative-bucket histogram with per-bucket exemplars.

    Not self-locking: observations happen under the owning
    :class:`ServeMetrics` lock (one lock for the whole metrics struct
    keeps snapshots consistent).  ``counts[i]`` is the number of
    observations ``<= bounds[i]``-noncumulative; the renderer
    accumulates.  ``exemplars[i]`` keeps the last ``(value, trace_id)``
    landing in bucket i (trace-id exemplars on the latency families).
    """

    __slots__ = ("bounds", "counts", "overflow", "sum", "count",
                 "exemplars")

    def __init__(self, bounds: Tuple[float, ...] =
                 DEFAULT_DURATION_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must strictly increase")
        self.counts = [0] * len(self.bounds)
        self.overflow = 0            # observations > bounds[-1] (+Inf)
        self.sum = 0.0
        self.count = 0
        self.exemplars: Dict[int, Tuple[float, str]] = {}

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        idx = self._bucket_of(v)
        if idx is None:
            self.overflow += 1
            idx = len(self.bounds)
        else:
            self.counts[idx] += 1
        if trace_id:
            self.exemplars[idx] = (v, trace_id)

    def _bucket_of(self, v: float) -> Optional[int]:
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo if lo < len(self.bounds) else None

    def state(self) -> Dict[str, Any]:
        """Copy for snapshots: bounds, *cumulative* counts (aligned
        with bounds + the +Inf bucket), sum/count, exemplars keyed by
        bucket index."""
        cum: List[int] = []
        acc = 0
        for c in self.counts:
            acc += c
            cum.append(acc)
        cum.append(acc + self.overflow)
        return {
            "bounds": list(self.bounds),
            "cumulative": cum,
            "sum": self.sum,
            "count": self.count,
            "exemplars": {i: list(e) for i, e in self.exemplars.items()},
        }


class ServeMetrics:
    def __init__(self, max_latency_samples: int = _MAX_LATENCIES):
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self._max_latencies = int(max_latency_samples)
        self.lat_seen = 0            # latencies offered (>= kept)
        self._lat_rng = 0x9E3779B97F4A7C15
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self.n_solved = 0
        self.n_flushes = 0
        self.flush_reasons: Dict[str, int] = {}
        # Sharding/fusing observability: total device launches (a mesh
        # flush may group into 1-2 launch groups; a single device is 1),
        # fused multi-bucket flush units, how many m-buckets those
        # folded together, and packed rows dispatched per device index.
        self.launches = 0
        self.fused_flushes = 0
        self.fused_buckets = 0
        self.rows_by_device: List[int] = []
        self.problems_real = 0
        self.problems_padded = 0
        self.cells_valid = 0
        self.cells_total = 0
        self.solve_seconds = 0.0
        self.assemble_seconds = 0.0
        # Pipeline gauges/counters.
        self.n_dispatched = 0
        self.inflight_now = 0
        self.inflight_max = 0
        self.overlapped_dispatches = 0
        self.device_idle_s = 0.0
        self._t_last_complete: Optional[float] = None
        # Error counters by kind (timer_flush, solve, ...); each kind
        # warns once so failures are loud without spamming.
        self.errors: Dict[str, int] = {}
        self._warned: set = set()
        # Exported histogram families (observed under the same lock).
        self.hists: Dict[str, _Histogram] = {
            name: _Histogram() for name in HIST_FAMILIES}
        # Observability hook: called (outside the lock) with the error
        # kind after each record_error — the flight recorder's trigger.
        self._error_hook: Optional[Callable[[str], Any]] = None

    def set_error_hook(self,
                       hook: Optional[Callable[[str], Any]]) -> None:
        """Install (or clear) a callable invoked with the error kind on
        every :meth:`record_error` — outside the metrics lock, and
        exception-proofed (a broken hook never takes down the thread
        that hit the original error)."""
        self._error_hook = hook

    def touch_clock(self) -> None:
        """Mark traffic activity (throughput is solved / active window)."""
        now = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._t_last = now

    def record_latency(self, seconds: float,
                       trace_id: Optional[str] = None) -> None:
        """Add one sample to the bounded reservoir and the request
        latency histogram (``trace_id`` becomes the bucket exemplar).

        Below capacity every sample is kept; past it, sample n replaces
        a uniformly chosen slot with probability k/n (classic reservoir
        sampling, index drawn from a deterministic LCG), so percentiles
        of long runs reflect the whole run, not its first k samples.
        """
        with self._lock:
            self.lat_seen += 1
            self.hists["request_latency_seconds"].observe(
                seconds, trace_id)
            if len(self._latencies) < self._max_latencies:
                self._latencies.append(seconds)
                return
            self._lat_rng = (self._lat_rng * _LCG_MUL + _LCG_INC) \
                & _LCG_MASK
            j = self._lat_rng % self.lat_seen
            if j < self._max_latencies:
                self._latencies[j] = seconds

    def record_queue_wait(self, seconds: float,
                          trace_id: Optional[str] = None) -> None:
        """One request's submit -> flush-assembly wait (observed at
        assemble time for every member of the flush)."""
        with self._lock:
            self.hists["queue_wait_seconds"].observe(seconds, trace_id)

    def record_queue_waits(
            self, waits: List[Tuple[float, Optional[str]]]) -> None:
        """Batch form of :meth:`record_queue_wait` — one lock hold per
        flush instead of one per member request."""
        with self._lock:
            h = self.hists["queue_wait_seconds"]
            for seconds, trace_id in waits:
                h.observe(seconds, trace_id)

    def record_dispatch(self) -> int:
        """One flush handed to the device; returns the in-flight depth
        including it.  Dispatches that find the device already busy
        count as *overlapped*; dispatches that find it idle accrue the
        idle gap since the previous completion."""
        now = time.perf_counter()
        with self._lock:
            self.n_dispatched += 1
            self.inflight_now += 1
            if self.inflight_now > self.inflight_max:
                self.inflight_max = self.inflight_now
            if self.inflight_now > 1:
                self.overlapped_dispatches += 1
            elif self._t_last_complete is not None:
                self.device_idle_s += max(0.0,
                                          now - self._t_last_complete)
            return self.inflight_now

    def record_complete(self) -> int:
        """One dispatched flush fully completed; returns the remaining
        in-flight depth."""
        now = time.perf_counter()
        with self._lock:
            if self.inflight_now > 0:
                self.inflight_now -= 1
            self._t_last_complete = now
            return self.inflight_now

    def record_error(self, kind: str, warn: Optional[str] = None) -> None:
        """Count an error by kind; the first error of each kind emits
        ``warn`` as a RuntimeWarning (once), so broken tables or
        executables are visible instead of silently swallowed."""
        with self._lock:
            self.errors[kind] = self.errors.get(kind, 0) + 1
            first = kind not in self._warned
            self._warned.add(kind)
            hook = self._error_hook
        if first and warn is not None:
            try:
                warnings.warn(warn, RuntimeWarning, stacklevel=2)
            except Exception:
                # Warning filters may escalate to errors (pytest -W
                # error) — the counter above is the durable record;
                # never let the warning kill a worker thread.
                pass
        if hook is not None:
            try:
                hook(kind)
            except Exception:
                # The hook (flight recorder) is best-effort evidence
                # capture; it must never compound the original error.
                pass

    def record_flush(self, *, n_real: int, b_pad: int, bucket_m: int,
                     sum_m: int, solve_seconds: float,
                     reason: str, assemble_seconds: float = 0.0,
                     dispatch_seconds: float = 0.0,
                     n_buckets: int = 1, launches: int = 1,
                     shards: tuple = (),
                     trace_id: Optional[str] = None) -> None:
        """Count one completed flush.  ``assemble_seconds`` is the
        assembly's own time, ``dispatch_seconds`` the dispatch's (its
        wait for an in-flight slot included) and ``solve_seconds`` the
        dispatch's return to the results on the host; the flush duration
        is their sum."""
        with self._lock:
            self.hists["solve_duration_seconds"].observe(
                solve_seconds, trace_id)
            self.hists["flush_duration_seconds"].observe(
                assemble_seconds + dispatch_seconds + solve_seconds,
                trace_id)
            self.n_flushes += 1
            self.flush_reasons[reason] = (
                self.flush_reasons.get(reason, 0) + 1)
            self.launches += launches
            if n_buckets > 1:
                self.fused_flushes += 1
                self.fused_buckets += n_buckets
            for i, rows in enumerate(shards):
                while len(self.rows_by_device) <= i:
                    self.rows_by_device.append(0)
                self.rows_by_device[i] += int(rows)
            self.n_solved += n_real
            self.problems_real += n_real
            self.problems_padded += b_pad - n_real
            self.cells_valid += sum_m
            self.cells_total += b_pad * bucket_m
            self.solve_seconds += solve_seconds
            self.assemble_seconds += assemble_seconds
            self._t_last = time.perf_counter()
            if self._t0 is None:
                self._t0 = self._t_last

    @staticmethod
    def _percentile_of(xs: List[float], p: float) -> float:
        """Linear-interpolated percentile of a *sorted* sample list;
        0.0 when empty (finite Prometheus lines, never NaN)."""
        if not xs:
            return 0.0
        if len(xs) == 1:
            return xs[0]
        k = (p / 100.0) * (len(xs) - 1)
        lo = int(k)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)

    def percentile(self, p: float) -> float:
        """Linear-interpolated percentile of recorded latencies,
        seconds.  An empty reservoir yields 0.0, not NaN — a fresh
        server's ``/metrics`` scrape must render finite Prometheus
        sample lines (Prometheus text parsers reject malformed values,
        and ``NaN`` percentiles poison alert rules)."""
        with self._lock:
            xs = sorted(self._latencies)
        return self._percentile_of(xs, p)

    def snapshot(self, cache_stats: Optional[Dict] = None) -> Dict:
        """One *consistent* summary dict: every field — the percentiles
        included — is computed from state copied under a single hold of
        the metrics lock.  (Percentiles used to be re-derived by two
        later ``percentile()`` calls, each re-acquiring the lock, so a
        scrape racing the completion worker could pair a pre-flush
        counter block with post-flush percentiles.)"""
        with self._lock:
            elapsed = ((self._t_last - self._t0)
                       if self._t0 is not None and self._t_last is not None
                       else 0.0)
            # Empty-state values are 0.0 (not NaN) so snapshot numbers
            # are always finite — see percentile().
            n_lat = len(self._latencies)
            mean = (sum(self._latencies) / n_lat) if n_lat else 0.0
            lat_sorted = sorted(self._latencies)
            prob_total = self.problems_real + self.problems_padded
            snap = {
                "n_solved": self.n_solved,
                "n_flushes": self.n_flushes,
                "flush_reasons": dict(self.flush_reasons),
                "launches_total": self.launches,
                "fused_flushes": self.fused_flushes,
                "fused_buckets": self.fused_buckets,
                "rows_per_device": list(self.rows_by_device),
                "elapsed_s": elapsed,
                "throughput_lps": (self.n_solved / elapsed
                                   if elapsed > 0 else 0.0),
                "latency_mean_ms": mean * 1e3,
                "latency_samples": n_lat,
                "latency_seen": self.lat_seen,
                "solve_seconds": self.solve_seconds,
                "assemble_seconds": self.assemble_seconds,
                "n_dispatched": self.n_dispatched,
                "inflight_now": self.inflight_now,
                "inflight_max": self.inflight_max,
                "overlapped_dispatches": self.overlapped_dispatches,
                "device_idle_s_est": self.device_idle_s,
                "errors": dict(self.errors),
                "padding_waste_problems": (
                    self.problems_padded / prob_total if prob_total
                    else 0.0),
                "padding_waste_cells": (
                    1.0 - self.cells_valid / self.cells_total
                    if self.cells_total else 0.0),
                "latency_p50_ms":
                    self._percentile_of(lat_sorted, 50.0) * 1e3,
                "latency_p99_ms":
                    self._percentile_of(lat_sorted, 99.0) * 1e3,
                "histograms": {name: h.state()
                               for name, h in self.hists.items()},
            }
        if cache_stats is not None:
            snap["cache"] = dict(cache_stats)
        return snap

    def format_report(self, cache_stats: Optional[Dict] = None) -> str:
        s = self.snapshot(cache_stats)
        sampled = (f" (reservoir: {s['latency_samples']} of "
                   f"{s['latency_seen']})"
                   if s["latency_seen"] > s["latency_samples"] else "")
        lines = [
            f"solved {s['n_solved']} LPs in {s['n_flushes']} flushes "
            f"over {s['elapsed_s']:.2f}s "
            f"({s['throughput_lps']:.1f} LPs/s)",
            f"latency ms: p50={s['latency_p50_ms']:.2f} "
            f"p99={s['latency_p99_ms']:.2f} "
            f"mean={s['latency_mean_ms']:.2f}" + sampled,
            f"padding waste: problems "
            f"{100 * s['padding_waste_problems']:.1f}%  cells "
            f"{100 * s['padding_waste_cells']:.1f}%",
            f"pipeline: {s['n_dispatched']} dispatched, max in flight "
            f"{s['inflight_max']}, overlapped "
            f"{s['overlapped_dispatches']}, device idle "
            f"~{s['device_idle_s_est']:.2f}s, assemble "
            f"{s['assemble_seconds']:.2f}s / solve "
            f"{s['solve_seconds']:.2f}s",
            "flushes by trigger: " + (", ".join(
                f"{k}={v}" for k, v in
                sorted(s['flush_reasons'].items())) or "none"),
            f"sharding: {s['launches_total']} launches / "
            f"{s['n_flushes']} flushes, fused {s['fused_flushes']} "
            f"units covering {s['fused_buckets']} buckets, rows/device "
            + (str(s["rows_per_device"]) if s["rows_per_device"]
               else "[]"),
        ]
        if s["errors"]:
            lines.append("errors: " + ", ".join(
                f"{k}={v}" for k, v in sorted(s["errors"].items())))
        if "cache" in s:
            c = s["cache"]
            lines.append(
                f"executable cache: {c['size']} built, {c['hits']} hits "
                f"/ {c['misses']} misses "
                f"({100 * c['hit_rate']:.1f}% hit rate)")
        return "\n".join(lines)
