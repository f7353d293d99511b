"""The flight recorder: evidence capture at the moment things go wrong.

A :class:`FlightRecorder` owns a pointer to the live
:class:`~repro_torch.obs.trace.Tracer` ring and a ``state_fn`` returning the
scheduler's debug state (queue depths, in-flight flushes, buffer-pool
leases, per-device row counts).  :meth:`trigger` snapshots both plus
the trigger reason into one JSON file in a bounded spool directory —
the last N incidents survive, each self-contained and diffable.

Triggers wired by the serving stack:

* every ``ServeMetrics.record_error`` (the metrics error hook);
* an SLO violation on the RPC plane (deadline expiry answering 504);
* a flush completing while the live p99 exceeds the configured
  threshold (checked post-flush, debounced).

Debounce: incident storms (one bad executable failing every flush)
must not turn the spool into an I/O hot loop, so triggers within
``min_interval_s`` of the last written snapshot are counted and
dropped.  Everything here is best-effort — a failing disk write is
counted, never raised into the serve loop.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.trace import Tracer


class FlightRecorder:
    """Snapshot the span ring + scheduler state to a bounded spool.

    Parameters
    ----------
    spool_dir:
        directory for snapshot files (created on first write).
    tracer:
        the live tracer whose ring is dumped; a disabled tracer is
        fine (snapshots then carry only state, no spans).
    state_fn:
        zero-arg callable returning a JSON-serializable scheduler
        state dict; bound later via :meth:`bind_state` when the
        recorder is constructed before the scheduler.
    max_snapshots:
        spool bound — oldest snapshot files beyond this are deleted.
    min_interval_s:
        debounce window between written snapshots.
    p99_threshold_s:
        when set, :meth:`check_p99` triggers on a live p99 above it.
    max_spans:
        cap on spans embedded per snapshot (newest kept).
    """

    def __init__(self, spool_dir: str, *,
                 tracer: Optional[Tracer] = None,
                 state_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 max_snapshots: int = 50,
                 min_interval_s: float = 1.0,
                 p99_threshold_s: Optional[float] = None,
                 max_spans: int = 4096):
        if max_snapshots < 1:
            raise ValueError(f"max_snapshots={max_snapshots} < 1")
        self.spool_dir = str(spool_dir)
        self.tracer = tracer
        self._state_fn = state_fn
        self.max_snapshots = int(max_snapshots)
        self.min_interval_s = float(min_interval_s)
        self.p99_threshold_s = p99_threshold_s
        self.max_spans = int(max_spans)
        self._lock = threading.Lock()
        self._seq = 0
        self._t_last_write: Optional[float] = None
        self._t_last_p99: Optional[float] = None
        self.triggers = 0           # trigger() calls
        self.written = 0            # snapshots actually written
        self.suppressed = 0         # debounced triggers
        self.write_errors = 0

    def bind_state(self, state_fn: Callable[[], Dict[str, Any]]) -> None:
        self._state_fn = state_fn

    # -- trigger entry points ---------------------------------------------

    def on_error(self, kind: str) -> Optional[str]:
        """The ``ServeMetrics`` error-hook adapter."""
        return self.trigger(f"error:{kind}")

    def check_p99(self, p99_s: float) -> Optional[str]:
        """Trigger when the live p99 exceeds the configured threshold
        (call with the current percentile; cheap no-op when no
        threshold is set)."""
        if self.p99_threshold_s is None or p99_s <= self.p99_threshold_s:
            return None
        return self.trigger(
            "p99_threshold",
            extra={"p99_s": p99_s, "threshold_s": self.p99_threshold_s})

    def maybe_check_p99(self,
                        p99_fn: Callable[[], float]) -> Optional[str]:
        """Interval-gated :meth:`check_p99` for hot paths: computing a
        live percentile sorts the reservoir, so the scheduler calls
        this per flush and the percentile is only computed at most once
        per ``min_interval_s`` (and never when no threshold is set)."""
        if self.p99_threshold_s is None:
            return None
        now = time.perf_counter()
        with self._lock:
            if (self._t_last_p99 is not None
                    and now - self._t_last_p99 < self.min_interval_s):
                return None
            self._t_last_p99 = now
        try:
            p99 = float(p99_fn())
        except Exception:
            return None
        return self.check_p99(p99)

    def trigger(self, reason: str,
                extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Capture one snapshot; returns the written path or ``None``
        (debounced / failed).  Never raises."""
        now = time.perf_counter()
        with self._lock:
            self.triggers += 1
            if (self._t_last_write is not None
                    and now - self._t_last_write < self.min_interval_s):
                self.suppressed += 1
                return None
            self._t_last_write = now
            self._seq += 1
            seq = self._seq
        try:
            return self._write(seq, reason, extra)
        except Exception:
            with self._lock:
                self.write_errors += 1
            return None

    # -- the snapshot body ------------------------------------------------

    def _write(self, seq: int, reason: str,
               extra: Optional[Dict[str, Any]]) -> str:
        state: Dict[str, Any] = {}
        if self._state_fn is not None:
            try:
                state = self._state_fn()
            except Exception as e:
                state = {"state_error": repr(e)}
        spans: List[Dict[str, Any]] = []
        ring: Dict[str, Any] = {}
        if self.tracer is not None:
            snap = self.tracer.spans()
            spans = [s.to_dict() for s in snap[-self.max_spans:]]
            ring = self.tracer.stats()
        body = {
            "schema": "repro.obs.flight/1",
            "seq": seq,
            "reason": reason,
            "unix_time": time.time(),
            "perf_counter": time.perf_counter(),
            "extra": extra or {},
            "scheduler": state,
            "ring": ring,
            "spans": spans,
        }
        os.makedirs(self.spool_dir, exist_ok=True)
        safe = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                       for ch in reason)[:48]
        path = os.path.join(self.spool_dir,
                            f"flight-{seq:06d}-{safe}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(body, f)
        os.replace(tmp, path)
        with self._lock:
            self.written += 1
        self._prune()
        return path

    def _prune(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.spool_dir)
                           if n.startswith("flight-")
                           and n.endswith(".json"))
        except OSError:
            return
        for n in names[:-self.max_snapshots]:
            try:
                os.remove(os.path.join(self.spool_dir, n))
            except OSError:
                pass

    # -- views ------------------------------------------------------------

    def list_snapshots(self) -> List[str]:
        """Spool file names, oldest first."""
        try:
            return sorted(n for n in os.listdir(self.spool_dir)
                          if n.startswith("flight-")
                          and n.endswith(".json"))
        except OSError:
            return []

    def load_snapshot(self, name: str) -> Optional[Dict[str, Any]]:
        """Parse one spool file by name; ``None`` when missing or
        unparseable.  Names outside the spool are refused."""
        if os.path.basename(name) != name:
            return None
        try:
            with open(os.path.join(self.spool_dir, name),
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "spool_dir": self.spool_dir,
                "triggers": self.triggers,
                "written": self.written,
                "suppressed": self.suppressed,
                "write_errors": self.write_errors,
                "max_snapshots": self.max_snapshots,
                "min_interval_s": self.min_interval_s,
                "p99_threshold_s": self.p99_threshold_s,
            }
