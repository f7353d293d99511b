"""Prometheus text exposition (version 0.0.4) for the RPC server.

Renders the scheduler's :class:`~repro_torch.serve_lp.metrics.ServeMetrics`
snapshot plus the RPC layer's own counters as a ``GET /metrics``
scrape.  No client library: the text format is a few lines of
``# HELP`` / ``# TYPE`` plus ``name{labels} value`` samples, and
growing a dependency for that would violate the no-new-deps rule.

Two format obligations are enforced here:

* every sample value is rendered finite — Prometheus rejects sample
  lines it cannot parse, and one malformed line poisons the whole
  scrape, so non-finite values are coerced to 0 (the metrics layer
  already guards its empty-reservoir cases; this is the belt to that
  suspenders);
* label values are escaped per the exposition spec (backslash, quote,
  newline).

Histograms: the four duration families recorded by ``ServeMetrics``
(request latency, queue wait, solve, flush) render in the real
Prometheus histogram representation — cumulative ``_bucket{le=...}``
lines, ``_sum`` and ``_count`` — instead of only percentile gauges, so
scrapes can be aggregated across servers and over time.  The latency
families additionally carry OpenMetrics-style *exemplars*
(``... # {trace_id="..."} value``) naming the last trace id observed
in each bucket: a dashboard's p99 spike links straight to a pullable
``/debug/trace?trace_id=``.  (Exposition 0.0.4 parsers that predate
exemplars simply treat the `` # {...}`` suffix as one more value
token; Prometheus itself has parsed the form since 2.26.)
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

# Human blurbs for the histogram families exported by ServeMetrics.
_HIST_HELP = {
    "request_latency_seconds":
        "Submit-to-result latency per request (histogram)",
    "queue_wait_seconds":
        "Submit-to-flush-assembly queue wait per request (histogram)",
    "solve_duration_seconds":
        "Dispatch-to-complete device service time per flush "
        "(histogram)",
    "flush_duration_seconds":
        "Assembly-start-to-complete duration per flush (histogram)",
}

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _finite(v) -> float:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return 0.0
    return f if math.isfinite(f) else 0.0


def _escape(label: str) -> str:
    return (str(label).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Writer:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self.lines: List[str] = []

    def family(self, name: str, kind: str, help_: str,
               samples: List[Tuple[Dict[str, str], float]]) -> None:
        """One metric family: HELP/TYPE then its samples."""
        full = f"{self.prefix}_{name}"
        self.lines.append(f"# HELP {full} {help_}")
        self.lines.append(f"# TYPE {full} {kind}")
        for labels, value in samples:
            lab = ("{" + ",".join(
                f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
                + "}") if labels else ""
            self.lines.append(f"{full}{lab} {_finite(value)}")

    def scalar(self, name: str, kind: str, help_: str, value) -> None:
        self.family(name, kind, help_, [({}, value)])

    def histogram(self, name: str, help_: str, state: Dict,
                  exemplars: bool = True) -> None:
        """One histogram family from a ``_Histogram.state()`` dict:
        cumulative ``_bucket{le=...}`` lines (exemplar-suffixed where
        one was captured), then ``_sum`` and ``_count``."""
        full = f"{self.prefix}_{name}"
        self.lines.append(f"# HELP {full} {help_}")
        self.lines.append(f"# TYPE {full} histogram")
        bounds = state["bounds"]
        cum = state["cumulative"]
        ex = state.get("exemplars") or {}
        for i, b in enumerate(bounds):
            le = f"{float(b):.12g}"
            line = f'{full}_bucket{{le="{le}"}} {int(cum[i])}'
            e = ex.get(i, ex.get(str(i)))
            if exemplars and e:
                line += (f' # {{trace_id="{_escape(e[1])}"}} '
                         f'{_finite(e[0])}')
            self.lines.append(line)
        line = f'{full}_bucket{{le="+Inf"}} {int(cum[-1])}'
        e = ex.get(len(bounds), ex.get(str(len(bounds))))
        if exemplars and e:
            line += f' # {{trace_id="{_escape(e[1])}"}} {_finite(e[0])}'
        self.lines.append(line)
        self.lines.append(f"{full}_sum {_finite(state['sum'])}")
        self.lines.append(f"{full}_count {int(state['count'])}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_metrics(snapshot: Dict, *,
                   rpc: Optional[Dict] = None,
                   quotas: Optional[Dict] = None,
                   slo: Optional[Dict] = None,
                   trace: Optional[Dict] = None,
                   prefix: str = "repro_serve") -> str:
    """The full scrape body: scheduler snapshot + RPC counters.

    ``snapshot`` is ``ServeMetrics.snapshot(cache_stats)``; ``rpc`` is
    :meth:`~repro_torch.serve_lp.rpc.server.RpcCounters.snapshot`; ``quotas``
    is :meth:`~repro_torch.serve_lp.rpc.quota.QuotaManager.snapshot`;
    ``slo`` is :meth:`~repro_torch.serve_lp.rpc.slo.SLOController.plans`
    (``{bucket_m: BucketPlan}``); ``trace`` is ``Tracer.stats()``.
    """
    w = _Writer(prefix)

    # -- scheduler/solver plane ------------------------------------------
    w.scalar("solved_total", "counter",
             "LPs solved through the scheduler", snapshot["n_solved"])
    w.family("flushes_total", "counter",
             "Scheduler flushes by trigger reason",
             [({"reason": r}, v)
              for r, v in sorted(snapshot["flush_reasons"].items())]
             or [({}, 0)])
    w.scalar("dispatched_total", "counter",
             "Flushes dispatched to the device",
             snapshot["n_dispatched"])
    w.scalar("inflight_flushes", "gauge",
             "Flushes currently dispatched and not completed",
             snapshot["inflight_now"])
    w.scalar("inflight_flushes_max", "gauge",
             "High-watermark of concurrently in-flight flushes",
             snapshot["inflight_max"])
    w.scalar("overlapped_dispatches_total", "counter",
             "Dispatches that found the device already busy",
             snapshot["overlapped_dispatches"])
    w.scalar("device_idle_seconds_total", "counter",
             "Estimated seconds the device sat idle between flushes",
             snapshot["device_idle_s_est"])
    w.scalar("solve_seconds_total", "counter",
             "Cumulative dispatch-to-complete device service time",
             snapshot["solve_seconds"])
    w.scalar("assemble_seconds_total", "counter",
             "Cumulative host-side flush assembly time",
             snapshot["assemble_seconds"])
    w.scalar("throughput_lps", "gauge",
             "Solved LPs per second over the active traffic window",
             snapshot["throughput_lps"])
    w.family("latency_seconds", "summary",
             "End-to-end submit-to-result latency (reservoir-sampled)",
             [({"quantile": "0.5"}, snapshot["latency_p50_ms"] / 1e3),
              ({"quantile": "0.99"}, snapshot["latency_p99_ms"] / 1e3)])
    w.scalar("latency_seconds_count", "counter",
             "Latency samples offered to the reservoir",
             snapshot["latency_seen"])
    for name, state in sorted(
            (snapshot.get("histograms") or {}).items()):
        w.histogram(name, _HIST_HELP.get(name, name), state)
    w.scalar("launches_total", "counter",
             "Device launches issued (a mesh flush may group into "
             "1-2 sub-mesh launches)",
             snapshot.get("launches_total", 0))
    w.scalar("fused_flushes_total", "counter",
             "Fused multi-bucket flush units dispatched",
             snapshot.get("fused_flushes", 0))
    w.scalar("fused_buckets_total", "counter",
             "m-buckets folded into fused flush units",
             snapshot.get("fused_buckets", 0))
    w.family("device_rows_total", "counter",
             "Packed problem rows dispatched per device index",
             [({"device": str(i)}, v) for i, v in
              enumerate(snapshot.get("rows_per_device", []))]
             or [({}, 0)])
    w.scalar("padding_waste_problems_ratio", "gauge",
             "Fraction of solved problem slots that were padding",
             snapshot["padding_waste_problems"])
    w.scalar("padding_waste_cells_ratio", "gauge",
             "Fraction of solved constraint cells that were padding",
             snapshot["padding_waste_cells"])
    w.family("errors_total", "counter",
             "Scheduler-side errors by kind",
             [({"kind": k}, v)
              for k, v in sorted(snapshot["errors"].items())]
             or [({}, 0)])
    cache = snapshot.get("cache")
    if cache is not None:
        w.scalar("executables_built", "gauge",
                 "Distinct compiled flush executables", cache["size"])
        w.scalar("executable_cache_hits_total", "counter",
                 "Executable cache hits", cache["hits"])
        w.scalar("executable_cache_misses_total", "counter",
                 "Executable cache misses", cache["misses"])

    # -- RPC plane --------------------------------------------------------
    if rpc is not None:
        w.family("rpc_requests_total", "counter",
                 "HTTP requests by endpoint and status code",
                 [({"endpoint": e, "code": str(c)}, v)
                  for (e, c), v in sorted(rpc["requests"].items())]
                 or [({}, 0)])
        w.family("rpc_shed_total", "counter",
                 "Requests shed before solving, by reason",
                 [({"reason": r}, v)
                  for r, v in sorted(rpc["shed"].items())]
                 or [({}, 0)])
        w.scalar("rpc_inprogress", "gauge",
                 "Solve requests currently being handled",
                 rpc["inprogress"])
        w.scalar("rpc_lps_accepted_total", "counter",
                 "LPs admitted past admission control",
                 rpc["lps_accepted"])
    # -- SLO plane: the controller's installed per-bucket plans ----------
    if slo is not None:
        plans = sorted(slo.items())
        w.family("slo_bucket_max_batch", "gauge",
                 "SLO-planned size trigger per m-bucket",
                 [({"bucket_m": str(bm), "source": p.source},
                   p.max_batch) for bm, p in plans] or [({}, 0)])
        w.family("slo_bucket_max_wait_seconds", "gauge",
                 "SLO-planned wait trigger per m-bucket",
                 [({"bucket_m": str(bm), "source": p.source},
                   p.max_wait_s) for bm, p in plans] or [({}, 0)])
        w.family("slo_bucket_est_flush_seconds", "gauge",
                 "Estimated flush service time per m-bucket (0 when "
                 "no measured tuning entry)",
                 [({"bucket_m": str(bm), "source": p.source},
                   p.est_flush_s or 0.0) for bm, p in plans]
                 or [({}, 0)])
        w.family("slo_bucket_allow_fuse", "gauge",
                 "Fused-flush policy per m-bucket (1 = may join "
                 "cross-bucket fused flush units)",
                 [({"bucket_m": str(bm), "source": p.source},
                   1 if p.allow_fuse else 0) for bm, p in plans]
                 or [({}, 0)])
    # -- trace plane: the span ring's own health -------------------------
    if trace is not None:
        w.scalar("trace_enabled", "gauge",
                 "Whether the serving stack records spans",
                 trace.get("enabled", 0))
        w.scalar("trace_spans_recorded_total", "counter",
                 "Ended spans committed to the ring",
                 trace.get("spans_recorded", 0))
        w.scalar("trace_spans_dropped_total", "counter",
                 "Spans the bounded ring has already forgotten",
                 trace.get("ring_dropped", 0))
        w.scalar("trace_ring_len", "gauge",
                 "Spans currently resident in the ring",
                 trace.get("ring_len", 0))
    if quotas is not None:
        w.family("rpc_quota_admitted_total", "counter",
                 "LPs admitted by the per-tenant token bucket",
                 [({"tenant": t}, q["admitted"])
                  for t, q in sorted(quotas.items())] or [({}, 0)])
        w.family("rpc_quota_rejected_total", "counter",
                 "LPs rejected by the per-tenant token bucket",
                 [({"tenant": t}, q["rejected"])
                  for t, q in sorted(quotas.items())] or [({}, 0)])
        w.family("rpc_quota_tokens", "gauge",
                 "Tokens currently available per tenant",
                 [({"tenant": t}, q["tokens"])
                  for t, q in sorted(quotas.items())] or [({}, 0)])
    return w.render()


def validate_exposition(text: str) -> None:
    """Structural check of an exposition body (used by tests and the
    bench): every non-comment line is ``name{labels} value`` with a
    finite float value, optionally followed by an OpenMetrics exemplar
    (`` # {labels} value``); and every family declared ``# TYPE ...
    histogram`` obeys the histogram grammar — cumulative
    non-decreasing ``_bucket`` counts with ``le`` labels, a terminal
    ``le="+Inf"`` bucket, and ``_sum``/``_count`` lines with ``_count``
    equal to the +Inf bucket.  Raises ValueError on any violation."""
    hists: Dict[str, Dict] = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4 and parts[3] == "histogram":
                hists[parts[2]] = {"last": None, "inf": None,
                                   "sum": False, "count": None}
            continue
        if line.startswith("#"):
            continue
        sample, sep, exemplar = line.partition(" # ")
        try:
            metric, value = sample.rsplit(" ", 1)
            v = float(value)
        except ValueError:
            raise ValueError(f"malformed sample line: {line!r}")
        if not math.isfinite(v):
            raise ValueError(f"non-finite sample value: {line!r}")
        if sep:
            ex = exemplar.strip()
            head, brace, tail = ex.partition("}")
            bad = (not ex.startswith("{") or not brace
                   or not tail.strip())
            if not bad:
                try:
                    ev = float(tail.strip().split()[0])
                    bad = not math.isfinite(ev)
                except ValueError:
                    bad = True
            if bad:
                raise ValueError(f"malformed exemplar: {line!r}")
        name = metric.split("{", 1)[0]
        for base, st in hists.items():
            if name == f"{base}_bucket":
                if 'le="' not in metric:
                    raise ValueError(
                        f"histogram bucket without le label: {line!r}")
                if st["last"] is not None and v < st["last"]:
                    raise ValueError(
                        f"non-cumulative histogram buckets: {line!r}")
                st["last"] = v
                if 'le="+Inf"' in metric:
                    st["inf"] = v
            elif name == f"{base}_sum":
                st["sum"] = True
            elif name == f"{base}_count":
                st["count"] = v
    for base, st in hists.items():
        if st["inf"] is None:
            raise ValueError(f"histogram {base} has no +Inf bucket")
        if not st["sum"]:
            raise ValueError(f"histogram {base} has no _sum line")
        if st["count"] is None:
            raise ValueError(f"histogram {base} has no _count line")
        if st["count"] != st["inf"]:
            raise ValueError(
                f"histogram {base}: _count {st['count']} != +Inf "
                f"bucket {st['inf']}")
