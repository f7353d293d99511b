"""Render the dry run's tables from the port's records.

The PyTorch twin of ``benchmarks/roofline_report.py``: the same three
tables (cell status on both meshes, the single-pod roofline, the perf
variants against their baseline), read from the file the port's dry run
writes (``build/dryrun/dryrun.json``, ``repro_torch.launch.dryrun``).  The records were counted on ``meta`` for
the card they name (``peaks``); rendering them needs no device.  A
variant recorded ``no_counterpart`` (``pt_hillclimb``) is shown as such,
not as a failure.

    PYTHONPATH=src python -m benchmarks.pt_roofline_report
"""
from __future__ import annotations

import json

from repro_torch.launch.dryrun import RESULTS_DIR

RESULTS = RESULTS_DIR / "dryrun.json"
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_t(s):
    if s is None:
        return "-"
    return f"{s*1e3:.1f}ms" if s < 10 else f"{s:.2f}s"


def render(all_recs: list) -> list:
    """The report's lines."""
    out = []
    p = out.append
    variants = [r for r in all_recs
                if r.get("variant", "baseline") != "baseline"]
    recs = [r for r in all_recs
            if r.get("variant", "baseline") == "baseline"]
    single = [r for r in recs if not r.get("multi_pod")]
    cards = sorted({r["peaks"] for r in all_recs if r.get("peaks")})

    p("### Dry-run status (all cells must compile)\n")
    p(f"counted on meta for: {', '.join(cards) or '-'}\n")
    p("| arch | shape | 16x16 | 2x16x16 | compile_s (1pod/2pod) |")
    p("|---|---|---|---|---|")
    by_key = {(r["arch"], r["shape"], r.get("multi_pod", False)): r
              for r in recs}
    archs = sorted({r["arch"] for r in recs})
    n_ok = n_skip = n_fail = 0
    for a in archs:
        for s in SHAPES:
            r1 = by_key.get((a, s, False), {})
            r2 = by_key.get((a, s, True), {})
            st1, st2 = r1.get("status", "?"), r2.get("status", "?")
            for st in (st1, st2):
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "FAIL"
            p(f"| {a} | {s} | {st1} | {st2} | "
              f"{r1.get('compile_s','-')}/{r2.get('compile_s','-')} |")
    p(f"\nok={n_ok} skipped={n_skip} FAILED={n_fail}\n")

    p("### Roofline (single-pod 16x16, per-device terms)\n")
    p("| arch | shape | t_compute | t_memory(fused) | t_mem(unfused) "
      "| t_collective | bottleneck | useful | roofline_frac |")
    p("|---|---|---|---|---|---|---|---|---|")
    for r in single:
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        f = r["roofline"]
        p(f"| {r['arch']} | {r['shape']} | {fmt_t(f['t_compute_s'])} | "
          f"{fmt_t(f['t_memory_s'])} | "
          f"{fmt_t(f.get('t_memory_unfused_s'))} | "
          f"{fmt_t(f['t_collective_s'])} | {f['bottleneck']} | "
          f"{f['useful_ratio']:.3f} | {f['roofline_fraction']:.3f} |")

    if variants:
        p("\n### Perf variants (baseline vs optimized, single pod)\n")
        p("| arch | shape | variant | t_coll base->opt | "
          "frac base->opt | verdict |")
        p("|---|---|---|---|---|---|")
        base = {(r["arch"], r["shape"]): r for r in single
                if r.get("roofline")}
        for r in variants:
            if r.get("status") == "no_counterpart":
                p(f"| {r['arch']} | {r['shape']} | {r.get('variant')} | "
                  "- | - | no counterpart |")
                continue
            if r.get("status") != "ok" or "roofline" not in r:
                p(f"| {r['arch']} | {r['shape']} | "
                  f"{r.get('variant')} | - | - | FAILED |")
                continue
            b = base.get((r["arch"], r["shape"]))
            if not b:
                continue
            bf, of = b["roofline"], r["roofline"]
            verdict = ("confirmed" if of["roofline_fraction"] >
                       bf["roofline_fraction"] * 1.05 else
                       "refuted" if of["roofline_fraction"] <
                       bf["roofline_fraction"] * 0.95 else "neutral")
            p(f"| {r['arch']} | {r['shape']} | {r['variant']} | "
              f"{fmt_t(bf['t_collective_s'])} -> "
              f"{fmt_t(of['t_collective_s'])} | "
              f"{bf['roofline_fraction']:.3f} -> "
              f"{of['roofline_fraction']:.3f} | {verdict} |")
    return out


def main() -> list:
    lines = render(json.loads(RESULTS.read_text()))
    print("\n".join(lines), flush=True)
    return lines


if __name__ == "__main__":
    main()
