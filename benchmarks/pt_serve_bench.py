"""Serving-layer benchmark on the port: traffic through repro_torch.serve_lp.

The PyTorch twin of ``benchmarks/serve_bench.py``, on
``repro_torch.serve_lp.bench``: one CSV row per traffic profile
(``us_per_call`` is mean end-to-end request latency; ``derived`` packs
throughput / p99 / padding / cache-hit numbers), ``JSON`` lines with the
reference's keys plus ``card``.

The reference's ``serve_shard_*`` profiles A/B its mesh flush path against
the legacy pmap one.  The port has the mesh path only: its ``"pmap"``
sharding mode raises ``ValueError`` by design, so each pmap profile is one
``JSON`` line saying it has no counterpart, and no row.

The burst profiles run under a ``repro_torch.obs`` tracer, so their
``idle_frac`` comes from per-device ``device.solve`` spans.
"""
from __future__ import annotations

import json

from benchmarks.pt_common import emit
from repro_torch.device import as_device, card_info
from repro_torch.serve_lp.bench import (BenchConfig, run_rpc_traffic,
                                        run_traffic, smoke_config)

NO_PMAP = ("the port's sharding modes are the mesh path only: 'pmap' "
           "raises ValueError by design (repro_torch.serve_lp.buckets."
           "SHARDING_MODES)")


def _shard_profile(sharding: str) -> BenchConfig:
    """Underfull-heterogeneous burst: requests spread over the full
    m-bucket ladder, so per-bucket occupancy stays well below
    max_batch and the fused/uneven machinery has real work to do."""
    cfg = BenchConfig(requests=240, rate=2000.0, m_min=8, m_max=1024,
                      max_batch=32, max_wait_s=0.005, check=8)
    cfg.open_loop = True
    cfg.sharding = sharding
    return cfg


def profiles(full: bool = False) -> dict:
    """The reference's profiles, by name, in its order."""
    profs = {"serve_smoke": smoke_config()}
    burst = smoke_config()
    burst.open_loop = True
    burst.trace = True
    profs["serve_burst_pipelined"] = burst
    stopgo = smoke_config()
    stopgo.open_loop = True
    stopgo.pipeline = False
    stopgo.trace = True
    profs["serve_burst_stopgo"] = stopgo
    if full:
        profs["serve_open_loop"] = BenchConfig(
            requests=2000, rate=5000.0, m_max=1024, max_batch=128,
            max_wait_s=0.02)
        profs["serve_kernel"] = BenchConfig(
            requests=256, rate=2000.0, m_max=256, max_batch=64,
            method="kernel", check=4)
    profs["serve_shard_mesh"] = _shard_profile("mesh")
    profs["serve_shard_pmap"] = _shard_profile("pmap")
    return profs


def run(full: bool = False, *, device=None) -> list:
    devices = [as_device(device)]
    card = card_info()
    rows = []
    shard_rows = {}
    for name, cfg in profiles(full).items():
        if cfg.sharding == "pmap":
            print("JSON " + json.dumps({
                "profile": name, "sharding": cfg.sharding,
                "status": "no_counterpart", "reason": NO_PMAP,
                "card": card}), flush=True)
            continue
        snap, _ = run_traffic(cfg, quiet=True, devices=devices)
        if name.startswith("serve_shard_"):
            row = {
                "profile": name,
                "sharding": cfg.sharding,
                "throughput_lps": round(snap["throughput_lps"], 1),
                "launches": snap["launches_total"],
                "flushes": snap["n_flushes"],
                "fused_flushes": snap["fused_flushes"],
                "fused_buckets": snap["fused_buckets"],
                "pad_waste_problems": round(
                    snap["padding_waste_problems"], 4),
                "pad_waste_cells": round(snap["padding_waste_cells"], 4),
                "rows_per_device": snap["rows_per_device"],
                "card": card,
            }
            shard_rows[cfg.sharding] = row
            print("JSON " + json.dumps(row), flush=True)
        if "device_idle_frac" in snap:
            idle = f"|idle_frac={snap['device_idle_frac']:.3f}"
            print("JSON " + json.dumps({
                "profile": name,
                "device_idle_frac": round(snap["device_idle_frac"], 4),
                "device_busy_s": round(snap["device_busy_s"], 4),
                "device_window_s": round(snap["device_window_s"], 4),
                "device_tracks": snap["device_tracks"],
                "trace_spans": snap["trace_spans"],
                "card": card,
            }), flush=True)
        else:
            idle = f"|idle_s={snap['device_idle_s_est']:.3f}"
        rows.append(emit(
            name, snap["latency_mean_ms"] / 1e3,
            f"lps={snap['throughput_lps']:.1f}"
            f"|p50ms={snap['latency_p50_ms']:.2f}"
            f"|p99ms={snap['latency_p99_ms']:.2f}"
            f"|waste_cells={snap['padding_waste_cells']:.3f}"
            f"|cache_hit={snap['cache']['hit_rate']:.3f}"
            f"|inflight_max={snap['inflight_max']}"
            f"|overlapped={snap['overlapped_dispatches']}"
            + idle +
            f"|launches={snap['launches_total']}"
            f"|fused={snap['fused_flushes']}"))
    if "mesh" in shard_rows:
        mesh = shard_rows["mesh"]
        print(f"[serve_bench] shard A/B: mesh {mesh['launches']} "
              f"launches @ {mesh['throughput_lps']:.1f} LPs/s; pmap has no "
              "counterpart in the port", flush=True)
    rpc_cfg = smoke_config()
    rpc_cfg.rpc = True
    rep, _ = run_rpc_traffic(rpc_cfg, quiet=True, devices=devices)
    c, o = rep["closed_loop"], rep["overload"]
    rows.append(emit(
        "serve_rpc_http", c["p50_ms"] / 1e3,
        f"rps={c['rps']:.1f}"
        f"|p50ms={c['p50_ms']:.2f}"
        f"|p99ms={c['p99_ms']:.2f}"
        f"|errors={c['errors']}"
        f"|shed_rate={o['shed_rate']:.3f}"
        f"|retry_after={int(o['retry_after_on_429'])}"))
    return rows
