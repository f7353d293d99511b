#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It drives the port's main path (``repro_torch`` only) on the card at sizes
users would call real — the paper's figure-3 batch of 16384 problems at the
README's example width of 256 constraints — and prints one JSON object per
line:

1. ``probe``   PyTorch / CUDA versions, device name and power limit, nvcc.
2. ``build``   builds ``src/repro_torch/kernels/csrc/batch_lp.cu`` for
   sm_90a; seconds, registers / shared memory / spills per kernel.
3. ``kernels`` every ``rgb_cuda`` variant (float32 dense, float32
   ``chunk=128``, float64 dense) at ``B=16384, m_pad=256`` and
   ``B=2048, m_pad=2048`` (problems staged in shared memory) and at
   ``B=64, m_pad=19456`` (too wide to stage: the kernel's global-memory
   regime) against its plain PyTorch version on the same tensors
   (feasible, ragged, infeasible and adversarial problems): 0 feasibility
   mismatches, ``x`` within 1e-4 (float32) / 1e-9 (float64), dense and
   chunked equal bit for bit (a zero's sign included); its time beside
   the least time the card could take for the same work, and its launch
   geometry (warps per CTA,
   dynamic shared memory, staged or not).  After phase 5 the same is done at
   every shape, tile and chunk the serving run really launched the kernel
   with (read from the scheduler's executable cache).  The ``kernels``
   line is printed once, near the end, with the launch counts of phases 4
   and 5.
4. ``solver``  ``SolverSpec(backend="auto").build().solve(...)`` on AoS and
   pre-packed batches: resolved to the kernel, launch count advanced,
   packed-vs-AoS bit-identical, agreement with the plain RGB solver.
5. ``serve``   ``BatchScheduler`` answering 8192 single-LP requests of mixed
   size and kind: every future resolves, a sample re-solved directly is
   bit-identical, kernel launches equal the metrics' launch count and
   the flushes the executable cache served, zero repacks.

Every input is made from a fixed numpy seed.  Any failed check exits
non-zero.  The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}``.
Without a CUDA device — or without the rest of the checkout beside this
file — it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 20190213
# The paper's figure-3 batch and the README's example width; a second,
# wide shape whose problems are 2048 constraints long; a third whose
# problems are too wide for one warp's shared memory even in float32
# (the first m_pad past 19,328), so the kernel reads global memory.
SHAPES = ((16384, 256), (2048, 2048), (64, 19456))
VARIANTS = (("float32", 0), ("float32", 128), ("float64", 0))
X_TOL = {"float32": 1e-4, "float64": 1e-9}
# Published peaks of one H100 SXM: HBM bytes/s, FLOP/s outside the tensor
# cores.  A roofline share is stated against these whatever the power limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/batch_lp.cu"
KERNEL_REPLACES = "src/repro/kernels/batch_lp.py:63"

SERVE_REQUESTS = 8192
SERVE_SIZES = (8, 16, 32, 64, 128, 256, 512, 1024)
SERVE_KINDS = ("feasible", "infeasible", "degenerate")
SERVE_MIX = (0.8, 0.1, 0.1)


class SmokeFailure(AssertionError):
    """A check of the smoke run did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# Inputs (numpy, seeded)
# ---------------------------------------------------------------------------

def feasible_arrays(rng, B: int, m: int):
    """Random feasible problems (numpy twin of core.random_feasible_lp)."""
    xstar = rng.uniform(-50.0, 50.0, (B, 1, 2))
    theta = rng.uniform(0.0, 2.0 * np.pi, (B, m))
    A = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    b = (A * xstar).sum(-1) + rng.uniform(0.1, 5.0, (B, m))
    phi = rng.uniform(0.0, 2.0 * np.pi, B)
    c = np.stack([np.cos(phi), np.sin(phi)], axis=-1)
    return A, b, c


def mixed_arrays(rng, B: int, m: int):
    """A batch holding every kind the checks name: 3/4 feasible and full,
    ragged (``m_valid`` in 4..m), 1/32 infeasible, 1/32 adversarial
    (every constraint invalidates the optimum before it)."""
    A, b, c = feasible_arrays(rng, B, m)
    mv = np.full((B,), m, np.int32)
    # (a batch of a few problems has room for the first two kinds only)
    n_inf = n_adv = min(max(1, B // 32), B // 12)
    n_rag = B // 4 - n_inf - n_adv
    lo = B - B // 4
    rag = slice(lo, lo + n_rag)
    mv[rag] = rng.integers(4, m + 1, n_rag)
    keep = np.arange(m)[None, :] < mv[:, None]
    A = np.where(keep[..., None], A, 0.0)
    b = np.where(keep, b, 1.0)
    inf = slice(lo + n_rag, lo + n_rag + n_inf)
    A[inf, 0] = (1.0, 0.0)
    b[inf, 0] = -1.0
    A[inf, 1] = (-1.0, 0.0)
    b[inf, 1] = -1.0
    adv = slice(lo + n_rag + n_inf, B)
    i = np.arange(m, dtype=np.float64)
    ang = np.pi / 2 + (np.pi / 2.2) * (0.98 ** i) * np.where(
        i % 2 == 0, 1.0, -1.0)
    A[adv] = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    b[adv] = 1.0
    c[adv] = (0.0, 1.0)
    return A, b, c, mv


def packed_on(device, A, b, c, mv, dtype: str, m_pad: int):
    """Numpy AoS arrays -> normalised packed tensors on ``device``."""
    from repro_torch.core import (batch_from_numpy, normalize_packed, pack,
                                  pad_packed)
    npdt = np.dtype(dtype)
    batch = batch_from_numpy(A.astype(npdt), b.astype(npdt),
                             c.astype(npdt), mv, device=device)
    pb = normalize_packed(pad_packed(pack(batch), m_pad))
    return pb.L.contiguous(), pb.c.contiguous(), pb.m_valid.contiguous()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_probe(card: str) -> None:
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    emit({"phase": "probe", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "card": card,
          "nvcc": nvcc.strip().splitlines()[-2:]})


def phase_build(card: str) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load("batch_lp")
    emit({"phase": "build", "source": KERNEL_SOURCE,
          "flags": " ".join(_build.NVCC_FLAGS),
          "nvcc_seconds": _build.build_seconds("batch_lp"),
          "seconds": time.perf_counter() - t0,
          "kernels": _build.kernel_resources("batch_lp"), "card": card})


def time_launches(fn, n_warm: int = 3, n: int = 20) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``n`` eager
    calls: the device's time where it is the bottleneck, else the host's
    time to make one call (Python wrapper, allocation, launch)."""
    for _ in range(n_warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def time_device(fn, n: int = 20) -> float:
    """Milliseconds of device time per call of ``fn``: ``n`` calls
    captured in one CUDA graph and replayed back to back, timed by CUDA
    events, so the host's cost of a call does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def bound_ms(B, m_pad, dtype, mv_sum, resolve_work):
    """Least time the card could take: each input read once and each
    output written once over the memory rate, against the operations these
    inputs need (~4 per constraint tested, ~12 per prior constraint
    scanned by a re-solve actually taken) over the peak rate."""
    item = np.dtype(dtype).itemsize
    nbytes = B * 3 * m_pad * item + B * 2 * item + B * 4 + B * 2 * item + B * 4
    ops = 4 * mv_sum + 12 * resolve_work
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (``torch.equal`` takes -0 == +0)."""
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def check_inputs(rng, B: int, m_pad: int):
    """The two batches a kernel entry is checked on: a mixed one, and the
    full-width feasible one that is also timed."""
    mixed = mixed_arrays(rng, B, m_pad)
    A, b, c = feasible_arrays(rng, B, m_pad)
    return mixed, (A, b, c, np.full((B,), m_pad, np.int32))


def hold_and_time(device, card: str, inputs, B: int, m_pad: int, dtype: str,
                  tile: int, chunk: int, path: str, dense_out: dict) -> dict:
    """One ``kernels`` entry: ``rgb_cuda`` at this shape, tile and chunk
    held against ``rgb_plain`` on both batches of ``inputs`` and timed on
    the second.  ``dense_out`` carries the dense variant's outputs to the
    chunked one of the same inputs and dtype, which must equal them bit
    for bit."""
    from repro_torch.kernels.batch_lp import (launch_geometry, rgb_cuda,
                                              rgb_plain)
    M = 1.0e4
    mixed, timed = inputs
    err = 0.0
    mismatches = 0
    stats: dict = {}
    plain_ms = None
    for which, arrays in (("mixed", mixed), ("timed", timed)):
        L, cc, mv = packed_on(device, *arrays, dtype, m_pad)
        x_k, f_k = rgb_cuda(L, cc, mv, M=M, tile=tile, chunk=chunk)
        torch.cuda.synchronize()
        st = stats if which == "timed" else None
        t0 = time.perf_counter()
        # One tile for the whole batch: per-problem results do not
        # depend on the tile, and the plain version then needs one
        # pass of tensor ops per step instead of one per tile.
        x_p, f_p = rgb_plain(L, cc, mv, M=M, tile=B, chunk=chunk, stats=st)
        torch.cuda.synchronize()
        if which == "timed":
            plain_ms = (time.perf_counter() - t0) * 1e3
        mismatches += int((f_k != f_p).sum())
        ok = f_p[:, 0] != 0
        # Where infeasible, x is documented garbage (it is the same
        # garbage in both, but that is not part of the contract).
        err = max(err, float((x_k[ok] - x_p[ok]).abs().max()))
        if chunk == 0:
            dense_out[(dtype, which)] = (x_k, f_k)
        elif (dtype, which) in dense_out:
            x_d, f_d = dense_out[(dtype, which)]
            check(torch.equal(bits(x_d), bits(x_k))
                  and torch.equal(f_d, f_k),
                  f"dense and chunk={chunk} differ in bits at "
                  f"B={B} m_pad={m_pad} {dtype} ({which})")
    def launch():
        return rgb_cuda(L, cc, mv, M=M, tile=tile, chunk=chunk)
    ms = time_device(launch)
    call_ms = time_launches(launch)
    bms, by, nbytes, ops = bound_ms(
        B, m_pad, dtype, int(mv.sum()), stats.get("resolve_work", 0))
    geom = launch_geometry(m_pad, np.dtype(dtype).itemsize, tile)
    entry = {
        "name": "rgb_cuda", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "dtype": dtype, "path": path,
        "shape": [B, 4, m_pad], "tile": tile, "chunk": chunk,
        "launches": 0, "max_abs_err": err,
        "feasible_mismatches": mismatches, "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "bytes": nbytes, "operations": ops,
        "resolves": stats.get("resolves", 0),
        "warps_per_cta": geom.warps, "smem_bytes": geom.smem_bytes,
        "staged": geom.staged, "card": card}
    check(mismatches == 0, f"{mismatches} feasibility mismatches: {entry}")
    check(err <= X_TOL[dtype],
          f"x differs from the plain version by {err}: {entry}")
    return entry


def phase_kernels(device, card: str, shapes=SHAPES) -> list:
    """Every kernel variant at the direct-solve shapes, with the tile the
    solver picks there."""
    from repro_torch.kernels.batch_lp import _pick_tile
    entries = []
    for si, (B, m_pad) in enumerate(shapes):
        inputs = check_inputs(np.random.default_rng([SEED, 1, si]), B, m_pad)
        dense_out: dict = {}
        for dtype, chunk in VARIANTS:
            entries.append(hold_and_time(
                device, card, inputs, B, m_pad, dtype, _pick_tile(B), chunk,
                "solver", dense_out))
    return entries


def phase_serve_kernels(device, card: str, exec_specs: list) -> list:
    """The kernel at every shape, tile and chunk the serving run launched
    it with; ``launches`` is the number of flushes that ran there."""
    entries = []
    for si, es in enumerate(exec_specs):
        B, m_pad = es["b_pad"], es["bucket_m"]
        inputs = check_inputs(np.random.default_rng([SEED, 3, si]), B, m_pad)
        e = hold_and_time(device, card, inputs, B, m_pad, es["dtype"],
                          es["tile"], es["chunk"], "serve", {})
        e["launches"] = es["flushes"]
        entries.append(e)
    return entries


def phase_solver(device, card: str, entries: list, shapes=SHAPES) -> None:
    """The direct-solve entry point, once per kernel variant and shape;
    fills each entry's ``launches`` from its own drive."""
    from repro_torch.core import (batch_from_numpy, normalize_packed,
                                  solve_rgb_packed)
    from repro_torch.core.packed import PackedLPBatch
    from repro_torch.kernels.batch_lp import rgb_cuda
    from repro_torch.solver import SolverSpec

    by_key = {(tuple(e["shape"]), e["dtype"], e["chunk"]): e
              for e in entries}
    for si, (B, m) in enumerate(shapes):
        rng = np.random.default_rng([SEED, 2, si])
        A, b, c = feasible_arrays(rng, B, m)
        A *= rng.uniform(0.5, 2.0, (B, m, 1))   # not unit: normalize works
        b *= np.linalg.norm(A, axis=-1)
        A32, b32, c32 = (a.astype(np.float32) for a in (A, b, c))
        for dtype, chunk in VARIANTS:
            main = dtype == "float32" and chunk == 0
            spec = (SolverSpec(backend="auto", normalize=True) if main else
                    SolverSpec(backend="kernel", normalize=True,
                               chunk=chunk, dtype=dtype))
            solver = spec.build()          # the card, or it raises
            check(solver.spec.backend == "kernel"
                  and solver.spec.interpret is False
                  and solver.device.type == "cuda",
                  f"spec did not resolve to the CUDA kernel: {solver!r}")
            batch = batch_from_numpy(A32, b32, c32, device=device)
            packed = batch.pack()
            rgb_cuda.launches = 0
            sol_a = solver.solve(batch)
            sol_p = solver.solve(packed)
            torch.cuda.synchronize()
            launches = rgb_cuda.launches
            check(launches == 2, f"two solves made {launches} launches")
            by_key[((B, 4, m), dtype, chunk)]["launches"] = launches
            check(torch.equal(sol_a.x, sol_p.x)
                  and torch.equal(sol_a.feasible, sol_p.feasible)
                  and torch.equal(sol_a.objective, sol_p.objective),
                  "packed and AoS solves differ in bits")
            check(bool(torch.isfinite(sol_a.x).all())
                  and sol_a.x.shape == (B, 2)
                  and bool(sol_a.feasible.all()),
                  "solution not finite / feasible / of the expected shape")
            if not main:
                continue
            # Agreement with the plain RGB solver on a subset.
            n_ref = min(1024, B)
            sub = PackedLPBatch(L=packed.L[:n_ref], c=packed.c[:n_ref],
                                m_valid=packed.m_valid[:n_ref])
            ref = solve_rgb_packed(normalize_packed(sub), M=spec.M,
                                   tile=n_ref)
            check(torch.equal(ref.feasible, sol_a.feasible[:n_ref]),
                  "feasibility differs from solve_rgb_packed")
            check(torch.allclose(ref.x, sol_a.x[:n_ref], rtol=1e-4,
                                 atol=1e-4),
                  "x differs from solve_rgb_packed")

            def timed(bt):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solver.solve(bt)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            t_aos = sorted(timed(batch) for _ in range(7))
            t_pk = sorted(timed(packed) for _ in range(7))
            emit({"phase": "solver", "B": B, "m": m, "dtype": dtype,
                  "spec": repr(solver.spec), "launches": launches,
                  "aos_seconds_median": t_aos[3],
                  "aos_lps": B / t_aos[3],
                  "packed_seconds_median": t_pk[3],
                  "packed_lps": B / t_pk[3],
                  "packed_vs_aos_bit_identical": True,
                  "max_abs_diff_vs_solve_rgb_packed": float(
                      (ref.x - sol_a.x[:n_ref]).abs().max()),
                  "card": card})


def serve_request(i: int):
    """Request #i of the stream — a pure function of (SEED, i); numpy copy
    of the reference serving benchmark's generator (0.8 feasible, 0.1
    infeasible, 0.1 degenerate: every constraint tight at one point)."""
    rng = np.random.default_rng(np.random.SeedSequence([SEED, i, 0x52E41]))
    m = int(SERVE_SIZES[rng.integers(len(SERVE_SIZES))])
    kind = SERVE_KINDS[rng.choice(3, p=np.asarray(SERVE_MIX))]
    xstar = rng.uniform(-50.0, 50.0, 2)
    theta = rng.uniform(0.0, 2.0 * np.pi, m)
    A = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    b = A @ xstar + rng.uniform(0.1, 5.0, m)
    phi = rng.uniform(0.0, 2.0 * np.pi)
    c = np.array([np.cos(phi), np.sin(phi)])
    A, b, c = (a.astype(np.float32) for a in (A, b, c))
    if kind == "degenerate":
        b = (A @ rng.uniform(-50.0, 50.0, 2).astype(np.float32)
             ).astype(np.float32)
    elif kind == "infeasible":
        A[0] = (1.0, 0.0)
        b[0] = -1.0
        A[1] = (-1.0, 0.0)
        b[1] = -1.0
    return A, b, c, kind


def phase_serve(devices, card: str, n_requests: int = SERVE_REQUESTS,
                max_batch: int = 1024) -> dict:
    """The serving entry point: a stream of single-LP requests."""
    from repro_torch.core import pack_call_count
    from repro_torch.kernels.batch_lp import rgb_cuda
    from repro_torch.serve_lp import BatchScheduler
    from repro_torch.solver import SolverSpec

    spec = SolverSpec(backend="kernel")
    reqs = [serve_request(i) for i in range(n_requests)]

    def drive(sched, items):
        t0 = time.perf_counter()
        futs = [sched.submit(A, b, c) for A, b, c, _ in items]
        t_submit = time.perf_counter() - t0
        res = [f.result(timeout=300) for f in futs]
        return res, t_submit, time.perf_counter() - t0

    # Warm-up on a scheduler of its own: CUDA context, pinned allocator,
    # the first touch of every bucket shape.
    with BatchScheduler(spec, max_batch=max_batch, max_wait_s=0.005,
                        devices=devices) as warm:
        drive(warm, reqs[:max(1, n_requests // 4)])
    warm.close()

    packs0 = pack_call_count()
    rgb_cuda.launches = 0
    sched = BatchScheduler(spec, max_batch=max_batch, max_wait_s=0.005,
                           devices=devices)
    with sched:
        results, t_submit, t_total = drive(sched, reqs)
    launches = rgb_cuda.launches
    repacks = pack_call_count() - packs0
    snap = sched.metrics.snapshot(sched.cache.stats())
    pinned = sched.buffers.pinned
    # What the flushes really handed the kernel: on one card a flush is one
    # launch of (b_pad, 4, bucket_m) at the tile and chunk pinned for it.
    exec_specs = sorted(
        ({"bucket_m": es.bucket_m, "b_pad": es.b_pad,
          "dtype": es.solver.dtype, "tile": es.solver.tile,
          "chunk": es.solver.chunk, "flushes": n}
         for es, n in sched.cache.uses().items()),
        key=lambda d: (-d["flushes"], -d["b_pad"], -d["bucket_m"]))
    for es in exec_specs:
        pin = sched._pin_for_bucket(es["bucket_m"], es["b_pad"])
        check((pin.tile, pin.chunk) == (es["tile"], es["chunk"]),
              f"flush geometry {es} is not what the scheduler pins: {pin!r}")
    sched.close()

    check(len(results) == n_requests, "a future did not resolve")
    check(snap["errors"] == {}, f"serving errors: {snap['errors']}")
    check(launches > 0 and launches == snap["launches_total"],
          f"kernel launches {launches} != metrics' launch count "
          f"{snap['launches_total']}")
    check(len(devices) > 1
          or sum(es["flushes"] for es in exec_specs) == launches,
          f"{launches} launches but the executable cache served "
          f"{exec_specs}")
    check(repacks == 0, f"{repacks} AoS->SoA repacks on the serving path")
    for (A, b, c, kind), r in zip(reqs, results):
        check(np.isfinite(r.x).all() and r.x.shape == (2,),
              "non-finite serving answer")
        if kind != "degenerate":
            check(r.feasible == (kind == "feasible"),
                  f"{kind} request answered feasible={r.feasible}")
    # A sample re-solved directly: bit-identical to the scheduler's answer.
    solver = spec.build(device=devices[0])
    step = max(1, n_requests // 64)
    n_checked = 0
    for (A, b, c, _), r in list(zip(reqs, results))[::step][:64]:
        s = solver.solve_one(A, b, c)
        check(np.array_equal(s.x.cpu().numpy(), r.x)
              and bool(s.feasible) == r.feasible,
              "scheduler answer differs in bits from the direct solve")
        n_checked += 1
    lat = np.sort(np.array([r.latency_s for r in results]))
    out = {"phase": "serve", "requests": n_requests, "max_batch": max_batch,
           "max_wait_s": 0.005, "devices": [str(d) for d in devices],
           "pinned_buffers": pinned,
           "submit_seconds": t_submit, "total_seconds": t_total,
           "lps": n_requests / t_total,
           "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
           "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
           "flushes": snap["n_flushes"],
           "flush_reasons": snap["flush_reasons"],
           "fused_flushes": snap["fused_flushes"],
           "launches": launches, "launches_metrics": snap["launches_total"],
           "inflight_max": snap["inflight_max"],
           "assemble_seconds": snap["assemble_seconds"],
           "solve_seconds": snap["solve_seconds"],
           "padding_waste_cells": snap["padding_waste_cells"],
           "repacks": repacks, "bit_identical_checked": n_checked,
           "exec_specs": exec_specs, "card": card}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script "
              "measures the port on the card and does not run without "
              "one", file=sys.stderr)
        return 2
    from repro_torch.device import card_info, default_device, default_devices
    from repro_torch.kernels.batch_lp import rgb_cuda

    device = default_device()
    card = card_info()
    t_start = time.perf_counter()
    try:
        check(card is not None,
              "nvidia-smi did not give the card's name and power limit, "
              "which every number printed here must carry")
        phase_probe(card)
        phase_build(card)
        entries = phase_kernels(device, card)
        rgb_cuda.launches = 0
        phase_solver(device, card, entries)
        serve = phase_serve(default_devices()[:1], card)
        # Launches made from here on compare and time; the counts of the
        # main path have been read.
        entries += phase_serve_kernels(device, card, serve["exec_specs"])
        for e in entries:
            check(e["launches"] > 0,
                  f"the main path never launched {e['name']} "
                  f"{e['dtype']} chunk={e['chunk']} {e['shape']}")
        check(serve["launches"] > 0, "the serving path launched no kernel")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"kernels": entries})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
