#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It drives the port's main paths (``repro_torch`` only) on the card at sizes
users would call real — the paper's figure-3 batch of 16384 problems at the
README's example width of 256 constraints, and Qwen2-0.5B trained at full
width with the LP solver inside its optimizer — and prints one JSON object
per line:

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
   dynamic shared memory, staged or not).  After phases 5 and 8 the same
   is done at every shape, tile and chunk the serving and RPC runs really
   launched the kernel with (read from the scheduler's executable cache).
   The ``kernels`` line is printed once, near the end, with the launch
   counts of phases 4, 5, 8 and 9.
4. ``solver``  ``SolverSpec(backend="auto").build().solve(...)`` on AoS and
   pre-packed batches: resolved to what the active tuning table names
   (the kernel on a miss), launch count advanced,
   packed-vs-AoS bit-identical, agreement with the plain RGB solver.
5. ``serve``   ``BatchScheduler`` answering 8192 single-LP requests of mixed
   size and kind: every future resolves, a sample re-solved directly is
   bit-identical, kernel launches equal the metrics' launch count and
   the flushes the executable cache served, zero repacks.
6. ``pdhg``    ``SolverSpec(backend="pdhg").build().solve(...)`` at the
   figure-3 shape (feasible, ragged and infeasible problems): feasibility
   equal to the kernel's on every problem, the objective within 1e-3 of
   the kernel's relative to the problem's scale ``max(1, ||b||_inf)`` on
   the feasible ones,
   ``solve_pdhg_with_stats`` converged on every feasible problem; the
   solve's time, iterations, restarts, and one block's host time, device
   time and CUDA kernel launches (``torch.profiler``).
7. ``tune``    the bundled tuning table has rows for this card;
   ``backend="auto"`` at the figure-3 shape resolves to what its row
   names; ``tune_shape`` times real candidates at ``128 x 1024``; the
   table's save -> load -> merge round trip holds.
8. ``rpc``     the HTTP front end (``make_frontend`` + ``run_in_thread``,
   kernel backend, SLO controller, tracing on) answering 1024
   ``POST /v1/solve`` requests of 1-8 LPs from 8 client threads: every
   answer bit-identical to a direct ``Solver.solve``; a 1 ms deadline
   gets 504, a tenant over its quota 429; ``/metrics`` is valid
   exposition; an SLO plan came from a measured row; the flushes
   launched ``rgb_cuda``; the span ring exports a valid Chrome trace
   with complete span chains, and ``device_idle`` is printed.  The
   kernel geometries these flushes used join the ``kernels`` line.
9. ``train``   ``repro_torch.launch.train.main`` at full width: Qwen2-0.5B
   in bf16 with ``--lp-clip``, batch 8 x 512 tokens of synthetic data, 20
   steps checkpointed at step 10 into a temporary directory, then a second
   run to step 22 that must log ``resumed from step 20``: every loss finite
   and the last below the first, ``lp_s1`` in [0, 1], one ``rgb_cuda``
   launch per step; the median step, tokens/s, peak memory, each stage of
   a step timed apart (forward+backward, the fp32 logits and loss, AdamW,
   the LP clip, apply) and the step's kernels from a profiler trace.  The
   LP batch of one real step is held against ``rgb_plain`` bit for bit
   (a ``kernels`` entry with ``path="train"``), and the smoke config in
   float32 takes three LP-clipped steps on the card and on the CPU from the
   same weights, TF32 off: loss and ``lp_s1`` within 1e-4, every leaf
   within 2e-6 (the CPU parity test's tolerance).

Every input is made from a fixed numpy seed.  Any failed check exits
non-zero.  The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}``.
Without a CUDA device — or without the rest of the checkout beside this
file — it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
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
PEAK_BF16_FLOPS = 989e12   # dense bf16 on the tensor cores
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


GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def device_kernels(fn, top: int = 12) -> dict:
    """What ``fn`` ran on the card, from a ``torch.profiler`` trace: the
    device ms of all its kernels, of the matrix-multiply ones (cuBLAS /
    CUTLASS names), and the ``top`` kernels by device time; ``None``s
    when the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_ms": None, "gemm_ms": None, "launches": None,
                "top": None}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    return {"device_ms": sum(by_name.values()),
            "gemm_ms": sum(t for n, t in by_name.items()
                           if any(w in n.lower() for w in GEMM_NAMES)),
            "launches": len(kernels),
            "top": sorted(([n[:90], t] for n, t in by_name.items()),
                          key=lambda x: -x[1])[:top]}


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
                  tile: int, chunk: int, path: str, dense_out: dict,
                  M: float = 1.0e4) -> dict:
    """One ``kernels`` entry: ``rgb_cuda`` at this shape, tile and chunk
    held against ``rgb_plain`` on both batches of ``inputs`` and timed on
    the second.  ``dense_out`` carries the dense variant's outputs to the
    chunked one of the same inputs and dtype, which must equal them bit
    for bit.  ``bits_equal`` says whether the kernel's ``x`` (where
    feasible) and flags equal the plain version's bit for bit."""
    from repro_torch.kernels.batch_lp import (launch_geometry, rgb_cuda,
                                              rgb_plain)
    mixed, timed = inputs
    err = 0.0
    mismatches = 0
    bits_equal = True
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
        bits_equal = bits_equal and torch.equal(f_k, f_p) and torch.equal(
            bits(x_k[ok]), bits(x_p[ok]))
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
        "feasible_mismatches": mismatches, "bits_equal": bits_equal,
        "M": M, "ms": ms, "call_ms": call_ms,
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
    solver pins there (the tuning table's, else the heuristic's)."""
    from repro_torch.solver import SolverSpec
    entries = []
    for si, (B, m_pad) in enumerate(shapes):
        inputs = check_inputs(np.random.default_rng([SEED, 1, si]), B, m_pad)
        dense_out: dict = {}
        for dtype, chunk in VARIANTS:
            tile = SolverSpec(backend="kernel", dtype=dtype,
                              chunk=chunk).resolve_for_shape(
                                  m_pad, B, platform="cuda").tile
            entries.append(hold_and_time(
                device, card, inputs, B, m_pad, dtype, tile, chunk,
                "solver", dense_out))
    return entries


def phase_serve_kernels(device, card: str, exec_specs: list,
                        path: str = "serve") -> list:
    """The kernel at every shape, tile and chunk the serving (or RPC) run
    launched it with; ``launches`` is the number of flushes that ran
    there."""
    entries = []
    for si, es in enumerate(exec_specs):
        B, m_pad = es["b_pad"], es["bucket_m"]
        inputs = check_inputs(np.random.default_rng([SEED, 3, si]), B, m_pad)
        e = hold_and_time(device, card, inputs, B, m_pad, es["dtype"],
                          es["tile"], es["chunk"], path, {})
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

    from repro_torch.tune import active_table

    by_key = {(tuple(e["shape"]), e["dtype"], e["chunk"]): e
              for e in entries}
    table = active_table()
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
            # Per shape, "auto" takes what the active tuning table names
            # (its fastest measured backend), the kernel on a miss; this
            # phase drives the kernel, so the table must name it here.
            best = table.lookup_best_backend(dtype=dtype, m=m, batch=B)
            named = best.key.backend if best is not None else "kernel"
            resolved = spec.resolve_for_shape(m, B).backend
            check(resolved == named == "kernel",
                  f"{spec!r} at m={m} B={B} resolved to {resolved!r}, the "
                  f"active table names {named!r}")
            batch = batch_from_numpy(A32, b32, c32, device=device)
            packed = batch.pack()
            rgb_cuda.launches = 0
            sol_a = solver.solve(batch)
            sol_p = solver.solve(packed)
            torch.cuda.synchronize()
            launches = rgb_cuda.launches
            check(launches == 2,
                  f"two kernel solves made {launches} kernel launches")
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
                  "spec": repr(solver.spec), "resolved_backend": resolved,
                  "table_names": named, "launches": launches,
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


PDHG_SHAPE = (16384, 256)       # the paper's figure-3 batch and width
# Objective agreement with the kernel, in the form of the reference's
# tests/test_pdhg.py (|pdhg - kernel| <= atol + rtol |kernel|, from a
# solve at tol=1e-5), held to 1e-3 where that test allows 2e-3.  At
# float32's default tolerance (1e-4) a certified iterate may sit a
# relative 1e-4 outside a constraint, and the objective then differs by
# up to ~6e-3 relative; the phase prints that too, and holds the default
# solve to the certificate and the feasibility flags.
PDHG_CHECK_TOL = 1e-5
PDHG_OBJ_RTOL = PDHG_OBJ_ATOL = 1e-3


def phase_pdhg(device, card: str) -> dict:
    """The first-order backend through its user entry point at the
    figure-3 shape, held against the kernel on the same problems."""
    from repro_torch.core import batch_from_numpy, normalize_packed
    from repro_torch.pdhg import (default_max_iters, default_tol,
                                  solve_pdhg_with_stats)
    from repro_torch.pdhg.solve import _solve_rows
    from repro_torch.solver import SolverSpec

    B, m = PDHG_SHAPE
    A, b, c, mv = mixed_arrays(np.random.default_rng([SEED, 4, 0]), B, m)
    batch = batch_from_numpy(A.astype(np.float32), b.astype(np.float32),
                             c.astype(np.float32), mv, device=device)
    ref = SolverSpec(backend="kernel").build().solve(batch)
    spec = SolverSpec(backend="pdhg", dtype="float32")
    solver = spec.build()
    # the schedule the solve runs with (the tuning table's, else default)
    sched = spec.resolve_for_shape(m, B)
    ib, rp = sched.iter_block, sched.restart_period
    check(solver.device.type == "cuda" and solver.spec.backend == "pdhg",
          f"pdhg spec did not build on the card: {solver!r}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(batch)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    # The certificate, on the rows the Solver feeds the backend.
    pb = normalize_packed(batch.pack())
    sol_s, st = solve_pdhg_with_stats(pb, iter_block=ib, restart_period=rp)
    fk = ref.feasible
    check(torch.equal(sol_s.x, sol.x) and torch.equal(sol_s.feasible,
                                                      sol.feasible),
          "solve_pdhg_with_stats differs from the Solver's pdhg solve")
    mism = int((sol.feasible != fk).sum())
    check(mism == 0, f"pdhg feasibility differs from the kernel's on "
                     f"{mism} of {B} problems")
    for name, t in (("iterations", st.iterations), ("kkt", st.kkt),
                    ("converged", st.converged)):
        check(t.shape == (B,) and t.device == sol.x.device,
              f"PDHGStats.{name} is not a ({B},) tensor on the card")
    # The objective, from a solve at the reference test's tolerance.
    t0 = time.perf_counter()
    tight = SolverSpec(backend="pdhg", dtype="float32",
                       tol=PDHG_CHECK_TOL).build().solve(batch)
    torch.cuda.synchronize()
    tight_s = time.perf_counter() - t0
    mism_tight = int((tight.feasible != fk).sum())
    check(mism_tight == 0, f"pdhg at tol={PDHG_CHECK_TOL} differs from the "
                           f"kernel's feasibility on {mism_tight} problems")
    ref_obj = ref.objective[fk]
    diff = (tight.objective[fk] - ref_obj).abs()
    excess = float((diff - (PDHG_OBJ_ATOL
                            + PDHG_OBJ_RTOL * ref_obj.abs())).max())
    max_rel = float((diff / ref_obj.abs().clamp_min(1.0)).max())
    check(excess <= 0.0,
          f"pdhg objective at tol={PDHG_CHECK_TOL} differs from the "
          f"kernel's by {max_rel} relative (limit rtol=atol="
          f"{PDHG_OBJ_RTOL})")
    max_rel_default = float(((sol.objective - ref.objective).abs()[fk]
                             / ref_obj.abs().clamp_min(1.0)).max())
    unconv = int((fk & ~st.converged).sum())
    check(unconv == 0, f"{unconv} feasible problems did not converge")
    check(bool(torch.isfinite(sol.x).all()), "non-finite pdhg answer")

    # One block: host time, device time and kernel launches, as the
    # difference of a 3-block and a 1-block run of the same rows (setup
    # and polish cancel).  Every problem is still active that early.
    rows = (pb.ax, pb.ay, pb.b, pb.c, pb.m_valid)

    def run(blocks):
        return lambda: _solve_rows(*rows, M=1.0e4, tol=None,
                                   max_iters=blocks * ib, iter_block=ib,
                                   restart_period=rp)

    def host_s(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return sorted(ts)[1]

    block_ms = (host_s(run(3)) - host_s(run(1))) / 2 * 1e3
    k1, k3 = device_kernels(run(1)), device_kernels(run(3))
    n1, d1 = k1["launches"], k1["device_ms"]
    n3, d3 = k3["launches"], k3["device_ms"]
    per_block = None if n1 is None or n3 is None else (n3 - n1) / 2
    dev_ms = None if d1 is None or d3 is None else (d3 - d1) / 2
    it = st.iterations.float()
    blocks = int(st.iterations.max()) // ib
    out = {"phase": "pdhg", "B": B, "m": m, "dtype": "float32",
           "spec": repr(solver.spec), "tol": default_tol(torch.float32),
           "max_iters": default_max_iters(torch.float32),
           "solve_seconds": solve_s, "lps": B / solve_s,
           "feasible": int(fk.sum()), "feasible_mismatches": mism,
           "check_tol": PDHG_CHECK_TOL, "check_solve_seconds": tight_s,
           "max_obj_diff_rel_objective": max_rel,
           "obj_rtol_atol": PDHG_OBJ_RTOL,
           "max_obj_diff_rel_objective_default_tol": max_rel_default,
           "unconverged_feasible": unconv,
           "iterations_median": float(it.median()),
           "iterations_max": int(st.iterations.max()),
           "restarts_median": float(st.restarts.float().median()),
           "blocks": blocks, "iter_block": ib, "restart_period": rp,
           "block_host_ms": block_ms, "block_device_ms": dev_ms,
           "block_launches": per_block,
           "launches_per_iteration": (None if per_block is None
                                      else per_block / ib),
           "card": card}
    emit(out)
    return out


def phase_tune(device, card: str) -> dict:
    """The bundled table is this card's and routes ``auto``; the tuner
    times real candidates; the table round-trips."""
    from repro_torch.solver import SolverSpec
    from repro_torch.tune import (TuningTable, check_round_trip,
                                  current_device_kind, default_table,
                                  tune_shape, winner_entries)

    table = default_table()
    kind = current_device_kind()
    mine = [e for e in table.entries() if e.key.device_kind == kind]
    check(len(mine) > 0, f"the bundled tuning table has no rows for "
                         f"{kind!r} (regenerate: scripts/tune_table.py)")
    check(all(e.source == "measured" for e in mine),
          "a bundled row is not a measurement")
    B, m = PDHG_SHAPE
    best = table.lookup_best_backend(dtype="float32", m=m, batch=B)
    check(best is not None, f"no bundled row covers m={m} B={B}")
    spec = SolverSpec(backend="auto").resolve_for_shape(m, B)
    check(spec.backend == best.key.backend,
          f"auto resolved to {spec.backend!r}, the table names "
          f"{best.key.backend!r}")
    slots = ((spec.iter_block, spec.restart_period)
             if spec.backend == "pdhg" else (spec.tile, spec.chunk))
    check(slots == (best.tile, best.chunk),
          f"auto pinned {slots}, the table's row has "
          f"{(best.tile, best.chunk)}")
    t0 = time.perf_counter()
    # one timed call a candidate: this checks that the tuner times real
    # candidates on the card; the table's own timings are tune_table.py's
    results = tune_shape(128, 1024, warmup=0, iters=1, device=device)
    tune_s = time.perf_counter() - t0
    check(results and all(r.seconds > 0 and r.device_kind == kind
                          for r in results),
          "tune_shape returned no real timings")
    check({r.candidate.backend for r in results} == {"kernel", "pdhg"},
          "tune_shape did not time both of the card's backends")
    measured = TuningTable(winner_entries(results))
    try:
        check_round_trip(table)
    except ValueError as e:
        check(False, f"the bundled table's round trip: {e}")
    out = {"phase": "tune", "device_kind": kind, "rows": len(mine),
           "auto_at_figure3": {"backend": spec.backend, "slots": slots,
                               "us_per_lp": best.us_per_lp},
           "tune_shape": {"m_pad": 128, "batch": 1024,
                          "seconds": tune_s, "candidates": len(results),
                          "fastest": results[0].candidate.label(),
                          "fastest_us_per_lp": results[0].us_per_lp,
                          "winners": {e.key.backend: [e.tile, e.chunk,
                                                      e.us_per_lp]
                                      for e in measured.entries()}},
           "round_trip": True, "card": card}
    emit(out)
    return out


RPC_REQUESTS = 1024
RPC_CLIENTS = 8
RPC_TARGET_P99_S = 0.025


def rpc_problems(i: int):
    """Request #i of the RPC traffic: 1-8 LPs, each drawn as the
    ``serve`` phase draws one (m from 8..1024, 0.8/0.1/0.1 feasible,
    infeasible, degenerate)."""
    rng = np.random.default_rng(np.random.SeedSequence([SEED, i, 0x4C50]))
    n = int(rng.integers(1, 9))
    return [serve_request(1_000_000 + 8 * i + k)[:3] for k in range(n)]


def phase_rpc(devices, card: str) -> dict:
    """The HTTP front end over the kernel backend, as a tenant reaches
    it."""
    import http.client
    import threading

    from repro_torch.kernels.batch_lp import rgb_cuda
    from repro_torch.obs import (Tracer, check_span_chains, device_idle,
                                 to_chrome_trace)
    from repro_torch.obs.export import validate_chrome_trace
    from repro_torch.serve_lp.rpc import (QuotaManager, make_frontend,
                                          run_in_thread,
                                          validate_exposition)
    from repro_torch.solver import SolverSpec

    spec = SolverSpec(backend="kernel")
    tracer = Tracer(enabled=True, capacity=1 << 18)
    quotas = QuotaManager(per_tenant={"capped": (1.0, 8.0)})
    reqs = [rpc_problems(i) for i in range(RPC_REQUESTS)]
    bodies = [json.dumps({"problems": [
        {"A": A.tolist(), "b": b.tolist(), "c": c.tolist()}
        for A, b, c in probs]}) for probs in reqs]
    frontend = make_frontend(spec, devices=devices, max_batch=1024,
                             target_p99_s=RPC_TARGET_P99_S, quotas=quotas,
                             tracer=tracer)
    port, stop = run_in_thread(frontend)
    answers: list = [None] * RPC_REQUESTS
    lat = np.zeros(RPC_REQUESTS)
    errors: list = []

    def post(conn, body, headers=None):
        conn.request("POST", "/v1/solve", body, headers or {})
        r = conn.getresponse()
        return r.status, r.read()

    def client(t: int):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            for i in range(t, RPC_REQUESTS, RPC_CLIENTS):
                t0 = time.perf_counter()
                status, body = post(conn, bodies[i])
                lat[i] = time.perf_counter() - t0
                answers[i] = (status, body)
            conn.close()
        except Exception as e:   # surfaced below as a failed check
            errors.append(repr(e))

    try:
        rgb_cuda.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(RPC_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = rgb_cuda.launches
        check(not errors and all(not th.is_alive() for th in threads),
              f"RPC clients failed: {errors}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        one = json.dumps({"A": reqs[0][0][0].tolist(),
                          "b": reqs[0][0][1].tolist(),
                          "c": reqs[0][0][2].tolist()})
        deadline_status, deadline_body = post(conn, one,
                                              {"X-Deadline-Ms": "1"})
        capped = bodies[next(i for i, p in enumerate(reqs) if len(p) == 8)]
        quota_first, _ = post(conn, capped, {"X-Tenant": "capped"})
        quota_status, quota_body = post(conn, capped,
                                        {"X-Tenant": "capped"})
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        metrics_text = r.read().decode()
        metrics_status = r.status
        conn.close()
    finally:
        stop()
    sched = frontend.scheduler
    exec_specs = sorted(
        ({"bucket_m": es.bucket_m, "b_pad": es.b_pad,
          "dtype": es.solver.dtype, "tile": es.solver.tile,
          "chunk": es.solver.chunk, "flushes": n}
         for es, n in sched.cache.uses().items()),
        key=lambda d: (-d["flushes"], -d["b_pad"], -d["bucket_m"]))
    plans = frontend.slo.plans()

    statuses = [a[0] for a in answers]
    check(statuses.count(200) == RPC_REQUESTS,
          f"not every request answered 200: "
          f"{sorted(set(statuses))}")
    check(launches > 0, "the RPC flushes launched no kernel")
    check(deadline_status == 504
          and json.loads(deadline_body)["error"]["code"]
          == "deadline_exceeded",
          f"a 1 ms deadline got {deadline_status} {deadline_body!r}")
    check(quota_first == 200 and quota_status == 429
          and json.loads(quota_body)["error"]["code"] == "quota_exhausted",
          f"a tenant over its quota got {quota_first}, {quota_status}")
    check(metrics_status == 200, f"/metrics answered {metrics_status}")
    validate_exposition(metrics_text)
    measured = sorted(bm for bm, p in plans.items()
                      if p.source == "measured")
    check(measured, f"no SLO plan came from a measured row: {plans}")
    # Every answer equals a direct solve of the same LP through the same
    # spec, in bits.
    solver = spec.build(device=devices[0])
    n_lps = 0
    for probs, (_, body) in zip(reqs, answers):
        got = json.loads(body)["results"]
        check(len(got) == len(probs), "an answer lost problems")
        for (A, b, c), g in zip(probs, got):
            d = solver.solve_one(A, b, c)
            x = np.asarray(g["x"], np.float32)
            check(np.array_equal(d.x.cpu().numpy(), x)
                  and bool(d.feasible) == g["feasible"],
                  "an RPC answer differs in bits from the direct solve")
            n_lps += 1
    spans = tracer.spans()
    chrome = to_chrome_trace(spans)
    validate_chrome_trace(chrome)
    chains = check_span_chains(spans)
    check(chains["problems"] == [],
          f"span chains broken: {chains['problems'][:5]}")
    check(tracer.stats()["ring_dropped"] == 0, "the span ring dropped")
    idle = device_idle(spans)
    lat_ok = np.sort(lat)
    out = {"phase": "rpc", "requests": RPC_REQUESTS, "lps": n_lps,
           "clients": RPC_CLIENTS, "target_p99_s": RPC_TARGET_P99_S,
           "wall_seconds": wall, "requests_per_s": RPC_REQUESTS / wall,
           "lps_per_s": n_lps / wall,
           "latency_p50_ms": float(np.percentile(lat_ok, 50) * 1e3),
           "latency_p99_ms": float(np.percentile(lat_ok, 99) * 1e3),
           "launches": launches, "flushes": sched.metrics.n_flushes,
           "deadline_status": deadline_status, "quota_status": quota_status,
           "slo_measured_buckets": measured,
           "slo_plans": {str(bm): {"max_batch": p.max_batch,
                                   "max_wait_s": p.max_wait_s,
                                   "est_flush_s": p.est_flush_s,
                                   "source": p.source}
                         for bm, p in sorted(plans.items())},
           "bit_identical_checked": n_lps,
           "spans": len(spans), "span_chains_complete": chains["complete"],
           "chrome_events": len(chrome["traceEvents"]),
           "device_idle_frac": idle["idle_frac"],
           "device_idle_window_s": idle["window_s"],
           "device_idle_is": "lower bound (host-observed solve windows)",
           "exec_specs": exec_specs, "card": card}
    emit(out)
    return out


TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS, RESUME_STEPS, CKPT_EVERY = 20, 22, 10
TRAIN_LOG = re.compile(r"\[train\] step\s+(\d+) loss\s+(\S+) dt\s+(\S+)ms "
                       r"lp_s1 (\S+)")
# Card against CPU: the tolerance of tests/test_torch_train.py's
# three-step parity test (float32, TF32 off).
PARITY_STEPS = 3
PARITY_LOSS_RTOL = PARITY_S1_TOL = 1e-4
PARITY_LEAF_ATOL = 2e-6


def run_trainer(argv) -> tuple:
    """``repro_torch.launch.train.main(argv)`` on the card, its log lines
    captured (this script's stdout carries JSON only): ``(final loss,
    log text)``."""
    import contextlib
    import io

    from repro_torch.launch.train import main as train_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = train_main(argv)
    return loss, buf.getvalue()


def drive_train(ckpt_dir: str) -> dict:
    """The training entry point at full width: 20 steps checkpointed at
    step 10 (and at the end), then a second run to step 22 resumed from
    the directory.  Returns what the logs and counters say."""
    from repro_torch.kernels.batch_lp import rgb_cuda
    common = ["--arch", TRAIN_ARCH, "--lp-clip", "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--log-every", "1",
              "--ckpt-every", str(CKPT_EVERY), "--ckpt-dir", ckpt_dir]
    torch.cuda.reset_peak_memory_stats()
    rgb_cuda.launches = 0
    t0 = time.perf_counter()
    _, log1 = run_trainer(common + ["--steps", str(TRAIN_STEPS)])
    run1_s = time.perf_counter() - t0
    launches1 = rgb_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    _, log2 = run_trainer(common + ["--steps", str(RESUME_STEPS)])
    run2_s = time.perf_counter() - t0
    launches2 = rgb_cuda.launches - launches1
    rows = [(int(a), float(b), float(c), float(d))
            for a, b, c, d in TRAIN_LOG.findall(log1 + log2)]
    steps = [r[0] for r in rows]
    check(steps == list(range(RESUME_STEPS)),
          f"the trainer logged steps {steps}, not 0..{RESUME_STEPS - 1}")
    check(f"[train] resumed from step {TRAIN_STEPS}" in log2,
          f"the second run did not resume from step {TRAIN_STEPS}: {log2!r}")
    losses = [r[1] for r in rows]
    s1s = [r[3] for r in rows]
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0],
          f"the last loss {losses[-1]} is not below the first {losses[0]}")
    check(all(0.0 <= x <= 1.0 for x in s1s), f"lp_s1 outside [0, 1]: {s1s}")
    check(launches1 == TRAIN_STEPS and
          launches2 == RESUME_STEPS - TRAIN_STEPS,
          f"rgb_cuda launched {launches1} + {launches2} times in "
          f"{TRAIN_STEPS} + {RESUME_STEPS - TRAIN_STEPS} steps")
    dts = sorted(r[2] for r in rows[:TRAIN_STEPS])
    median_ms = dts[len(dts) // 2]
    return {"steps": RESUME_STEPS, "losses": losses, "lp_s1": s1s,
            "step_ms": [r[2] for r in rows], "median_step_ms": median_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
            "max_memory_allocated": peak, "run_seconds": [run1_s, run2_s],
            "launches": launches1 + launches2}


def train_matmul_flops(cfg, lay, B: int, S: int) -> float:
    """The matrix-multiply FLOPs of one training step of the dense LM at
    ``B x S`` tokens: projections, MLP and head forward (2 per MAC),
    backward (twice the forward), the blocks' forward again under remat,
    and the attention score and value products."""
    d, hd, f, Lr = cfg.d_model, cfg.hd, cfg.d_ff, cfg.n_layers
    v_pad = -(-cfg.vocab // 256) * 256
    block = d * (lay.h_pad + 2 * lay.kv_total) * hd + lay.h_pad * hd * d \
        + 3 * d * f                                  # MACs per token
    attn = 2 * S * lay.h_pad * hd                    # MACs per token
    n = B * S
    fwd_blocks = 2 * n * Lr * (block + attn)
    fwd_head = 2 * n * v_pad * d
    remat = 2 if cfg.remat else 1
    return 3 * (fwd_blocks + fwd_head) + (remat - 1) * fwd_blocks


def split_step(device) -> tuple:
    """Where a full-width step's time goes: each stage of the step timed
    apart (CUDA events) on the same state, the GEMMs' share of the
    forward+backward from a profiler trace; and the LP batch this step's
    ``lp_constrain_updates`` solved."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import TokenSource, for_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import layers as L
    from repro_torch.optim import (AdamW, apply_updates,
                                   lp_constrain_updates, lp_problems,
                                   sync_duplicated_grads)
    from repro_torch.tree import copy_into_, tree_leaves, tree_unflatten

    cfg = ARCHS[TRAIN_ARCH]
    opt = AdamW()
    prog = make_train_step(cfg, make_host_mesh(1, 1), opt,
                           global_batch=TRAIN_BATCH, lp_clip=True)
    model = prog.model
    params = model.init(torch.Generator(device=device).manual_seed(1))
    state = opt.init(params)
    src = TokenSource(for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=1))
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in src.global_batch(0).items()}
    leaves = tree_leaves(params)
    # one real step first, so the momenta are not zero
    params, state, _, _ = prog.step(params, state, batch, {})

    def fwd_bwd():
        with torch.enable_grad():
            loss, _ = model.loss(params, batch)
            return tree_unflatten(params, torch.autograd.grad(loss, leaves))

    grads = fwd_bwd()
    dup = model.kv_duplication()
    grads = sync_duplicated_grads(grads, dup, cfg.hd)
    updates, new_state = opt.update(grads, state, params)
    A, b, c = lp_problems(updates, grads, new_state.m, params)
    lp_batch = (A.cpu().numpy(), b.cpu().numpy(), c.cpu().numpy())
    h = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), device=device,
                    dtype=torch.bfloat16, requires_grad=True)

    def head():
        with torch.enable_grad():
            loss, _ = L.lm_head_loss(h, params["lm_head"], batch["labels"],
                                     model.mi, vocab_real=cfg.vocab)
            torch.autograd.grad(loss, [h, params["lm_head"]])

    def ms(fn, n=5):
        return time_launches(fn, n_warm=1, n=n)

    out = {
        "fwd_bwd_ms": ms(fwd_bwd, 3),
        "lm_head_loss_fwd_bwd_ms": ms(head),
        "sync_duplicated_grads_ms": ms(
            lambda: sync_duplicated_grads(grads, dup, cfg.hd)),
        "adamw_ms": ms(lambda: opt.update(grads, state, params)),
        "lp_clip_ms": ms(lambda: lp_constrain_updates(
            updates, grads, new_state.m, params)),
        # stage 5 as the step runs it (each call moves the weights on)
        "apply_ms": ms(lambda: copy_into_(
            params, apply_updates(params, updates))),
        "step_ms": ms(lambda: prog.step(params, state, batch, {}), 3),
    }
    flops = train_matmul_flops(cfg, model.lay, TRAIN_BATCH, TRAIN_SEQ)
    out["matmul_flops"] = flops
    out["matmul_bound_ms"] = flops / PEAK_BF16_FLOPS * 1e3
    out["step_kernels"] = device_kernels(
        lambda: prog.step(params, state, batch, {}))
    return out, lp_batch


def card_vs_cpu(device) -> dict:
    """The smoke config in float32, three steps with the LP clip on the
    card and on the CPU from the same parameters (carried across as
    numpy), TF32 off: loss, lp_s1 and every leaf agree."""
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.data.pipeline import TokenSource, for_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(smoke_config(ARCHS[TRAIN_ARCH]),
                              dtype="float32")
    init = None
    runs = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (torch.device("cpu"), device):
            opt = AdamW()
            prog = make_train_step(cfg, make_host_mesh(1, 1, device=dev),
                                   opt, global_batch=2, lp_clip=True)
            if init is None:
                init = params_to_numpy(prog.model.init(
                    torch.Generator().manual_seed(3)))
            params = params_from_numpy(prog.model, init)
            state = opt.init(params)
            src = TokenSource(for_model(cfg, 32, 2, seed=3))
            out = []
            for st in range(PARITY_STEPS):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in src.global_batch(st).items()}
                params, state, m, _ = prog.step(params, state, batch, {})
                out.append((float(m["loss"]), float(m["lp_s1"])))
            runs[dev.type] = (out, params_to_numpy(params))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    from repro_torch.tree import flatten_with_paths
    (cpu, pc), (gpu, pg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(cpu, gpu))
    s1_err = max(abs(a[1] - b[1]) for a, b in zip(cpu, gpu))
    fc, fg = flatten_with_paths(pc), flatten_with_paths(pg)
    leaf_err = max(float(np.abs(fc[k] - fg[k]).max()) for k in fc)
    check(loss_rel <= PARITY_LOSS_RTOL,
          f"card and CPU losses differ by {loss_rel} relative: {cpu} {gpu}")
    check(s1_err <= PARITY_S1_TOL, f"lp_s1 differs by {s1_err}")
    check(leaf_err <= PARITY_LEAF_ATOL,
          f"a parameter leaf differs by {leaf_err} after {PARITY_STEPS} "
          "steps")
    return {"steps": PARITY_STEPS, "cpu": cpu, "card": gpu,
            "max_loss_rel": loss_rel, "max_lp_s1_err": s1_err,
            "max_leaf_abs_err": leaf_err, "tf32": False}


def phase_train(device, card: str) -> dict:
    """The training entry point at full width with the LP clip, read
    right after its run; then the step's time split and card-vs-CPU
    parity.  Returns the phase line and the step's LP batch."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        drive = drive_train(d)
    split, lp_batch = split_step(device)
    parity = card_vs_cpu(device)
    out = {"phase": "train", "arch": TRAIN_ARCH, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", **drive,
           "split": split,
           "lp_clip_share": split["lp_clip_ms"] / drive["median_step_ms"],
           "card_vs_cpu": parity,
           "seconds": time.perf_counter() - t0, "card": card}
    emit(out)
    return out, lp_batch


def phase_train_kernel(device, card: str, lp_batch, launches: int) -> dict:
    """``rgb_cuda`` on the LP batch of one real training step, padded as
    the solver pads it (m to a lane, the batch to the tile with neutral
    problems), held against ``rgb_plain`` bit for bit and timed."""
    from repro_torch.kernels.batch_lp import LANE
    from repro_torch.optim.lp_clip import M_BOX
    from repro_torch.solver import SolverSpec
    A, b, c = lp_batch
    nb, m = b.shape
    tile = SolverSpec(backend="kernel", M=M_BOX).resolve_for_shape(
        m, nb, platform="cuda").tile
    B = -(-nb // tile) * tile
    pad = B - nb
    A = np.concatenate([A, np.zeros((pad, m, 2), A.dtype)])
    b = np.concatenate([b, np.ones((pad, m), b.dtype)])
    c = np.concatenate([c, np.tile(np.array([[1.0, 0.0]], c.dtype),
                                   (pad, 1))])
    mv = np.concatenate([np.full(nb, m, np.int32), np.zeros(pad, np.int32)])
    arrays = (A, b, c, mv)
    entry = hold_and_time(device, card, (arrays, arrays), B, LANE,
                          "float32", tile, 0, "train", {}, M=M_BOX)
    check(entry["bits_equal"],
          f"rgb_cuda differs from rgb_plain in bits on the step's LP "
          f"batch: {entry}")
    entry["launches"] = launches
    entry["problems"] = nb
    return entry


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
        phase_pdhg(device, card)
        phase_tune(device, card)
        rpc = phase_rpc(default_devices()[:1], card)
        train, lp_batch = phase_train(device, card)
        # Launches made from here on compare and time; the counts of the
        # main path have been read.
        entries.append(phase_train_kernel(device, card, lp_batch,
                                          train["launches"]))
        entries += phase_serve_kernels(device, card, serve["exec_specs"])
        entries += phase_serve_kernels(device, card, rpc["exec_specs"],
                                       path="rpc")
        for e in entries:
            check(e["launches"] > 0,
                  f"the main path never launched {e['name']} "
                  f"{e['dtype']} chunk={e['chunk']} {e['shape']}")
        check(serve["launches"] > 0, "the serving path launched no kernel")
        check(rpc["launches"] > 0, "the RPC path launched no kernel")
        check(train["launches"] == RESUME_STEPS,
              "the training path did not launch the kernel once a step")
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
