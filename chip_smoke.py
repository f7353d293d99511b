#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It drives the port's main paths (``repro_torch`` only) on the card at sizes
users would call real — the paper's figure-3 batch of 16384 problems at the
README's example width of 256 constraints, Qwen2-0.5B and Mamba2-1.3B
trained at full width with the LP solver inside their optimizer, six
language models served at full width, the solve service's own benchmark in
all its modes and the paper's crowd simulation at 16,384 agents — and,
in its ``dist`` phase, trains and serves Qwen2-0.5B at full width on meshes
of ranks over ``torch.distributed``, and in its ``dryrun`` phase counts
every architecture's step on the 256- and 512-card production meshes, and
in its ``paper`` phase runs the paper's figure harness —
and prints one JSON object per line:

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
   counts of phases 4, 5, 8, 8b-8d, 9, 9b, 11, 12 and 13 (phase 10
   launches none).
4. ``solver``  ``SolverSpec(backend="auto").build().solve(...)`` on AoS and
   pre-packed batches: resolved to what the active tuning table names
   (the kernel on a miss), launch count advanced,
   packed-vs-AoS bit-identical, agreement with the plain RGB solver.
4b. ``front``  the solver front end's two passes
   (``prep_cuda``, ``finish_cuda``, around every kernel-backend solve on
   the card) at the main paths' shapes (the figure-3 batch in float32 and
   float64, three serving flushes, the crowd's step, the LP clip's batch)
   held against the eager chain they replace (their plain version) bit for
   bit; each timed on the device and as an eager call beside the chain,
   ``prep`` beside its bytes bound.  Every phase that counts ``rgb_cuda``'s
   launches over a run (``Launches``) counts ``prep``'s and ``finish``'s
   over the same run, prints them beside (``front_launches``) and checks
   one of each with every kernel launch of an unshuffled solve.  Then the
   fused solve from its launch plans at the figure-3 batch (float32 and
   float64), the figure-4 batch, the crowd's step and a serving flush:
   its host time a call against the operator's path, in turns in one
   process, both equal to the eager chain in bits.
4c. ``crowd_grid``  the crowd's neighbour kernel (``neighbours_cuda``,
   ``csrc/crowd_grid.cu``) at 16,384 agents on the crowd cell's lead
   state: equal in bits to the plain grid (``grid.neighbours_plain``),
   timed by CUDA-graph replays beside its bytes bound and the plain
   version's time, with its ``ptxas`` report.
5. ``serve``   ``BatchScheduler`` over every visible card (``n_devices``)
   answering 8192 single-LP requests of mixed
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
8b. ``bench``  ``repro_torch.serve_lp.bench`` with ``--method kernel``, one
   line a mode, each with its own assertions and ``rgb_cuda``'s count set
   to 0 just before it: the default traffic (2000 requests at 5000 LP/s,
   m 8..1024, ``max_batch`` 64, ``--check 8``), ``--open-loop`` (its
   in-flight gauges printed, not asserted: see ``BENCH_MODES``),
   ``--open-loop --assert-fused``, ``--open-loop
   --trace-out --assert-trace`` (its flush count beside the untraced
   run's), ``--smoke --rpc --rpc-target-p99-ms 50 --assert-rpc`` (a
   contract check at the smoke preset: its rates are no measurement) and
   a traced open loop of m-1024 flushes of 1024; LP/s, p50/p99, in-flight
   depth, fused flushes, the device-idle lower bound; ``--sharding pmap``
   must raise ``ValueError``.  The geometries the
   modes launched join the ``kernels`` line (``path="bench"``).
8c. ``crowd``  ``examples/crowd_sim_torch.py`` at 16,384 agents (one LP of
   8 constraints each a step): 60 direct steps (one ``rgb_cuda`` launch
   each), then 10 served steps from the same start through the
   scheduler; the step lines of both equal, positions after 10 steps
   within 1e-5, ms a step by CUDA events, the worst clearance.  The first
   step's LP batch joins the ``kernels`` line (``path="crowd"``).
8d. ``quickstart`` ``examples/quickstart_torch.py`` at B=4096, m=128: the
   kernel solves the whole batch, the plain naive and rgb backends its first
   512 problems (``--plain-slice``), all agree there to 5e-4, pre-packed
   equals AoS in bits; its kernel shape joins the ``kernels`` line.
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
9b. ``train`` again for Mamba2-1.3B (the SSM family, 1.445 G parameters)
   at full width in bf16 with ``--lp-clip``, batch 8 x 512, 6 steps
   through the same entry point: every loss finite, ``lp_s1`` in [0, 1],
   one ``rgb_cuda`` launch a step; the median step, peak memory and one
   step's kernels; its 17-problem LP batch held against ``rgb_plain``
   bit for bit (``path="train-mamba2"``), and card against CPU over three
   float32 smoke steps to the bounds of 9; the roofline terms of 9.
10. ``lm_serve`` one line per architecture served at full width
   (qwen2-0.5b, olmoe-1b-7b, paligemma-3b, whisper-base, mamba2-1.3b,
   zamba2-2.7b):
   (a) ``repro_torch.launch.serve.main`` in bf16, 16 requests in batches
   of 8, prompts of 512 tokens (paligemma-3b: 256 after its 256 patches),
   32 tokens generated each: every token in the vocabulary, the cache's
   bytes as its shape says; prefill ms and the decode steps' ms (CUDA
   events), tokens/s (host clock), peak memory, the decode step's bytes
   bound beside the reference's ``fused_hbm_estimate``, the KV cache's bytes
   beside what the real KV heads would need (the SSM families: the
   float32 state and the conv windows, which do not grow with the
   sequence), and one decode step's kernels from a profiler trace; (b)
   the same model in float32 (TF32 off): 64 tokens prefilled, 4
   teacher-forced decode steps, each step's logits within rtol = atol =
   2e-4 of a prefill of the longer sequence (one SSD chunk each);
   (c) the smoke config in float32, one prefill and 3 decode steps on the
   card and on the CPU from the same weights: logits within 1e-5 of the
   largest |logit|.  No LP is solved on this path: ``rgb_cuda`` is
   launched 0 times, and each line says so.
11. ``dist``   each rank a process (this file with ``--dist-rank``):
   (a) NCCL, one rank a card (``device_count`` ranks): 3 LP-clipped
   full-width Qwen2-0.5B bf16 steps (8 x 512) on the ``(ranks, 1)`` mesh; at
   one rank equal in bits to the ``HostMesh`` steps of the same process;
   (b) four gloo ranks sharing card 0 (NCCL refuses two ranks on one card),
   every payload through pinned host memory: 3 float32 steps (4 x 256) on a
   2x2 mesh, tensor + data parallel and again with ``fsdp=True``: loss and
   ``lp_s1`` within 1e-4 of the one-card steps, step 1's gradients within
   1e-4 of each leaf's largest, each leaf after step 1 within 1e-4 of its
   largest value where its one-card gradient is above 1e-4 of the leaf's
   largest (AdamW's first step moves a parameter by about ``lr`` whatever
   its gradient's size, so a rounding-level gradient summed in another
   order can move it by up to ``2 lr``: every element is held to that),
   every rank's LP batch equal in bits and ``rgb_cuda`` launched once a
   step a rank; prefill + 4 decode steps on (1, 4) within 1e-5 of the
   largest one-card logit; (c) ``make_lp_step`` at ``B=16384, m=256`` on
   the 2x2 mesh equal in bits to one rank.  Each line: world, mesh,
   backend and transport, step ms (CUDA events; ``ranks_share_one_card``
   where they do), peak memory a rank, collectives a step by op.  Rank
   0's first LP batch joins the ``kernels`` line (``path="dist"``).
12. ``dryrun`` ``repro_torch.launch.dryrun``: (a) ``--all`` (one process a
   core) — every arch x shape on the 16x16 and 2x16x16 meshes, run on
   ``meta`` as rank 0 of a ``RecordingMesh`` — then ``--lp`` on both meshes
   and qwen2-0.5b ``train_4k`` with the LP clip: 80 cells, 16 skipped, 0
   FAIL, each cell's line with its per-device argument and peak bytes
   against the card's 80 GB, its three terms, bottleneck,
   ``roofline_fraction`` and collectives, the ``lp-clip`` cell one
   ``repro_torch::rgb`` call; (b) at world 1, the dry run of phase 9's
   LP-clipped step and of one phase-10 decode step (batch 8, cache 544)
   against the same steps on the card: the predicted peak within 10% of
   ``max_memory_allocated``, the FLOPs equal to ``count_call``'s, one
   ``rgb`` call recorded and one ``rgb_cuda`` launch, whose LP batch
   joins the ``kernels`` line (``path="dryrun"``); (c) phase 11's gloo
   steps (2x2 TP+DP, 2x2 FSDP, (1, 4) serving) recorded on a
   ``RecordingMesh``: every op's calls and bytes equal to the ranks'.
13. ``paper`` the paper's figure harness, ``benchmarks/pt_*.py``: every
   figure of ``pt_run --full --plain-quick`` (fig3-fig7, solver_sweep and
   the serving profiles; the plain ``rgb`` rows at the quick grid's shapes,
   one timed call each), the kernel on each fig4 batch and fig5's copies
   against the kernel's solve of each fig5 batch (those figures time naive
   and plain rgb only), ``pt_pack_layout`` / ``pt_pdhg_crossover`` /
   ``pt_tune_cli --smoke`` with their asserts, ``pt_hillclimb`` (three
   processes; ``vma-transpose`` recorded ``no_counterpart``) and
   ``pt_roofline_report`` on the records phase 12 wrote: one line per part
   with its rows, every kernel row's batch held against the naive backend
   (``feasible`` equal, ``x`` within 1e-4) and where HiGHS ran against its
   objective (2e-4 of max(1, |obj|)), one summary line per fig3 / fig4 shape
   (µs per LP of kernel, naive, plain rgb and HiGHS on the named host CPU,
   and the kernel's ratio to each), one per fig5 shape (the copies' share
   beside the kernel's solve) and one per pdhg_crossover ``m``.  Every
   geometry it launched ``rgb_cuda`` at joins the ``kernels`` line
   (``path="paper"``).

Every input is made from a fixed numpy seed.  Any failed check exits
non-zero.  The last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}``.
Without a CUDA device — or without the rest of the checkout beside this
file — it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
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
# The card's published peaks (``repro_torch.roofline.peaks_for`` of its
# name), set in main(): a roofline share is stated against these whatever
# the power limit.
PEAKS = None
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/batch_lp.cu"
KERNEL_REPLACES = "src/repro/kernels/batch_lp.py:63"

SERVE_REQUESTS = 8192


class SmokeFailure(AssertionError):
    """A check of the smoke run did not hold."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def front_ok(n: dict) -> bool:
    """Whether launch counts ``n`` (``Launches.counts``) show one ``prep``
    and one ``finish`` with each kernel launch that an unshuffled solve
    made: every such solve took the fused front end."""
    return (n["prep_cuda"] == n["finish_cuda"]
            == n["rgb_cuda"] - n["shuffled"])


class Launches:
    """The kernel's and the solver front end's launches over one run.

    ``with Launches() as n:`` sets ``rgb_cuda``'s, ``prep_cuda``'s and
    ``finish_cuda``'s launch counts to 0 and reads them on exit into
    ``n.rgb``, ``n.prep`` and ``n.finish``.  ``n.shuffled`` counts the
    solves of the run that would have taken the fused front end but for a
    shuffled spec (``solver._takes_fused`` is watched meanwhile): those
    keep the eager chain, so their kernel launches come without ``prep``
    and ``finish``."""

    def __enter__(self):
        import threading

        from repro_torch.kernels.batch_lp import (finish_cuda, prep_cuda,
                                                  rgb_cuda)
        from repro_torch.solver import solver as S
        real = self._real = S._takes_fused
        lock = threading.Lock()
        self.shuffled = 0

        def watch(spec, device, generator, batch, m):
            if generator is not None and real(spec, device, None, batch, m):
                with lock:
                    self.shuffled += 1
            return real(spec, device, generator, batch, m)

        S._takes_fused = watch
        rgb_cuda.launches = prep_cuda.launches = finish_cuda.launches = 0
        return self

    def __exit__(self, *exc) -> bool:
        from repro_torch.kernels.batch_lp import (finish_cuda, prep_cuda,
                                                  rgb_cuda)
        from repro_torch.solver import solver as S
        S._takes_fused = self._real
        self.rgb, self.prep = rgb_cuda.launches, prep_cuda.launches
        self.finish = finish_cuda.launches
        return False

    def counts(self) -> dict:
        return {"rgb_cuda": self.rgb, "prep_cuda": self.prep,
                "finish_cuda": self.finish, "shuffled": self.shuffled}

    def check_front(self, what: str) -> None:
        check(front_ok(self.counts()),
              f"{what}: launches {self.counts()}: an unshuffled solve took "
              "the eager front end, or prep and finish did not launch once "
              "each with the kernel")


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


def bound_ms(B, dtype, mv_sum, resolve_work):
    """Least time the card could take: each input read once and each
    output written once over the memory rate, against the operations these
    inputs need (~4 per constraint tested, ~12 per prior constraint
    scanned by a re-solve actually taken) over the peak rate.  The bytes
    are those of the constraints the batch holds (``mv_sum`` of them, three
    values each), not of its padding, plus each problem's ``c``,
    ``m_valid``, ``x`` and flag."""
    item = np.dtype(dtype).itemsize
    nbytes = 3 * mv_sum * item + B * (2 * item + 4 + 2 * item + 4)
    ops = 4 * mv_sum + 12 * resolve_work
    t_bytes = nbytes / PEAKS.hbm_bytes_s * 1e3
    t_ops = ops / {"float32": PEAKS.f32_flops,
                   "float64": PEAKS.f64_flops}[dtype] * 1e3
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
        B, dtype, int(mv.sum()), stats.get("resolve_work", 0))
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
            with Launches() as n:
                sol_a = solver.solve(batch)
                sol_p = solver.solve(packed)
                torch.cuda.synchronize()
            launches = n.rgb
            check(launches == 2,
                  f"two kernel solves made {launches} kernel launches")
            n.check_front("solver")
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


def kernels_ms(fn, n: int = 5) -> float:
    """Device milliseconds of ``fn``'s kernels a call (the profiler's sum
    over ``n`` calls after a warm-up): the device's work, without the
    gaps the host leaves between launches."""
    fn()
    return device_kernels(lambda: [fn() for _ in range(n)])["device_ms"] / n


# The solver front end's passes at the main paths' shapes: (path, layout,
# B, m, dtype).  The solver's figure-3 batch, the serving flushes (packed,
# already padded to their bucket), the crowd's step (16,384 agents, 8
# constraints each) and the LP clip's batch (15 leaves, 6 constraints).
FRONT_SHAPES = (("solver", "aos", 16384, 256, "float32"),
                ("solver", "aos", 16384, 256, "float64"),
                ("serve", "packed", 16, 128, "float32"),
                ("serve", "packed", 64, 1024, "float32"),
                ("serve", "packed", 1024, 1024, "float32"),
                ("crowd", "aos", 16384, 8, "float32"),
                ("train", "aos", 15, 6, "float32"))


def front_entry(device, card: str, path: str, layout: str, B: int, m: int,
                dtype: str, M: float = 1.0e4) -> dict:
    """``prep_cuda`` and ``finish_cuda`` at one shape against the eager
    chain they replace (the plain version), bit for bit, on a mixed batch
    of non-unit normals; each timed on the device (a CUDA graph of 20
    calls; the chain, which copies a host constant, by the profiler's sum
    of its kernels) and as an eager call, ``prep`` beside its bytes bound
    (the input read once, ``L``, ``c`` and ``m_valid`` written once)."""
    from repro_torch.core import (batch_from_numpy, normalize_batch,
                                  normalize_packed, pack, pad_packed,
                                  pad_packed_batch_dim)
    from repro_torch.kernels.batch_lp import (LANE, finish_cuda, prep_cuda,
                                              rgb_cuda)
    from repro_torch.solver import SolverSpec
    rng = np.random.default_rng([SEED, 14, B, m])
    A, b, c, mv = mixed_arrays(rng, B, m)
    A = A * rng.uniform(0.5, 2.0, (B, m, 1))   # not unit: normalize works
    b = b * np.linalg.norm(A, axis=-1)
    npdt = np.dtype(dtype)
    lp = batch_from_numpy(A.astype(npdt), b.astype(npdt), c.astype(npdt),
                          mv, device=device)
    src = lp.pack() if layout == "packed" else lp
    tile = SolverSpec(backend="kernel", dtype=dtype).resolve_for_shape(
        m, B, platform="cuda").tile
    m_pad, b_pad = -(-m // LANE) * LANE, -(-B // tile) * tile
    args = (src.L, None) if layout == "packed" else (src.A, src.b)

    def prep():
        return prep_cuda(*args, src.c, src.m_valid, m_pad=m_pad,
                         b_pad=b_pad)

    def eager():
        pb = normalize_packed(src) if layout == "packed" else pack(
            normalize_batch(src))
        pb = pad_packed_batch_dim(pad_packed(pb, m_pad), b_pad)
        return (pb.L.contiguous(), pb.c.contiguous(),
                pb.m_valid.to(torch.int32).contiguous())

    got, want = prep(), eager()
    prep_equal = all(g.shape == w.shape and torch.equal(bits(g), bits(w))
                     for g, w in zip(got, want))
    x, f = rgb_cuda(*got, M=M, tile=tile)
    cc = got[1]

    def finish():
        return finish_cuda(x, f, cc, B)

    def objective():
        return (cc[:B] * x[:B]).sum(-1), f[:B, 0].to(torch.bool)

    (obj, ok), (obj_e, ok_e) = finish(), objective()
    finish_equal = torch.equal(bits(obj), bits(obj_e)) and torch.equal(
        ok, ok_e)
    item = npdt.itemsize
    rows = 4 if layout == "packed" else 3
    nbytes = (B * (rows * m * item + 2 * item + 4)
              + b_pad * (4 * m_pad * item + 2 * item + 4))
    entry = {
        "name": "prep_cuda", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "the eager normalise, pack and pad", "path": path,
        "layout": layout, "dtype": dtype, "shape": [B, m],
        "out_shape": [b_pad, 4, m_pad], "prep_bits_equal": prep_equal,
        "finish_bits_equal": finish_equal,
        "ms": time_device(prep), "plain_ms": kernels_ms(eager),
        "call_ms": time_launches(prep), "plain_call_ms": time_launches(eager),
        "bound_ms": nbytes / PEAKS.hbm_bytes_s * 1e3, "bound_by": "bytes",
        "bytes": nbytes, "finish_ms": time_device(finish),
        "finish_plain_ms": kernels_ms(objective),
        "finish_call_ms": time_launches(finish),
        "finish_plain_call_ms": time_launches(objective), "card": card}
    check(prep_equal, f"prep_cuda differs from the eager chain: {entry}")
    check(finish_equal, f"finish_cuda differs from the eager objective: "
          f"{entry}")
    return entry


# The fused solve's shapes on the main paths, for its launch plans: (path,
# layout, B, m, dtype).  The figure-3 batch in float32 and float64, the
# figure-4 batch, the crowd's step and a serving flush.
PLAN_SHAPES = (("solver", "aos", 16384, 256, "float32"),
               ("solver", "aos", 16384, 256, "float64"),
               ("solver", "aos", 131072, 64, "float32"),
               ("crowd", "aos", 16384, 8, "float32"),
               ("serve", "packed", 64, 1024, "float32"))
PLAN_CALLS = 1000


def plan_entry(device, card: str, path: str, layout: str, B: int, m: int,
               dtype: str, M: float = 1.0e4) -> dict:
    """A fused solve at one shape from its launch plan (``planned``)
    against the same solve through the operator ``repro_torch::rgb``
    (``op``: the path a dispatch mode takes), in turns in this process
    (op, planned, planned, op), ``PLAN_CALLS`` calls a turn: each
    call's host time from entering ``solve_with_spec`` to its return,
    the device synchronised after it, outside the time.  Both held bit for
    bit to the eager chain."""
    from repro_torch.core import batch_from_numpy
    from repro_torch.solver import SolverSpec, solve_with_spec
    from repro_torch.solver import solver as S
    rng = np.random.default_rng([SEED, 32, B, m])
    A, b, c, mv = mixed_arrays(rng, B, m)
    npdt = np.dtype(dtype)
    lp = batch_from_numpy(A.astype(npdt), b.astype(npdt), c.astype(npdt),
                          mv, device=device)
    batch = lp.pack() if layout == "packed" else lp
    spec = SolverSpec(backend="kernel", M=M, dtype=dtype)
    real = S.unwatched

    def op_route(tensors):
        return False

    def turn(planned: bool) -> list:
        S.unwatched = real if planned else op_route
        try:
            solve_with_spec(spec, batch)
            torch.cuda.synchronize()
            host = []
            for _ in range(PLAN_CALLS):
                t0 = time.perf_counter()
                solve_with_spec(spec, batch)
                host.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
            return host
        finally:
            S.unwatched = real

    def same(sol, ref) -> bool:
        return (torch.equal(bits(sol.x), bits(ref.x))
                and torch.equal(sol.feasible, ref.feasible)
                and torch.equal(bits(sol.objective), bits(ref.objective)))

    h0, m0 = S.solve_with_spec.plan_hits, S.solve_with_spec.plan_misses
    times = {"op": [], "planned": []}
    for name in ("op", "planned", "planned", "op"):
        times[name] += turn(name == "planned")
    planned = solve_with_spec(spec, batch)
    S.unwatched = op_route
    try:
        op = solve_with_spec(spec, batch)
    finally:
        S.unwatched = real
    real_fused = S._takes_fused
    S._takes_fused = lambda *a: False
    try:
        eager = solve_with_spec(spec, batch)
    finally:
        S._takes_fused = real_fused
    torch.cuda.synchronize()
    ms = {k: np.asarray(v) * 1e3 for k, v in times.items()}
    entry = {
        "name": "launch_plan", "path": path, "layout": layout,
        "dtype": dtype, "shape": [B, m], "calls_a_turn": PLAN_CALLS,
        "planned_bits_equal": same(planned, eager),
        "op_bits_equal": same(op, eager),
        "plan_hits": S.solve_with_spec.plan_hits - h0,
        "plan_misses": S.solve_with_spec.plan_misses - m0,
        **{f"{k}_host_ms_mean": float(v.mean()) for k, v in ms.items()},
        **{f"{k}_host_ms_median": float(np.median(v))
           for k, v in ms.items()},
        "card": card}
    check(entry["planned_bits_equal"] and entry["op_bits_equal"],
          f"a planned or operator solve differs from the eager chain: "
          f"{entry}")
    check(entry["plan_misses"] == 1,
          f"the launch plan was made more than once: {entry}")
    return entry


def phase_front(device, card: str) -> None:
    """The front end's passes at every main path's shape (run early: a
    long process's later profiler sessions can come back without device
    activity), then the fused solve from its launch plans against the
    operator's path."""
    entries = [front_entry(device, card, *shape) for shape in FRONT_SHAPES]
    plans = [plan_entry(device, card, *shape) for shape in PLAN_SHAPES]
    emit({"phase": "front", "entries": entries, "plans": plans,
          "card": card})


# The crowd cell's configuration and a seed for its spawn's perturbations.
CROWD_CONFIG = "lpbench/configs/crowd-16384.json"
CROWD_GRID_SEED = 3000000019
CROWD_GRID_SOURCE = "src/repro_torch/kernels/csrc/crowd_grid.cu"


def phase_crowd_grid(device, card: str) -> dict:
    """The crowd's neighbour kernel (``neighbours_cuda``) at 16,384 agents
    on the crowd cell's lead state (RVO2's Blocks after the configuration's
    lead steps, the groups in contact): its ``Neighbours`` equal to the plain
    version's in bits, the kernel and the whole query (the binning, then the
    kernel) timed by CUDA-graph replays beside the kernel's bytes bound (the
    positions, the order, the cells, the grid's starts and counts read once,
    ``idx``, ``valid`` and ``count`` written once) and the plain version's
    time."""
    from lpbench.loops.crowd_step import params
    from lpbench.problems import crowd_blocks
    from repro_torch.crowd import CrowdState, grid, step_direct
    from repro_torch.kernels import _build
    from repro_torch.kernels.crowd_grid import neighbours_cuda
    from repro_torch.solver import SolverSpec
    with open(os.path.join(ROOT, CROWD_CONFIG)) as f:
        cfg = json.load(f)
    prm = params(cfg)
    pos, goal, eps = crowd_blocks.spawn(cfg["problem"], CROWD_GRID_SEED)
    st = CrowdState.start(pos.to(device), goal.to(device), eps.to(device))
    solver = SolverSpec(backend=cfg["solver"]["backend"], M=float(cfg["M"]),
                        dtype=cfg["dtype"]).build(device=device)
    for _ in range(int(cfg["episode"]["lead_steps"])):
        st = step_direct(st, solver, prm)[0]
    p, dist, k = st.pos, prm.neighbor_dist, prm.max_neighbors
    kw = dict(dist=dist, k=k, world=prm.world, capacity=prm.capacity,
              fallback=prm.fallback)
    G, _, cell, order, counts, start = grid._bins(p, dist, prm.world)

    def kernel():
        return neighbours_cuda(p, cell, order, start, counts, grid=G,
                               dist=dist, k=k)

    def query():
        return grid.neighbours(p, **kw)

    def plain():
        return grid.neighbours_plain(p, **kw)

    got, want = query(), plain()
    fields = ("idx", "valid", "count", "over_cells")
    equal = {f: torch.equal(getattr(got, f), getattr(want, f))
             for f in fields}
    n = p.shape[0]
    nbytes = n * (8 + 8 + 8) + 2 * G * G * 8 + n * k * (8 + 1) + n * 8
    entry = {
        "phase": "crowd_grid", "name": "neighbours_cuda", "route": "cuda",
        "source": CROWD_GRID_SOURCE, "replaces": "the plain grid's gather, "
        "top-k and second pass (no TPU kernel)", "agents": n, "k": k,
        "grid": G, "state": f"lead ({cfg['episode']['lead_steps']} steps)",
        "bits_equal": equal, "plain_unplaced": int(want.unplaced),
        "over_cells": int(want.over_cells),
        "neighbours": int(got.count.sum()),
        "ms": time_device(kernel), "query_ms": time_device(query),
        "plain_ms": time_device(plain), "call_ms": time_launches(kernel),
        "bound_ms": nbytes / PEAKS.hbm_bytes_s * 1e3, "bound_by": "bytes",
        "bytes": nbytes, "nvcc_seconds": _build.build_seconds("crowd_grid"),
        "kernels": _build.kernel_resources("crowd_grid"), "card": card}
    emit(entry)
    check(int(want.unplaced) == 0 and all(equal.values()),
          f"neighbours_cuda differs from the plain grid: {entry}")
    return entry


GEOMETRY = ("bucket_m", "b_pad", "dtype", "tile", "chunk")


def exec_specs_of(sched) -> list:
    """What a scheduler's flushes really handed the kernel: on one card a
    flush is one launch of ``(b_pad, 4, bucket_m)`` at the tile and chunk
    pinned for it."""
    return sorted(
        ({"bucket_m": es.bucket_m, "b_pad": es.b_pad,
          "dtype": es.solver.dtype, "tile": es.solver.tile,
          "chunk": es.solver.chunk, "flushes": n}
         for es, n in sched.cache.uses().items()),
        key=lambda d: (-d["flushes"], -d["b_pad"], -d["bucket_m"]))


def phase_serve(devices, card: str, n_requests: int = SERVE_REQUESTS,
                max_batch: int = 1024) -> dict:
    """The serving entry point: a stream of single-LP requests."""
    from repro_torch.core import pack_call_count
    from repro_torch.serve_lp import BatchScheduler
    from repro_torch.serve_lp.bench import BenchConfig, make_request
    from repro_torch.solver import SolverSpec

    spec = SolverSpec(backend="kernel")
    # the serving benchmark's stream (m from 8..1024, 0.8/0.1/0.1
    # feasible, infeasible, degenerate) at this script's seed
    cfg = BenchConfig(seed=SEED)
    reqs = [make_request(cfg, i) for i in range(n_requests)]

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
    sched = BatchScheduler(spec, max_batch=max_batch, max_wait_s=0.005,
                           devices=devices)
    with Launches() as n, sched:
        results, t_submit, t_total = drive(sched, reqs)
    launches = n.rgb
    repacks = pack_call_count() - packs0
    snap = sched.metrics.snapshot(sched.cache.stats())
    pinned = sched.buffers.pinned
    exec_specs = exec_specs_of(sched)
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
    n.check_front("serve")
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
           "n_devices": len(devices),
           "pinned_buffers": pinned,
           "submit_seconds": t_submit, "total_seconds": t_total,
           "lps": n_requests / t_total,
           "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
           "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
           "flushes": snap["n_flushes"],
           "flush_reasons": snap["flush_reasons"],
           "fused_flushes": snap["fused_flushes"],
           "launches": launches, "launches_metrics": snap["launches_total"],
           "front_launches": n.counts(),
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
    ``serve`` phase draws one."""
    from repro_torch.serve_lp.bench import BenchConfig, make_request
    rng = np.random.default_rng(np.random.SeedSequence([SEED, i, 0x4C50]))
    n = int(rng.integers(1, 9))
    cfg = BenchConfig(seed=SEED)
    return [make_request(cfg, 1_000_000 + 8 * i + k)[:3] for k in range(n)]


def phase_rpc(devices, card: str) -> dict:
    """The HTTP front end over the kernel backend, as a tenant reaches
    it."""
    import http.client
    import threading

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
        with Launches() as n:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(RPC_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
        launches = n.rgb
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
    exec_specs = exec_specs_of(sched)
    plans = frontend.slo.plans()

    statuses = [a[0] for a in answers]
    check(statuses.count(200) == RPC_REQUESTS,
          f"not every request answered 200: "
          f"{sorted(set(statuses))}")
    check(launches > 0, "the RPC flushes launched no kernel")
    n.check_front("rpc")
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
           "launches": launches, "front_launches": n.counts(),
           "flushes": sched.metrics.n_flushes,
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


# The serving benchmark's modes, as the reference's CI runs them, through
# repro_torch.serve_lp.bench on the card with the kernel backend, each with
# the BenchConfig fields it overrides.  The open loop runs without
# --assert-overlap, which is not reachable on one H100: the host dispatches
# a flush of 64 every 5-24 ms and the card is done with each within about a
# millisecond of its dispatch, so two are never in flight.  Its line prints
# the gauges, and so does a traced open loop of m-1024 flushes of 1024 (the
# largest flushes the bench's ladder makes), to show whether a mix of long
# solves overlaps.
BENCH_MODES = (
    ("default", ["--check", "8"], {}),
    ("open-loop", ["--open-loop"], {}),
    ("fused", ["--open-loop", "--assert-fused"], {}),
    ("trace", ["--open-loop", "--trace-out", None, "--assert-trace"], {}),
    ("rpc", ["--smoke", "--rpc", "--rpc-target-p99-ms", "50",
             "--assert-rpc"], {}),
    ("open-loop-m1024", ["--open-loop", "--trace", "--requests", "16384",
                         "--max-batch", "1024", "--max-wait-ms", "1000",
                         "--tile", "8"], {"m_min": 1024}),
)
TRACED_MODES = ("trace", "open-loop-m1024")


def spread_ms(seconds: list) -> list:
    """``[min, median, max]`` of durations in seconds, as milliseconds."""
    xs = sorted(seconds)
    return [xs[0] * 1e3, xs[len(xs) // 2] * 1e3, xs[-1] * 1e3] if xs \
        else None


def phase_bench(devices, card: str) -> dict:
    """Each mode of the serving benchmark with ``--method kernel``, its
    own assertions on, the launch counts set to 0 just before it and
    read just after (one ``prep`` and one ``finish`` a kernel launch);
    then ``--sharding pmap``, which must raise the reference's
    ``ValueError``.  Returns the geometries the modes
    launched (flushes summed over modes)."""
    import tempfile

    from repro_torch.serve_lp import bench

    geoms: dict = {}
    flushes = {}
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        for mode, flags, over in BENCH_MODES:
            argv = ["--method", "kernel"] + [
                os.path.join(tmp, "trace.json") if f is None else f
                for f in flags]
            with Launches() as n:
                t0 = time.perf_counter()
                if over:
                    snap, sched = bench.run_traffic(dataclasses.replace(
                        bench.parse_config(argv), **over), devices=devices,
                        quiet=True)
                else:
                    snap, sched = bench.main(argv, devices=devices,
                                             quiet=True)
                seconds = time.perf_counter() - t0
            launches = n.rgb
            check(launches > 0, f"bench {mode}: rgb_cuda was not launched")
            n.check_front(f"bench {mode}")
            specs = exec_specs_of(sched)
            for es in specs:
                key = tuple(es[k] for k in GEOMETRY)
                geoms[key] = geoms.get(key, 0) + es["flushes"]
            out = {"phase": "bench", "mode": mode, "argv": argv,
                   "overrides": over, "launches": launches,
                   "front_launches": n.counts(), "seconds": seconds}
            if mode == "rpc":
                cl, ov = snap["closed_loop"], snap["overload"]
                out.update({
                    "closed_loop_rps": cl["rps"], "p50_ms": cl["p50_ms"],
                    "p99_ms": cl["p99_ms"], "closed_loop_ok": cl["ok"],
                    "overload_accepted": ov["accepted"],
                    "overload_shed_429": ov["shed_429"],
                    "shed_rate": ov["shed_rate"],
                    "slo_plans": snap["slo"]})
            else:
                flushes[mode] = snap["n_flushes"]
                out.update({
                    "requests": snap["n_solved"],
                    "lps": snap["n_solved"] / snap["wall_s"],
                    "wall_s": snap["wall_s"],
                    "p50_ms": snap["latency_p50_ms"],
                    "p99_ms": snap["latency_p99_ms"],
                    "n_flushes": snap["n_flushes"],
                    "flush_reasons": snap["flush_reasons"],
                    "inflight_max": snap["inflight_max"],
                    "overlapped_dispatches": snap["overlapped_dispatches"],
                    "fused_flushes": snap["fused_flushes"],
                    "fused_buckets": snap["fused_buckets"],
                    "device_idle_s_est": snap["device_idle_s_est"],
                    "device_idle_frac": snap.get("device_idle_frac"),
                    "device_idle_is": snap.get(
                        "device_idle_is", "not measured (no trace)")})
            if mode in TRACED_MODES:
                # why nothing overlaps on one card: how far apart the host
                # dispatches flushes, and how long each is in flight
                spans = sched.tracer.spans()
                starts = sorted(sp.t_start for sp in spans
                                if sp.name == "flush.dispatch")
                solves = [sp.t_end - sp.t_start for sp in spans
                          if sp.name == "device.solve"]
                out.update({"device_tracks": snap["device_tracks"],
                            "trace_complete_chains":
                                snap["trace_complete_chains"],
                            "dispatch_gap_ms": spread_ms(
                                [b - a for a, b in zip(starts, starts[1:])]),
                            "device_solve_ms": spread_ms(solves)})
            if mode == "trace":
                # the same open-loop stream untraced
                out["n_flushes_untraced"] = flushes["open-loop"]
            out.update({"exec_specs": specs, "card": card})
            emit(out)
        try:
            bench.main(["--method", "kernel", "--sharding", "pmap"],
                       devices=devices, quiet=True)
            raised = None
        except ValueError as e:
            raised = f"ValueError: {e}"
    check(raised is not None, "bench --sharding pmap did not raise")
    emit({"phase": "bench", "mode": "pmap", "raised": raised, "card": card})
    return {"exec_specs": [dict(zip(GEOMETRY, k), flushes=n) for k, n in
                           sorted(geoms.items(), key=lambda kv: -kv[1])],
            "seconds": time.perf_counter() - t_all}


# The paper's application at its figure-3 batch: one LP of K_NEIGH
# constraints per agent per step.
CROWD_AGENTS, CROWD_DIRECT_STEPS, CROWD_SERVED_STEPS = 16384, 60, 10
CROWD_POS_TOL = 1e-5


def import_example(name: str):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def phase_crowd(device, card: str) -> tuple:
    """``examples/crowd_sim_torch.py`` at 16,384 agents on the card: 60
    direct steps (one ``rgb_cuda`` launch each), then 10 served steps
    from the same start through ``BatchScheduler``; the step lines of the
    first 10 steps and the positions after them must match.  Returns the
    phase line and the first step's LP batch (numpy)."""
    from repro_torch.serve_lp import BatchScheduler
    crowd = import_example("crowd_sim_torch")

    n = CROWD_AGENTS
    pos_np, goal_np = crowd.spawn(n, 0)
    pos0 = torch.as_tensor(pos_np, device=device)
    goal = torch.as_tensor(goal_np, device=device)
    spec = crowd.spec_for(device)
    lp = crowd.step_constraints(pos0, goal - pos0)
    first = (lp.A.cpu().numpy(), lp.b.cpu().numpy(), lp.c.cpu().numpy(),
             lp.m_valid.cpu().numpy())
    logged = {0, CROWD_SERVED_STEPS - 1}

    def run(step, steps):
        pos, ms, lines, gaps, at = pos0, [], {}, [], None
        for t in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            pos = step(pos)
            stop.record()
            stop.synchronize()
            ms.append(start.elapsed_time(stop))
            if t in logged or t % 20 == 0 or t == steps - 1:
                line, gap = crowd.step_line(t, pos, goal)
                lines[t] = line
                gaps.append(gap)
            if t == CROWD_SERVED_STEPS - 1:
                at = pos.clone()
        return at, ms, lines, min(gaps)

    solver = spec.build(device=device)
    check(solver.spec.backend == "kernel" and solver.device == device,
          f"the crowd sim's solver is not the kernel on the card: {solver}")
    with Launches() as n_d:
        at_d, ms_d, lines_d, gap_d = run(
            lambda p: crowd.sim_step(p, goal, solver), CROWD_DIRECT_STEPS)
    launches_d = n_d.rgb
    sched = BatchScheduler(spec, max_batch=n, devices=[device])
    try:
        with Launches() as n_s:
            at_s, ms_s, lines_s, gap_s = run(
                lambda p: crowd.sim_step_served(p, goal, sched),
                CROWD_SERVED_STEPS)
        launches_s = n_s.rgb
        snap = sched.metrics.snapshot(sched.cache.stats())
        specs = exec_specs_of(sched)
    finally:
        sched.close()
    check(launches_d == CROWD_DIRECT_STEPS,
          f"crowd: {launches_d} rgb_cuda launches in {CROWD_DIRECT_STEPS} "
          "direct steps")
    check(launches_s >= CROWD_SERVED_STEPS,
          f"crowd: {launches_s} launches in {CROWD_SERVED_STEPS} served "
          "steps")
    n_d.check_front("crowd direct")
    n_s.check_front("crowd served")
    same = [t for t in sorted(logged) if lines_d[t] == lines_s[t]]
    check(len(same) == len(logged),
          f"crowd: direct and served step lines differ: "
          f"{[(lines_d[t], lines_s[t]) for t in sorted(logged)]}")
    pos_err = float((at_d - at_s).abs().max())
    check(pos_err <= CROWD_POS_TOL,
          f"crowd: positions after {CROWD_SERVED_STEPS} steps differ by "
          f"{pos_err}")
    check(bool(torch.isfinite(at_d).all()), "crowd: non-finite positions")
    med = lambda xs: sorted(xs)[len(xs) // 2]
    d_ms, s_ms = med(ms_d[1:]), med(ms_s[1:])
    out = {"phase": "crowd", "agents": n, "constraints": crowd.K_NEIGH,
           "spec": repr(solver.spec),
           "direct_steps": CROWD_DIRECT_STEPS,
           "served_steps": CROWD_SERVED_STEPS,
           "direct_step_ms_median": d_ms, "direct_lps": n / (d_ms / 1e3),
           "direct_first_step_ms": ms_d[0],
           "served_step_ms_median": s_ms, "served_lps": n / (s_ms / 1e3),
           "launches_direct": launches_d, "launches_served": launches_s,
           "front_launches_direct": n_d.counts(),
           "front_launches_served": n_s.counts(),
           "served_flushes": snap["n_flushes"], "exec_specs": specs,
           "lines": [lines_d[t] for t in sorted(lines_d)],
           "lines_served": [lines_s[t] for t in sorted(lines_s)],
           "tile": solver.spec.tile, "chunk": solver.spec.chunk,
           "M": solver.spec.M,
           "max_pos_diff_after_10": pos_err,
           "worst_clearance": min(gap_d, gap_s),
           "two_radii": 2 * crowd.RADIUS, "card": card}
    emit(out)
    return out, first


# The plain backends (naive, rgb) take ~20 s each at the quickstart's whole
# batch on the card: they solve its first 512 problems, the kernel all.
QUICKSTART_PLAIN = 512


def phase_quickstart(device, card: str) -> dict:
    """``examples/quickstart_torch.py`` on the card (B=4096, m=128): the
    naive, rgb and kernel backends agree, pre-packed equals AoS in bits,
    and the kernel backend launched ``rgb_cuda`` (its spec shuffles, so
    without ``prep`` and ``finish``)."""
    import contextlib
    import io

    quickstart = import_example("quickstart_torch")
    buf = io.StringIO()
    with Launches() as n, contextlib.redirect_stdout(buf):
        res = quickstart.main(["--plain-slice", str(QUICKSTART_PLAIN)],
                              device=device)
    launches = n.rgb
    check(launches >= 2, f"quickstart: {launches} rgb_cuda launches")
    n.check_front("quickstart")
    out = {"phase": "quickstart", **res, "launches": launches,
           "front_launches": n.counts(), "card": card}
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
    common = ["--arch", TRAIN_ARCH, "--lp-clip", "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--log-every", "1",
              "--ckpt-every", str(CKPT_EVERY), "--ckpt-dir", ckpt_dir]
    torch.cuda.reset_peak_memory_stats()
    with Launches() as n1:
        t0 = time.perf_counter()
        _, log1 = run_trainer(common + ["--steps", str(TRAIN_STEPS)])
        run1_s = time.perf_counter() - t0
    launches1 = n1.rgb
    peak = torch.cuda.max_memory_allocated()
    with Launches() as n2:
        t0 = time.perf_counter()
        _, log2 = run_trainer(common + ["--steps", str(RESUME_STEPS)])
        run2_s = time.perf_counter() - t0
    launches2 = n2.rgb
    n1.check_front("train")
    n2.check_front("train, resumed")
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
            "launches": launches1 + launches2,
            "front_launches": {k: v + n2.counts()[k]
                               for k, v in n1.counts().items()}}


def train_matmul_flops(cfg, lay, B: int, S: int) -> float:
    """The matrix-multiply FLOPs of one training step of the dense LM at
    ``B x S`` tokens: projections, MLP and head forward (2 per MAC),
    backward (twice the forward), the attention score and value products,
    and under remat the blocks' forward again up to the last tensor the
    backward needs: torch's non-reentrant checkpoint stops there, so each
    block's down projection is not recomputed."""
    d, hd, f, Lr = cfg.d_model, cfg.hd, cfg.d_ff, cfg.n_layers
    v_pad = -(-cfg.vocab // 256) * 256
    block = d * (lay.h_pad + 2 * lay.kv_total) * hd + lay.h_pad * hd * d \
        + 3 * d * f                                  # MACs per token
    attn = 2 * S * lay.h_pad * hd                    # MACs per token
    n = B * S
    fwd_blocks = 2 * n * Lr * (block + attn)
    fwd_head = 2 * n * v_pad * d
    remat = fwd_blocks - 2 * n * Lr * f * d if cfg.remat else 0
    return 3 * (fwd_blocks + fwd_head) + remat


def count_step(model, params, batch) -> dict:
    """``repro_torch.roofline.count_call`` of one forward + backward of
    ``model``'s loss on ``batch`` (on meta tensors where every op runs
    there, else on the card; ``ran_on`` says which)."""
    from repro_torch.roofline import count_call
    from repro_torch.tree import tree_leaves

    def fwd_bwd(params, batch):
        with torch.enable_grad():
            loss, _ = model.loss(params, batch)
            return torch.autograd.grad(loss, tree_leaves(params))

    c = count_call(fwd_bwd, params, batch)
    return {"flops": c.flops, "bytes": c.bytes, "ran_on": c.ran_on}


def train_roofline(cfg, median_step_ms: float, count: dict) -> dict:
    """The step's roofline terms from ``repro_torch.roofline``: useful
    work 6 N D, its share of the bf16 peak at the median step (``mfu``),
    and the counted step against the card's peaks."""
    from repro_torch.roofline import (from_counts, fused_hbm_estimate,
                                      model_flops_estimate)
    mf = model_flops_estimate(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    roof = from_counts(count["flops"], count["bytes"], chips=1,
                       model_flops=mf, peaks=PEAKS,
                       hbm_fused=fused_hbm_estimate(
                           cfg, "train", TRAIN_BATCH, TRAIN_SEQ, 1, 1))
    return {"model_flops": mf,
            "mfu": mf / (median_step_ms / 1e3 * PEAKS.bf16_flops),
            "count_call": count, "roofline": roof.as_dict()}


def step_lp_batch(updates, grads, opt_state, params) -> tuple:
    """The LP batch ``lp_constrain_updates`` solves for these updates, as
    numpy ``(A, b, c)``."""
    from repro_torch.optim import lp_problems
    A, b, c = lp_problems(updates, grads, opt_state.m, params)
    return A.cpu().numpy(), b.cpu().numpy(), c.cpu().numpy()


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
                                   lp_constrain_updates,
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
    lp_batch = step_lp_batch(updates, grads, new_state, params)
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
    out["matmul_bound_ms"] = flops / PEAKS.bf16_flops * 1e3
    count = count_step(model, params, batch)
    out["count_call"] = count
    rel = count["flops"] / flops - 1.0
    out["count_call_vs_matmul_flops"] = rel
    # what separates the count from a formula that recomputes the whole
    # block under remat: the down projections torch's checkpoint does not
    # recompute
    out["remat_down_proj_flops"] = (2 * TRAIN_BATCH * TRAIN_SEQ
                                    * cfg.n_layers * cfg.d_ff * cfg.d_model)
    out["step_kernels"] = device_kernels(
        lambda: prog.step(params, state, batch, {}))
    return out, lp_batch


def card_vs_cpu(device, arch: str = TRAIN_ARCH) -> dict:
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

    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
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
    from repro_torch.configs import ARCHS
    out = {"phase": "train", "arch": TRAIN_ARCH, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", **drive,
           **train_roofline(ARCHS[TRAIN_ARCH], drive["median_step_ms"],
                            split["count_call"]),
           "split": split,
           "lp_clip_share": split["lp_clip_ms"] / drive["median_step_ms"],
           "card_vs_cpu": parity,
           "seconds": time.perf_counter() - t0, "card": card}
    emit(out)
    return out, lp_batch


# The SSM family's training run: Mamba2-1.3B at full width, LP-clipped.
TRAIN_SSM_ARCH, TRAIN_SSM_STEPS = "mamba2-1.3b", 6


def phase_train_ssm(device, card: str) -> tuple:
    """``repro_torch.launch.train.main`` on mamba2-1.3b at full width in
    bf16 with ``--lp-clip``, 8 x 512 tokens, read right after its run
    (the launch counts set to 0 just before); then one step of a fresh
    model traced, the LP batch of that step, and card-vs-CPU parity on
    the smoke config.  Returns the phase line and the LP batch."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import TokenSource, for_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, sync_duplicated_grads
    from repro_torch.tree import tree_leaves, tree_unflatten

    arch, steps = TRAIN_SSM_ARCH, TRAIN_SSM_STEPS
    t0 = time.perf_counter()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    with Launches() as n:
        _, log = run_trainer(["--arch", arch, "--lp-clip", "--batch",
                              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                              "--log-every", "1", "--steps", str(steps)])
    launches = n.rgb
    peak = torch.cuda.max_memory_allocated()
    run_s = time.perf_counter() - t0
    rows = [(int(a), float(b), float(c), float(d))
            for a, b, c, d in TRAIN_LOG.findall(log)]
    check([r[0] for r in rows] == list(range(steps)),
          f"{arch}: the trainer logged {log!r}")
    losses, s1s = [r[1] for r in rows], [r[3] for r in rows]
    check(all(np.isfinite(losses)), f"{arch}: a loss is not finite: "
          f"{losses}")
    check(all(0.0 <= x <= 1.0 for x in s1s),
          f"{arch}: lp_s1 outside [0, 1]: {s1s}")
    check(launches == steps, f"{arch}: rgb_cuda launched {launches} times "
          f"in {steps} steps")
    n.check_front(arch)
    dts = sorted(r[2] for r in rows[1:])      # the first step starts up
    median_ms = dts[len(dts) // 2]
    free_card()

    cfg = ARCHS[arch]
    opt = AdamW()
    prog = make_train_step(cfg, make_host_mesh(1, 1), opt,
                           global_batch=TRAIN_BATCH, lp_clip=True)
    model = prog.model
    params = model.init(torch.Generator(device=device).manual_seed(1))
    state = opt.init(params)
    src = TokenSource(for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=1))
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in src.global_batch(0).items()}
    params, state, _, _ = prog.step(params, state, batch, {})
    step_kernels = device_kernels(lambda: prog.step(params, state, batch,
                                                    {}))
    count = count_step(model, params, batch)
    with torch.enable_grad():
        loss, _ = model.loss(params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(
            loss, tree_leaves(params)))
    grads = sync_duplicated_grads(grads, model.kv_duplication(), cfg.hd)
    updates, new_state = opt.update(grads, state, params)
    lp_batch = step_lp_batch(updates, grads, new_state, params)
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves = len(tree_leaves(params))
    f32_leaves = sorted(k for k, p in model.blocks.items()
                        if p.dtype == torch.float32)
    del prog, model, params, state, grads, updates, new_state, loss
    free_card()
    check(lp_batch[1].shape[0] == n_leaves,
          f"{arch}: {lp_batch[1].shape[0]} LPs for {n_leaves} leaves")
    out = {"phase": "train", "arch": arch, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "dtype": "bfloat16", "steps": steps,
           "parameters": n_params, "float32_leaves": f32_leaves,
           "losses": losses, "lp_s1": s1s, "step_ms": [r[2] for r in rows],
           "median_step_ms": median_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
           **train_roofline(cfg, median_ms, count),
           "max_memory_allocated": peak, "run_seconds": run_s,
           "launches": launches, "front_launches": n.counts(),
           "lp_problems": int(lp_batch[1].shape[0]),
           "step_kernels": step_kernels,
           "card_vs_cpu": card_vs_cpu(device, arch),
           "seconds": time.perf_counter() - t0, "card": card}
    emit(out)
    return out, lp_batch


# The serving phase: each architecture served at full width, then held
# to the prefill oracle (full width, float32) and to the CPU (smoke).
LM_ARCHS = (("qwen2-0.5b", 512), ("olmoe-1b-7b", 512),
            ("paligemma-3b", 256), ("whisper-base", 512),
            ("mamba2-1.3b", 512), ("zamba2-2.7b", 512))
LM_REQUESTS, LM_BATCH, LM_GEN = 16, 8, 32
# tests/test_decode_equivalence.py's form: prefill, stream teacher-forced
# steps, hold each step's logits against a prefill of the longer sequence
EQ_BATCH, EQ_PREFILL, EQ_STEPS, EQ_TOL = 2, 64, 4, 2e-4
LM_CPU_STEPS, LM_CPU_TOL = 3, 1e-5


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def float32_exact():
    """TF32 off (for float32 checks); returns a function that restores
    the old setting."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return restore


def lm_inputs(cfg, rng, B: int, S: int, device):
    """Tokens (B, S) and a function giving the batch of the first ``t``
    tokens on ``device``, with the family's patches or frames (drawn in
    float32, cast to the model's dtype)."""
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = {}
    act = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)

    def batch(t: int) -> dict:
        b = {"tokens": torch.as_tensor(toks[:, :t], device=device)}
        for k, v in extra.items():
            b[k] = torch.as_tensor(v, device=device).to(act)
        return b
    return toks, batch


def real_err(got, ref, vocab: int) -> tuple:
    """Largest |got - ref| over the real vocabulary, the largest |ref|
    there, and whether the padded columns are equal."""
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    return (float(np.abs(g[:, :vocab] - r[:, :vocab]).max()),
            float(np.abs(r[:, :vocab]).max()),
            bool(np.array_equal(g[:, vocab:], r[:, vocab:])))


def cache_parts(cfg, B: int, seq: int) -> dict:
    """A grown bf16 serving cache's bytes by part, from the config alone:
    the self-attention K/V of ``seq`` slots (with an encoder-decoder's
    cross K/V) and what the real KV heads would need, the SSM state
    (float32) and conv windows, which do not grow with the sequence, and
    the positions."""
    from repro_torch.models.common import head_layout
    parts = {"kv": 0, "kv_real_heads": 0, "ssm_state": 0, "conv": 0,
             "pos": 0, "kv_heads_stored": None, "kv_heads_real": None}
    if cfg.family in ("ssm", "hybrid"):
        parts["ssm_state"] = (cfg.n_layers * B * cfg.ssm_heads
                              * cfg.ssm_state * cfg.ssm_head_dim * 4)
        parts["conv"] = (cfg.n_layers * B * (cfg.ssm_conv - 1)
                         * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
    if cfg.family != "ssm":
        lay = head_layout(cfg, 1)
        n = (cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid"
             else cfg.n_layers)            # caches: one a segment
        slots = seq + (cfg.enc_seq if cfg.family == "encdec" else 0)
        parts["kv"] = 2 * n * B * cfg.hd * 2 * slots * lay.kv_total
        parts["kv_real_heads"] = parts["kv"] * lay.n_kv // lay.kv_total
        parts["pos"] = n * B * 4
        parts["kv_heads_stored"] = lay.kv_total
        parts["kv_heads_real"] = lay.n_kv
    return parts


def serve_arch(device, card: str, arch: str, prompt_len: int) -> dict:
    """(a) ``repro_torch.launch.serve.main`` at full width in bf16, read
    right after its run; then one decode step of a fresh server of the
    same shape in a profiler trace."""
    import contextlib
    import io

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve import pad_cache, prefill_length
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg = ARCHS[arch]
    free_card()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--requests", str(LM_REQUESTS), "--batch",
            str(LM_BATCH), "--prompt-len", str(prompt_len), "--gen",
            str(LM_GEN)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = serve_main(argv)
    peak = torch.cuda.max_memory_allocated()
    log = buf.getvalue()
    n_batches = -(-LM_REQUESTS // LM_BATCH)
    check(f"[serve] {n_batches * LM_BATCH * LM_GEN} tokens in " in log,
          f"{arch}: the server's last line is not there: {log!r}")
    check([t.shape for t in run.tokens] == [(LM_BATCH, LM_GEN)] * n_batches,
          f"{arch}: generated {[t.shape for t in run.tokens]}")
    check(all(((t >= 0) & (t < cfg.vocab)).all() for t in run.tokens),
          f"{arch}: a generated token is outside the real vocabulary")
    decode_ms = sorted(ms for b in run.decode_ms for ms in b)
    seq = prompt_len + LM_GEN + (cfg.n_prefix if cfg.family == "vlm" else 0)
    parts = cache_parts(cfg, LM_BATCH, seq)
    kv_bytes = parts["kv"]
    state_bytes = parts["ssm_state"] + parts["conv"]
    check(run.cache_bytes == kv_bytes + state_bytes + parts["pos"],
          f"{arch}: the cache holds {run.cache_bytes} bytes, not {parts}")
    out = {"arch": arch, "family": cfg.family, "batch": LM_BATCH,
           "prompt_len": prompt_len, "gen": LM_GEN,
           "requests": LM_REQUESTS, "dtype": cfg.dtype,
           "prefill_ms": run.prefill_ms,
           "decode_step_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_min": decode_ms[0],
           "decode_step_ms_max": decode_ms[-1],
           "tokens": run.n_tokens, "seconds": run.seconds,
           "tokens_per_s": run.n_tokens / run.seconds,
           "max_memory_allocated": peak,
           "cache_bytes": run.cache_bytes,
           "kv_cache_bytes": kv_bytes,
           "kv_cache_bytes_real_heads": parts["kv_real_heads"],
           "kv_heads_stored": parts["kv_heads_stored"],
           "kv_heads_real": parts["kv_heads_real"],
           "ssm_state_bytes": parts["ssm_state"],
           "conv_cache_bytes": parts["conv"],
           "sample_row": run.tokens[0][0][:8].tolist()}
    del run
    free_card()
    # one decode step of a fresh server (the same shapes), traced
    mesh = make_host_mesh(1, 1)
    pre = make_prefill_step(cfg, mesh, global_batch=LM_BATCH)
    dec = make_decode_step(cfg, mesh, global_batch=LM_BATCH, model=pre.model)
    params = pre.model.init(torch.Generator(device=device).manual_seed(0))
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in pre.model.parameters())
    _, batch = lm_inputs(cfg, np.random.default_rng([SEED, 7]), LM_BATCH,
                         prompt_len, device)
    logits, cache = pre.jit()(params, batch(prompt_len))
    cur = prefill_length(cache, prompt_len)
    cache = pad_cache(cache, LM_GEN)
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    pos = torch.full((LM_BATCH,), cur, dtype=torch.int32, device=device)
    step = {"token": tok, "pos": pos}
    dec.jit()(params, step, cache)           # warm
    out["decode_step"] = device_kernels(lambda: dec.jit()(params, step,
                                                          cache))
    out["weight_bytes"] = weight_bytes
    # a decode step reads every weight and the whole cache (K/V, SSM
    # state and conv windows) at least once
    out["decode_bytes_bound_ms"] = (weight_bytes + kv_bytes + state_bytes) \
        / PEAKS.hbm_bytes_s * 1e3
    # the reference's analytic estimate of the same step: at least 16 KV
    # heads, the fp32 logits, the config's (unpadded) parameter count
    from repro_torch.roofline import fused_hbm_estimate
    out["fused_hbm_decode_bytes"] = fused_hbm_estimate(cfg, "decode",
                                                       LM_BATCH, seq, 1, 1)
    out["fused_hbm_decode_ms"] = out["fused_hbm_decode_bytes"] \
        / PEAKS.hbm_bytes_s * 1e3
    del pre, dec, params, cache, logits
    free_card()
    return out


def decode_equivalence(device, arch: str) -> dict:
    """(b) The full-width model in float32, TF32 off: prefill 64 tokens,
    stream 4 teacher-forced decode steps, each step's logits against a
    prefill of the longer sequence (real columns, rtol = atol = 2e-4)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import pad_cache, prefill_length
    from repro_torch.models import MeshInfo, build_model
    cfg = dataclasses.replace(ARCHS[arch], dtype="float32")
    restore = float32_exact()
    try:
        model = build_model(cfg, MeshInfo())
        params = model.init(torch.Generator(device=device).manual_seed(1))
        toks, batch = lm_inputs(cfg, np.random.default_rng([SEED, 8]),
                                EQ_BATCH, EQ_PREFILL + EQ_STEPS, device)
        logits, cache = model.prefill(params, batch(EQ_PREFILL))
        cur = prefill_length(cache, EQ_PREFILL)
        cache = pad_cache(cache, EQ_STEPS)
        stream = [logits]
        for t in range(EQ_STEPS - 1):
            tok = torch.as_tensor(toks[:, EQ_PREFILL + t][:, None],
                                  device=device)
            pos = torch.full((EQ_BATCH,), cur + t, dtype=torch.int32,
                             device=device)
            logits, cache = model.decode(params, {"token": tok, "pos": pos},
                                         cache)
            stream.append(logits)
        errs, worst = [], 0.0
        for t in range(EQ_STEPS):
            ref, _ = model.prefill(params, batch(EQ_PREFILL + t))
            g = stream[t][:, :cfg.vocab].cpu().double()
            r = ref[:, :cfg.vocab].cpu().double()
            errs.append(float((g - r).abs().max()))
            # assert_allclose's rule: |g - r| <= atol + rtol |r|
            worst = max(worst, float(((g - r).abs()
                                      / (EQ_TOL + EQ_TOL * r.abs())).max()))
        check(worst <= 1.0,
              f"{arch}: streamed decode misses the prefill oracle: max abs "
              f"err per step {errs}, {worst} of the allowed")
        out = {"steps": EQ_STEPS, "prefill": EQ_PREFILL, "batch": EQ_BATCH,
               "max_abs_err": max(errs), "max_abs_err_per_step": errs,
               "share_of_tolerance": worst, "rtol": EQ_TOL, "atol": EQ_TOL,
               "tf32": False}
    finally:
        restore()
        model = params = cache = None
        free_card()
    return out


def lm_card_vs_cpu(device, arch: str) -> dict:
    """(c) The smoke config in float32, TF32 off: one prefill and 3 decode
    steps on the card and on the CPU from the same weights; logits within
    1e-5 of the largest |logit|."""
    import dataclasses

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.serve import pad_cache, prefill_length
    from repro_torch.models import (MeshInfo, build_model, params_from_numpy,
                                    params_to_numpy)
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    restore = float32_exact()
    runs, init = {}, None
    try:
        for dev in (torch.device("cpu"), device):
            model = build_model(cfg, MeshInfo(), device=dev)
            if init is None:
                init = params_to_numpy(model.init(
                    torch.Generator().manual_seed(2)))
            params = params_from_numpy(model, init)
            toks, batch = lm_inputs(cfg, np.random.default_rng([SEED, 9]),
                                    2, 8 + LM_CPU_STEPS, dev)
            logits, cache = model.prefill(params, batch(8))
            cur = prefill_length(cache, 8)
            cache = pad_cache(cache, LM_CPU_STEPS)
            out = [logits.cpu()]
            for t in range(LM_CPU_STEPS):
                logits, cache = model.decode(params, {
                    "token": torch.as_tensor(toks[:, 8 + t][:, None],
                                             device=dev),
                    "pos": torch.full((2,), cur + t, dtype=torch.int32,
                                      device=dev)}, cache)
                out.append(logits.cpu())
            runs[dev.type] = out
    finally:
        restore()
    rel, pad_equal = 0.0, True
    for g, c in zip(runs["cuda"], runs["cpu"]):
        err, scale, same = real_err(g, c, cfg.vocab)
        rel = max(rel, err / scale)
        pad_equal = pad_equal and same
    check(rel <= LM_CPU_TOL and pad_equal,
          f"{arch}: card and CPU logits differ by {rel} of the largest "
          f"(padded columns equal: {pad_equal})")
    return {"steps": 1 + LM_CPU_STEPS, "max_rel_err": rel,
            "padded_equal": pad_equal, "tf32": False}


def phase_lm_serve(device, card: str) -> dict:
    """LM serving for each family: (a) the served run and
    its decode step's kernels, (b) decode against the prefill oracle at
    full width, (c) card against CPU on the smoke config.  Launches no
    ``rgb_cuda`` (no LP is solved on this path)."""
    from repro_torch.kernels.batch_lp import rgb_cuda
    n0 = rgb_cuda.launches
    t0 = time.perf_counter()
    archs = []
    for arch, prompt_len in LM_ARCHS:
        ta = time.perf_counter()
        out = {"phase": "lm_serve", **serve_arch(device, card, arch,
                                                 prompt_len)}
        out["decode_equivalence"] = decode_equivalence(device, arch)
        out["card_vs_cpu"] = lm_card_vs_cpu(device, arch)
        out["rgb_cuda_launches"] = rgb_cuda.launches - n0
        out["seconds_all"] = time.perf_counter() - ta
        out["card"] = card
        emit(out)
        archs.append(arch)
    launches = rgb_cuda.launches - n0
    check(launches == 0, f"the LM serving path launched rgb_cuda "
          f"{launches} times")
    return {"archs": archs, "rgb_cuda_launches": launches,
            "seconds": time.perf_counter() - t0}


def phase_train_kernel(device, card: str, lp_batch, launches: int,
                       path: str = "train") -> dict:
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
                          "float32", tile, 0, path, {}, M=M_BOX)
    check(entry["bits_equal"],
          f"rgb_cuda differs from rgb_plain in bits on the step's LP "
          f"batch: {entry}")
    entry["launches"] = launches
    entry["problems"] = nb
    return entry


# ---------------------------------------------------------------------------
# The multi-rank phase: the train and serve steps on meshes of ranks over
# torch.distributed, and the batch-sharded LP step.  Each rank is a child
# process running this file with ``--dist-rank``; the parent reads what the
# ranks wrote.  (a) NCCL, one rank a card (``device_count`` ranks);
# (b) four gloo ranks sharing card 0 (NCCL refuses two ranks on one card),
# their payloads through pinned host memory.
# ---------------------------------------------------------------------------

DIST_ARCH = "qwen2-0.5b"
DIST_STEPS = 3
DIST_NCCL_BATCH, DIST_NCCL_SEQ = 8, 512     # (a): the train phase's shape
DIST_GLOO_BATCH, DIST_GLOO_SEQ = 4, 256     # (b): float32, 2 data shards
DIST_GLOO_WORLD = 4
DIST_SERVE_BATCH, DIST_SERVE_PROMPT, DIST_SERVE_DECODE = 2, 128, 4
DIST_TOL = 1e-4          # loss, lp_s1, step 1's gradients, the leaves after
DIST_LR = 3e-4           # AdamW's default learning rate, which the runs use
DIST_SERVE_TOL = 1e-5    # logits, of the largest |logit|
DIST_TIMEOUT_S = 600


def _dist_cfg(dtype: str, **kw):
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[DIST_ARCH], dtype=dtype, **kw)


def _dist_train(mesh, cfg, batch: int, seq: int, *, lp_spy=None,
                keep=("params_1",)) -> dict:
    """``DIST_STEPS`` LP-clipped train steps of ``cfg`` on ``mesh`` from the
    seeded init (train.main's composition, timed): each step's loss,
    lp_s1 and CUDA-event ms, the collectives of the last step, peak
    memory, the rgb_cuda launches of the run and, as ``keep`` asks, the
    whole parameters after step 1 and at the end (on the card)."""
    from repro_torch import dist as D
    from repro_torch.data.pipeline import TokenSource, for_model
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW
    from repro_torch.optim import lp_clip as lp_clip_mod

    dev = mesh.device
    torch.empty(1, device=dev)  # the allocator must exist to be reset
    torch.cuda.reset_peak_memory_stats(dev)
    opt = AdamW(lr=DIST_LR)
    prog = make_train_step(cfg, mesh, opt, global_batch=batch, lp_clip=True)
    params = prog.model.init(torch.Generator(device=dev).manual_seed(SEED))
    state = opt.init(params)
    src = TokenSource(for_model(cfg, seq, batch, seed=SEED))
    real = lp_clip_mod.make_batch
    if lp_spy is not None:
        def spy(A, b, c, *a, **k):
            lp_spy.append(tuple(t.detach().cpu().numpy() for t in (A, b, c)))
            return real(A, b, c, *a, **k)
        lp_clip_mod.make_batch = spy
    out = {"loss": [], "lp_s1": [], "step_ms": []}
    grads_1 = None
    if "params_1" in keep:  # step 1's gradients, whole, for the checks
        first = {k: torch.as_tensor(v, device=dev)
                 for k, v in src.global_batch(0).items()}
        _, g = prog.grads(params, first)
        grads_1 = _whole(prog.model, g)
        del g
    try:
        with Launches() as n:
            for step in range(DIST_STEPS):
                bt = {k: torch.as_tensor(v, device=dev)
                      for k, v in src.global_batch(step).items()}
                D.reset_counts()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                params, state, m, _ = prog.step(params, state, bt, {})
                b.record()
                torch.cuda.synchronize(dev)
                out["step_ms"].append(a.elapsed_time(b))
                out["loss"].append(float(m["loss"]))
                out["lp_s1"].append(float(m["lp_s1"]))
                out["collectives"] = D.counts()
                if step == 0 and "params_1" in keep:
                    out["params_1"] = _whole(prog.model)
                    out["grads_1"] = grads_1
    finally:
        lp_clip_mod.make_batch = real
    out["launches"], out["front_launches"] = n.rgb, n.counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if "final" in keep:
        out["final"] = _whole(prog.model)
    return out


def _whole(model, tree=None) -> dict:
    """The model's whole parameters (or ``tree`` of their shapes), on its
    card, by slash path."""
    from repro_torch.dist import flat_specs, gather_leaf
    from repro_torch.tree import flatten_with_paths
    flat = flatten_with_paths(model.param_tree() if tree is None else tree)
    if not model.sharded:
        return {k: v.detach().clone() for k, v in flat.items()}
    specs = flat_specs(model.full_param_specs())
    return {k: gather_leaf(v, specs[k], model.mesh) for k, v in flat.items()}


def _leaf_err(a: dict, b: dict) -> dict:
    """Each leaf's max |a - b| / max |b|."""
    out = {}
    for k, ref in b.items():
        den = float(ref.abs().max()) or 1.0
        out[k] = float((a[k].float() - ref.float()).abs().max()) / den
    return out


def _step1_err(p: dict, p_one: dict, g: dict, g_one: dict) -> dict:
    """Each leaf after step 1 against one card, in units of the leaf's
    largest |value|: overall, and on the elements whose one-card gradient
    is above ``DIST_TOL`` of the leaf's largest (AdamW's first step is
    about ``lr sign(g)`` whatever |g| is, so a gradient at float32's
    rounding level can move by up to ``2 lr`` when its sum runs in another
    order); with the worst element's gradients on both sides."""
    out = {}
    for k, ref in p_one.items():
        d = (p[k].float() - ref.float()).abs().flatten()
        den = float(ref.abs().max()) or 1.0
        go = g_one[k].float().flatten()
        live = go.abs() > DIST_TOL * float(go.abs().max())
        i = int(d.argmax())
        out[k] = {"err": float(d[i]) / den, "abs": float(d[i]),
                  "err_live": float(d[live].max()) / den if live.any()
                  else 0.0,
                  "n_over_tol": int((d > DIST_TOL * den).sum()),
                  "n": d.numel(),
                  "worst_grad_one_card": float(go[i]),
                  "worst_grad_mesh": float(g[k].float().flatten()[i]),
                  "grad_max_one_card": float(go.abs().max())}
    return out


def _dist_serve(mesh, cfg, prompt, nxt) -> list:
    """Prefill, then teacher-forced decode steps: every step's logits."""
    from repro_torch.launch import steps
    from repro_torch.launch.serve import pad_cache
    B = prompt.shape[0]
    pre = steps.make_prefill_step(cfg, mesh, global_batch=B)
    dec = steps.make_decode_step(cfg, mesh, global_batch=B, model=pre.model)
    dev = mesh.device
    params = pre.model.init(torch.Generator(device=dev).manual_seed(SEED))
    logits, cache = pre.step(params, {"tokens": torch.as_tensor(
        prompt, device=dev)})
    out = [logits]
    cache = pad_cache(cache, nxt.shape[1])
    for t in range(nxt.shape[1]):
        pos = torch.full((B,), prompt.shape[1] + t, dtype=torch.int32,
                         device=dev)
        logits, cache = dec.step(params, {"token": torch.as_tensor(
            nxt[:, t:t + 1], device=dev), "pos": pos}, cache)
        out.append(logits)
    return out


def _rank_nccl(rank: int, world: int, root: str) -> dict:
    """(a): on one card, the HostMesh run first, then the NCCL mesh of
    ``world`` x 1 ranks from the same seed; at world 1 they must agree in
    bits, losses, lp_s1 and every leaf."""
    from repro_torch.launch.mesh import (init_process_group, make_host_mesh,
                                         rank_device)
    cfg = _dist_cfg("bfloat16")
    dev = rank_device(None)
    host = None
    if world == 1:
        host = _dist_train(make_host_mesh(1, 1, device=dev), cfg,
                           DIST_NCCL_BATCH, DIST_NCCL_SEQ, keep=("final",))
        free_card()
    init_process_group(dev, backend="nccl")
    mesh = make_host_mesh(world, 1, device=dev)
    run = _dist_train(mesh, cfg, DIST_NCCL_BATCH, DIST_NCCL_SEQ,
                      keep=("final",) if world == 1 else ())
    res = {k: run[k] for k in ("loss", "lp_s1", "step_ms", "collectives",
                               "launches", "front_launches", "peak_gb")}
    res["backend"] = mesh.backend
    if host is not None:
        res["bits_equal_hostmesh"] = (
            host["loss"] == run["loss"] and host["lp_s1"] == run["lp_s1"]
            and all(torch.equal(host["final"][k], v)
                    for k, v in run["final"].items()))
        res["hostmesh_loss"] = host["loss"]
    return res


def _rank_gloo(rank: int, world: int, root: str) -> dict:
    """(b) and (c): four gloo ranks on card 0."""
    from repro_torch import dist as D
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.seidel import solve_naive
    from repro_torch.launch.mesh import (init_process_group, make_host_mesh,
                                         rank_device)
    from repro_torch.launch.steps import make_lp_step
    restore = float32_exact()
    dev = rank_device("cuda:0")
    init_process_group(dev, backend="gloo")
    mesh = make_host_mesh(2, 2, device=dev)
    # gloo moves each CUDA payload through pinned host memory
    res = {"backend": mesh.backend, "transport": mesh.backend}
    runs, lps = {}, {}
    for name, kw in (("tp_dp", {}), ("fsdp", {"fsdp": True})):
        lps[name] = []
        runs[name] = _dist_train(mesh, _dist_cfg("float32", **kw),
                                 DIST_GLOO_BATCH, DIST_GLOO_SEQ,
                                 lp_spy=lps[name])
        if rank != 0:  # rank 0 holds them against the one-card steps
            del runs[name]["params_1"]
        free_card()
    np.savez(os.path.join(root, f"lp_rank{rank}.npz"),
             **{f"{n}_{i}_{j}": a for n, steps in lps.items()
                for i, s in enumerate(steps) for j, a in enumerate(s)})
    # (1, 4): the serving steps, tensor-parallel over the 4 ranks
    rng = np.random.default_rng([SEED, 21])
    cfg = _dist_cfg("float32")
    prompt = rng.integers(0, cfg.vocab, (DIST_SERVE_BATCH,
                                         DIST_SERVE_PROMPT), dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab, (DIST_SERVE_BATCH, DIST_SERVE_DECODE),
                       dtype=np.int32)
    tp = make_host_mesh(1, 4, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    D.reset_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    served = _dist_serve(tp, cfg, prompt, nxt)
    b.record()
    torch.cuda.synchronize(dev)
    res["serve"] = {"ms": a.elapsed_time(b), "collectives": D.counts(),
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    served = [x.cpu() for x in served]
    free_card()
    # (c): make_lp_step at the figure-3 batch over every rank
    A, bb, c = feasible_arrays(np.random.default_rng([SEED, 22]),
                               *PDHG_SHAPE)
    batch = {"A": torch.as_tensor(A, dtype=torch.float32, device=dev),
             "b": torch.as_tensor(bb, dtype=torch.float32, device=dev),
             "c": torch.as_tensor(c, dtype=torch.float32, device=dev),
             "m_valid": torch.full((PDHG_SHAPE[0],), PDHG_SHAPE[1],
                                   dtype=torch.int32, device=dev)}
    prog = make_lp_step(mesh, batch=PDHG_SHAPE[0], m=PDHG_SHAPE[1],
                        method="naive")
    torch.cuda.reset_peak_memory_stats(dev)
    D.reset_counts()
    a.record()
    sol = prog.step(batch)
    b.record()
    torch.cuda.synchronize(dev)
    res["lp_step"] = {"ms": a.elapsed_time(b), "collectives": D.counts(),
                      "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    for name, run in runs.items():
        res[name] = {k: run[k] for k in ("loss", "lp_s1", "step_ms",
                                         "collectives", "launches",
                                         "front_launches", "peak_gb")}
    D.barrier(mesh)
    if rank == 0:
        # the one-card float32 references, on rank 0 while the others wait
        from repro_torch.launch.mesh import HostMesh
        one_mesh = HostMesh(device=dev)
        for name, kw in (("tp_dp", {}), ("fsdp", {"fsdp": True})):
            one = _dist_train(one_mesh, _dist_cfg("float32", **kw),
                              DIST_GLOO_BATCH, DIST_GLOO_SEQ)
            r = runs[name]
            res[name]["one_card_loss"] = one["loss"]
            res[name]["one_card_lp_s1"] = one["lp_s1"]
            res[name]["loss_rel_err"] = max(
                abs(x - y) / abs(y) for x, y in zip(r["loss"], one["loss"]))
            res[name]["lp_s1_err"] = max(
                abs(x - y) for x, y in zip(r["lp_s1"], one["lp_s1"]))
            grad_err = _leaf_err(r["grads_1"], one["grads_1"])
            step1 = _step1_err(r["params_1"], one["params_1"],
                               r["grads_1"], one["grads_1"])
            res[name]["grad_err_step1"] = max(grad_err.values())
            res[name]["leaf_err_step1"] = max(v["err"] for v in
                                              step1.values())
            res[name]["leaf_err_step1_live"] = max(v["err_live"] for v in
                                                   step1.values())
            res[name]["leaf_abs_step1"] = max(v["abs"] for v in
                                              step1.values())
            res[name]["by_leaf"] = {k: {"grad_err": grad_err[k], **v}
                                    for k, v in step1.items()}
            del one
            free_card()
        ref = _dist_serve(HostMesh(device=dev), cfg, prompt, nxt)
        res["serve"]["logit_err"] = max(
            float((x[:, :cfg.vocab] - y.cpu()[:, :cfg.vocab]).abs().max())
            / float(y[:, :cfg.vocab].abs().max())
            for x, y in zip(served, ref))
        one = solve_naive(LPBatch(**batch))
        res["lp_step"]["bits_equal_one_rank"] = bool(
            torch.equal(one.x, sol["x"])
            and torch.equal(one.feasible, sol["feasible"]))
    runs.clear()
    D.barrier(mesh)
    restore()
    return res


def dist_rank_main(argv) -> int:
    """A child process: one rank of ``argv[0]`` ("nccl" | "gloo")."""
    scenario, root = argv[0], argv[1]
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    fn = {"nccl": _rank_nccl, "gloo": _rank_gloo}[scenario]
    res = fn(rank, world, root)
    res["rank"] = rank
    with open(os.path.join(root, f"{scenario}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


def spawn_ranks(scenario: str, world: int, root: str) -> list:
    """Start ``world`` ranks of ``scenario`` and wait for every one; a
    failed rank fails the phase (and every rank is stopped)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world))
    logs = [os.path.join(root, f"{scenario}_rank{r}.log")
            for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank",
                 scenario, root],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        with open(logs[r]) as f:
            sys.stderr.write(f"--- rank {r} ---\n" + f.read()[-6000:])
    check(not bad, f"dist {scenario}: ranks {bad} failed")
    out = []
    for r in range(world):
        with open(os.path.join(root, f"{scenario}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_dist(device, card: str) -> tuple:
    """(a) NCCL at device_count ranks, (b) + (c) four gloo ranks on card 0.
    Every line is printed, then any failed check fails the phase.  Returns
    rank 0's LP batch of the first 2x2 step, its rgb_cuda launches and the
    phase's seconds."""
    import tempfile
    t0 = time.perf_counter()
    free_card()
    lines, failed = [], []

    def hold(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as root:
        world = torch.cuda.device_count()
        nccl = spawn_ranks("nccl", world, root)
        r0 = nccl[0]
        hold(all(r["launches"] == DIST_STEPS for r in nccl),
             f"dist nccl: rgb_cuda launches {[r['launches'] for r in nccl]},"
             f" not one a step")
        hold(all(front_ok(r["front_launches"]) for r in nccl),
             f"dist nccl: launches {[r['front_launches'] for r in nccl]}: "
             "a solve took the eager front end")
        if world == 1:
            hold(r0["bits_equal_hostmesh"], "dist nccl: the 1x1 NCCL mesh "
                 "differs in bits from the HostMesh step")
        lines.append({"phase": "dist", "run": "nccl", "arch": DIST_ARCH,
                      "dtype": "bfloat16", "world": world,
                      "mesh": [world, 1], "backend": r0["backend"],
                      "transport": r0["backend"],
                      "ranks_share_one_card": False,
                      "batch": DIST_NCCL_BATCH, "seq": DIST_NCCL_SEQ,
                      "loss": r0["loss"], "lp_s1": r0["lp_s1"],
                      "hostmesh_loss": r0.get("hostmesh_loss"),
                      "bits_equal_hostmesh": r0.get("bits_equal_hostmesh"),
                      "step_ms": [r["step_ms"] for r in nccl],
                      "peak_gb": [r["peak_gb"] for r in nccl],
                      "collectives_per_step": r0["collectives"],
                      "rgb_cuda_launches": [r["launches"] for r in nccl],
                      "front_launches": [r["front_launches"] for r in nccl]})
        gloo = spawn_ranks("gloo", DIST_GLOO_WORLD, root)
        g0 = gloo[0]
        lps = [np.load(os.path.join(root, f"lp_rank{r}.npz"))
               for r in range(DIST_GLOO_WORLD)]
        lp_equal = all(sorted(f.files) == sorted(lps[0].files) and all(
            f[k].tobytes() == lps[0][k].tobytes() for k in f.files)
            for f in lps[1:])
        hold(lp_equal, "dist gloo: the ranks' LP batches differ in bits")
        lp_batch = tuple(lps[0][f"tp_dp_0_{j}"] for j in range(3))
        for name in ("tp_dp", "fsdp"):
            g = g0[name]
            hold(all(r[name]["launches"] == DIST_STEPS for r in gloo),
                 f"dist {name}: rgb_cuda not launched once a step a rank")
            hold(all(front_ok(r[name]["front_launches"]) for r in gloo),
                 f"dist {name}: a solve took the eager front end")
            hold(all(r[name]["lp_s1"] == g["lp_s1"] for r in gloo),
                 f"dist {name}: lp_s1 differs between ranks")
            # step 1's gradients and the leaves after it where the gradient
            # is above rounding; any element at most AdamW's 2 lr
            hold(g["loss_rel_err"] <= DIST_TOL and g["lp_s1_err"] <= DIST_TOL
                 and g["grad_err_step1"] <= DIST_TOL
                 and g["leaf_err_step1_live"] <= DIST_TOL
                 and g["leaf_abs_step1"] <= 2 * DIST_LR,
                 f"dist {name}: off the one-card float32 steps")
            lines.append({
                "phase": "dist", "run": name, "arch": DIST_ARCH,
                "dtype": "float32", "world": DIST_GLOO_WORLD,
                "mesh": [2, 2], "fsdp": name == "fsdp",
                "backend": g0["backend"], "transport": g0["transport"],
                "ranks_share_one_card": True, "batch": DIST_GLOO_BATCH,
                "seq": DIST_GLOO_SEQ, "loss": g["loss"], "lp_s1": g["lp_s1"],
                "one_card_loss": g["one_card_loss"],
                "loss_rel_err": g["loss_rel_err"],
                "lp_s1_err": g["lp_s1_err"], "tol": DIST_TOL,
                "grad_err_step1": g["grad_err_step1"],
                "leaf_err_step1": g["leaf_err_step1"],
                "leaf_err_step1_live": g["leaf_err_step1_live"],
                "leaf_abs_step1": g["leaf_abs_step1"],
                "by_leaf": g["by_leaf"],
                "lp_batch_bits_equal_across_ranks": lp_equal,
                "step_ms": [r[name]["step_ms"] for r in gloo],
                "peak_gb": [r[name]["peak_gb"] for r in gloo],
                "collectives_per_step": g["collectives"],
                "rgb_cuda_launches": [r[name]["launches"] for r in gloo],
                "front_launches": [r[name]["front_launches"]
                                   for r in gloo]})
        s = g0["serve"]
        hold(s["logit_err"] <= DIST_SERVE_TOL,
             f"dist serve: (1, 4) logits {s['logit_err']} off one card")
        lines.append({"phase": "dist", "run": "serve", "arch": DIST_ARCH,
                      "dtype": "float32", "world": DIST_GLOO_WORLD,
                      "mesh": [1, 4], "backend": g0["backend"],
                      "transport": g0["transport"],
                      "ranks_share_one_card": True,
                      "batch": DIST_SERVE_BATCH, "prompt": DIST_SERVE_PROMPT,
                      "decode_steps": DIST_SERVE_DECODE,
                      "logit_err": s["logit_err"], "tol": DIST_SERVE_TOL,
                      "ms": [r["serve"]["ms"] for r in gloo],
                      "peak_gb": [r["serve"]["peak_gb"] for r in gloo],
                      "collectives": s["collectives"]})
        lp = g0["lp_step"]
        hold(lp["bits_equal_one_rank"],
             "dist lp_step: the 2x2 solve differs in bits from one rank's")
        lines.append({"phase": "dist", "run": "lp_step", "method": "naive",
                      "B": PDHG_SHAPE[0], "m": PDHG_SHAPE[1],
                      "world": DIST_GLOO_WORLD, "mesh": [2, 2],
                      "backend": g0["backend"], "transport": g0["transport"],
                      "ranks_share_one_card": True,
                      "bits_equal_one_rank": lp["bits_equal_one_rank"],
                      "ms": [r["lp_step"]["ms"] for r in gloo],
                      "peak_gb": [r["lp_step"]["peak_gb"] for r in gloo],
                      "collectives": lp["collectives"]})
    seconds = time.perf_counter() - t0
    for line in lines:
        emit({**line, "card": card})
    emit({"phase": "dist", "run": "done", "seconds": seconds, "card": card})
    check(not failed, "; ".join(failed))
    gloo_counts = {"tp_dp": g0["tp_dp"]["collectives"],
                   "fsdp": g0["fsdp"]["collectives"],
                   "serve": g0["serve"]["collectives"]}
    return lp_batch, g0["tp_dp"]["launches"], seconds, gloo_counts


# ---------------------------------------------------------------------------
# The dry run (repro_torch.launch.dryrun): every arch x shape step on the
# 16x16 and 2x16x16 production meshes, run on meta tensors as rank 0 of a
# RecordingMesh, its collectives recorded and not issued; then its model of
# a step held against the card (peak memory, FLOPs, the kernel's one call)
# and against the real ranks of the dist phase (every collective).
# ---------------------------------------------------------------------------

DRYRUN_TIMEOUT_S = 600
DRYRUN_MEM_RTOL = 0.10       # predicted peak against max_memory_allocated
DRYRUN_DECODE_BATCH, DRYRUN_DECODE_CACHE = 8, 544   # lm_serve's shape
DRYRUN_CELLS, DRYRUN_SKIPPED = 80, 16


def _dryrun_sweep(card: str, name: str) -> list:
    """``python -m repro_torch.launch.dryrun --all`` (one process a core),
    ``--lp`` on both meshes, and qwen2-0.5b ``train_4k`` with the LP clip
    on 16x16: every record, each cell on its own line."""
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    jobs = max(1, min(8, os.cpu_count() or 1))
    out = str(dryrun.RESULTS_DIR / "dryrun.json")
    t0 = time.perf_counter()
    for argv in (["--all", "--jobs", str(jobs)], ["--lp"],
                 ["--lp", "--multi-pod"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--peaks", name, "--out", out], env=env, capture_output=True,
            text=True, timeout=DRYRUN_TIMEOUT_S)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-6000:] + proc.stderr[-6000:])
        check(proc.returncode == 0, f"dryrun {' '.join(argv)} exited "
              f"{proc.returncode}")
    sweep_s = time.perf_counter() - t0
    clip = dryrun.dryrun_cell(TRAIN_ARCH, "train_4k", peaks=name,
                              step_kwargs={"lp_clip": True},
                              variant="lp-clip", verbose=False)
    dryrun.write_records([clip], out)
    with open(out) as f:
        records = json.load(f)
    base = [r for r in records if not r["arch"].startswith("lp-")
            and r.get("variant", "baseline") == "baseline"]
    status = [r["status"] for r in base]
    for r in records:
        line = {"phase": "dryrun", "part": "sweep", "arch": r["arch"],
                "shape": r["shape"],
                "mesh": "2x16x16" if r["multi_pod"] else "16x16",
                "variant": r.get("variant", "baseline"),
                "status": r["status"], "card": card}
        if r["status"] == "ok":
            roof, mem = r["roofline"], r["memory"]
            line.update(
                argument_gb=mem["argument_bytes"] / 1e9,
                peak_gb=mem["peak_bytes"] / 1e9,
                memory_gb=roof["peaks"]["memory_bytes"] / 1e9,
                fits=mem["peak_bytes"] <= roof["peaks"]["memory_bytes"],
                t_compute_ms=roof["t_compute_s"] * 1e3,
                t_memory_ms=roof["t_memory_s"] * 1e3,
                t_collective_ms=roof["t_collective_s"] * 1e3,
                bottleneck=roof["bottleneck"],
                roofline_fraction=roof["roofline_fraction"],
                coll_by_op=roof["coll_by_op"],
                kernel_calls=r.get("kernel_calls"),
                meta_run_s=r["compile_s"])
        else:
            line["reason"] = r.get("reason") or r.get("error")
        emit(line)
    ok = [r for r in base if r["status"] == "ok"]
    emit({"phase": "dryrun", "part": "sweep_done", "cells": len(base),
          "ok": len(ok), "skipped": status.count("skipped"),
          "failed": status.count("FAIL"),
          "do_not_fit": [[r["arch"], r["shape"], r["multi_pod"]]
                         for r in ok if not r["fits"]],
          "sweep_s": sweep_s, "jobs": jobs, "records": out, "card": card})
    check(len(base) == DRYRUN_CELLS and status.count("FAIL") == 0
          and status.count("skipped") == DRYRUN_SKIPPED,
          f"dryrun sweep: {len(base)} cells, {status.count('FAIL')} FAIL, "
          f"{status.count('skipped')} skipped")
    check(all(r["memory"]["peak_bytes"] > 0 and r["roofline"]["coll_by_op"]
              for r in ok), "dryrun: a cell without a peak or collectives")
    lp = {(r["arch"], r["multi_pod"]): r for r in records
          if r["arch"].startswith("lp-")}
    check(all(lp[("lp-naive", mp)]["status"] == "ok"
              and lp[("lp-rgb", mp)]["status"] == "not_on_meta"
              for mp in (False, True)), f"dryrun --lp: {sorted(lp)}")
    check(clip["kernel_calls"] == {"repro_torch::rgb": 1},
          f"dryrun lp-clip: kernel calls {clip['kernel_calls']}")
    return records


def _card_peak(step, *args) -> tuple:
    """``step(*args)`` on the card: ``(max_memory_allocated after
    reset_peak_memory_stats, memory_allocated before)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step(*args)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), before


def _dryrun_vs_card(device, card: str, name: str) -> tuple:
    """(b) at world 1: the dry run of the train phase's LP-clipped step and
    of one lm_serve decode step (qwen2-0.5b, bf16, on a ``meta`` HostMesh)
    against the same steps on the card.  Returns the lines, the card
    step's LP batch and its rgb_cuda launches."""
    from repro_torch.configs import ARCHS, InputShape
    from repro_torch.data.pipeline import TokenSource, for_model
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import dryrun_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.optim import lp_clip as lp_clip_mod
    from repro_torch.roofline import count_call

    cfg = ARCHS[TRAIN_ARCH]
    meta = make_host_mesh(1, 1, device="meta")
    lines = []
    # the train step
    dry = dryrun_step(cfg, InputShape("train", "train", TRAIN_SEQ,
                                      TRAIN_BATCH), meta, peaks=name,
                      step_kwargs={"lp_clip": True})
    free_card()
    opt = AdamW()
    prog = steps.make_train_step(cfg, make_host_mesh(1, 1, device=device),
                                 opt, global_batch=TRAIN_BATCH, lp_clip=True)
    params = prog.model.init(torch.Generator(device=device).manual_seed(
        SEED))
    state = opt.init(params)
    src = TokenSource(for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in src.global_batch(0).items()}
    counted = count_call(prog.step, params, state, batch, {})
    seen = []
    real = lp_clip_mod.make_batch

    def spy(A, b, c, *a, **k):
        seen.append(tuple(t.detach().cpu().numpy() for t in (A, b, c)))
        return real(A, b, c, *a, **k)
    lp_clip_mod.make_batch = spy
    try:
        with Launches() as n:
            peak, before = _card_peak(prog.step, params, state, batch, {})
    finally:
        lp_clip_mod.make_batch = real
    launches = n.rgb
    n.check_front("dryrun's card step")
    lines.append(_dryrun_line("train", dry, peak, before, card, {
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": cfg.dtype,
        "count_call_flops": counted.flops, "count_call_ran_on":
        counted.ran_on, "rgb_cuda_launches": launches,
        "front_launches": n.counts()}))
    del prog, params, state, batch
    free_card()
    # one decode step
    B, S = DRYRUN_DECODE_BATCH, DRYRUN_DECODE_CACHE
    dry_d = dryrun_step(cfg, InputShape("decode", "decode", S, B), meta,
                        peaks=name)
    prog = steps.make_decode_step(cfg, make_host_mesh(1, 1, device=device),
                                  global_batch=B)
    params = prog.model.init(torch.Generator(device=device).manual_seed(
        SEED))
    cache = prog.model.init_cache(B, S)
    tok = {"token": torch.ones((B, 1), dtype=torch.int32, device=device),
           "pos": torch.full((B,), S - 32, dtype=torch.int32,
                             device=device)}
    peak_d, before_d = _card_peak(prog.step, params, tok, cache)
    lines.append(_dryrun_line("decode", dry_d, peak_d, before_d, card, {
        "batch": B, "cache": S, "dtype": cfg.dtype}))
    del prog, params, cache
    free_card()
    return lines, seen, launches


def _dryrun_line(step: str, dry: dict, peak: int, before: int, card: str,
                 extra: dict) -> dict:
    mem = dry["memory"]
    return {"phase": "dryrun", "part": "vs_card", "step": step,
            "arch": TRAIN_ARCH, "world": 1, **extra,
            "predicted_peak_bytes": mem["peak_bytes"],
            "max_memory_allocated": peak,
            "peak_rel_err": abs(mem["peak_bytes"] - peak) / peak,
            "predicted_argument_bytes": mem["argument_bytes"],
            "memory_allocated_before": before,
            "flops": dry["roofline"].flops,
            "kernel_calls": dry["kernel_calls"],
            "meta_run_s": dry["seconds"], "card": card}


def _dryrun_vs_ranks(card: str, gloo_counts: dict) -> list:
    """(c) the dist phase's gloo steps recorded on rank 0 of a 2x2 (and a
    (1, 4)) RecordingMesh on meta: every op's calls and bytes equal to
    what the real ranks counted."""
    from repro_torch import dist as D
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.launch.serve import pad_cache
    from repro_torch.optim import AdamW

    def meta(shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")
    lines = []
    for run, kw in (("tp_dp", {}), ("fsdp", {"fsdp": True})):
        opt = AdamW(lr=DIST_LR)
        prog = steps.make_train_step(
            _dist_cfg("float32", **kw), RecordingMesh(("data", "model"),
                                                      (2, 2)), opt,
            global_batch=DIST_GLOO_BATCH, lp_clip=True)
        params = prog.model.param_tree()
        bt = {k: meta((DIST_GLOO_BATCH, DIST_GLOO_SEQ))
              for k in ("tokens", "labels")}
        D.reset_counts()
        prog.step(params, opt.init(params), bt, {})
        lines.append((run, D.counts()))
    mesh = RecordingMesh(("data", "model"), (1, 4))
    cfg = _dist_cfg("float32")
    pre = steps.make_prefill_step(cfg, mesh, global_batch=DIST_SERVE_BATCH)
    dec = steps.make_decode_step(cfg, mesh, global_batch=DIST_SERVE_BATCH,
                                 model=pre.model)
    params = pre.model.param_tree()
    D.reset_counts()
    _, cache = pre.step(params, {"tokens": meta((DIST_SERVE_BATCH,
                                                 DIST_SERVE_PROMPT))})
    cache = pad_cache(cache, DIST_SERVE_DECODE)
    for _ in range(DIST_SERVE_DECODE):
        _, cache = dec.step(params, {"token": meta((DIST_SERVE_BATCH, 1)),
                                     "pos": meta((DIST_SERVE_BATCH,))},
                            cache)
    lines.append(("serve", D.counts()))
    out = []
    for run, rec in lines:
        out.append({"phase": "dryrun", "part": "vs_ranks", "run": run,
                    "arch": DIST_ARCH, "world": DIST_GLOO_WORLD,
                    "mesh": [1, 4] if run == "serve" else [2, 2],
                    "recorded": rec, "real_ranks": gloo_counts[run],
                    "equal": rec == gloo_counts[run], "card": card})
    return out


def phase_dryrun(device, card: str, gloo_counts: dict) -> dict:
    """(a) the sweep, (b) the dry run against the card at world 1, (c)
    the record transport against the dist phase's real ranks.  Every line
    is printed, then any failed check fails the phase.  Returns the card
    train step's LP batch, its rgb_cuda launches and the seconds."""
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    _dryrun_sweep(card, name)
    card_lines, seen, launches = _dryrun_vs_card(device, card, name)
    rank_lines = _dryrun_vs_ranks(card, gloo_counts)
    seconds = time.perf_counter() - t0
    for line in card_lines + rank_lines:
        emit(line)
    emit({"phase": "dryrun", "part": "done", "seconds": seconds,
          "card": card})
    train, decode = card_lines
    check(train["peak_rel_err"] <= DRYRUN_MEM_RTOL
          and decode["peak_rel_err"] <= DRYRUN_MEM_RTOL,
          f"dryrun: predicted peaks off the card's by "
          f"{train['peak_rel_err']} (train), {decode['peak_rel_err']} "
          f"(decode)")
    check(train["flops"] == train["count_call_flops"],
          f"dryrun FLOPs {train['flops']} != count_call's "
          f"{train['count_call_flops']}")
    check(train["kernel_calls"] == {"repro_torch::rgb": 1}
          and launches == 1 and len(seen) == 1,
          f"dryrun: {train['kernel_calls']} recorded, {launches} launches "
          f"on the card")
    bad = [ln["run"] for ln in rank_lines if not ln["equal"]]
    check(not bad, f"dryrun: recorded collectives differ from the real "
          f"ranks' on {bad}")
    return {"lp_batch": seen[0], "launches": launches, "seconds": seconds}

# ---------------------------------------------------------------------------
# 13. paper: the figure harness (benchmarks/pt_*)
# ---------------------------------------------------------------------------

PAPER_FIGS = ("fig3", "fig4", "fig5", "fig6", "fig7", "solver_sweep",
              "serve")
PAPER_OBJ_RTOL = 2e-4     # kernel objective against HiGHS's, of max(1, |obj|)
HILLCLIMB_TIMEOUT_S = 600
HILLCLIMB_STATUS = {"vma-transpose": "no_counterpart",
                    "weight-resident": "ok", "fused-psum": "ok"}


class PaperHold:
    """What the harness's rows solved: each kernel row's batch and spec,
    each fig4 batch (the figure has no kernel row) and HiGHS's
    objectives, by row prefix."""

    def __init__(self):
        self.kernel, self.fig4, self.scipy = [], [], {}

    def __call__(self, name, lp, spec, objectives=None):
        if spec is None:
            self.scipy[name.rsplit("/", 1)[0]] = objectives
        elif spec.backend == "kernel":
            self.kernel.append((name, lp, spec))
        elif name.startswith("fig4/") and spec.backend == "naive":
            self.fig4.append((name.rsplit("/", 1)[0], lp))


def _captured(fn, *args, **kw) -> tuple:
    """``fn(*args, **kw)``'s value and the lines it printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _split_lines(lines) -> dict:
    """A harness run's output: CSV rows as ``[name, us, derived]``, JSON
    rows, and the other lines."""
    rows, js, notes = [], [], []
    for ln in lines:
        if ln.startswith("JSON "):
            js.append(json.loads(ln[5:]))
        elif ln.startswith("{"):
            js.append(json.loads(ln))
        elif (ln.count(",") >= 2 and not ln.startswith("#")
              and ln != "name,us_per_call,derived"):
            name, us, derived = ln.split(",", 2)
            rows.append([name, float(us), derived])
        else:
            notes.append(ln)
    return {"rows": rows, "json": js, "notes": notes}


def _paper_drive(device, card: str, hold: PaperHold) -> dict:
    """The main path of the phase: every figure of ``pt_run --full
    --plain-quick``, the kernel on each fig4 batch and fig5's copies against
    the kernel's solve (the figures time naive and plain rgb only), the
    three ``--smoke`` modes, the hillclimb cells and the roofline report.
    Each part's output is printed as it ends."""
    from benchmarks import (pt_common, pt_fig5_transfer, pt_pack_layout,
                            pt_pdhg_crossover, pt_roofline_report, pt_run,
                            pt_tune_cli)
    from repro_torch.solver import SolverSpec

    out: dict = {"figures": {}, "fig4_kernel_s": {}, "fig5_kernel": [],
                 "seconds": {}}
    kernel = SolverSpec(backend="kernel", normalize=False)
    solver = kernel.build(device)

    def part(name, fn, *args, **kw):
        t0 = time.perf_counter()
        value, lines = _captured(fn, *args, **kw)
        dt = time.perf_counter() - t0
        out["seconds"][name] = dt
        got = _split_lines(lines)
        out["figures"][name] = got
        emit({"phase": "paper", "part": name, "seconds": dt, **got,
              "card": card})
        return value

    for fig in PAPER_FIGS:
        part(fig, pt_run.main, ["--full", "--plain-quick", "--only", fig],
             device=device, hold=hold)
        if fig == "fig4":
            for prefix, lp in hold.fig4:
                out["fig4_kernel_s"][prefix] = pt_common.time_fn(
                    solver.solve, lp, device=device)
                hold.kernel.append((prefix + "/kernel", lp, kernel))
        if fig == "fig5":  # the copies against the kernel's solve
            for B, m in pt_fig5_transfer.FULL_GRID:
                lp = pt_fig5_transfer.case(B, m, device)
                hA, hb, hc, hL = pt_fig5_transfer.host_arrays(lp)
                t = [pt_common.time_fn(pt_fig5_transfer.transfer, arrays,
                                       device, iters=5, device=device)
                     for arrays in ((hA, hb, hc), (hL, hc))]
                t_k = pt_common.time_fn(solver.solve, lp, device=device)
                out["fig5_kernel"].append({
                    "shape": f"fig5/b{B}/m{m}", "transfer_ms": t[0] * 1e3,
                    "transfer_packed_ms": t[1] * 1e3,
                    "kernel_solve_ms": t_k * 1e3,
                    "transfer_frac": t[0] / (t[0] + t_k),
                    "transfer_frac_packed": t[1] / (t[1] + t_k)})
                hold.kernel.append((f"fig5/b{B}/m{m}/kernel", lp, kernel))
    part("pack_layout", pt_pack_layout.run, smoke=True, device=device,
         hold=hold)
    part("pdhg_crossover", pt_pdhg_crossover.run, smoke=True, device=device,
         hold=hold)
    part("tune", pt_tune_cli.run, smoke=True, device=device)
    # the hillclimb cells as a user runs them, one process a cell
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.pt_hillclimb", "--peaks",
         torch.cuda.get_device_name(0), "--jobs", "3"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=HILLCLIMB_TIMEOUT_S)
    out["seconds"]["hillclimb"] = time.perf_counter() - t0
    if proc.returncode:
        sys.stderr.write(proc.stdout[-6000:] + proc.stderr[-6000:])
    check(proc.returncode == 0, f"pt_hillclimb exited {proc.returncode}")
    emit({"phase": "paper", "part": "hillclimb",
          "seconds": out["seconds"]["hillclimb"],
          "lines": proc.stdout.splitlines()[-40:], "card": card})
    out["report"] = part("roofline_report", pt_roofline_report.main)
    return out


def _paper_checks(device, hold: PaperHold) -> list:
    """Each kernel row's batch against the naive backend on the same batch
    (``feasible`` equal, ``x`` within 1e-4), and where HiGHS ran, its
    objective within 2e-4 of max(1, |obj|)."""
    lines = []
    for name, lp, spec in hold.kernel:
        k = spec.build(device).solve(lp)
        n = dataclasses.replace(spec, backend="naive").build(
            device).solve(lp)
        ok = n.feasible
        line = {"phase": "paper", "part": "check", "row": name,
                "batch": lp.batch,
                "feasible_mismatches": int((k.feasible != ok).sum()),
                "max_abs_err_vs_naive": float(
                    (k.x[ok] - n.x[ok]).abs().max()) if bool(ok.any())
                else 0.0}
        obj = hold.scipy.get(name.rsplit("/", 1)[0])
        if obj is not None:
            got = k.objective[:len(obj)].double().cpu().numpy()
            kf = k.feasible[:len(obj)].cpu().numpy()
            sf = ~np.isnan(obj)
            line["scipy_problems"] = len(obj)
            line["scipy_feasible_mismatches"] = int((kf != sf).sum())
            line["scipy_obj_rel_err"] = float(
                (np.abs(got[sf] - obj[sf])
                 / np.maximum(1.0, np.abs(obj[sf]))).max()) if sf.any() \
                else 0.0
        lines.append(line)
    return lines


def _per_lp(rows: list) -> dict:
    """``{row name: µs per LP}`` of the ``fig3``/``fig4`` rows (batch from
    the name)."""
    out = {}
    for name, us, _ in rows:
        B = int(re.search(r"/b(\d+)", name).group(1))
        out[name] = us / B
    return out


def _paper_summaries(drive: dict, card: str, host: str) -> list:
    """One line per fig3 / fig4 shape: µs per LP of kernel, naive, plain
    rgb and HiGHS (the host CPU's), and the kernel's ratio to each; one
    line per fig5 shape: the host-to-device copies against the kernel's
    solve of the batch; one line per pdhg_crossover m: kernel against
    pdhg."""
    figs = drive["figures"]
    per = _per_lp(figs["fig3"]["rows"] + figs["fig4"]["rows"])
    for prefix, s in drive["fig4_kernel_s"].items():
        B = int(re.search(r"/b(\d+)", prefix).group(1))
        per[prefix + "/kernel"] = s * 1e6 / B
    prefixes = sorted({n.rsplit("/", 1)[0] for n in per},
                      key=lambda p: [int(v) for v in re.findall(r"\d+", p)])
    lines = []
    for p in prefixes:
        us = {m: per.get(f"{p}/{m}")
              for m in ("kernel", "naive", "rgb", "scipy-highs")}
        k = us["kernel"]
        lines.append({
            "phase": "paper", "part": "summary", "shape": p,
            "us_per_lp": us,
            "kernel_speedup": {m: (v / k if k and v else None)
                               for m, v in us.items() if m != "kernel"},
            "fig4_kernel": "timed by this phase on the figure's batch"
            if p.startswith("fig4/") else None,
            "card": card, "host_cpu": host})
    for row in drive["fig5_kernel"]:
        lines.append({"phase": "paper", "part": "fig5_kernel", **row,
                      "card": card})
    by_m: dict = {}
    for r in figs["pdhg_crossover"]["json"]:
        by_m.setdefault(r["m"], {})[r["backend"]] = r["us_per_lp"]
    for m, v in sorted(by_m.items()):
        lines.append({"phase": "paper", "part": "kernel_vs_pdhg", "m": m,
                      "batch": figs["pdhg_crossover"]["json"][0]["batch"],
                      "us_per_lp": v,
                      "pdhg_over_kernel": v["pdhg"] / v["kernel"],
                      "card": card})
    return lines


def phase_paper(device, card: str) -> dict:
    """The paper's figure harness on the card (``benchmarks/pt_*``), each
    kernel row held against naive and HiGHS, the geometries it launched
    ``rgb_cuda`` at counted.  Needs the dry-run records the ``dryrun``
    phase wrote."""
    from benchmarks.pt_common import host_cpu
    from repro_torch.kernels.batch_lp import rgb_cuda
    from repro_torch.launch.dryrun import RESULTS_DIR

    check((RESULTS_DIR / "dryrun.json").exists(),
          "paper: no dry-run records to report on")
    hold = PaperHold()
    t0 = time.perf_counter()
    rgb_cuda.geometries.clear()
    with Launches() as n:
        drive = _paper_drive(device, card, hold)
    launches, geometries = n.rgb, dict(rgb_cuda.geometries)
    drive_s = time.perf_counter() - t0
    checks = _paper_checks(device, hold)
    for line in checks + _paper_summaries(drive, card, host_cpu()):
        emit(line)
    bad = [c["row"] for c in checks
           if c["feasible_mismatches"]
           or c["max_abs_err_vs_naive"] > X_TOL["float32"]
           or c.get("scipy_feasible_mismatches")
           or c.get("scipy_obj_rel_err", 0.0) > PAPER_OBJ_RTOL]
    check(not bad, f"paper: kernel rows off naive or HiGHS: {bad}")
    check(len(checks) >= 20, f"paper: only {len(checks)} kernel rows held")
    with open(RESULTS_DIR / "dryrun.json") as f:
        variants = {(r["arch"], r["shape"], r["variant"]): r["status"]
                    for r in json.load(f)
                    if r.get("variant", "baseline") != "baseline"
                    and r["variant"] in HILLCLIMB_STATUS}
    check(len(variants) == 5 and all(
        st == HILLCLIMB_STATUS[k[2]] for k, st in variants.items()),
        f"paper: hillclimb cells {variants}")
    report = "\n".join(drive["report"])
    check("FAILED=0" in report and "| FAILED |" not in report
          and report.count("| no counterpart |") == 2,
          "paper: the roofline report shows a failed cell")
    check(launches == sum(geometries.values()) and launches > 0,
          f"paper: {launches} launches, by geometry {geometries}")
    n.check_front("paper")
    emit({"phase": "paper", "part": "done", "seconds":
          time.perf_counter() - t0, "drive_s": drive_s,
          "by_part_s": drive["seconds"], "rgb_cuda_launches": launches,
          "front_launches": n.counts(),
          "geometries": len(geometries), "kernel_rows_held": len(checks),
          "card": card})
    return {"geometries": geometries, "launches": launches}


def phase_paper_kernels(device, card: str, geometries: dict) -> list:
    """A ``kernels`` entry (``path="paper"``) for every geometry the paper
    phase launched ``rgb_cuda`` at, held against ``rgb_plain`` on a mixed
    and a feasible batch of that shape, with its launch count."""
    entries = []
    for i, ((B, m_pad, dtype, tile), n) in enumerate(
            sorted(geometries.items())):
        inputs = check_inputs(np.random.default_rng([SEED, 13, i]), B, m_pad)
        e = hold_and_time(device, card, inputs, B, m_pad, dtype, tile, 0,
                          "paper", {})
        e["launches"] = n
        entries.append(e)
    return entries


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--dist-rank":
        return dist_rank_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script "
              "measures the port on the card and does not run without "
              "one", file=sys.stderr)
        return 2
    from repro_torch.device import card_info, default_device, default_devices
    from repro_torch.kernels.batch_lp import LANE, rgb_cuda
    from repro_torch.roofline import peaks_for
    from repro_torch.solver import SolverSpec

    global PEAKS
    device = default_device()
    card = card_info()
    t_start = time.perf_counter()
    try:
        check(card is not None,
              "nvidia-smi did not give the card's name and power limit, "
              "which every number printed here must carry")
        PEAKS = peaks_for(torch.cuda.get_device_name(0))
        phase_probe(card)
        phase_build(card)
        entries = phase_kernels(device, card)
        rgb_cuda.launches = 0
        phase_solver(device, card, entries)
        phase_front(device, card)
        phase_crowd_grid(device, card)
        serve = phase_serve(default_devices(), card)
        phase_pdhg(device, card)
        phase_tune(device, card)
        rpc = phase_rpc(default_devices()[:1], card)
        bench = phase_bench(default_devices()[:1], card)
        crowd, crowd_lp = phase_crowd(device, card)
        quick = phase_quickstart(device, card)
        train, lp_batch = phase_train(device, card)
        train_ssm, lp_batch_ssm = phase_train_ssm(device, card)
        phase_lm_serve(device, card)
        dist_lp, dist_launches, _, gloo_counts = phase_dist(device, card)
        dry = phase_dryrun(device, card, gloo_counts)
        paper = phase_paper(device, card)
        # Launches made from here on compare and time; the counts of the
        # main path have been read.
        entries.append(phase_train_kernel(device, card, lp_batch,
                                          train["launches"]))
        entries.append(phase_train_kernel(device, card, lp_batch_ssm,
                                          train_ssm["launches"],
                                          path="train-mamba2"))
        entries.append(phase_train_kernel(device, card, dist_lp,
                                          dist_launches, path="dist"))
        entries.append(phase_train_kernel(device, card, dry["lp_batch"],
                                          dry["launches"], path="dryrun"))
        entries += phase_paper_kernels(device, card, paper["geometries"])
        entries += phase_serve_kernels(device, card, serve["exec_specs"])
        entries += phase_serve_kernels(device, card, rpc["exec_specs"],
                                       path="rpc")
        entries += phase_serve_kernels(device, card, bench["exec_specs"],
                                       path="bench")
        e = hold_and_time(device, card, (crowd_lp, crowd_lp),
                          CROWD_AGENTS, LANE, "float32", crowd["tile"],
                          crowd["chunk"], "crowd", {}, M=crowd["M"])
        e["launches"] = crowd["launches_direct"] + crowd["launches_served"]
        entries.append(e)
        qb, qm = quick["batch"], quick["m"]
        q_tile = SolverSpec(backend="kernel").resolve_for_shape(
            qm, qb, platform="cuda").tile
        e = hold_and_time(device, card, check_inputs(
            np.random.default_rng([SEED, 10]), qb, qm), qb, qm, "float32",
            q_tile, 0, "quickstart", {})
        e["launches"] = quick["launches"]
        entries.append(e)
        for e in entries:
            check(e["launches"] > 0,
                  f"the main path never launched {e['name']} "
                  f"{e['dtype']} chunk={e['chunk']} {e['shape']}")
        check(serve["launches"] > 0, "the serving path launched no kernel")
        check(rpc["launches"] > 0, "the RPC path launched no kernel")
        check(train["launches"] == RESUME_STEPS,
              "the training path did not launch the kernel once a step")
        check(train_ssm["launches"] == TRAIN_SSM_STEPS,
              "the mamba2 training path did not launch the kernel once a "
              "step")
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
