"""Shared benchmark utilities of the PyTorch port's figure harness: wall-clock
timing of a call on the device it runs on, CSV emission, seeded generators.

The port's twin of ``benchmarks/common.py``.  On a card every warm-up and
every timed call ends with ``torch.cuda.synchronize``: a host clock around
an asynchronous launch alone would time the launch, not the work.
"""
from __future__ import annotations

import os
import platform
import time
from typing import Callable

import torch

from repro_torch.device import DeviceLike, as_device


def sync(device: DeviceLike) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    device = as_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
            device: DeviceLike = None, **kw) -> float:
    """Median wall-time (seconds) of ``fn(*args, **kw)``, each call
    followed by a synchronise of ``device`` (default: the card)."""
    device = as_device(device)
    for _ in range(warmup):
        fn(*args, **kw)
        sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def emit(name: str, seconds: float, derived: str = "") -> str:
    line = f"{name},{seconds*1e6:.1f},{derived}"
    print(line, flush=True)
    return line


def generator(seed: int, device: DeviceLike) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with one of the
    reference's ``jax.random.key`` integers (the streams differ: only the
    seed carries over)."""
    return torch.Generator(device=as_device(device)).manual_seed(seed)


def host_cpu() -> str:
    """The host CPU's ``model name`` from ``/proc/cpuinfo`` (commas
    dropped, so it fits a CSV field); where the host hides it (``unknown``,
    as some virtual machines do), its vendor, family and model numbers;
    and the cores this process sees."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown":
        name = (f"{info.get('vendor_id', platform.machine())} family "
                f"{info.get('cpu family', '?')} model "
                f"{info.get('model', '?')}")
    return f"{name.replace(',', ' ')} ({os.cpu_count()} cores)"


def plain_timing(plain_quick: bool) -> dict:
    """``time_fn``'s ``warmup`` and ``iters`` for a plain ``rgb`` row: the
    reference's (one warm-up, the median of three), or with
    ``plain_quick`` one timed call (such a call takes seconds on a card and
    compiles nothing, so a warm-up buys little)."""
    return {"warmup": 0, "iters": 1} if plain_quick else {}


def shapes(full_grid, quick_grid, full: bool, plain_quick: bool = False):
    """The shapes a run visits, in the reference's loop order, each with
    whether its plain ``rgb`` rows run there: the quick grid, or the full
    one; with ``plain_quick`` the full grid and the quick one together,
    the plain rows at the quick grid's shapes only (on a card the plain
    backend's Python loop over tiles syncs at every constraint step, so
    its rows at the full grid's large shapes take minutes)."""
    if not full:
        return [(s, True) for s in quick_grid]
    if not plain_quick:
        return [(s, True) for s in full_grid]
    return [(s, s in set(quick_grid))
            for s in sorted(set(full_grid) | set(quick_grid))]
