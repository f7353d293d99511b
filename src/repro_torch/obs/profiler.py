"""Opt-in profiler hooks that line device traces up with host spans.

:func:`annotation` is a context manager that opens an NVTX range
(``torch.cuda.nvtx.range``) named like the host span when a CUDA device
is in use, so the per-launch dispatch shows up as a labelled region in a
device profile (``torch.profiler``, Nsight).  Where there is no card — or
NVTX is unavailable in this build of PyTorch — it is a null context: the
CPU has no device timeline to label.

The reference's ``ProfileSession`` (start/stop of a whole-run profiler
trace) is not ported yet; it arrives with the RPC front end that owns
its command-line flag.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def available() -> bool:
    """True when annotations reach a device profiler (a card is visible)."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def annotation(name: str) -> Iterator[None]:
    """``torch.cuda.nvtx.range(name)`` on a card, else a no-op block."""
    if not torch.cuda.is_available():
        yield
        return
    try:
        cm = torch.cuda.nvtx.range(name)
    except Exception:   # NVTX missing from this build: label nothing
        yield
        return
    with cm:
        yield
