"""Opt-in profiler hooks that line device traces up with host spans.

* :func:`annotation` is a context manager that opens an NVTX range
  (``torch.cuda.nvtx.range``) named like the host span when a CUDA device
  is in use, so the per-launch dispatch shows up as a labelled region in
  a device profile (``torch.profiler``, Nsight).  Where there is no card
  — or NVTX is unavailable in this build of PyTorch — it is a null
  context: the CPU has no device timeline to label.
* :class:`ProfileSession` brackets a whole run with ``torch.profiler``
  (CPU activity, and CUDA activity when a card is visible) and writes a
  Chrome trace into its ``log_dir`` on :meth:`~ProfileSession.stop`
  (``python -m repro_torch.serve_lp.rpc --profile-dir``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

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


class ProfileSession:
    """Start/stop a ``torch.profiler`` trace around a run.

    ``start()`` returns False (and profiles nothing) without a
    ``log_dir`` or when already started; ``stop()`` exports the trace as
    ``log_dir/profile-<pid>-<unix ms>.json`` (Chrome trace format, which
    Perfetto loads), records the path in :attr:`trace_path`, and
    tolerates never-started and double-stop so shutdown paths can call
    it unconditionally.
    """

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.active = False
        self.trace_path: Optional[str] = None
        self._prof = None

    def start(self) -> bool:
        if not self.log_dir or self.active:
            return False
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self.active = True
        return True

    def stop(self) -> bool:
        if not self.active:
            return False
        self.active = False
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(
            self.log_dir,
            f"profile-{os.getpid()}-{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        return True

    def __enter__(self) -> "ProfileSession":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
