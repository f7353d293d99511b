"""Fault tolerance: heartbeat, straggler detection, supervised restart.

On a real multi-pod deployment each host runs the trainer under
this supervisor.  The failure model (matching TPU-pod operational
reality) is fail-stop per slice: a host that dies or stalls takes its
slice out, and recovery is restart-from-checkpoint of the job (possibly
on fewer/more slices — the checkpoint is mesh-independent, see
ckpt.checkpoint).  What this module provides:

  * ``Heartbeat`` — step + wall-time progress file, atomically updated.
  * ``StragglerMonitor`` — EWMA of step times; flags steps slower than
    ``threshold`` x the running median so the trainer can log/alert (on a
    real pod: trigger preemptive re-slicing before a hard timeout).
  * ``Supervisor`` — runs the trainer as a subprocess, watches the
    heartbeat, kills and relaunches from the latest checkpoint when the
    heartbeat stalls or the process dies.  Bounded restarts.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import List, Optional


class Heartbeat:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"step": step, "t": time.time()}))
        os.rename(tmp, self.path)

    def read(self) -> Optional[dict]:
        try:
            return json.loads(self.path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def age(self) -> float:
        hb = self.read()
        return time.time() - hb["t"] if hb else float("inf")


class StragglerMonitor:
    """Flags abnormally slow steps (gray failure / straggling host)."""

    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.times: deque = deque(maxlen=window)
        self.flagged: List[int] = []

    def record(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.threshold * med
            if slow:
                self.flagged.append(step)
        self.times.append(dt)
        return slow

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]


class Supervisor:
    """Restart-from-checkpoint supervision of a trainer."""

    def __init__(self, cmd: List[str], heartbeat_path: str | Path,
                 stall_timeout: float = 300.0, max_restarts: int = 10,
                 poll: float = 2.0):
        self.cmd = cmd
        self.hb = Heartbeat(heartbeat_path)
        self.stall_timeout = stall_timeout
        self.max_restarts = max_restarts
        self.poll = poll
        self.restarts = 0

    def run(self) -> int:
        while True:
            proc = subprocess.Popen(self.cmd, stdout=sys.stdout,
                                    stderr=sys.stderr)
            rc = self._watch(proc)
            if rc == 0:
                return 0
            self.restarts += 1
            if self.restarts > self.max_restarts:
                print(f"[supervisor] giving up after {self.restarts - 1} "
                      f"restarts", flush=True)
                return rc or 1
            print(f"[supervisor] relaunching (restart {self.restarts}); "
                  f"trainer resumes from the latest checkpoint", flush=True)

    def _watch(self, proc: subprocess.Popen) -> int:
        start = time.time()
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc != 0:
                    print(f"[supervisor] trainer died rc={rc}", flush=True)
                return rc
            age = self.hb.age()
            if age == float("inf"):
                # grace period before the first beat (compile time etc.)
                age = time.time() - start
            if age > self.stall_timeout:
                print(f"[supervisor] heartbeat stalled "
                      f"({age:.0f}s) — killing the trainer", flush=True)
                proc.kill()
                proc.wait()
                return -9
            time.sleep(self.poll)
