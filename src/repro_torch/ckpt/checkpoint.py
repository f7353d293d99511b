"""Checkpointing with async save and atomic commit, in the reference's
on-disk format.

Layout (one directory per step), the same as ``repro.ckpt.checkpoint``'s:

    <root>/step_000042/
        manifest.json     # step, flat leaf paths, shapes, dtypes, meta
        <path>.npy        # one .npy per leaf (slash paths joined by "__")
    <root>/LATEST         # atomically-updated pointer file

A checkpoint written by either package loads in the other:

* **bfloat16** leaves are written as numpy void ``V2`` words (what
  ``np.save`` makes of the reference's ``ml_dtypes`` arrays) with the
  manifest's dtype string ``"bfloat16"``; a ``V2`` leaf is read back as
  raw 16-bit words reinterpreted with ``torch.Tensor.view``.  numpy has no
  bfloat16 of its own and this module never imports ``ml_dtypes``.
* **atomicity** — writes go to ``step_N.tmp/`` and are renamed into
  place; the LATEST pointer is updated last via atomic rename.  A crash
  mid-save never corrupts the previous checkpoint.
* **async** — save() copies the leaves to host memory (pinned, from a
  card), then returns; a daemon thread writes them.  wait() joins (called
  before the next save).
* garbage collection keeps the newest ``keep`` step directories.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_with_paths

# torch dtype -> the numpy dtype name the reference writes in manifests.
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int32: "int32", torch.int64: "int64",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool"}


def _host_copy(x) -> torch.Tensor:
    """A copy of a tensor leaf in host memory — a copy even on the CPU: training
    goes on updating the parameters in place while the daemon thread
    writes.  From a card the copy is asynchronous into pinned memory
    (PyTorch's caching host allocator, so later saves reuse the pages);
    the caller synchronises before reading it."""
    x = x.detach()
    if x.device.type == "cuda":
        return x.to("cpu", non_blocking=True)
    return x.to("cpu", copy=True)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array the reference would save:
    bfloat16 as void 2-byte words, everything else in its own dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if dtype_name != "bfloat16":
            raise ValueError(f"a void leaf whose manifest dtype is "
                             f"{dtype_name!r}, not bfloat16")
        return torch.from_numpy(arr.view(np.int16).copy()
                                ).view(torch.bfloat16)
    # np.ascontiguousarray would make a 0-d leaf (AdamWState.step) 1-d
    return torch.from_numpy(np.require(arr, requirements="C"))


class Checkpointer:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, params, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot (the device->host copy happens HERE, synchronously);
        disk IO happens on the daemon thread unless blocking=True."""
        self.wait()
        flat = flatten_with_paths(params)
        copies = {k: _host_copy(v) for k, v in flat.items()}
        if any(v.device.type == "cuda" for v in flat.values()):
            torch.cuda.synchronize()
        host = {k: _as_numpy(v) for k, v in copies.items()}
        meta = {"step": step, "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape),
                               "dtype": _DTYPE_NAMES[v.dtype]}
                           for k, v in flat.items()}}

        def work():
            self._write(step, host, meta)

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: Dict):
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for k, v in host.items():
            fp = tmp / (k.replace("/", "__") + ".npy")
            np.save(fp, v)
        (tmp / "manifest.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        # atomic LATEST pointer
        ptr = self.root / "LATEST.tmp"
        ptr.write_text(final.name)
        os.rename(ptr, self.root / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(p for p in self.root.glob("step_????????")
                       if p.is_dir())
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- load ---------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        ptr = self.root / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.root / name / "manifest.json").exists():
            return None
        return int(name.split("_")[1])

    def load(self, like, step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like`` (a tree of tensors, or
        of ``device="meta"`` stand-ins): each leaf takes the dtype of its
        ``like`` leaf and lies on its device (the CPU for a meta leaf).
        Returns ``(tree, extra)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = self.root / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        out = {}
        for k, ref in flatten_with_paths(like).items():
            arr = np.load(d / (k.replace("/", "__") + ".npy"))
            t = _from_host(arr, meta["leaves"][k]["dtype"])
            dev = ref.device if ref.device.type != "meta" else "cpu"
            out[k] = t.to(device=dev, dtype=ref.dtype)
        return unflatten_with_paths(out, like), meta["extra"]
