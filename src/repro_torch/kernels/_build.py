"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface, is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` (the hash is of
the source text and the flags, so an edited source never loads a stale
library) and is loaded with :mod:`ctypes`.  No PyTorch header is
included, so a build takes seconds.  Nothing here runs at import: the
first kernel launch builds, later launches reuse the loaded library.

A failed build raises :class:`KernelBuildError` carrying ``nvcc``'s
output; there is no fallback.  ``ptxas -v``'s report (registers, shared
memory, spills per kernel) is kept beside the library as ``.log`` and
returned by :func:`build_log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).with_name("csrc")

# No -use_fast_math; --fmad=false so every product and sum rounds on its
# own, as the plain PyTorch versions' separate ops do — kernel and plain
# version are then expected to agree to the last bit (but for the sign of
# a zero where +0 and -0 tie in a min or max).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# Environment override for the build directory.
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch`` at the root
    of a source checkout (``src/repro_torch/kernels/`` three levels
    down), else under the working directory for an installed package."""
    env = os.environ.get(ENV_BUILD_DIR)
    if env:
        return Path(env)
    src = Path(__file__).resolve().parents[2]
    root = src.parent if src.name == "src" else Path.cwd()
    return root / "build" / "repro_torch"


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, the ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(Path(os.environ[var]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built here")


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise KernelBuildError(f"no kernel source {src}")
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = f"{name}-{h.hexdigest()[:16]}"
    d = build_dir()
    return src, d / f"{stem}.so", d / f"{stem}.log"


def load(name: str) -> ctypes.CDLL:
    """The shared library for ``csrc/<name>.cu``, built if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src, so, log = _paths(name)
        if not so.is_file():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            _build_seconds[name] = time.perf_counter() - t0
            if r.returncode != 0 or not tmp.is_file():
                raise KernelBuildError(
                    f"nvcc failed for {src.name} (exit {r.returncode}):\n"
                    f"$ {' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
            log.write_text(r.stdout + r.stderr)
            os.replace(tmp, so)
        lib = _libs[name] = ctypes.CDLL(str(so))
        return lib


def build_seconds(name: str) -> Optional[float]:
    """Seconds ``nvcc`` took for ``name`` in this process (``None`` when
    the library was already built)."""
    return _build_seconds.get(name)


def build_log(name: str) -> str:
    """``nvcc``/``ptxas -v`` output of the build of ``name``."""
    _, _, log = _paths(name)
    return log.read_text() if log.is_file() else ""


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads")


def kernel_resources(name: str) -> List[dict]:
    """Registers, static shared memory and spills per kernel, parsed from
    the ``ptxas -v`` report of ``name``'s build."""
    out: List[dict] = []
    cur: Optional[dict] = None
    for line in build_log(name).splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur = {"kernel": m.group(1), "registers": None,
                   "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"] = int(m.group(2))
            cur["spill_loads"] = int(m.group(3))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _PTXAS_SMEM.search(line)
            if s:
                cur["smem_bytes"] = int(s.group(1))
    return out
