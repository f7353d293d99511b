"""The crowd's neighbour query on a card: the wrapper of ``csrc/crowd_grid.cu``.

``neighbours_cuda`` launches the hand-written CUDA C++ kernel (built by
:mod:`._build` into its own library at the first call, loaded with ctypes):
from the agents sorted by grid cell, every agent of each agent's nine cells
is tested and the ``k`` nearest within the radius are kept, with no capacity
a cell.  Its plain version is ``repro_torch.crowd.grid.neighbours_plain``
(the capped gather, the top-k and the exact second pass); the two agree in
every bit wherever the plain version places every agent.  The kernel
replaces no TPU kernel: the crowd exists only in the port.

Only the crowd's first call on a card builds and loads the library, so
nothing else compiles it.  ``neighbours_cuda.launches`` counts the kernel's
launches, eager or replayed from a CUDA graph (:func:`add_launches`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

# The most neighbours one launch keeps (the kernel's register array, KMAX in
# the source).
MAX_K = 16

_lock = threading.Lock()
_bound = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 3 + [ctypes.c_double, _P]


def _launcher():
    """The library's entry point, built and bound at the first call."""
    fn = _bound.get("neighbours")
    if fn is not None:
        return fn
    from repro_torch.kernels import _build
    lib = _build.load("crowd_grid")
    fn = lib.crowd_neighbours_launch_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.crowd_grid_error_string.argtypes = [ctypes.c_int]
    lib.crowd_grid_error_string.restype = ctypes.c_char_p
    _bound["error_string"] = lib.crowd_grid_error_string
    _bound["neighbours"] = fn
    return fn


def _check(pos, cell, order, start, counts, grid: int, k: int) -> None:
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"neighbours_cuda: unsupported device {dev}")
    if pos.dtype != torch.float32:
        raise TypeError(f"neighbours_cuda: positions must be float32, got "
                        f"{pos.dtype}")
    n = pos.shape[0]
    want = {"pos": (pos, (n, 2), torch.float32),
            "cell": (cell, (n,), torch.int64),
            "order": (order, (n,), torch.int64),
            "start": (start, (grid * grid,), torch.int64),
            "counts": (counts, (grid * grid,), torch.int64)}
    for key, (t, shape, dt) in want.items():
        if (t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(
                f"neighbours_cuda: {key} must be {shape} {dt} and "
                f"contiguous on {dev}; got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, contiguous {t.is_contiguous()}")
    if pos.data_ptr() % 8:
        raise ValueError("neighbours_cuda: pos must be 8-byte aligned")
    if not 1 <= k <= MAX_K or grid < 1 or n >= 2 ** 31:
        raise ValueError(f"neighbours_cuda: want 1 <= k <= {MAX_K}, a grid "
                         f"of at least one cell and under 2^31 agents; got "
                         f"k {k}, grid {grid}, {n} agents")


def neighbours_cuda(pos: torch.Tensor, cell: torch.Tensor,
                    order: torch.Tensor, start: torch.Tensor,
                    counts: torch.Tensor, *, grid: int, dist: float, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(idx (N, k) int64, valid (N, k) bool, count (N,) int64)``: the
    ``k`` nearest agents ``j != i`` with ``|p_j - p_i|^2 < dist^2`` of every
    agent of ``pos (N, 2)`` float32, nearest first, ties by index, filled
    from the front (an empty slot holds 0 and is not valid).

    ``cell`` is each agent's cell ``y * grid + x``, ``order`` the agents
    sorted by cell, ``start`` and ``counts`` (``grid^2``) each cell's first
    sorted position and its agents: every agent of the nine cells around an
    agent's own is tested.  Enqueued on PyTorch's current stream of the
    tensors' card without synchronising; a refused launch raises, and so does
    any tensor that is not on a card, not float32 positions, or not
    contiguous."""
    _check(pos, cell, order, start, counts, grid, k)
    n, dev = pos.shape[0], pos.device
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    count = torch.empty((n,), dtype=torch.int64, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        code = fn(pos.data_ptr(), order.data_ptr(), cell.data_ptr(),
                  start.data_ptr(), counts.data_ptr(), idx.data_ptr(),
                  valid.data_ptr(), count.data_ptr(), n, grid, k,
                  float(dist) * float(dist),
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        msg = _bound["error_string"](code).decode(errors="replace")
        raise RuntimeError(f"neighbours_cuda: launch refused (cuda error "
                           f"{code}: {msg}) for {n} agents, grid {grid}, "
                           f"k {k}")
    add_launches(1)
    return idx, valid, count


def add_launches(n: int) -> None:
    """Add ``n`` launches to ``neighbours_cuda.launches``: a CUDA graph's
    replay launches what its capture counted without calling the wrapper."""
    with _lock:
        neighbours_cuda.launches += n


# Kernel launches made by this process (plain-version calls do not count).
neighbours_cuda.launches = 0
