"""The card's published peaks and the bytes a solve needs: the roofline's
two sides, kept with the benchmark so that they do not move with the
program.

Peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit
(dense rates, no sparsity); a card set below that limit runs slower, which
is why every run prints the card's name.  The bytes are those the inputs
need, each read or written once, counted from the constraints a batch
holds, not from its padding.
"""
from __future__ import annotations

# H100 SXM, 80 GB HBM3.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
BF16_FLOPS = 989e12

ITEMSIZE = {"float32": 4, "float64": 8}


def kernel_bytes(n_problems: int, constraints: int, dtype: str) -> int:
    """The kernel's side: three values (a_x, a_y, b) of each constraint the
    batch holds, and each problem's objective ``c``, valid count
    (int32), answer ``x`` and flag (int32)."""
    item = ITEMSIZE[dtype]
    return 3 * constraints * item + n_problems * (2 * item + 4 + 2 * item + 4)


def solve_bytes(n_problems: int, constraints: int, dtype: str) -> int:
    """A whole ``Solver.solve`` call: the kernel's bytes and each problem's
    objective, written once."""
    return kernel_bytes(n_problems, constraints, dtype) + \
        n_problems * ITEMSIZE[dtype]


def roofline_share(nbytes: float, device_s: float) -> float:
    """Per cent of the memory roofline: the least time the bytes need at
    the peak rate, over the time the device took."""
    return 100.0 * nbytes / HBM_BYTES_S / device_s
