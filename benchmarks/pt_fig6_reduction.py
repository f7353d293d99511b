"""Paper Figure 6 on the port: accumulation strategy vs contention.

The PyTorch twin of ``benchmarks/fig6_reduction.py``.  The paper compares
shared-memory atomics, global atomics and a CUB segmented reduction for the
``u_left``/``u_right`` folds; the reference's candidates, and these, are
the array-level strategies (plain torch ops here, no kernel of the port's):

  * masked-min  — ``amin`` over a dense (contention-wide) axis (what the
    RGB kernel's re-solve does),
  * segment-min — ``scatter_reduce(..., "amin")`` scatter-style,
  * sort-min    — stable argsort by segment, then the same scatter.

Contention = elements reducing into one output (the paper's x-axis,
2..512).
"""
from __future__ import annotations

import torch

from benchmarks.pt_common import emit, generator, time_fn
from repro_torch.device import as_device

N = 1 << 16


def reductions(n_seg: int, c: int, device):
    """``{name: fn}``: each maps ``v (N,)`` to its ``n_seg`` segment
    minima (segment ``i`` = elements ``i*c .. i*c + c - 1``)."""
    seg = torch.arange(n_seg, device=device).repeat_interleave(c)

    def masked_min(v):
        return v.reshape(n_seg, c).amin(dim=1)

    def segment_min(v):
        return torch.zeros(n_seg, dtype=v.dtype, device=v.device
                           ).scatter_reduce(0, seg, v, "amin",
                                            include_self=False)

    def sort_min(v):
        order = torch.argsort(seg, stable=True)
        return torch.zeros(n_seg, dtype=v.dtype, device=v.device
                           ).scatter_reduce(0, seg[order], v[order], "amin",
                                            include_self=False)

    return {"masked-min": masked_min, "segment-min": segment_min,
            "sort-min": sort_min}


def run(full: bool = False, *, device=None):
    device = as_device(device)
    rows = []
    contentions = (2, 8, 32, 128, 512) if full else (2, 32, 512)
    x = torch.rand((N,), generator=generator(0, device), device=device)
    for c in contentions:
        for name, fn in reductions(N // c, c, device).items():
            dt = time_fn(fn, x, iters=5, device=device)
            rows.append(emit(f"fig6/contention{c}/{name}", dt,
                             f"elems_per_us={N/(dt*1e6):.0f}"))
    return rows


if __name__ == "__main__":
    run(full=True)
