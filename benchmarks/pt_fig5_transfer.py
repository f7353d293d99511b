"""Paper Figure 5 on the port: the share of time spent moving data.

The PyTorch twin of ``benchmarks/fig5_transfer.py``: the host-to-device
copy of the constraint arrays (``torch.from_numpy(h).to(device)`` from
pageable host memory, then a synchronise) against the solve itself, for
the two layouts the reference moves: three AoS arrays, and the packed
``L`` with ``c``.  The solve is the plain ``rgb`` backend's, as in the
reference.
"""
from __future__ import annotations

import torch

from benchmarks.pt_common import (emit, generator, plain_timing, shapes,
                                  time_fn)
from repro_torch.core import (normalize_batch, pack, random_feasible_lp,
                              shuffle_batch)
from repro_torch.device import as_device
from repro_torch.solver import SolverSpec

FULL_GRID = ((256, 64), (4096, 64), (16384, 64), (4096, 512))
QUICK_GRID = ((256, 64), (4096, 64))
SOLVE = SolverSpec(backend="rgb", normalize=False)


def case(B: int, m: int, device=None):
    lp = normalize_batch(random_feasible_lp(generator(B + m, device), B, m,
                                            device=device))
    return shuffle_batch(generator(3, device), lp)


def host_arrays(lp):
    """``(A, b, c, L)`` of ``lp`` as host numpy arrays (``L`` packed)."""
    return (lp.A.cpu().numpy(), lp.b.cpu().numpy(), lp.c.cpu().numpy(),
            pack(lp).L.cpu().numpy())


def transfer(arrays, device):
    """Each host array on ``device``, from pageable memory."""
    return tuple(torch.from_numpy(h).to(device) for h in arrays)


def run(full: bool = False, *, device=None, plain_quick: bool = False):
    """Each row's solve is plain ``rgb``: with ``plain_quick`` a ``--full``
    run visits the quick grid only."""
    device = as_device(device)
    rows = []
    for (B, m), plain in shapes(FULL_GRID, QUICK_GRID, full, plain_quick):
        if not plain:
            continue
        lp = case(B, m, device)
        hostA, hostb, hostc, hostL = host_arrays(lp)
        t_x = time_fn(transfer, (hostA, hostb, hostc), device, iters=5,
                      device=device)
        t_xp = time_fn(transfer, (hostL, hostc), device, iters=5,
                       device=device)
        t_c = time_fn(SOLVE.build(device).solve, lp, device=device,
                      **plain_timing(plain_quick))
        frac = t_x / (t_x + t_c)
        rows.append(emit(f"fig5/b{B}/m{m}", t_x + t_c,
                         f"transfer_frac={frac:.3f}"))
        rows.append(emit(f"fig5/b{B}/m{m}/packed", t_xp + t_c,
                         f"transfer_frac={t_xp / (t_xp + t_c):.3f}"))
    return rows


if __name__ == "__main__":
    run(full=True)
