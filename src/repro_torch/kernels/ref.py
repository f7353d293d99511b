"""Plain-PyTorch oracle for the RGB kernel on the unpacked representation.

Mirrors the kernel's exact interface (packed struct-of-arrays layout) but
computes on the AoS representation, reusing the core solver (which
prepends four box rows instead of applying the box in closed form).
"""
from __future__ import annotations

import torch

from repro_torch.core.lp import LPBatch
from repro_torch.core.packed import PackedLPBatch, unpack
from repro_torch.core.seidel import solve_rgb


def unpack_constraints(L, c, m_valid) -> LPBatch:
    """Raw packed tensors -> AoS batch (wrapper over core.packed.unpack)."""
    return unpack(PackedLPBatch(
        L=L, c=c, m_valid=m_valid.reshape(L.shape[0], 1)))


def solve_packed_ref(L, c, m_valid, *, M: float = 1.0e4):
    """Reference results for packed inputs: (x (B,2), feasible (B,) int32)."""
    sol = solve_rgb(unpack_constraints(L, c, m_valid), M=M)
    return sol.x, sol.feasible.to(torch.int32)
