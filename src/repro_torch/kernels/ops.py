"""Compatibility layer for the RGB kernel — the *kernel backend*.

The packed struct-of-arrays layout the kernel consumes is a first-class
type, :class:`repro_torch.core.packed.PackedLPBatch`; the solver core
hands its ``L`` block to the kernel directly and a pre-packed batch never
round-trips back to AoS.  The public way to run the kernel is
``repro_torch.solver``::

    from repro_torch.solver import SolverSpec
    sol = SolverSpec(backend="kernel").build().solve(batch)

This module keeps one historical entry point as a thin wrapper:
``pack_constraints`` over :func:`repro_torch.core.packed.pack` (plus the
kernel's LANE-multiple validation).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.lp import LPBatch
from repro_torch.core.packed import pack, pad_packed
from repro_torch.kernels.batch_lp import LANE


def pack_constraints(batch: LPBatch, m_pad: Optional[int] = None):
    """LPBatch -> (L (B,4,m_pad), c (B,2), m_valid (B,1)) with unit-norm
    rows assumed (call lp.normalize_batch first).

    Thin wrapper over :func:`repro_torch.core.packed.pack` that enforces
    the kernel's lane layout.  ``m_pad`` overrides the padding target.
    Prefer ``core.pack`` + ``core.pad_packed`` in new code — they return
    the :class:`~repro_torch.core.packed.PackedLPBatch` the solver
    accepts directly."""
    m = batch.m
    if m_pad is None:
        m_pad = -(-m // LANE) * LANE
    if m_pad < m or m_pad % LANE:
        raise ValueError(f"m_pad={m_pad} must be a multiple of {LANE} "
                         f">= m={m}")
    pb = pad_packed(pack(batch), m_pad)
    return pb.L, pb.c, pb.m_valid
