"""Packed struct-of-arrays constraint layout — the canonical device form.

The paper's central memory claim is that "combining the information
into one extended set of data ensures scattered reads use as much of
each cache line as possible".  :class:`PackedLPBatch` is that layout as
a first-class type: constraints live in one block ``L (B, 4, m_pad)``
with rows ``(a_x, a_y, b, 0)`` and the constraint index on the minor
(contiguous) axis, objectives in ``c (B, 2)`` and the ragged valid
counts in ``m_valid (B, 1)``.  The layout is the contract between this
package and the JAX reference: the same padded arrays feed both.

``pack``/``unpack`` convert losslessly to and from the AoS
:class:`~repro_torch.core.lp.LPBatch`; every batch utility in ``lp`` has
a packed-native twin here (``normalize_packed``, ``shuffle_packed``,
``pad_packed``, ``pad_packed_batch_dim``, ``concat_packed``,
``split_packed``) computing the *same scalar pipeline*, so a batch
packs once and solves bit-identically to the AoS path — without ever
round-tripping back to AoS.  (For ``shuffle=True`` solves the
bit-identity needs the default ``m_pad == m`` pack: extra constraint
padding — in either layout — changes the shuffle's score-draw shape,
leaving results equal only to the usual order-invariance tolerance.)

``pack`` and the kernel backend's fused front end on the card (``prep``,
in ``repro_torch.kernels.batch_lp``, which packs an AoS batch as it
normalises it) are the only AoS -> SoA conversions in the tree, and both
count their invocations (:func:`pack_call_count`); the serving layer's
zero-repack guarantee is asserted against that counter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.lp import (NORM_EPS, PAD_B, LPBatch, _norm_scale,
                                 _row_norms, _shuffle_order)
from repro_torch.device import DeviceLike, as_device

# AoS -> SoA conversion counter.  Incremented by ``pack`` and by an AoS
# ``prep`` only: a hot path that never repacks leaves it untouched.
_PACK_CALLS = 0


def pack_call_count() -> int:
    """Total AoS -> SoA conversions in this process.  Diff around a code
    path to prove it does no repacking."""
    return _PACK_CALLS


def count_pack() -> None:
    """Count one AoS -> SoA conversion."""
    global _PACK_CALLS
    _PACK_CALLS += 1


@dataclasses.dataclass(frozen=True)
class PackedLPBatch:
    """A batch of 2-D LPs in the packed struct-of-arrays layout.

    ``L[b, 0, h]``/``L[b, 1, h]`` are the constraint normal components,
    ``L[b, 2, h]`` the offset, ``L[b, 3, h]`` zero padding (kept so the
    arrays are interchangeable with the reference's).  Columns
    ``h >= m_valid[b, 0]`` are the neutral constraint ``0*x <= 1``.
    """

    L: torch.Tensor        # (B, 4, m_pad) packed (a_x, a_y, b, 0)
    c: torch.Tensor        # (B, 2) objective directions (maximize)
    m_valid: torch.Tensor  # (B, 1) int32 valid (non-padding) rows

    @property
    def batch(self) -> int:
        return self.L.shape[0]

    @property
    def m_pad(self) -> int:
        return self.L.shape[2]

    @property
    def device(self) -> torch.device:
        return self.L.device

    # Row views (no copies: slices of L).
    @property
    def ax(self) -> torch.Tensor:
        return self.L[:, 0, :]

    @property
    def ay(self) -> torch.Tensor:
        return self.L[:, 1, :]

    @property
    def b(self) -> torch.Tensor:
        return self.L[:, 2, :]

    def to(self, device: DeviceLike) -> "PackedLPBatch":
        """The same batch on ``device`` (self when already there)."""
        device = as_device(device)
        if self.L.device == device:
            return self
        return PackedLPBatch(L=self.L.to(device), c=self.c.to(device),
                             m_valid=self.m_valid.to(device))

    def unpack(self) -> LPBatch:
        return unpack(self)


def packed_from_numpy(L, c, m_valid, *,
                      device: DeviceLike = None) -> PackedLPBatch:
    """Carry a reference packed batch's arrays across as numpy:
    ``L (B, 4, m_pad)``, ``c (B, 2)``, ``m_valid (B, 1)`` or ``(B,)``.
    The arrays are copied (never aliased)."""
    device = as_device(device)
    L = torch.as_tensor(np.array(L), device=device)
    return PackedLPBatch(
        L=L, c=torch.as_tensor(np.array(c), dtype=L.dtype, device=device),
        m_valid=torch.as_tensor(np.array(m_valid), device=device)
        .to(torch.int32).reshape(L.shape[0], 1))


def pack(batch: LPBatch, m_pad: Optional[int] = None) -> PackedLPBatch:
    """AoS -> SoA: the one conversion point (counted).

    ``m_pad`` pads the constraint axis with neutral rows; the default
    (``m``) makes ``unpack(pack(batch))`` exactly lossless.  Layout
    consumers with alignment needs (the kernel wants ``LANE``
    multiples) pad further via :func:`pad_packed`.
    """
    count_pack()
    B, m = batch.batch, batch.m
    if m_pad is None:
        m_pad = m
    if m_pad < m:
        raise ValueError(f"m_pad={m_pad} < m={m}")
    dt = batch.A.dtype
    ax = batch.A[..., 0]
    ay = batch.A[..., 1]
    L = torch.stack([ax, ay, batch.b, torch.zeros_like(ax)], dim=1)
    pb = PackedLPBatch(L=L, c=batch.c.to(dt),
                       m_valid=batch.m_valid.reshape(B, 1))
    return pad_packed(pb, m_pad)


def unpack(pb: PackedLPBatch) -> LPBatch:
    """SoA -> AoS (padding columns kept as neutral rows)."""
    A = torch.stack([pb.L[:, 0, :], pb.L[:, 1, :]], dim=-1)  # (B, m_pad, 2)
    return LPBatch(A=A, b=pb.L[:, 2, :], c=pb.c,
                   m_valid=pb.m_valid.reshape(-1).to(torch.int32))


def _neutral_block(batch: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """A ``(batch, 4, m)`` block of neutral constraints (a = 0, b = 1)."""
    blk = torch.zeros((batch, 4, m), dtype=like.dtype, device=like.device)
    blk[:, 2, :] = PAD_B
    return blk


def pad_packed(pb: PackedLPBatch, m_pad: int) -> PackedLPBatch:
    """Pad the constraint axis up to ``m_pad`` with neutral columns
    (a = 0, b = 1) — the packed twin of ``lp.pad_batch``."""
    m = pb.m_pad
    if m_pad < m:
        raise ValueError(f"m_pad={m_pad} < m_pad={m}")
    if m_pad == m:
        return pb
    L = torch.cat([pb.L, _neutral_block(pb.batch, m_pad - m, pb.L)], dim=2)
    return PackedLPBatch(L=L, c=pb.c, m_valid=pb.m_valid)


def pad_packed_batch_dim(pb: PackedLPBatch, b_pad: int) -> PackedLPBatch:
    """Pad the batch axis up to ``b_pad`` with neutral problems
    (m_valid=0, c=(1,0)) — the packed twin of ``lp.pad_batch_dim``."""
    B = pb.batch
    if b_pad < B:
        raise ValueError(f"b_pad={b_pad} < batch={B}")
    if b_pad == B:
        return pb
    pad = b_pad - B
    L = torch.cat([pb.L, _neutral_block(pad, pb.m_pad, pb.L)])
    c_pad = torch.tensor([1.0, 0.0], dtype=pb.c.dtype,
                         device=pb.c.device).expand(pad, 2)
    mv_pad = torch.zeros((pad, 1), dtype=pb.m_valid.dtype,
                         device=pb.m_valid.device)
    return PackedLPBatch(L=L, c=torch.cat([pb.c, c_pad]),
                         m_valid=torch.cat([pb.m_valid, mv_pad]))


def concat_packed(pbs: list[PackedLPBatch]) -> PackedLPBatch:
    """Fuse packed batches along the batch axis (members padded with
    neutral columns to the largest ``m_pad``) — twin of
    ``lp.concat_batches``."""
    if not pbs:
        raise ValueError("concat_packed of empty list")
    m_max = max(pb.m_pad for pb in pbs)
    padded = [pad_packed(pb, m_max) for pb in pbs]
    return PackedLPBatch(
        L=torch.cat([pb.L for pb in padded]),
        c=torch.cat([pb.c for pb in padded]),
        m_valid=torch.cat([pb.m_valid for pb in padded]),
    )


def split_packed(pb: PackedLPBatch, sizes: list[int],
                 *, allow_remainder: bool = False) -> list[PackedLPBatch]:
    """Inverse of :func:`concat_packed` — twin of ``lp.split_batch``
    (same remainder policy)."""
    total = sum(sizes)
    if total > pb.batch:
        raise ValueError(f"split sizes {sizes} exceed batch {pb.batch}")
    if total < pb.batch and not allow_remainder:
        raise ValueError(
            f"split sizes {sizes} sum to {total} < batch {pb.batch}; "
            "pass allow_remainder=True to drop the trailing problems")
    out, lo = [], 0
    for s in sizes:
        out.append(PackedLPBatch(L=pb.L[lo:lo + s], c=pb.c[lo:lo + s],
                                 m_valid=pb.m_valid[lo:lo + s]))
        lo += s
    return out


def normalize_packed(pb: PackedLPBatch, eps: float = NORM_EPS
                     ) -> PackedLPBatch:
    """Scale every constraint column so ||a_h|| = 1 — the packed twin of
    ``lp.normalize_batch``, computing the identical scalar pipeline so
    packed and AoS solves stay bit-identical.  Zero-norm (padding)
    columns keep scale 1; the zero row rides along (0 * s = 0)."""
    scale = _norm_scale(_row_norms(pb.ax, pb.ay), eps)  # (B, m_pad)
    return PackedLPBatch(L=pb.L * scale[:, None, :], c=pb.c,
                         m_valid=pb.m_valid)


def shuffle_packed(generator: torch.Generator,
                   pb: PackedLPBatch) -> PackedLPBatch:
    """Random per-problem constraint order (the R in RGB) — the packed
    twin of ``lp.shuffle_batch``: same score draw, same masking, same
    stable argsort, so the permutation (and therefore the solve) is
    bit-identical to shuffling the AoS batch when ``m_pad`` matches its
    constraint count.  Padding columns stay at the tail."""
    order = _shuffle_order(generator, pb.batch, pb.m_pad, pb.m_valid)
    return PackedLPBatch(
        L=torch.take_along_dim(pb.L, order[:, None, :], dim=2),
        c=pb.c, m_valid=pb.m_valid)
