"""Problem types, generators and batch utilities for 2-D linear programs.

A single LP is   maximize  c @ x   subject to  A @ x <= b,  x in R^2.

Batches are stored dense:  A (B, m, 2), b (B, m), c (B, 2).  Ragged batches
(the paper's "different-sized individual LPs within the batches") carry a
per-problem valid count ``m_valid`` and pad the tail with the *neutral
constraint* ``0*x + 0*y <= 1`` which is satisfied by every point and ignored
by the 1-D re-solve (its normal has zero norm).

PyTorch counterpart of ``repro.core.lp``: frozen dataclasses of tensors,
plain functions on tensors.  Functions that create data take an explicit
``device=`` (default: the card, see :mod:`repro_torch.device`) and, where
the JAX function takes a ``key``, an explicit ``generator=``
(:class:`torch.Generator`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, as_device

# Neutral padding constraint: 0*x <= 1 (always satisfied, zero normal).
PAD_A = (0.0, 0.0)
PAD_B = 1.0

# Constraint normals shorter than this are left unscaled by the
# normalisers (padding rows have norm 0).
NORM_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class LPBatch:
    """A batch of 2-D linear programs (dense layout, optionally ragged)."""

    A: torch.Tensor  # (B, m, 2) constraint normals
    b: torch.Tensor  # (B, m)    constraint offsets
    c: torch.Tensor  # (B, 2)    objective directions (maximize)
    m_valid: torch.Tensor  # (B,) int32 number of valid (non-padding) rows

    @property
    def batch(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.A.shape[1]

    @property
    def device(self) -> torch.device:
        return self.A.device

    def to(self, device: DeviceLike) -> "LPBatch":
        """The same batch on ``device`` (self when already there)."""
        device = as_device(device)
        if self.A.device == device:
            return self
        return LPBatch(A=self.A.to(device), b=self.b.to(device),
                       c=self.c.to(device),
                       m_valid=self.m_valid.to(device))

    def pack(self, m_pad: Optional[int] = None):
        """AoS -> packed SoA (:class:`~repro_torch.core.packed.PackedLPBatch`).
        Pack once before repeated solves; see ``repro_torch.core.packed``."""
        from repro_torch.core.packed import pack  # deferred: import cycle
        return pack(self, m_pad)


@dataclasses.dataclass(frozen=True)
class LPSolution:
    x: torch.Tensor  # (B, 2) argmax (garbage where infeasible)
    feasible: torch.Tensor  # (B,) bool
    objective: torch.Tensor  # (B,) c @ x (garbage where infeasible)


def _objective(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``c @ x`` per problem."""
    return (c * x).sum(dim=-1)


def make_batch(A, b, c, m_valid=None, *,
               device: DeviceLike = None) -> LPBatch:
    """Build an :class:`LPBatch` from array-likes.  ``device=None`` keeps
    a tensor input where it lies and places anything else on the default
    device (the card)."""
    if device is None and isinstance(A, torch.Tensor):
        device = A.device
    device = as_device(device)
    A = torch.as_tensor(np.asarray(A) if not isinstance(A, torch.Tensor)
                        else A, device=device)
    if not A.dtype.is_floating_point:
        A = A.to(torch.float32)
    # One dtype for the whole problem: mixed inputs (e.g. a float64 b
    # against a float32 A) must not flow through silently.
    b = torch.as_tensor(b, dtype=A.dtype, device=device)
    c = torch.as_tensor(c, dtype=A.dtype, device=device)
    if A.ndim == 2:  # single problem -> batch of one
        A, b, c = A[None], b[None], c[None]
    B, m = A.shape[0], A.shape[1]
    if m_valid is None:
        m_valid = torch.full((B,), m, dtype=torch.int32, device=device)
    else:
        m_valid = torch.as_tensor(m_valid, device=device).to(torch.int32)
    return LPBatch(A=A, b=b, c=c, m_valid=m_valid)


def batch_from_numpy(A, b, c, m_valid=None, *,
                     device: DeviceLike = None) -> LPBatch:
    """Carry a reference batch's arrays across as numpy:
    ``A (B, m, 2)``, ``b (B, m)``, ``c (B, 2)``, ``m_valid (B,)``.  The
    arrays are copied: the result never aliases the caller's (possibly
    read-only) buffers."""
    return make_batch(np.array(A), np.array(b), np.array(c),
                      None if m_valid is None else np.array(m_valid),
                      device=device)


def pad_batch(batch: LPBatch, m_pad: int) -> LPBatch:
    """Pad the constraint dimension up to ``m_pad`` with neutral rows."""
    B, m = batch.batch, batch.m
    if m_pad < m:
        raise ValueError(f"m_pad={m_pad} < m={m}")
    if m_pad == m:
        return batch
    dt, dev = batch.A.dtype, batch.A.device
    padA = torch.zeros((B, m_pad - m, 2), dtype=dt, device=dev)
    padb = torch.full((B, m_pad - m), PAD_B, dtype=dt, device=dev)
    return LPBatch(
        A=torch.cat([batch.A, padA], dim=1),
        b=torch.cat([batch.b, padb], dim=1),
        c=batch.c,
        m_valid=batch.m_valid,
    )


def pad_batch_dim(batch: LPBatch, b_pad: int) -> LPBatch:
    """Pad the *batch* dimension up to ``b_pad`` with neutral problems
    (m_valid=0, c=(1,0)): they solve at the box corner in zero iterations
    and never trigger a re-solve."""
    B, m = batch.batch, batch.m
    if b_pad < B:
        raise ValueError(f"b_pad={b_pad} < batch={B}")
    if b_pad == B:
        return batch
    pad = b_pad - B
    dt, dev = batch.A.dtype, batch.A.device
    c_pad = torch.tensor([1.0, 0.0], dtype=dt, device=dev).expand(pad, 2)
    return LPBatch(
        A=torch.cat([batch.A,
                     torch.zeros((pad, m, 2), dtype=dt, device=dev)]),
        b=torch.cat([batch.b,
                     torch.full((pad, m), PAD_B, dtype=dt, device=dev)]),
        c=torch.cat([batch.c, c_pad]),
        m_valid=torch.cat(
            [batch.m_valid,
             torch.zeros((pad,), dtype=torch.int32, device=dev)]),
    )


def concat_batches(batches: list[LPBatch]) -> LPBatch:
    """Fuse several batches into one super-batch: every member is padded
    (neutral rows) to the largest constraint count, then stacked along the
    batch dimension.  For callers fusing pre-built batches offline; the
    serving scheduler assembles the same layout host-side in numpy to keep
    flushes off the device."""
    if not batches:
        raise ValueError("concat_batches of empty list")
    m_max = max(b.m for b in batches)
    padded = [pad_batch(b, m_max) for b in batches]
    return LPBatch(
        A=torch.cat([b.A for b in padded]),
        b=torch.cat([b.b for b in padded]),
        c=torch.cat([b.c for b in padded]),
        m_valid=torch.cat([b.m_valid for b in padded]),
    )


def split_batch(batch: LPBatch, sizes: list[int],
                *, allow_remainder: bool = False) -> list[LPBatch]:
    """Inverse of :func:`concat_batches`: slice the batch dimension back
    into consecutive pieces of the given sizes (padding rows kept).

    ``sizes`` must cover the batch exactly; a shortfall raises unless
    ``allow_remainder=True`` is passed explicitly (the remainder is then
    discarded, e.g. to strip padding problems off a fused flush)."""
    total = sum(sizes)
    if total > batch.batch:
        raise ValueError(
            f"split sizes {sizes} exceed batch {batch.batch}")
    if total < batch.batch and not allow_remainder:
        raise ValueError(
            f"split sizes {sizes} sum to {total} < batch {batch.batch}; "
            "pass allow_remainder=True to drop the trailing problems")
    out, lo = [], 0
    for s in sizes:
        out.append(LPBatch(A=batch.A[lo:lo + s], b=batch.b[lo:lo + s],
                           c=batch.c[lo:lo + s],
                           m_valid=batch.m_valid[lo:lo + s]))
        lo += s
    return out


def _row_norms(ax: torch.Tensor, ay: torch.Tensor) -> torch.Tensor:
    """||a|| per constraint from its components — the one norm op both
    the AoS and packed normalisers run (on an identically shaped
    contiguous stack), so packed/AoS bit-identity holds by
    construction inside the port."""
    return torch.linalg.vector_norm(torch.stack([ax, ay], dim=-1), dim=-1)


def _norm_scale(n: torch.Tensor, eps: float) -> torch.Tensor:
    """1/||a|| where the norm is real, 1 on zero-norm (padding) rows."""
    return torch.where(n < eps, 1.0, 1.0 / torch.clamp(n, min=eps))


def normalize_batch(batch: LPBatch, eps: float = NORM_EPS) -> LPBatch:
    """Scale every constraint so ||a_h|| = 1 (zero-norm padding rows kept).

    Normalisation makes every epsilon threshold in the solver an absolute
    distance, which is what keeps float32 behaviour within the paper's own
    5-significant-figure tolerance.
    """
    scale = _norm_scale(_row_norms(batch.A[..., 0], batch.A[..., 1]), eps)
    return LPBatch(
        A=batch.A * scale[..., None],
        b=batch.b * scale,
        c=batch.c,
        m_valid=batch.m_valid,
    )


def _shuffle_order(generator: torch.Generator, batch: int, m: int,
                   m_valid: torch.Tensor) -> torch.Tensor:
    """Per-problem permutation (B, m): valid columns in random order,
    padding columns (score ``inf``) kept at the tail in their original
    order — the argsort is stable, like the reference's."""
    dev = m_valid.device
    scores = torch.rand((batch, m), generator=generator,
                        device=generator.device).to(dev)
    idx = torch.arange(m, device=dev)[None, :]
    scores = torch.where(idx < m_valid.reshape(-1, 1), scores,
                         float("inf"))
    return torch.argsort(scores, dim=-1, stable=True)


def shuffle_batch(generator: torch.Generator, batch: LPBatch) -> LPBatch:
    """Random per-problem constraint order — the R in RGB (Seidel's
    randomisation).  Valid rows are permuted uniformly; padding rows stay at
    the tail so ragged masks remain prefix masks."""
    order = _shuffle_order(generator, batch.batch, batch.m, batch.m_valid)
    return LPBatch(
        A=torch.take_along_dim(batch.A, order[..., None], dim=1),
        b=torch.take_along_dim(batch.b, order, dim=1),
        c=batch.c, m_valid=batch.m_valid,
    )


# ---------------------------------------------------------------------------
# Problem generators (mirroring the paper's experimental setup, section 4)
# ---------------------------------------------------------------------------

def _uniform(generator: torch.Generator, shape, dtype, lo: float,
             hi: float, device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (u * (hi - lo) + lo).to(device)


def random_feasible_lp(
    generator: torch.Generator,
    batch: int,
    m: int,
    *,
    dtype: torch.dtype = torch.float32,
    radius: float = 100.0,
    slack: float = 5.0,
    device: DeviceLike = None,
) -> LPBatch:
    """Random feasible problems: pick an interior point per problem, draw
    constraint normals uniformly on the circle and offset them so the
    interior point is strictly feasible (paper: "constraint lines are
    generated randomly and tested to ensure a solution is possible")."""
    device = as_device(device)
    xstar = _uniform(generator, (batch, 1, 2), dtype, -radius / 2,
                     radius / 2, device)
    theta = _uniform(generator, (batch, m), dtype, 0.0, 2.0 * np.pi, device)
    A = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    s = _uniform(generator, (batch, m), dtype, 0.1, slack, device)
    b = (A * xstar).sum(dim=-1) + s
    phi = _uniform(generator, (batch,), dtype, 0.0, 2.0 * np.pi, device)
    c = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    return make_batch(A, b, c)


def replicated_lp(generator: torch.Generator, batch: int, m: int,
                  **kw) -> LPBatch:
    """Paper's batch construction: one LP generated per run and copied
    ``batch`` times into memory to simulate batch numbers."""
    one = random_feasible_lp(generator, 1, m, **kw)
    rep = lambda a: a.expand((batch,) + tuple(a.shape[1:])).contiguous()
    return LPBatch(A=rep(one.A), b=rep(one.b), c=rep(one.c),
                   m_valid=rep(one.m_valid))


def adversarial_lp(batch: int, m: int, *,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> LPBatch:
    """Worst-case consideration order (paper section 2.1): constraints are
    tangents to the unit circle with angles sweeping monotonically toward
    the objective direction, so *every* constraint, considered in the given
    order, invalidates the previous intermediate optimum.  Used to benchmark
    the naive/RGB divergence gap and the value of randomisation."""
    i = np.arange(m, dtype=np.float64)
    # Angles converge geometrically toward pi/2 (the optimum for c=(0,1)).
    ang = np.pi / 2 + (np.pi / 2.2) * (0.98 ** i) * np.where(i % 2 == 0, 1.0, -1.0)
    A = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    b = np.ones((m,))
    device = as_device(device)
    A = torch.as_tensor(np.broadcast_to(A, (batch, m, 2)).copy(),
                        dtype=dtype, device=device)
    b = torch.as_tensor(np.broadcast_to(b, (batch, m)).copy(),
                        dtype=dtype, device=device)
    c = torch.tensor([0.0, 1.0], dtype=dtype,
                     device=device).expand(batch, 2).contiguous()
    return make_batch(A, b, c)


def ragged_feasible_lp(
    generator: torch.Generator, batch: int, m_max: int, *, m_min: int = 4,
    dtype: torch.dtype = torch.float32, device: DeviceLike = None,
) -> LPBatch:
    """Different-sized LPs in one batch (paper section 6 'allowance for
    different-sized individual LPs within the batches')."""
    device = as_device(device)
    full = random_feasible_lp(generator, batch, m_max, dtype=dtype,
                              device=device)
    m_valid = torch.randint(m_min, m_max + 1, (batch,), generator=generator,
                            device=generator.device).to(device)
    idx = torch.arange(m_max, device=device)[None, :]
    keep = idx < m_valid[:, None]
    A = torch.where(keep[..., None], full.A, 0.0)
    b = torch.where(keep, full.b, PAD_B)
    return LPBatch(A=A, b=b, c=full.c, m_valid=m_valid.to(torch.int32))


def infeasible_lp(batch: int, m: int, *,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> LPBatch:
    """x <= -1 and -x <= -1 (i.e. x >= 1): empty feasible set; remaining
    rows neutral."""
    A = np.zeros((m, 2))
    b = np.full((m,), PAD_B)
    A[0] = (1.0, 0.0); b[0] = -1.0
    A[1] = (-1.0, 0.0); b[1] = -1.0
    device = as_device(device)
    A = torch.as_tensor(np.broadcast_to(A, (batch, m, 2)).copy(),
                        dtype=dtype, device=device)
    b = torch.as_tensor(np.broadcast_to(b, (batch, m)).copy(),
                        dtype=dtype, device=device)
    c = torch.tensor([1.0, 0.0], dtype=dtype,
                     device=device).expand(batch, 2).contiguous()
    return make_batch(A, b, c)
