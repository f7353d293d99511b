"""Collectives over the ranks of a mesh: the port's counterpart of
``lax.psum`` / ``lax.pmax`` / ``lax.all_gather`` / ``lax.ppermute`` /
``lax.axis_index`` under ``shard_map``.

A :class:`~repro_torch.launch.mesh.DistMesh` holds one process group for
every non-empty set of its axes; each function here takes the mesh and a
tuple of axis names and is the identity over axes whose size is 1 (no
collective is issued and nothing is counted).

Gradients are placed the Megatron way, not by JAX's transpose rules (the
reference relies on ``shard_map``'s replication tracking, which PyTorch
has no counterpart of).  The convention every layer keeps:

* over the **model** axis a replicated activation holds its *full*
  gradient on every rank.  :func:`psum` (all-reduce forward, identity
  backward) closes a row-parallel product; :func:`copy_to` (identity
  forward, all-reduce backward) is its conjugate, placed wherever a
  model-replicated tensor enters model-sharded work; :func:`psum_all`
  (all-reduce both ways) is the two in one, for a reduced value that
  sharded work goes on to consume (``rms_norm_sharded``'s sum of squares);
* over the **data** axes each rank's backward gives its own share of the
  gradient, and the train step sums them once (an all-reduce of the
  data-replicated leaves; an FSDP leaf's share arrives summed by
  :func:`all_gather`'s backward, a reduce-scatter).

Transport: NCCL for CUDA tensors, gloo for CPU tensors.  A gloo group
given CUDA tensors (several ranks on one card, which NCCL refuses) moves
every payload through pinned host memory, explicitly (``mesh.backend``
says ``"gloo"``); NCCL is never swapped for gloo behind the caller's
back.  Under gloo a reduce-scatter is an all-reduce and a
slice.

Every collective issued is counted by op: calls and bytes of the payload
each rank puts in (:func:`counts`, :func:`reset_counts`).

The ``"record"`` transport (a :class:`~repro_torch.launch.mesh.
RecordingMesh`, ``mesh.backend == "record"``) issues nothing: each
collective is counted as above, recorded in the reference's convention
(:func:`recorded`), and returns an empty tensor of its result's shape.  It
takes ``meta`` tensors only (a dry run's), and raises on any other: a
collective over real data must not come back with made-up values.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

Axes = Tuple[str, ...]

_COUNTS: Dict[str, Dict[str, int]] = collections.defaultdict(
    lambda: {"calls": 0, "bytes": 0})


def reset_counts() -> None:
    """Set every collective's count, and the record transport's log, to
    0."""
    _COUNTS.clear()
    _RECORDED.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """``{op: {"calls": n, "bytes": b}}`` since the last reset: ``bytes``
    is the payload this rank put into the op."""
    return {k: dict(v) for k, v in sorted(_COUNTS.items())}


def _count(op: str, t: torch.Tensor) -> None:
    c = _COUNTS[op]
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


# The record transport's log, in the reference's convention
# (``repro.roofline.collective_bytes`` reads its HLO so): XLA's op names,
# the bytes of each call's *result* (an all-gather's gathered tensor, a
# reduce-scatter's piece), by the axes each call ran over.
_HLO_OP = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
           "psum_int8": "all-gather", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter",
           "ppermute": "collective-permute"}
_RECORDED: Dict[str, Dict] = {}


def recorded() -> Dict[str, Dict]:
    """``{hlo_op: {"calls": n, "bytes": b, "by_axes": {"data,model": b}}}``:
    what the record transport took since the last :func:`reset_counts`
    (``bytes`` are each call's result bytes on this rank)."""
    return {k: {"calls": v["calls"], "bytes": v["bytes"],
                "by_axes": dict(v["by_axes"])}
            for k, v in sorted(_RECORDED.items())}


def coll_by_op(rec: Dict[str, Dict]) -> Dict[str, int]:
    """``{hlo_op: bytes}`` of a :func:`recorded` log: the form of the
    reference's ``Roofline.coll_by_op``."""
    return {k: v["bytes"] for k, v in rec.items()}


def _recording(mesh, t: torch.Tensor) -> bool:
    if mesh.backend != "record":
        return False
    if t.device.type != "meta":
        raise ValueError(f"the record transport takes meta tensors only, "
                         f"not {t.device}: it moves no data")
    return True


def _record(op: str, axes: Axes, shape, like: torch.Tensor
            ) -> torch.Tensor:
    """Log one recorded call; its result: empty, of ``shape`` and
    ``like``'s dtype and device."""
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    r = _RECORDED.setdefault(_HLO_OP[op], {"calls": 0, "bytes": 0,
                                           "by_axes": {}})
    nbytes = out.numel() * out.element_size()
    r["calls"] += 1
    r["bytes"] += nbytes
    key = ",".join(axes)
    r["by_axes"][key] = r["by_axes"].get(key, 0) + nbytes
    return out


# ---------------------------------------------------------------------------
# Raw collectives (no autograd)
# ---------------------------------------------------------------------------

def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _all_reduce(mesh, axes: Axes, x: torch.Tensor, op: str = "sum"
                ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``axes`` (``op`` sum or max)."""
    group = mesh.group(axes)
    if group is None:
        return x
    name = "all_reduce" if op == "sum" else "all_reduce_max"
    _count(name, x)
    if _recording(mesh, x):
        return _record(name, axes, x.shape, x)
    rop = tdist.ReduceOp.SUM if op == "sum" else tdist.ReduceOp.MAX
    if _staged(mesh, x):
        h = _to_host(x)
        tdist.all_reduce(h, op=rop, group=group)
        return h.to(x.device)
    out = x.contiguous().clone()
    tdist.all_reduce(out, op=rop, group=group)
    return out


def psum_int8(q: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The int32 sum over ``axes`` of int8 ``q``: the int8 shards travel
    (an all-gather) and every rank sums them in int32, exactly."""
    if not _active(mesh, axes):
        return q.to(torch.int32)
    group = mesh.group(axes)
    _count("psum_int8", q)
    n = mesh.size(axes)
    if _recording(mesh, q):
        _record("psum_int8", axes, (n,) + tuple(q.shape), q)
        return torch.empty(q.shape, dtype=torch.int32, device=q.device)
    src = _to_host(q) if _staged(mesh, q) else q.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(torch.int32).sum(0).to(q.device)


def _all_gather(mesh, axes: Axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``axes``, concatenated on ``dim`` in the
    order of the axes' coordinates (``lax.all_gather(tiled=True)``)."""
    group = mesh.group(axes)
    if group is None:
        return x
    _count("all_gather", x)
    n = mesh.size(axes)
    if _recording(mesh, x):
        shape = list(x.shape)
        shape[dim] *= n
        return _record("all_gather", axes, shape, x)
    src = _to_host(x) if _staged(mesh, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(mesh, axes: Axes, x: torch.Tensor, dim: int
                    ) -> torch.Tensor:
    """``x`` summed over ``axes`` and cut along ``dim``: this rank's
    piece (the transpose of :func:`_all_gather`)."""
    group = mesh.group(axes)
    if group is None:
        return x
    _count("reduce_scatter", x)
    n, i = mesh.size(axes), mesh.index(axes)
    if _recording(mesh, x):
        return _record("reduce_scatter", axes, x.chunk(n, dim=dim)[i].shape,
                       x)
    if mesh.backend == "gloo":
        h = _to_host(x) if x.is_cuda else x.contiguous().clone()
        tdist.all_reduce(h, group=group)
        return h.chunk(n, dim=dim)[i].contiguous().to(x.device)
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    tdist.reduce_scatter(out, parts, group=group)
    return out


def _ppermute(mesh, axes: Axes, x: torch.Tensor,
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: index ``src`` sends ``x`` to index ``dst`` for
    each pair; a rank nobody sends to gets zeros."""
    group = mesh.group(axes)
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    _count("ppermute", x)
    if _recording(mesh, x):
        return _record("ppermute", axes, x.shape, x)
    me = mesh.index(axes)
    ranks = mesh.group_ranks(axes)
    staged = _staged(mesh, x)
    src = _to_host(x) if staged else x.contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(tdist.P2POp(tdist.isend, src, ranks[d], group))
        elif d == me:
            ops.append(tdist.P2POp(tdist.irecv, out, ranks[s], group))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward (the conjugate of _PSum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


class _PSumAll(torch.autograd.Function):
    """All-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, ctx.axes, g), None, None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather forward, reduce-scatter (sum) backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(ctx.mesh, ctx.axes, g, ctx.dim), None, None,
                None)


class _PPermute(torch.autograd.Function):
    """ppermute forward, the inverse permutation backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, perm):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.inv = tuple((d, s) for s, d in perm)
        return _ppermute(mesh, axes, x, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(ctx.mesh, ctx.axes, g, ctx.inv), None, None, None


def _active(mesh, axes: Axes) -> bool:
    return mesh is not None and mesh.size(axes) > 1


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes``; the gradient passes through unchanged (each
    rank's cotangent is already the full one: the result is replicated)."""
    return _PSum.apply(x, mesh, tuple(axes)) if _active(mesh, axes) else x


def copy_to(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The identity; its gradient is summed over ``axes`` (the conjugate
    of :func:`psum`, where a replicated tensor enters sharded work)."""
    return _CopyTo.apply(x, mesh, tuple(axes)) if _active(mesh, axes) else x


def psum_all(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes``, and sum the gradient too: for a reduced value
    that each rank's sharded work then consumes."""
    return _PSumAll.apply(x, mesh, tuple(axes)) if _active(mesh, axes) \
        else x


def all_reduce(x: torch.Tensor, mesh, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` summed (``op="max"``: maxed) over ``axes``, without a
    gradient: for values the step reduces itself (gradients, counts)."""
    if not _active(mesh, axes):
        return x
    return _all_reduce(mesh, tuple(axes), x.detach(), op)


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Max over ``axes``, without a gradient (its one use, the softmax's
    stability max, is detached in the reference too)."""
    return all_reduce(x, mesh, axes, op="max")


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``; its backward is a
    reduce-scatter (sum), ZeRO's gradient."""
    if not _active(mesh, axes):
        return x
    return _AllGather.apply(x, mesh, tuple(axes), dim)


def ppermute(x: torch.Tensor, mesh, axes: Axes,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute`` over ``axes`` (indices into the axes' group);
    backward the inverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if mesh is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, tuple(axes), perm)


def axis_index(mesh, axes: Axes) -> int:
    """``lax.axis_index``: this rank's index along ``axes`` (0 without a
    mesh)."""
    return 0 if mesh is None else mesh.index(tuple(axes))


def sum_leaves(values, leaf_axes, mesh) -> list:
    """Per-leaf local partial sums (tensors of one shape) -> the sums over
    each leaf's shards: ``leaf_axes[i]`` names the axes that shard leaf
    ``i`` (empty: replicated, already whole).  One all-reduce for each
    distinct set of axes."""
    out = list(values)
    by_axes: Dict[Axes, list] = collections.defaultdict(list)
    for i, axes in enumerate(leaf_axes):
        if _active(mesh, axes):
            by_axes[tuple(axes)].append(i)
    for axes, idx in by_axes.items():
        red = _all_reduce(mesh, axes, torch.stack([out[i] for i in idx]))
        for j, i in enumerate(idx):
            out[i] = red[j]
    return out


# ---------------------------------------------------------------------------
# Specs: which axes shard which dim of a leaf
# ---------------------------------------------------------------------------
# A spec is a tuple with one entry a dim: None (whole), an axis name, or a
# tuple of axis names (sharded over their product, row-major), as the
# reference's PartitionSpecs.

def flat_specs(specs, prefix: str = "") -> Dict[str, tuple]:
    """``{"blocks/wq": (None, None, "model"), ...}``: a spec tree's leaves
    (tuples) by slash path."""
    out: Dict[str, tuple] = {}
    for k, v in specs.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_specs(v, path))
        else:
            out[path] = v
    return out


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` leaf under ``spec``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = mesh.size(_entry_axes(entry)) if entry is not None else 1
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"into {n} shards ({spec})")
        out[i] //= n
    return tuple(out)


def shard_of(x, spec, mesh):
    """This rank's block of the global array or tensor ``x`` under
    ``spec``."""
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = mesh.size(axes) if axes else 1
        if n > 1:
            step = x.shape[i] // n
            j = mesh.index(axes)
            x = x[(slice(None),) * i + (slice(j * step, (j + 1) * step),)]
    return x


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global leaf from every rank's shard ``x`` (an all-gather over
    each sharded dim's axes; no gradient): a new tensor, never ``x``."""
    out = x.detach().clone()
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes and mesh.size(axes) > 1:
            out = _all_gather(mesh, axes, out, i)
    return out


def barrier(mesh: Optional[object]) -> None:
    """Wait for every rank of the mesh (the record transport: nothing to
    wait for)."""
    if mesh is not None and mesh.backend != "record" \
            and tdist.is_initialized():
        tdist.barrier()
