"""LP-constrained update scaling: the paper's batch 2-D LP solver inside
the optimizer.

For every parameter block we pose a tiny 2-D linear program over
(s1 = proposed-update scale, s2 = momentum-correction scale):

    maximize    s1 + lambda * s2
    subject to  s1 * ||u||    <= delta * (||p|| + eps)   (trust region)
                s1 * <u, g> + s2 * <mu, g> <= 0          (descent guard)
                0 <= s1 <= 1,   -1 <= s2 <= 1            (box)

where u is the optimizer's proposed update, g the gradient and mu the unit
momentum direction.  One LP per parameter leaf -> a *batch* of LPs with
identical structure but different coefficients, solved through
``repro_torch.solver`` — on a card by the hand-written CUDA kernel
``rgb_cuda`` (``backend="kernel"``), so every training step launches it
once.

Counterpart of ``repro.optim.lp_clip``.  Leaves are taken in the order
``jax.tree.flatten`` gives (dict keys sorted), so LP ``i`` is the same
leaf in both packages.  The backend is chosen by device where the
reference always defaults to ``"rgb"`` (ROADMAP C): ``"kernel"`` for
tensors on a card, ``"rgb"`` (the plain Seidel loop, the reference's
default) on the CPU; an explicit ``method`` wins.  Both are exact solvers,
so the answers agree to the usual 1e-4.

On a mesh each leaf is this rank's shard, where the reference's statistics
are of whole leaves (it runs outside ``shard_map``): ``||u||``, ``<u, g>``,
``||m||``, ``||p||`` and ``<mu, g>`` are then local sums of squares and
dots, all-reduced over exactly the axes that shard the leaf (``leaf_axes``)
and never over those that replicate it.  Every rank so poses the same LP
batch, equal in bits, and launches the kernel once on it.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import dist as D
from repro_torch.core.lp import make_batch
from repro_torch.solver import SolverSpec, get_solver
from repro_torch.tree import tree_leaves, tree_unflatten

_EPS = 1e-12
M_BOX = 10.0  # the solver's box; s1, s2 live in [0, 1] x [-1, 1]


def _block_stats(u, g, m):
    u32 = u.float().ravel()
    g32 = g.float().ravel()
    m32 = m.float().ravel()
    un = torch.linalg.vector_norm(u32)
    mn = torch.linalg.vector_norm(m32)
    mu = m32 / (mn + _EPS)
    return un, torch.dot(u32, g32), torch.dot(mu, g32), mn


def _leaf_stats(updates, grads, momenta, params, leaf_axes, mesh):
    """Per leaf ``(||u||, <u, g>, <mu, g>, ||p||, ||m||)`` of the whole
    leaf.  A leaf sharded over some axes of ``mesh`` (``leaf_axes[i]``)
    sums its shards' squares and dots over exactly those axes."""
    leaves = list(zip(tree_leaves(updates), tree_leaves(grads),
                      tree_leaves(momenta), tree_leaves(params),
                      strict=True))
    if leaf_axes is None:
        leaf_axes = [()] * len(leaves)
    sharded = [mesh is not None and mesh.size(ax) > 1 for ax in leaf_axes]
    stats = [None] * len(leaves)
    local = []
    for i, (u, g, m, p) in enumerate(leaves):
        if not sharded[i]:
            un, ug, mg, mn = _block_stats(u, g, m)
            stats[i] = (un, ug, mg, torch.linalg.vector_norm(
                p.float().ravel()), mn)
            local.append(None)
            continue
        u32, g32 = u.float().ravel(), g.float().ravel()
        m32, p32 = m.float().ravel(), p.float().ravel()
        local.append(torch.stack([torch.dot(u32, u32), torch.dot(m32, m32),
                                  torch.dot(p32, p32), torch.dot(u32, g32)]))
    idx = [i for i in range(len(leaves)) if sharded[i]]
    axes = [leaf_axes[i] for i in idx]
    tot = D.sum_leaves([local[i] for i in idx], axes, mesh)
    mg_local = []
    for i, t in zip(idx, tot):
        mn = torch.sqrt(t[1])
        m32, g32 = leaves[i][2].float().ravel(), leaves[i][1].float().ravel()
        mg_local.append(torch.dot(m32 / (mn + _EPS), g32))
        stats[i] = (torch.sqrt(t[0]), t[3], None, torch.sqrt(t[2]), mn)
    for i, mg in zip(idx, D.sum_leaves(mg_local, axes, mesh)):
        un, ug, _, pn, mn = stats[i]
        stats[i] = (un, ug, mg, pn, mn)
    return stats


def _problems(stats, delta: float, lam: float):
    rows_A, rows_b = [], []
    for un, ug, mg, pn, _ in stats:
        # the s2 momentum correction is scaled to 10% of the update norm
        mg_s = 0.1 * un * mg
        zero, one = torch.zeros_like(un), torch.ones_like(un)
        # constraints (A s <= b), s = (s1, s2)
        rows_A.append(torch.stack([
            torch.stack([un, zero]),      # s1*||u|| <= d*||p||
            torch.stack([ug, mg_s]),      # descent guard <= 0
            torch.stack([one, zero]),     # s1 <= 1
            torch.stack([-one, zero]),    # -s1 <= 0
            torch.stack([zero, one]),     # s2 <= 1
            torch.stack([zero, -one]),    # -s2 <= 1
        ]))
        rows_b.append(torch.stack([delta * (pn + 1e-3), zero, one, zero,
                                   one, one]))
    A = torch.stack(rows_A)
    b = torch.stack(rows_b)
    c = torch.tensor([1.0, lam], dtype=torch.float32,
                     device=A.device).expand(A.shape[0], 2)
    return A, b, c


@torch.no_grad()
def lp_problems(updates, grads, momenta, params, *, delta: float = 0.05,
                lam: float = 0.1, leaf_axes=None, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step's LP batch: ``A (nb, 6, 2)``, ``b (nb, 6)``, ``c (nb, 2)``
    float32 on the leaves' device, problem ``i`` for leaf ``i`` in
    :func:`~repro_torch.tree.tree_leaves` order.  On a mesh,
    ``leaf_axes[i]`` names the axes that shard leaf ``i``."""
    return _problems(_leaf_stats(updates, grads, momenta, params,
                                 leaf_axes, mesh), delta, lam)


@torch.no_grad()
def lp_constrain_updates(
    updates, grads, momenta, params,
    *,
    delta: float = 0.05,
    lam: float = 0.1,
    method: Optional[str] = None,
    leaf_axes=None,
    mesh=None,
) -> Tuple[Any, torch.Tensor]:
    """Scale each update leaf by the LP-optimal (s1, s2).

    Returns (new_updates, mean_s1) — mean_s1 is a health metric: 1.0 means
    the trust region never binds.  ``method=None`` picks ``"kernel"`` for
    tensors on a card, and on ``meta`` (a dry run models the card), and
    ``"rgb"`` on the CPU.  On a mesh ``leaf_axes``
    (one tuple of axis names a leaf) says which axes shard each leaf.
    """
    stats = _leaf_stats(updates, grads, momenta, params, leaf_axes, mesh)
    A, b, c = _problems(stats, delta, lam)
    if method is None:
        method = "kernel" if A.device.type in ("cuda", "meta") else "rgb"
    sol = get_solver(SolverSpec(backend=method, M=M_BOX),
                     device=A.device)(make_batch(A, b, c))
    s1 = torch.where(sol.feasible, sol.x[:, 0], 1.0)
    s2 = torch.where(sol.feasible, sol.x[:, 1], 0.0)

    new_leaves = []
    for i, (u, m) in enumerate(zip(tree_leaves(updates),
                                   tree_leaves(momenta), strict=True)):
        u32 = u.float()
        un, mn = stats[i][0], stats[i][4] + _EPS
        nu = (s1[i] * u32
              + 0.1 * un * s2[i] * m.float() / mn)
        new_leaves.append(nu.to(u.dtype))
    return tree_unflatten(updates, new_leaves), torch.mean(s1)
