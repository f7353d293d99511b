"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

Counterpart of ``repro.launch.pipeline``.  Layers are partitioned into S
stages (one a rank of the ``pipe`` axis) and microbatches stream through,
the boundary activations moved to the next stage by ``ppermute`` (point
to point sends and receives).  The schedule is the classic GPipe
fill-drain: M microbatches finish in M + S - 1 ticks with bubble fraction
(S-1)/(M+S-1).

The engine is model-agnostic: any per-rank stage function
``fn(stage_params, x) -> x`` can be pipelined.  ``torch.autograd`` runs
back through the whole schedule (``ppermute``'s backward sends each
cotangent back along the inverse permutation), so it composes with a
training step.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import dist as D


def gpipe(
    fn_stage: Callable,
    stage_params,
    x_microbatches: torch.Tensor,  # (M, mb, ...) input microbatches
    *,
    n_stages: int,
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``fn_stage`` as a pipeline across the ``n_stages`` ranks of
    ``axis`` of ``mesh``.  Per-rank code: ``stage_params`` is this rank's
    stage; every rank receives the full microbatch array (the first stage
    consumes it; the others ignore it).

    Returns the (M, mb, ...) outputs of the LAST stage on every rank of
    the axis (combined with a masked psum)."""
    M = x_microbatches.shape[0]
    axes = (axis,)
    stage = D.axis_index(mesh, axes)
    dev = x_microbatches.device
    # where-masks, as the reference's jnp.where: every rank builds the
    # same graph, so every ppermute's backward runs on every rank
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == n_stages - 1, device=dev)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    buf = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(M + n_stages - 1):
        # stage 0 injects microbatch t (clipped); the others take the
        # neighbour's output from the previous tick
        inject = x_microbatches[min(max(t, 0), M - 1)]
        y = fn_stage(stage_params, torch.where(is_first, inject, buf))
        # collect once the pipe has filled (real on the last stage only)
        if t >= n_stages - 1:
            outs.append(y)
        # shift boundary activations to the next stage
        buf = D.ppermute(y, mesh, axes, perm)
    # only the last stage holds real outputs; make them replicated
    acc = torch.where(is_last, torch.stack(outs), 0.0)
    return D.psum(acc, mesh, axes)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe bubble overhead: idle-tick share of the schedule."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
