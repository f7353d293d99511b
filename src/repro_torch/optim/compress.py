"""Error-feedback int8 gradient compression for the cross-pod all-reduce.

Counterpart of ``repro.optim.compress``.  The pod axis is the scarcest
bandwidth in a multi-pod mesh, so its gradient reduction is the one
compressed, with the classic error-feedback scheme (1-bit Adam / EF-SGD
lineage):

    e      <- residual carried from the last step
    q      = quantize(g + e)          # int8, one scale a tensor
    e'     = (g + e) - dequant(q)     # quantization error, fed back
    g_out  = psum(q, 'pod') * scale   # int8 payload, summed in int32

The scale is the max over the axis (a ``pmax``), so every pod dequantizes
with the same one.  Used by ``launch.steps.make_train_step(manual_comm=
True, compress_pod=True)``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import dist as D
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization.  Returns ``(q, scale)``."""
    amax = torch.amax(torch.abs(g.float()))
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compressed_psum(grads, error_state, axis_name: str, mesh
                    ) -> Tuple[Any, Any]:
    """Error-feedback compressed all-reduce of a gradient tree over
    ``axis_name``: the mean over the axis (the reference divides the sum
    by the axis size) and the new error state."""
    axes = (axis_name,)
    n = mesh.size(axes) if mesh is not None else 1

    def one(g, e):
        g32 = g.float() + e
        # one scale across the axis, so the integer sum is coherent
        amax = D.pmax(torch.amax(torch.abs(g32)), mesh, axes)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_e = g32 - q.float() * scale
        # the int8 payload goes on the wire; it is summed in int32 so the
        # sum cannot overflow
        summed = D.psum_int8(q, mesh, axes)
        return summed.float() * scale / n, new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(error_state), strict=True)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
