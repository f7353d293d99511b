"""AdamW on parameter trees, with the reference's math.

Counterpart of ``repro.optim.adamw``: fp32 ``m`` and ``v`` whatever the
parameter's dtype, a global-norm gradient clip, weight decay only on
leaves with ``ndim >= 2``, and ``(p.float() + u).to(p.dtype)`` to apply an
update.  Trees are nested dicts of tensors walked in the reference's
order (:mod:`repro_torch.tree`); every function is functional (returns new
tensors), as the reference's are.

``sync_duplicated_grads`` averages gradients across the KV-head copies
that the padded head layout introduced (``models.transformer.
init_attn_params`` tiles them identically at init; averaging keeps them
identical, which keeps the padded layout equal to the real GQA
architecture).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import (flatten_with_paths, tree_leaves, tree_map,
                              unflatten_with_paths)


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        leaf = tree_leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        grads = tree_map(lambda g: g.float(), grads)
        if self.grad_clip:
            gn = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gn + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        b1c = 1.0 - self.b1 ** step.float()
        b2c = 1.0 - self.b2 ** step.float()

        new_m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                         state.m, grads)
        new_v = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                         state.v, grads)

        def upd(p, m, v):
            mh = m / b1c
            vh = v / b2c
            u = mh / (torch.sqrt(vh) + self.eps)
            if self.weight_decay and p.ndim >= 2:
                u = u + self.weight_decay * p.float()
            return -self.lr * u

        updates = tree_map(upd, params, new_m, new_v)
        return updates, AdamWState(step=step, m=new_m, v=new_v)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                    params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


# ---------------------------------------------------------------------------
# Duplicated-KV gradient averaging
# ---------------------------------------------------------------------------

@torch.no_grad()
def sync_duplicated_grads(grads, dup_map: Dict[str, int], hd: int):
    """dup_map: slash-path -> replication factor.  The duplicated axis is
    always the trailing (kv_total*hd) weight column / bias axis laid out
    head-major, so averaging is reshape (..., n_kv, rep, hd) -> mean."""
    if not dup_map:
        return grads
    flat = flatten_with_paths(grads)
    for path, rep in dup_map.items():
        if path not in flat:
            continue
        g = flat[path]
        last = g.shape[-1]
        n_kv = last // (rep * hd)
        gr = g.reshape(g.shape[:-1] + (n_kv, rep, hd))
        gr = gr.mean(dim=-2, keepdim=True).expand(gr.shape)
        flat[path] = gr.reshape(g.shape)
    return unflatten_with_paths(flat, grads)
