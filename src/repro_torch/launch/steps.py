"""The train step, on one card.

Counterpart of ``repro.launch.steps.make_train_step``.  The step does what
the reference's does, in the same order:

1. loss and gradients (``torch.autograd.grad`` of the token-weighted mean
   loss over the data axis — one shard here);
2. ``sync_duplicated_grads`` over the duplicated KV heads;
3. ``optimizer.update`` (AdamW);
4. with ``lp_clip``, ``lp_constrain_updates(updates, grads, opt_state.m,
   params)`` — one batch of 2-D LPs, one ``rgb_cuda`` launch on a card;
5. ``apply_updates``, written into the model's parameters in place;

and returns ``(params, opt_state, {"loss", "lp_s1"}, extra)``.  The step
is eager PyTorch: ``Program.jit()`` returns it as it is (no
``torch.compile``).  The manual-communication path and its int8
compression across pods need several cards (ROADMAP A9g) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.launch.mesh import HostMesh, mesh_info
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import build_model
from repro_torch.optim import (AdamW, apply_updates, lp_constrain_updates,
                               sync_duplicated_grads)
from repro_torch.tree import copy_into_, tree_leaves, tree_unflatten


@dataclasses.dataclass
class Program:
    """A step with what built it."""
    mesh: HostMesh
    cfg: ModelConfig
    model: Any
    step: Callable

    def jit(self) -> Callable:
        """The step itself: PyTorch runs it eagerly."""
        return self.step


def make_train_step(
    cfg: ModelConfig,
    mesh: HostMesh,
    optimizer: Optional[AdamW] = None,
    *,
    global_batch: int,
    lp_clip: bool = False,
    manual_comm: bool = False,
    compress_pod: bool = False,
) -> Program:
    """The training step for ``cfg`` on ``mesh``'s device; the model is
    built there (parameters uninitialised: call ``program.model.init``
    or load weights)."""
    if manual_comm or compress_pod:
        raise NotImplementedError(
            "manual_comm / compress_pod exchange gradients between cards; "
            "multi-card training is not ported yet (ROADMAP A9g)")
    mi = mesh_info(mesh)
    model = build_model(cfg, mi, device=mesh.device)
    optimizer = optimizer or AdamW()
    dup = model.kv_duplication()

    def loss_fn(params, batch):
        loss, metrics = model.loss(params, batch)
        # the token-weighted mean over data shards, as the reference forms
        # it (one shard here)
        n = metrics["tokens"].float()
        tot = loss * n
        return tot / n

    def step(params, opt_state, batch, extra):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = tree_unflatten(
                params, torch.autograd.grad(loss, leaves))
        grads = sync_duplicated_grads(grads, dup, cfg.hd)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        s1 = torch.ones((), dtype=torch.float32, device=loss.device)
        if lp_clip:
            updates, s1 = lp_constrain_updates(
                updates, grads, opt_state.m, params)
        copy_into_(params, apply_updates(params, updates))
        metrics = {"loss": loss.detach(), "lp_s1": s1}
        return params, opt_state, metrics, extra

    return Program(mesh=mesh, cfg=cfg, model=model, step=step)
