"""The train step and the serving steps (prefill, decode), on one card.

Counterpart of ``repro.launch.steps``' ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``.  The step does what
the reference's does, in the same order:

1. loss and gradients (``torch.autograd.grad`` of the token-weighted mean
   loss over the data axis — one shard here);
2. ``sync_duplicated_grads`` over the duplicated KV heads;
3. ``optimizer.update`` (AdamW);
4. with ``lp_clip``, ``lp_constrain_updates(updates, grads, opt_state.m,
   params)`` — one batch of 2-D LPs, one ``rgb_cuda`` launch on a card;
5. ``apply_updates``, written into the model's parameters in place;

and returns ``(params, opt_state, {"loss", "lp_s1"}, extra)``.  The
serving steps run the model's ``prefill`` and ``decode`` without
autograd; the decode step writes into the cache it is given, in place,
where the reference donates the cache (``donate_argnums=(2,)``).  Every
step is eager PyTorch: ``Program.jit()`` returns it as it is (no
``torch.compile``).  The manual-communication path and its int8
compression across pods need several cards (ROADMAP A9g) and raise.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import torch

from repro_torch.launch.mesh import HostMesh, mesh_info
from repro_torch.models.common import MeshInfo, ModelConfig
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


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

def device_memory_bytes(device: torch.device) -> int:
    """The memory of the device the weights would live on: a card's own
    (``total_memory``), else the host's physical memory."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _serve_cfg(cfg: ModelConfig, mi: MeshInfo,
               weight_resident: Optional[bool],
               device: torch.device) -> ModelConfig:
    """Serving keeps weights resident (no per-token FSDP gather) whenever
    the tensor-parallel shard fits in 3/4 of the device's memory (the
    reference sizes this against a fixed TPU figure; the port asks the
    device).  ``weight_resident``: None = decide so.  On one card the
    choice changes no number: ``gather_fsdp`` is the identity there."""
    if not cfg.fsdp:
        return cfg
    if weight_resident is None:
        shard = cfg.param_count() * 2 / max(mi.model_size, 1)
        weight_resident = shard < 0.75 * device_memory_bytes(device)
    if weight_resident:
        return dataclasses.replace(cfg, fsdp=False)
    return cfg


def make_prefill_step(cfg: ModelConfig, mesh: HostMesh, *,
                      global_batch: int,
                      weight_resident: Optional[bool] = None,
                      model=None) -> Program:
    """``step(params, batch) -> (last-position logits, cache)``.  The
    model is built on ``mesh``'s device (parameters uninitialised) unless
    ``model`` is given: a model owns its parameters here, so the prefill
    and decode programs of one server share one."""
    mi = mesh_info(mesh)
    cfg = _serve_cfg(cfg, mi, weight_resident, mesh.device)
    model = model if model is not None else build_model(
        cfg, mi, device=mesh.device)

    def step(params, batch):
        return model.prefill(params, batch)

    return Program(mesh=mesh, cfg=cfg, model=model, step=step)


def make_decode_step(cfg: ModelConfig, mesh: HostMesh, *,
                     global_batch: int,
                     weight_resident: Optional[bool] = None,
                     model=None) -> Program:
    """``step(params, {"token", "pos"}, cache) -> (logits, cache)``: one
    token a row, written into ``cache`` in place (the reference donates
    the cache to its step; a caller who needs the old cache clones it
    first)."""
    mi = mesh_info(mesh)
    cfg = _serve_cfg(cfg, mi, weight_resident, mesh.device)
    model = model if model is not None else build_model(
        cfg, mi, device=mesh.device)

    def step(params, batch, cache):
        return model.decode(params, batch, cache)

    return Program(mesh=mesh, cfg=cfg, model=model, step=step)
