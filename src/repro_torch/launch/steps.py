"""The train step, the serving steps (prefill, decode) and the batch-sharded
LP step, on one card or on a mesh of ranks.

Counterpart of ``repro.launch.steps``.  The train step does what the
reference's does, in the same order:

1. loss and gradients: ``torch.autograd.grad`` of the token-weighted mean
   loss, psum'd over the data axes (:func:`per_rank_loss`);
2. on a mesh, the gradient reductions JAX's ``shard_map`` makes
   implicitly, made here explicitly and once: a sum over the data axes
   of every leaf FSDP does not shard (an FSDP leaf's arrives summed by its
   gather's backward).  Over the model axis nothing is added: the layers'
   conjugate collectives (``copy_model``) already give a model-replicated
   leaf its full gradient on every rank;
3. ``sync_duplicated_grads`` over the duplicated KV heads (on a mesh the
   duplicates of one head may sit on different model ranks: the leaf is
   gathered over the model axis for it);
4. ``optimizer.update`` (AdamW; its clip norm sums each leaf over the
   axes that shard it);
5. with ``lp_clip``, ``lp_constrain_updates(updates, grads, opt_state.m,
   params)`` — one batch of 2-D LPs, equal in bits on every rank, one
   ``rgb_cuda`` launch a rank on a card;
6. ``apply_updates``, written into the model's parameters in place;

and returns ``(params, opt_state, {"loss", "lp_s1"}, extra)``.  Steps
take the **global** batch, as the reference's jitted programs do, and
each rank takes its rows (the batch axes of :func:`batch_axes`).

``manual_comm=True`` is the reference's hand-written gradient path: each
rank differentiates its own token-weighted loss sum, the gradients are
summed over the inner data axis and then over ``pod`` — int8-compressed
with error feedback when ``compress_pod`` (``extra["err"]`` carries the
residual) — and divided by the global token count.

The serving steps run the model's ``prefill`` and ``decode`` without
autograd and gather the logits over the batch axes; the cache stays this
rank's shard (``model.cache_specs``).  The decode step writes into the
cache it is given, in place, where the reference donates the cache
(``donate_argnums=(2,)``).  Every step is eager PyTorch:
``Program.jit()`` returns it as it is (no ``torch.compile``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import dist as D
from repro_torch.launch.mesh import HostMesh, batch_axes, mesh_info
from repro_torch.models.common import MeshInfo, ModelConfig
from repro_torch.dist import flat_specs, gather_leaf, shard_of
from repro_torch.models.transformer import build_model
from repro_torch.optim import (AdamW, apply_updates, compressed_psum,
                               lp_constrain_updates, sync_duplicated_grads)
from repro_torch.tree import (copy_into_, flatten_with_paths, tree_leaves,
                              tree_unflatten, unflatten_with_paths)


@dataclasses.dataclass
class Program:
    """A step with what built it; a train program's ``grads(params,
    batch) -> (loss, grads)`` is its step's gradient stage (after the
    mesh's reductions, before the duplicated-KV sync)."""
    mesh: Any
    cfg: Optional[ModelConfig]
    model: Any
    step: Callable
    grads: Optional[Callable] = None

    def jit(self) -> Callable:
        """The step itself: PyTorch runs it eagerly."""
        return self.step


def _mesh_of(mesh):
    """The DistMesh, or None for the one-device HostMesh."""
    return None if isinstance(mesh, HostMesh) else mesh


def _spec_axes(spec) -> Tuple[str, ...]:
    out = []
    for e in spec:
        if e is not None:
            out += list(e) if isinstance(e, tuple) else [e]
    return tuple(out)


def local_batch(batch: Dict[str, torch.Tensor], mesh, bax
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (sharded over ``bax``)."""
    if _mesh_of(mesh) is None or bax is None:
        return batch
    return {k: shard_of(v, (bax,), mesh) for k, v in batch.items()}


def _gather_rows(x: torch.Tensor, mesh, bax) -> torch.Tensor:
    """The global rows from every rank's (sharded over ``bax``)."""
    if _mesh_of(mesh) is None or bax is None:
        return x
    if x.dtype == torch.bool:  # gloo moves no bool tensors
        return gather_leaf(x.to(torch.uint8), (bax,), mesh).bool()
    return gather_leaf(x, (bax,), mesh)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def per_rank_loss(model, params, batch, mi: MeshInfo) -> torch.Tensor:
    """The loss of this rank's rows, token-weighted and psum'd over the
    data axes: every rank returns the global mean, and its backward gives
    this rank's share of the gradient."""
    loss, metrics = model.loss(params, batch)
    n = metrics["tokens"].float()
    tot = loss * n
    if mi.mesh is not None:
        tot = D.psum(tot, mi.mesh, mi.data_axes)
        n = D.psum(n, mi.mesh, mi.data_axes)
    return tot / n


def _sync_duplicated(grads, dup, hd, specs, mi: MeshInfo):
    """``sync_duplicated_grads`` on whole leaves: a duplicated leaf that
    the model axis shards is gathered over it, averaged, and cut back."""
    mesh = mi.mesh
    if not dup or mesh is None or mi.model_size == 1:
        return sync_duplicated_grads(grads, dup, hd)
    flat = flatten_with_paths(grads)
    for path in dup:
        if path not in flat:
            continue
        spec = specs[path]
        model_only = tuple("model" if e == "model" else None for e in spec)
        whole = gather_leaf(flat[path], model_only, mesh)
        synced = sync_duplicated_grads({path: whole}, {path: dup[path]},
                                       hd)[path]
        flat[path] = shard_of(synced, model_only, mesh)
    return unflatten_with_paths(flat, grads)


def make_train_step(
    cfg: ModelConfig,
    mesh,
    optimizer: Optional[AdamW] = None,
    *,
    global_batch: int,
    lp_clip: bool = False,
    manual_comm: bool = False,
    compress_pod: bool = False,
) -> Program:
    """The training step for ``cfg`` on ``mesh``; the model is built on
    the mesh's device (parameters uninitialised: call
    ``program.model.init`` or load weights)."""
    mi = mesh_info(mesh)
    if manual_comm and cfg.fsdp:
        raise ValueError("manual_comm path requires fsdp=False "
                         "(FSDP grads already reduce-scatter in AD)")
    model = build_model(cfg, mi, device=mesh.device)
    optimizer = optimizer or AdamW()
    dup = model.kv_duplication()
    bax = batch_axes(mesh, global_batch)
    specs = flat_specs(model.full_param_specs())
    # the axes that shard each leaf, in tree_leaves order
    leaf_axes = [_spec_axes(specs[p]) for p in _leaf_paths(model)]
    dmesh = mi.mesh

    def reduce_data(grads):
        """Sum each data-replicated leaf's gradient over the data axes."""
        if dmesh is None or mi.data_size == 1:
            return grads
        out = []
        for g, axes in zip(tree_leaves(grads), leaf_axes):
            if any(a in mi.data_axes for a in axes):
                out.append(g)  # FSDP: summed by the gather's backward
            else:
                out.append(D.all_reduce(g, dmesh, mi.data_axes))
        return tree_unflatten(grads, out)

    def auto_grads(params, batch):
        with torch.enable_grad():
            loss = per_rank_loss(model, params, batch, mi)
            grads = tree_unflatten(params, torch.autograd.grad(
                loss, tree_leaves(params)))
        return loss.detach(), reduce_data(grads)

    def manual_grads(params, batch, err):
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch)
            n = metrics["tokens"].float()
            sl = loss * n
            grads = list(torch.autograd.grad(sl, tree_leaves(params)))
        sl, n = sl.detach(), n.detach()
        # no _model_sync: copy_model's backward has already summed a
        # model-replicated leaf's gradient over the model axis
        inner = tuple(a for a in mi.data_axes if a != "pod")
        grads = [D.all_reduce(g, dmesh, inner) for g in grads]
        sl, n = D.all_reduce(sl, dmesh, inner), D.all_reduce(n, dmesh, inner)
        new_err = err
        if "pod" in mi.data_axes:
            pod = ("pod",)
            if compress_pod:
                red, new_err = compressed_psum(
                    tree_unflatten(params, grads), err, "pod", dmesh)
                # the reference's psum, not mean
                grads = [g * dmesh.size(pod) for g in tree_leaves(red)]
            else:
                grads = [D.all_reduce(g, dmesh, pod) for g in grads]
            sl, n = D.all_reduce(sl, dmesh, pod), D.all_reduce(n, dmesh, pod)
        return sl / n, tree_unflatten(params, [g / n for g in grads]), new_err

    def leaf_sum(values):
        return D.sum_leaves(values, leaf_axes, dmesh)

    def step(params, opt_state, batch, extra):
        batch = local_batch(batch, mesh, bax)
        if manual_comm:
            loss, grads, new_err = manual_grads(params, batch,
                                                extra.get("err"))
            extra = {"err": new_err}
        else:
            loss, grads = auto_grads(params, batch)
        grads = _sync_duplicated(grads, dup, cfg.hd, specs, mi)
        updates, opt_state = optimizer.update(
            grads, opt_state, params,
            leaf_sum=leaf_sum if dmesh is not None else None)
        s1 = torch.ones((), dtype=torch.float32, device=loss.device)
        if lp_clip:
            updates, s1 = lp_constrain_updates(
                updates, grads, opt_state.m, params,
                leaf_axes=leaf_axes if dmesh is not None else None,
                mesh=dmesh)
        copy_into_(params, apply_updates(params, updates))
        metrics = {"loss": loss, "lp_s1": s1}
        return params, opt_state, metrics, extra

    def grads(params, batch):
        return auto_grads(params, local_batch(batch, mesh, bax))

    return Program(mesh=mesh, cfg=cfg, model=model, step=step, grads=grads)


def _leaf_paths(model) -> list:
    """Slash paths of the model's parameters in ``tree_leaves`` order."""
    tree = model.param_tree()
    flat = flatten_with_paths(tree)
    order = {id(v): k for k, v in flat.items()}
    return [order[id(leaf)] for leaf in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

def device_memory_bytes(device: torch.device) -> int:
    """The memory of the device the weights would live on: a card's own
    (``total_memory``), else the host's physical memory.  ``meta`` has
    none: a dry run passes the memory of the card it models."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    if device.type == "meta":
        raise ValueError("a meta device has no memory to ask: pass "
                         "memory_bytes (roofline.Peaks.memory_bytes of the "
                         "card a dry run models)")
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _serve_cfg(cfg: ModelConfig, mi: MeshInfo,
               weight_resident: Optional[bool],
               device: torch.device,
               memory_bytes: Optional[float] = None) -> ModelConfig:
    """Serving keeps weights resident (no per-token FSDP gather) whenever
    the tensor-parallel shard fits in 3/4 of the device's memory (the
    reference sizes this against a fixed TPU figure; the port asks the
    device unless ``memory_bytes`` is given).  ``weight_resident``: None =
    decide so."""
    if not cfg.fsdp:
        return cfg
    if weight_resident is None:
        shard = cfg.param_count() * 2 / max(mi.model_size, 1)
        if memory_bytes is None:
            memory_bytes = device_memory_bytes(device)
        weight_resident = shard < 0.75 * memory_bytes
    if weight_resident:
        return dataclasses.replace(cfg, fsdp=False)
    return cfg


def make_prefill_step(cfg: ModelConfig, mesh, *, global_batch: int,
                      weight_resident: Optional[bool] = None,
                      model=None,
                      memory_bytes: Optional[float] = None) -> Program:
    """``step(params, batch) -> (last-position logits, cache)``: the
    global batch in, the global logits out, the cache this rank's shard.
    The model is built on ``mesh``'s device (parameters uninitialised)
    unless ``model`` is given: a model owns its parameters here, so the
    prefill and decode programs of one server share one.
    ``memory_bytes`` (default: the device's) sizes ``weight_resident``."""
    mi = mesh_info(mesh)
    cfg = _serve_cfg(cfg, mi, weight_resident, mesh.device, memory_bytes)
    model = model if model is not None else build_model(
        cfg, mi, device=mesh.device)
    bax = batch_axes(mesh, global_batch)

    def step(params, batch):
        logits, cache = model.prefill(params, local_batch(batch, mesh, bax))
        return _gather_rows(logits, mesh, bax), cache

    return Program(mesh=mesh, cfg=cfg, model=model, step=step)


def make_decode_step(cfg: ModelConfig, mesh, *, global_batch: int,
                     weight_resident: Optional[bool] = None,
                     model=None,
                     memory_bytes: Optional[float] = None) -> Program:
    """``step(params, {"token", "pos"}, cache) -> (logits, cache)``: one
    token a row (the global batch), written into this rank's ``cache`` in
    place (the reference donates the cache to its step; a caller who
    needs the old cache clones it first).  ``memory_bytes`` as for
    :func:`make_prefill_step`."""
    mi = mesh_info(mesh)
    cfg = _serve_cfg(cfg, mi, weight_resident, mesh.device, memory_bytes)
    model = model if model is not None else build_model(
        cfg, mi, device=mesh.device)
    bax = batch_axes(mesh, global_batch)

    def step(params, batch, cache):
        logits, cache = model.decode(params, local_batch(batch, mesh, bax),
                                     cache)
        return _gather_rows(logits, mesh, bax), cache

    return Program(mesh=mesh, cfg=cfg, model=model, step=step)


# ---------------------------------------------------------------------------
# The paper's LP solver on the mesh (batch-parallel)
# ---------------------------------------------------------------------------

def make_lp_step(mesh, *, batch: int, m: int, method: str = "rgb",
                 dtype: torch.dtype = torch.float32) -> Program:
    """Batch 2-D LP solve sharded over every mesh axis (pure data
    parallelism over problems — the paper's regime at cluster scale).
    ``step({"A", "b", "c", "m_valid"})`` takes the global batch and
    returns the global ``{"x", "feasible", "objective"}`` on every rank;
    ``method`` is ``"rgb"`` or anything else for ``"naive"``, as the
    reference's."""
    from repro_torch.core.lp import LPBatch
    from repro_torch.core.seidel import solve_naive, solve_rgb

    mi = mesh_info(mesh)
    all_axes = mi.data_axes + (mi.model_axis,)
    solver = solve_rgb if method == "rgb" else solve_naive

    def step(batch_dict):
        local = local_batch(batch_dict, mesh, all_axes)
        sol = solver(LPBatch(**{k: v.to(dtype) if v.is_floating_point()
                                else v for k, v in local.items()}))
        out = {"x": sol.x, "feasible": sol.feasible,
               "objective": sol.objective}
        return {k: _gather_rows(v, mesh, all_axes) for k, v in out.items()}

    return Program(mesh=mesh, cfg=None, model=None, step=step)

