"""The dense decoder LM as an ``nn.Module``, in the reference's layout.

Counterpart of ``repro.models.transformer`` for ``family == "dense"`` on
one card.  ``DecoderLM`` holds one ``nn.Parameter`` per leaf of the
reference's parameter tree, under the reference's names and in its
**stacked** layout: ``emb``, ``lm_head``, ``final_norm`` and
``blocks/{wq,wk,wv,wo,bq,bk,bv,ln1,ln2,w_gate,w_up,w_down}``, each block
leaf shaped ``(n_layers, ...)``.  It is not split into per-layer modules
because the LP trust-region clip (``optim.lp_clip``) poses one LP per
leaf: another split would change the LP batch and its answer.

    model = build_model(cfg, mi, device="cpu")   # the card by default
    params = model.init(torch.Generator().manual_seed(0))  # the tree
    loss, metrics = model.loss(params, batch)

The layer scan is a loop over layer slices (``unbind`` of each stacked
leaf, so the backward stacks the per-layer gradients once), each block
under ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat``.
Weights cross between the packages as numpy: :func:`params_from_numpy`
loads the reference's ``model.init(key)`` tree, :func:`params_to_numpy`
gives the port's parameters back in that tree.  The ``moe``, ``vlm``,
``ssm``, ``hybrid`` and ``encdec`` families are later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, as_device
from repro_torch.models import layers as L
from repro_torch.models.common import (HeadLayout, MeshInfo, ModelConfig,
                                       head_layout, pad_vocab,
                                       q_head_permutation)
from repro_torch.tree import copy_into_, flatten_with_paths

Params = Dict[str, Any]

# Where each family not ported yet is queued.
_LATER = {
    "moe": "ROADMAP A9c (MoE)",
    "vlm": "ROADMAP A9d (VLM)",
    "ssm": "ROADMAP A9e (SSM/hybrid)",
    "hybrid": "ROADMAP A9e (SSM/hybrid)",
    "encdec": "ROADMAP A9f (encoder-decoder)",
}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense_init(g: torch.Generator, shape, dtype, device, scale=0.02):
    return (torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Attention block params
# ---------------------------------------------------------------------------

def attn_param_shapes(cfg: ModelConfig, lay: HeadLayout, n_layers: int):
    d, hd = cfg.d_model, cfg.hd
    sh = {
        "wq": (n_layers, d, lay.h_pad * hd),
        "wk": (n_layers, d, lay.kv_total * hd),
        "wv": (n_layers, d, lay.kv_total * hd),
        "wo": (n_layers, lay.h_pad * hd, d),
    }
    if cfg.qkv_bias:
        sh["bq"] = (n_layers, lay.h_pad * hd)
        sh["bk"] = (n_layers, lay.kv_total * hd)
        sh["bv"] = (n_layers, lay.kv_total * hd)
    return sh


def init_attn_params(g: torch.Generator, cfg: ModelConfig, lay: HeadLayout,
                     n_layers: int, out_scale: float, device):
    """Random init with (a) zero columns/rows for padded q heads so the
    padded layout computes exactly the real architecture, (b) KV weights
    drawn once per real head and *tiled* across the duplicated heads so
    duplicates start (and, with grad sync, stay) identical.  The same
    distributions and scales as the reference; the stream is torch's."""
    d, hd = cfg.d_model, cfg.hd
    dt = _dt(cfg)
    perm = torch.as_tensor(q_head_permutation(lay), device=device)
    qmask = (perm >= 0).to(dt)
    rep = lay.kv_total // lay.n_kv

    wq = _dense_init(g, (n_layers, d, lay.h_pad, hd), dt, device)
    wq = (wq * qmask[None, None, :, None]).reshape(n_layers, d, -1)
    wo = _dense_init(g, (n_layers, lay.h_pad, hd, d), dt, device, out_scale)
    wo = (wo * qmask[None, :, None, None]).reshape(n_layers, -1, d)

    def kv():
        real = _dense_init(g, (n_layers, d, lay.n_kv, hd), dt, device)
        return torch.repeat_interleave(real, rep, dim=2).reshape(
            n_layers, d, -1)

    p = {"wq": wq, "wk": kv(), "wv": kv(), "wo": wo}
    if cfg.qkv_bias:
        bq = _dense_init(g, (n_layers, lay.h_pad, hd), dt, device)
        p["bq"] = (bq * qmask[None, :, None]).reshape(n_layers, -1)
        for nm in ("bk", "bv"):
            real = _dense_init(g, (n_layers, lay.n_kv, hd), dt, device)
            p[nm] = torch.repeat_interleave(real, rep, dim=1).reshape(
                n_layers, -1)
    return p


def kv_duplication(cfg: ModelConfig, lay: HeadLayout) -> Dict[str, int]:
    """Param-name -> replication factor for cross-duplicate grad averaging
    (see optim.sync_duplicated_grads)."""
    rep = lay.kv_total // lay.n_kv
    if rep <= 1:
        return {}
    names = ["wk", "wv"] + (["bk", "bv"] if cfg.qkv_bias else [])
    return {n: rep for n in names}


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------

class BaseModel(nn.Module):
    """What every family shares: the config, the mesh bookkeeping and the
    padded vocabulary.  Parameters are allocated, uninitialised, on
    ``device`` (``"meta"`` allocates nothing: shapes only)."""

    def __init__(self, cfg: ModelConfig, mi: MeshInfo,
                 device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.mi = mi
        self.tp = mi.model_size
        self.v_pad = pad_vocab(cfg.vocab, self.tp)
        self.fsdp_size = mi.data_size if cfg.fsdp else 1
        self.device = as_device(device)

    def param_tree(self) -> Params:
        """The parameters as the reference's nested dict (the
        ``nn.Parameter`` objects themselves, not copies)."""
        raise NotImplementedError

    def param_shapes(self) -> Dict[str, tuple]:
        """``{"blocks/wq": (L, d, h_pad*hd), ...}`` in slash paths."""
        return {k: tuple(v.shape)
                for k, v in flatten_with_paths(self.param_tree()).items()}

    def loss(self, params, batch):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Decoder-only LM: dense
# ---------------------------------------------------------------------------

class DecoderLM(BaseModel):
    def __init__(self, cfg: ModelConfig, mi: MeshInfo,
                 device: DeviceLike = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                f"({_LATER.get(cfg.family, 'ROADMAP A9c-A9f')})")
        super().__init__(cfg, mi, device)
        self.lay = head_layout(cfg, self.tp)
        dt = _dt(cfg)

        def param(shape):
            return nn.Parameter(torch.empty(shape, dtype=dt,
                                            device=self.device))

        d = cfg.d_model
        self.emb = param((self.v_pad, d))
        self.lm_head = param((self.v_pad, d))
        self.final_norm = param((d,))
        self.blocks = nn.ParameterDict(
            {k: param(s) for k, s in self._block_shapes().items()})

    def _block_shapes(self):
        cfg, lay, Lr = self.cfg, self.lay, self.cfg.n_layers
        d, f = cfg.d_model, cfg.d_ff
        sh = dict(attn_param_shapes(cfg, lay, Lr))
        sh["ln1"] = (Lr, d)
        sh["ln2"] = (Lr, d)
        sh["w_gate"] = (Lr, d, f)
        sh["w_up"] = (Lr, d, f)
        sh["w_down"] = (Lr, f, d)
        return sh

    def param_tree(self) -> Params:
        return {"emb": self.emb, "lm_head": self.lm_head,
                "final_norm": self.final_norm,
                "blocks": dict(self.blocks.items())}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Params:
        """Fill the parameters in place from ``generator`` (on the
        parameters' device) in the reference's draw order; returns
        :meth:`param_tree`."""
        cfg, lay = self.cfg, self.lay
        dt, dev = _dt(cfg), self.device
        d, f, Lr = cfg.d_model, cfg.d_ff, cfg.n_layers
        out_scale = 0.02 / (2 * Lr) ** 0.5
        blocks = init_attn_params(generator, cfg, lay, Lr, out_scale, dev)
        blocks["ln1"] = torch.ones((Lr, d), dtype=dt, device=dev)
        blocks["ln2"] = torch.ones((Lr, d), dtype=dt, device=dev)
        blocks["w_gate"] = _dense_init(generator, (Lr, d, f), dt, dev)
        blocks["w_up"] = _dense_init(generator, (Lr, d, f), dt, dev)
        blocks["w_down"] = _dense_init(generator, (Lr, f, d), dt, dev,
                                       out_scale)
        tree = {
            "emb": _dense_init(generator, (self.v_pad, d), dt, dev),
            "lm_head": _dense_init(generator, (self.v_pad, d), dt, dev),
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
            "blocks": blocks,
        }
        copy_into_(self.param_tree(), tree)
        return self.param_tree()

    def kv_duplication(self):
        return {f"blocks/{k}": v
                for k, v in kv_duplication(self.cfg, self.lay).items()}

    # -- forward ------------------------------------------------------------
    def _block(self, h, names, *leaves):
        cfg, mi = self.cfg, self.mi
        p = dict(zip(names, leaves))
        a, _ = L.attn_layer(p, L.rms_norm(h, p["ln1"], cfg.norm_eps), mi,
                            self.lay, cfg, mode="train")
        h = h + a
        hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + L.mlp_glu(p, hn, mi, gelu=cfg.gelu_glu)

    def _trunk(self, params, h):
        cfg = self.cfg
        names = sorted(params["blocks"])
        per_layer = [params["blocks"][k].unbind(0) for k in names]
        for i in range(cfg.n_layers):
            leaves = [s[i] for s in per_layer]
            if cfg.remat:
                h = checkpoint(self._block, h, names, *leaves,
                               use_reentrant=False)
            else:
                h = self._block(h, names, *leaves)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps)

    def _embed(self, params, ids):
        cfg = self.cfg
        h = L.embed_lookup(params["emb"], ids, self.mi)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                                 device=h.device)
        return h

    def loss(self, params, batch):
        """``(loss, {"ce", "aux", "tokens"})`` for ``batch``
        ``{"tokens", "labels"}`` (B, S), as the reference's
        ``DecoderLM.loss``.  ``params`` is normally
        :meth:`param_tree`."""
        cfg = self.cfg
        h = self._embed(params, batch["tokens"])
        h = self._trunk(params, h)
        loss, n = L.lm_head_loss(h, params["lm_head"], batch["labels"],
                                 self.mi, vocab_real=cfg.vocab)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss + 0.01 * aux / max(cfg.n_layers, 1), {
            "ce": loss, "aux": aux, "tokens": n}


def build_model(cfg: ModelConfig, mi: MeshInfo,
                device: DeviceLike = None) -> BaseModel:
    """The model for ``cfg`` on ``device`` (default: the card).  Families
    other than ``dense`` raise ``NotImplementedError`` naming the ROADMAP
    item that ports them."""
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({_LATER[cfg.family]})")
    if cfg.family == "dense":
        return DecoderLM(cfg, mi, device)
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Weights across the two packages
# ---------------------------------------------------------------------------

def _tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (numpy's extension
    type, or a void of two bytes) keeps its bits."""
    a = np.array(a)  # a writable copy: the caller's may be read-only
    if a.dtype.name == "bfloat16" or a.dtype.kind == "V":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(model: BaseModel, tree) -> Params:
    """Load the reference's parameter tree (``model.init(key)`` of
    ``repro``, leaves as numpy arrays) into ``model`` in place; returns
    :meth:`~BaseModel.param_tree`.  Leaves are cast to the model's dtype
    (exact for the reference's own dtype)."""
    copy_into_(model.param_tree(), _tree_from(tree, model.param_tree()))
    return model.param_tree()


def _tree_from(node, like):
    if isinstance(like, dict):
        if set(node) != set(like):
            raise ValueError(f"keys {sorted(node)} are not the model's "
                             f"{sorted(like)}")
        return {k: _tree_from(node[k], v) for k, v in like.items()}
    return _tensor_from_numpy(node).to(like.dtype)


def params_to_numpy(model_or_tree) -> Params:
    """The port's parameters in the reference's tree, as numpy arrays
    (bfloat16 leaves widened to float32, which is exact)."""
    tree = (model_or_tree.param_tree()
            if isinstance(model_or_tree, BaseModel) else model_or_tree)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        # a copy: on the CPU ``numpy()`` would alias the parameter, which
        # the train step updates in place
        t = node.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return rec(tree)
