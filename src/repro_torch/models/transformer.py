"""The model families as ``nn.Module``s, in the reference's layout: the
decoder LM (``dense``, ``moe``, ``vlm``), the encoder-decoder
(``encdec``), the Mamba2 LM (``ssm``) and the hybrid (``hybrid``: Mamba2
layers and one shared attention block).

Counterpart of ``repro.models.transformer``.  Each model holds
one ``nn.Parameter`` per leaf of the reference's parameter tree, under the
reference's names and in its **stacked** layout: ``DecoderLM`` has
``emb``, ``lm_head``, ``final_norm``, ``blocks/{wq,wk,wv,wo,bq,bk,bv,ln1,
ln2,w_gate,w_up,w_down,w_router,dw_gate,dw_up,dw_down}`` (as the config
asks) and, for the VLM, ``vis_proj``/``vis_out``; ``EncDecLM`` has
``enc/...`` and ``dec/...`` stacks (the decoder's cross-attention under
``x_``) with ``enc_norm``; ``SSMLM`` has ``emb``, ``lm_head``,
``final_norm`` and ``blocks/{ln,w_z,w_x,w_B,w_C,w_dt,dt_bias,A_log,D,
conv_x,conv_B,conv_C,norm,w_out}``, and ``HybridLM`` adds the unstacked
``shared/...`` block.  Each block leaf is shaped ``(n_layers, ...)``;
``A_log`` and ``dt_bias`` are float32 whatever the model's dtype, as in
the reference.

On a mesh (``mi.mesh`` a :class:`~repro_torch.launch.mesh.DistMesh` of
more than one rank) each parameter holds this rank's shard: the
reference's ``full_param_specs()`` (plain tuples of axis names here, one
entry a dim: ``None``, ``"model"`` or a tuple of data axes for FSDP) say
which.  ``shard_params`` cuts the reference's global numpy tree into this
rank's shards and ``unshard_params`` gathers them back; FSDP leaves are
gathered layer by layer inside the forward (``gather_fsdp``, with the
reference's ``block_plan`` / ``top_plan`` / ``enc_plan`` / ``dec_plan`` /
``shared_plan``).
The stacks are not split into per-layer modules because the LP
trust-region clip (``optim.lp_clip``) poses one LP per leaf: another split
would change the LP batch and its answer.

    model = build_model(cfg, mi, device="cpu")   # the card by default
    params = model.init(torch.Generator().manual_seed(0))  # the tree
    loss, metrics = model.loss(params, batch)
    logits, cache = model.prefill(params, batch)   # last position's logits
    cache = ...                                    # grown to the full length
    logits, cache = model.decode(params, {"token": t, "pos": p}, cache)

The layer scan is a loop over layer slices (``unbind`` of each stacked
leaf, so the backward stacks the per-layer gradients once), each training
block under ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat``.
``prefill`` and ``decode`` run without autograd; ``decode`` writes each
new token's K/V, and the SSM state and conv windows, into the cache it is
given, **in place** (the reference returns a new cache and its serving
step donates the old one).  Weights cross between the packages as numpy:
:func:`params_from_numpy` loads the reference's ``model.init(key)`` tree,
:func:`params_to_numpy` gives the port's parameters back in that tree.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, as_device
from repro_torch.dist import flat_specs, gather_leaf, local_shape, shard_of
from repro_torch.models import layers as L
from repro_torch.models.common import (HeadLayout, MeshInfo, ModelConfig,
                                       fsdp_dim, head_layout, pad_vocab,
                                       q_head_permutation)
from repro_torch.tree import (copy_into_, flatten_with_paths,
                              unflatten_with_paths)

Params = Dict[str, Any]


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


def attn_param_specs(cfg: ModelConfig, stacked: bool = True):
    n = (None,) if stacked else ()
    sp = {
        "wq": (*n, None, "model"),
        "wk": (*n, None, "model"),
        "wv": (*n, None, "model"),
        "wo": (*n, "model", None),
    }
    if cfg.qkv_bias:
        sp["bq"] = (*n, "model")
        sp["bk"] = (*n, "model")
        sp["bv"] = (*n, "model")
    return sp


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
        self.mesh = mi.mesh
        # on a mesh the parameters are laid out on "meta" first and
        # allocated as this rank's shards by build_model (_localize)
        self.sharded = mi.mesh is not None and (mi.model_size > 1
                                                or mi.data_size > 1)
        self._plans: Dict[str, Any] = {}

    def _param(self, shape, dtype=None) -> nn.Parameter:
        dev = torch.device("meta") if self.sharded else self.device
        return nn.Parameter(torch.empty(shape, dtype=dtype or _dt(self.cfg),
                                        device=dev))

    def _stack(self, shapes: Dict[str, tuple],
               dtypes: Optional[Dict[str, torch.dtype]] = None
               ) -> nn.ParameterDict:
        """One parameter a leaf, of the model's dtype unless ``dtypes``
        names the leaf."""
        dtypes = dtypes or {}
        return nn.ParameterDict({k: self._param(s, dtypes.get(k))
                                 for k, s in shapes.items()})

    def param_tree(self) -> Params:
        """The parameters as the reference's nested dict (the
        ``nn.Parameter`` objects themselves, not copies)."""
        raise NotImplementedError

    def param_shapes(self) -> Dict[str, tuple]:
        """``{"blocks/wq": (L, d, h_pad*hd), ...}`` in slash paths."""
        return {k: tuple(v.shape)
                for k, v in flatten_with_paths(self.param_tree()).items()}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Params:
        """Fill the parameters in place from ``generator`` (on the
        parameters' device) in the reference's draw order; returns
        :meth:`param_tree`.  On a mesh every rank draws the whole tree
        (from the same seed) and keeps its shards."""
        if not self.sharded:
            return self._init_local(generator)
        twin = type(self)(self.cfg, MeshInfo(), device=self.device)
        twin._init_local(generator)
        _load_shards(self, flatten_with_paths(twin.param_tree()))
        return self.param_tree()

    def _init_local(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    # -- sharding: the reference's specs and FSDP plans ----------------------
    def _plan(self, shapes: Dict[str, Tuple[int, ...]],
              specs: Dict[str, tuple], stacked: bool,
              min_elems: Optional[int] = None) -> Dict[str, Any]:
        """Plan dims are in *sliced per-layer, per-model-rank local*
        coordinates (what gather_fsdp sees inside a block).
        -1 = not FSDP-sharded (replicated over data)."""
        if min_elems is None:
            min_elems = self.cfg.fsdp_min_elems
        plan = {}
        for name, shape in shapes.items():
            if self.fsdp_size <= 1:
                plan[name] = -1
                continue
            local = list(shape)
            skip = set()
            for i, ax in enumerate(specs[name]):
                axes = ax if isinstance(ax, tuple) else (ax,)
                if "model" in axes:
                    local[i] //= self.tp
                    skip.add(i)
            if stacked:
                local = local[1:]
                skip = {i - 1 for i in skip if i > 0}
            if math.prod(local) < min_elems:
                plan[name] = -1
                continue
            dim = fsdp_dim(tuple(local), self.fsdp_size,
                           skip_dims=tuple(skip))
            plan[name] = -1 if dim is None else dim
        return plan

    def _merge_fsdp_specs(self, specs: Dict[str, tuple], plans: Dict[str, Any],
                          shapes: Dict[str, Tuple[int, ...]],
                          offset: int) -> Dict[str, tuple]:
        """Insert the data-axes FSDP sharding into the model-parallel spec
        at the plan's dim (+offset for the stacked-L dim)."""
        if self.fsdp_size <= 1:
            return specs
        out = {}
        for name, sp in specs.items():
            dim = plans.get(name, -1)
            if dim is None or dim < 0:
                out[name] = sp
                continue
            g = dim + offset
            entries = list(sp) + [None] * (len(shapes[name]) - len(sp))
            assert entries[g] is None, (name, entries, g)
            entries[g] = self.mi.data_axes
            out[name] = tuple(entries)
        return out

    def _memo_plan(self, name: str, make):
        if name not in self._plans:
            self._plans[name] = make()
        return self._plans[name]

    def top_plan(self):
        shapes = {"emb": (self.v_pad, self.cfg.d_model),
                  "lm_head": (self.v_pad, self.cfg.d_model)}
        specs = {"emb": ("model", None), "lm_head": ("model", None)}
        return self._memo_plan("top", lambda: self._plan(shapes, specs,
                                                          stacked=False))

    def _top_shapes(self):
        return {"emb": (self.v_pad, self.cfg.d_model),
                "lm_head": (self.v_pad, self.cfg.d_model)}

    def _merge_top(self, sp):
        """``sp`` with the FSDP sharding of ``emb`` / ``lm_head`` merged."""
        top = self._merge_fsdp_specs(
            {"emb": sp["emb"], "lm_head": sp["lm_head"]}, self.top_plan(),
            self._top_shapes(), offset=0)
        sp.update(top)
        return sp

    def param_specs(self):
        raise NotImplementedError

    def full_param_specs(self):
        """param_specs() with FSDP data-axis sharding merged in."""
        raise NotImplementedError

    def _top(self, params, name: str):
        """``emb`` or ``lm_head``, gathered over the data axes if FSDP
        shards it."""
        return L.gather_fsdp({name: params[name]},
                             {name: self.top_plan()[name]}, self.mi)[name]

    def loss(self, params, batch):
        raise NotImplementedError

    def prefill(self, params, batch):
        raise NotImplementedError

    def decode(self, params, batch, caches):
        raise NotImplementedError

    def init_cache(self, B: int, s_max: int):
        raise NotImplementedError

    def _remat(self, mode: str) -> bool:
        # remat only matters to a backward pass
        return self.cfg.remat and mode == "train" and torch.is_grad_enabled()


def _layer_slices(stack: Params, n_layers: int):
    """``(names, layers)``: ``layers[i]`` holds layer ``i``'s leaves in the
    order of ``names`` (sorted), each stacked leaf ``unbind`` once."""
    names = sorted(stack)
    per = [stack[k].unbind(0) for k in names]
    return names, [[s[i] for s in per] for i in range(n_layers)]


@torch.no_grad()
def _put(stack, name: str, value: torch.Tensor) -> None:
    """Write one freshly drawn leaf into its parameter (and let the draw
    go: at full width the float32 draws are larger than the model)."""
    stack[name].copy_(value)


def _stack_caches(caches, keys=("k", "v", "pos")):
    return {k: torch.stack([c[k] for c in caches]) for k in keys}


# ---------------------------------------------------------------------------
# Decoder-only LM: dense / MoE / VLM (prefix-LM)
# ---------------------------------------------------------------------------

class DecoderLM(BaseModel):
    def __init__(self, cfg: ModelConfig, mi: MeshInfo,
                 device: DeviceLike = None):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: DecoderLM does not build family "
                             f"{cfg.family!r}")
        super().__init__(cfg, mi, device)
        self.lay = head_layout(cfg, self.tp)
        self.e_local = cfg.n_experts // self.tp if cfg.n_experts else 0
        if cfg.n_experts and cfg.n_experts % self.tp:
            raise ValueError(f"{cfg.name}: n_experts % tp != 0")
        d = cfg.d_model
        self.emb = self._param((self.v_pad, d))
        self.lm_head = self._param((self.v_pad, d))
        self.final_norm = self._param((d,))
        self.blocks = self._stack(self._block_shapes())
        if cfg.family == "vlm":
            self.vis_proj = self._param((d, d))
            self.vis_out = self._param((d, d))

    def _block_shapes(self):
        cfg, lay, Lr = self.cfg, self.lay, self.cfg.n_layers
        d, f = cfg.d_model, cfg.d_ff
        sh = dict(attn_param_shapes(cfg, lay, Lr))
        sh["ln1"] = (Lr, d)
        sh["ln2"] = (Lr, d)
        if cfg.n_experts:
            sh["w_router"] = (Lr, d, cfg.n_experts)
            sh["w_gate"] = (Lr, cfg.n_experts, d, f)
            sh["w_up"] = (Lr, cfg.n_experts, d, f)
            sh["w_down"] = (Lr, cfg.n_experts, f, d)
            if cfg.moe_dense_ff:
                df = cfg.moe_dense_ff
                sh["dw_gate"] = (Lr, d, df)
                sh["dw_up"] = (Lr, d, df)
                sh["dw_down"] = (Lr, df, d)
        else:
            sh["w_gate"] = (Lr, d, f)
            sh["w_up"] = (Lr, d, f)
            sh["w_down"] = (Lr, f, d)
        return sh

    def _block_specs(self):
        cfg = self.cfg
        sp = dict(attn_param_specs(cfg))
        sp["ln1"] = (None, None)
        sp["ln2"] = (None, None)
        if cfg.n_experts:
            sp["w_router"] = (None, None, None)
            sp["w_gate"] = (None, "model", None, None)
            sp["w_up"] = (None, "model", None, None)
            sp["w_down"] = (None, "model", None, None)
            if cfg.moe_dense_ff:
                sp["dw_gate"] = (None, None, "model")
                sp["dw_up"] = (None, None, "model")
                sp["dw_down"] = (None, "model", None)
        else:
            sp["w_gate"] = (None, None, "model")
            sp["w_up"] = (None, None, "model")
            sp["w_down"] = (None, "model", None)
        return sp

    def param_specs(self):
        sp = {
            "emb": ("model", None),
            "lm_head": ("model", None),
            "final_norm": (None,),
            "blocks": self._block_specs(),
        }
        if self.cfg.family == "vlm":
            sp["vis_proj"] = (None, "model")
            sp["vis_out"] = ("model", None)
        return sp

    def block_plan(self):
        return self._memo_plan("block", lambda: self._plan(
            self._block_shapes(), self._block_specs(), stacked=True))

    def full_param_specs(self):
        sp = self.param_specs()
        sp["blocks"] = self._merge_fsdp_specs(
            sp["blocks"], self.block_plan(), self._block_shapes(), offset=1)
        return self._merge_top(sp)

    def cache_specs(self, batch_axes):
        return {
            "k": (None, batch_axes, None, "model", None),
            "v": (None, batch_axes, None, "model", None),
            "pos": (None, batch_axes),
        }

    def param_tree(self) -> Params:
        tree = {"emb": self.emb, "lm_head": self.lm_head,
                "final_norm": self.final_norm,
                "blocks": dict(self.blocks.items())}
        if self.cfg.family == "vlm":
            tree["vis_proj"] = self.vis_proj
            tree["vis_out"] = self.vis_out
        return tree

    @torch.no_grad()
    def _init_local(self, generator: torch.Generator) -> Params:
        cfg, lay, g = self.cfg, self.lay, generator
        dt, dev = _dt(cfg), self.device
        d, f, Lr = cfg.d_model, cfg.d_ff, cfg.n_layers
        out_scale = 0.02 / (2 * Lr) ** 0.5
        blk = self.blocks
        for k, v in init_attn_params(g, cfg, lay, Lr, out_scale,
                                     dev).items():
            _put(blk, k, v)
        blk["ln1"].fill_(1)
        blk["ln2"].fill_(1)
        if cfg.n_experts:
            E = cfg.n_experts
            _put(blk, "w_router", _dense_init(g, (Lr, d, E), dt, dev))
            _put(blk, "w_gate", _dense_init(g, (Lr, E, d, f), dt, dev))
            _put(blk, "w_up", _dense_init(g, (Lr, E, d, f), dt, dev))
            _put(blk, "w_down", _dense_init(g, (Lr, E, f, d), dt, dev,
                                            out_scale))
            if cfg.moe_dense_ff:
                df = cfg.moe_dense_ff
                _put(blk, "dw_gate", _dense_init(g, (Lr, d, df), dt, dev))
                _put(blk, "dw_up", _dense_init(g, (Lr, d, df), dt, dev))
                _put(blk, "dw_down", _dense_init(g, (Lr, df, d), dt, dev,
                                                 out_scale))
        else:
            _put(blk, "w_gate", _dense_init(g, (Lr, d, f), dt, dev))
            _put(blk, "w_up", _dense_init(g, (Lr, d, f), dt, dev))
            _put(blk, "w_down", _dense_init(g, (Lr, f, d), dt, dev,
                                            out_scale))
        self.emb.copy_(_dense_init(g, (self.v_pad, d), dt, dev))
        self.lm_head.copy_(_dense_init(g, (self.v_pad, d), dt, dev))
        self.final_norm.fill_(1)
        if cfg.family == "vlm":
            self.vis_proj.copy_(_dense_init(g, (d, d), dt, dev))
            self.vis_out.copy_(_dense_init(g, (d, d), dt, dev))
        return self.param_tree()

    def kv_duplication(self):
        return {f"blocks/{k}": v
                for k, v in kv_duplication(self.cfg, self.lay).items()}

    # -- forward ------------------------------------------------------------
    def _block(self, h, names, *leaves, mode="train", mask_mode="causal",
               prefix=0, positions=None, cache=None):
        cfg, mi = self.cfg, self.mi
        p = L.gather_fsdp(dict(zip(names, leaves)), self.block_plan(), mi)
        a, new_cache = L.attn_layer(
            p, L.rms_norm(h, p["ln1"], cfg.norm_eps), mi, self.lay, cfg,
            mode=mode, mask_mode=mask_mode, prefix=prefix,
            positions=positions, cache=cache)
        h = h + a
        hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.n_experts:
            # the reference's capacity policy: training tolerates drops
            # (GShard cf=1.25); serving must not drop tokens — decode
            # takes worst-case capacity (token counts are tiny), prefill
            # a generous 8x
            cf = (1.25 if mode == "train"
                  else float(cfg.n_experts) if mode == "decode" else 8.0)
            if cfg.moe_dense_ff:
                # the MoE combine and the dense residual FFN add into the
                # same residual stream: one reduction for both
                y, aux = L.moe_layer(p, hn, mi, cfg, gelu=cfg.gelu_glu,
                                     psum=False, capacity_factor=cf)
                dp = {"w_gate": p["dw_gate"], "w_up": p["dw_up"],
                      "w_down": p["dw_down"]}
                y = y + L.mlp_glu(dp, hn, mi, gelu=cfg.gelu_glu, psum=False)
                y = L.psum_model(y, mi)
            else:
                y, aux = L.moe_layer(p, hn, mi, cfg, gelu=cfg.gelu_glu,
                                     capacity_factor=cf)
        else:
            y = L.mlp_glu(p, hn, mi, gelu=cfg.gelu_glu)
        return h + y, aux, new_cache

    def _trunk(self, params, h, *, mode="train", mask_mode="causal",
               prefix=0, positions=None, caches=None):
        """The block stack.  ``caches``: the stacked ``(L, ...)`` cache
        (decode).  Returns ``(h, aux, new_caches)``; ``new_caches`` is
        the stacked prefill cache, or ``caches`` updated in place."""
        cfg = self.cfg
        names, layers = _layer_slices(params["blocks"], cfg.n_layers)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        kw = dict(mode=mode, mask_mode=mask_mode, prefix=prefix,
                  positions=positions)
        new = []
        for i, leaves in enumerate(layers):
            cache = (L.AttnCache(k=caches["k"][i], v=caches["v"][i],
                                 pos=caches["pos"][i])
                     if caches is not None else None)
            if self._remat(mode):
                h, aux_l, c = checkpoint(self._block, h, names, *leaves,
                                         use_reentrant=False, cache=cache,
                                         **kw)
            else:
                h, aux_l, c = self._block(h, names, *leaves, cache=cache,
                                          **kw)
            aux = aux + aux_l
            if c is not None:
                new.append({"k": c.k, "v": c.v, "pos": c.pos})
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if caches is not None:
            caches["pos"].copy_(torch.stack([c["pos"] for c in new]))
            return h, aux, caches
        return h, aux, (_stack_caches(new) if new else None)

    def _embed(self, params, ids):
        cfg = self.cfg
        h = L.embed_lookup(self._top(params, "emb"), ids, self.mi)
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                                 device=h.device)
        return h

    def _inputs(self, params, batch):
        """Token embedding (+ VLM patch prefix).  Returns (h, prefix_len,
        positions)."""
        cfg = self.cfg
        h = self._embed(params, batch["tokens"])
        prefix = 0
        if cfg.family == "vlm" and "patches" in batch:
            patches = batch["patches"]
            # jnp promotes float32 patches against bf16 weights; torch's
            # matmul takes one dtype, so promote first, as jnp does
            dt = torch.promote_types(patches.dtype, params["vis_proj"].dtype)
            if self.mi.model_size > 1:
                # column-sharded projector + row-sharded output proj
                pe = L.copy_model(patches.to(dt), self.mi) \
                    @ params["vis_proj"].to(dt)
                pe = L.psum_model(pe @ params["vis_out"].to(dt), self.mi)
            else:
                pe = (patches.to(dt) @ params["vis_proj"].to(dt)
                      @ params["vis_out"].to(dt))
            h = torch.cat([pe.to(h.dtype), h], dim=1)
            prefix = patches.shape[1]
        B, S = h.shape[0], h.shape[1]
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        return h, prefix, positions

    def _mask_mode(self) -> str:
        return "prefix" if self.cfg.family == "vlm" else "causal"

    def loss(self, params, batch):
        """``(loss, {"ce", "aux", "tokens"})`` for ``batch``
        ``{"tokens", "labels"}`` (B, S) (+ ``"patches"`` for the VLM), as
        the reference's ``DecoderLM.loss``.  ``params`` is normally
        :meth:`param_tree`."""
        cfg = self.cfg
        h, prefix, pos = self._inputs(params, batch)
        h, aux, _ = self._trunk(params, h, mode="train",
                                mask_mode=self._mask_mode(), prefix=prefix,
                                positions=pos)
        labels = batch["labels"]
        if prefix:
            pad = torch.full((labels.shape[0], prefix), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        loss, n = L.lm_head_loss(h, self._top(params, "lm_head"), labels,
                                 self.mi, vocab_real=cfg.vocab)
        return loss + 0.01 * aux / max(cfg.n_layers, 1), {
            "ce": loss, "aux": aux, "tokens": n}

    @torch.no_grad()
    def prefill(self, params, batch):
        """``(logits (B, V_pad) of the last position, cache)``; the cache
        is ``{"k", "v": (L, B, S, kv_total, hd), "pos": (L, B)}`` with
        ``S`` the whole input (the VLM's patch prefix included)."""
        cfg = self.cfg
        h, prefix, pos = self._inputs(params, batch)
        h, _, caches = self._trunk(params, h, mode="prefill",
                                   mask_mode=self._mask_mode(),
                                   prefix=prefix, positions=pos)
        logits = L.lm_head_logits(h[:, -1:], self._top(params, "lm_head"),
                                  self.mi, vocab_real=cfg.vocab)
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, params, batch, caches):
        """One token a row: ``batch`` ``{"token": (B, 1), "pos": (B,)}``
        (``pos`` the RoPE position).  Writes into ``caches`` in place and
        returns ``(logits (B, V_pad), caches)``."""
        cfg = self.cfg
        h = self._embed(params, batch["token"])
        pos = batch["pos"][:, None]
        h, _, caches = self._trunk(params, h, mode="decode",
                                   mask_mode="causal", prefix=0,
                                   positions=pos, caches=caches)
        logits = L.lm_head_logits(h, self._top(params, "lm_head"), self.mi,
                                  vocab_real=cfg.vocab)
        return logits[:, 0], caches

    # -- caches -------------------------------------------------------------
    def init_cache(self, B: int, s_max: int):
        cfg, lay = self.cfg, self.lay
        kv = (cfg.n_layers, B, s_max, lay.kv_total, cfg.hd)
        return {
            "k": torch.zeros(kv, dtype=_dt(cfg), device=self.device),
            "v": torch.zeros(kv, dtype=_dt(cfg), device=self.device),
            "pos": torch.zeros((cfg.n_layers, B), dtype=torch.int32,
                               device=self.device),
        }


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------

class EncDecLM(BaseModel):
    """Whisper-style: stub conv frontend (precomputed frame embeddings in),
    bidirectional encoder, causal decoder with cross-attention."""

    def __init__(self, cfg: ModelConfig, mi: MeshInfo,
                 device: DeviceLike = None):
        super().__init__(cfg, mi, device)
        self.lay = head_layout(cfg, self.tp)
        d = cfg.d_model
        self.emb = self._param((self.v_pad, d))
        self.lm_head = self._param((self.v_pad, d))
        self.enc_norm = self._param((d,))
        self.final_norm = self._param((d,))
        self.enc = self._stack(self._enc_shapes())
        self.dec = self._stack(self._dec_shapes())

    def _mlp_shapes(self, Lr):
        d, f = self.cfg.d_model, self.cfg.d_ff
        return {"w_fc1": (Lr, d, f), "b_fc1": (Lr, f),
                "w_fc2": (Lr, f, d), "b_fc2": (Lr, d)}

    def _enc_shapes(self):
        cfg, Lr = self.cfg, self.cfg.enc_layers
        sh = dict(attn_param_shapes(cfg, self.lay, Lr))
        sh.update({"ln1": (Lr, cfg.d_model), "ln2": (Lr, cfg.d_model)})
        sh.update(self._mlp_shapes(Lr))
        return sh

    def _dec_shapes(self):
        cfg, Lr = self.cfg, self.cfg.n_layers
        d = cfg.d_model
        sh = dict(attn_param_shapes(cfg, self.lay, Lr))
        sh.update({f"x_{k}": v for k, v in
                   attn_param_shapes(cfg, self.lay, Lr).items()})
        sh.update({"ln1": (Lr, d), "ln_x": (Lr, d), "ln2": (Lr, d)})
        sh.update(self._mlp_shapes(Lr))
        return sh

    def _mlp_specs(self):
        return {"w_fc1": (None, None, "model"), "b_fc1": (None, "model"),
                "w_fc2": (None, "model", None), "b_fc2": (None, None)}

    def _enc_specs(self):
        sp = dict(attn_param_specs(self.cfg))
        sp.update({"ln1": (None, None), "ln2": (None, None)})
        sp.update(self._mlp_specs())
        return sp

    def _dec_specs(self):
        sp = dict(attn_param_specs(self.cfg))
        sp.update({f"x_{k}": v
                   for k, v in attn_param_specs(self.cfg).items()})
        sp.update({"ln1": (None, None), "ln_x": (None, None),
                   "ln2": (None, None)})
        sp.update(self._mlp_specs())
        return sp

    def param_specs(self):
        return {
            "emb": ("model", None), "lm_head": ("model", None),
            "enc_norm": (None,), "final_norm": (None,),
            "enc": self._enc_specs(), "dec": self._dec_specs(),
        }

    def enc_plan(self):
        return self._memo_plan("enc", lambda: self._plan(
            self._enc_shapes(), self._enc_specs(), stacked=True))

    def dec_plan(self):
        return self._memo_plan("dec", lambda: self._plan(
            self._dec_shapes(), self._dec_specs(), stacked=True))

    def full_param_specs(self):
        sp = self.param_specs()
        sp["enc"] = self._merge_fsdp_specs(
            sp["enc"], self.enc_plan(), self._enc_shapes(), offset=1)
        sp["dec"] = self._merge_fsdp_specs(
            sp["dec"], self.dec_plan(), self._dec_shapes(), offset=1)
        return self._merge_top(sp)

    def cache_specs(self, batch_axes):
        kv = (None, batch_axes, None, "model", None)
        return {"k": kv, "v": kv, "pos": (None, batch_axes),
                "xk": kv, "xv": kv}

    def param_tree(self) -> Params:
        return {"emb": self.emb, "lm_head": self.lm_head,
                "enc_norm": self.enc_norm, "final_norm": self.final_norm,
                "enc": dict(self.enc.items()), "dec": dict(self.dec.items())}

    @torch.no_grad()
    def _init_local(self, generator: torch.Generator) -> Params:
        cfg, lay, g = self.cfg, self.lay, generator
        dt, dev = _dt(cfg), self.device
        d, f = cfg.d_model, cfg.d_ff

        def mlp(stack, Lr, scale):
            _put(stack, "w_fc1", _dense_init(g, (Lr, d, f), dt, dev))
            stack["b_fc1"].zero_()
            _put(stack, "w_fc2", _dense_init(g, (Lr, f, d), dt, dev, scale))
            stack["b_fc2"].zero_()

        es = 0.02 / (2 * cfg.enc_layers) ** 0.5
        ds = 0.02 / (2 * cfg.n_layers) ** 0.5
        for k, v in init_attn_params(g, cfg, lay, cfg.enc_layers, es,
                                     dev).items():
            _put(self.enc, k, v)
        for k in ("ln1", "ln2"):
            self.enc[k].fill_(1)
        mlp(self.enc, cfg.enc_layers, es)
        for k, v in init_attn_params(g, cfg, lay, cfg.n_layers, ds,
                                     dev).items():
            _put(self.dec, k, v)
        for k, v in init_attn_params(g, cfg, lay, cfg.n_layers, ds,
                                     dev).items():
            _put(self.dec, f"x_{k}", v)
        for k in ("ln1", "ln_x", "ln2"):
            self.dec[k].fill_(1)
        mlp(self.dec, cfg.n_layers, ds)
        self.emb.copy_(_dense_init(g, (self.v_pad, d), dt, dev))
        self.lm_head.copy_(_dense_init(g, (self.v_pad, d), dt, dev))
        self.enc_norm.fill_(1)
        self.final_norm.fill_(1)
        return self.param_tree()

    def kv_duplication(self):
        out = {}
        for k, v in kv_duplication(self.cfg, self.lay).items():
            out[f"enc/{k}"] = v
            out[f"dec/{k}"] = v
            out[f"dec/x_{k}"] = v
        return out

    # -- forward ------------------------------------------------------------
    def _enc_block(self, h, names, *leaves):
        cfg, mi = self.cfg, self.mi
        p = L.gather_fsdp(dict(zip(names, leaves)), self.enc_plan(), mi)
        a, _ = L.attn_layer(p, L.rms_norm(h, p["ln1"], cfg.norm_eps), mi,
                            self.lay, cfg, mode="train", mask_mode="full",
                            use_rope=False)
        h = h + a
        return h + L.mlp_plain(p, L.rms_norm(h, p["ln2"], cfg.norm_eps), mi)

    def _encode(self, params, frames, mode):
        cfg = self.cfg
        B, S, d = frames.shape
        dt = _dt(cfg)
        h = frames.to(dt) + L.sinusoid_pos_emb(S, d, dt, frames.device)
        names, layers = _layer_slices(params["enc"], cfg.enc_layers)
        for leaves in layers:
            if self._remat(mode):
                h = checkpoint(self._enc_block, h, names, *leaves,
                               use_reentrant=False)
            else:
                h = self._enc_block(h, names, *leaves)
        return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)

    def _cross_kv(self, p_l, enc_out):
        """Per-layer cross K/V from the encoder's output."""
        B, S, _ = enc_out.shape
        hd, kvl = self.cfg.hd, self.lay.kv_local
        enc_out = L.copy_model(enc_out, self.mi)
        k = (enc_out @ p_l["x_wk"]).reshape(B, S, kvl, hd)
        v = (enc_out @ p_l["x_wv"]).reshape(B, S, kvl, hd)
        if self.cfg.qkv_bias:
            k = k + p_l["x_bk"].reshape(1, 1, kvl, hd)
            v = v + p_l["x_bv"].reshape(1, 1, kvl, hd)
        return k, v

    def _dec_block(self, h, names, *leaves, enc_out=None, mode="train",
                   cache=None, cross_kv=None, positions=None):
        cfg, mi = self.cfg, self.mi
        p_l = L.gather_fsdp(dict(zip(names, leaves)), self.dec_plan(), mi)
        a, new_cache = L.attn_layer(
            p_l, L.rms_norm(h, p_l["ln1"], cfg.norm_eps), mi, self.lay, cfg,
            mode=mode, mask_mode="causal", positions=positions, cache=cache,
            use_rope=False)
        h = h + a
        if cross_kv is None:
            cross_kv = self._cross_kv(p_l, enc_out)
        xp = {k[2:]: v for k, v in p_l.items() if k.startswith("x_")}
        xa, _ = L.attn_layer(
            xp, L.rms_norm(h, p_l["ln_x"], cfg.norm_eps), mi, self.lay, cfg,
            mode="train", mask_mode="full", use_rope=False,
            kv_override=cross_kv)
        h = h + xa
        h = h + L.mlp_plain(p_l, L.rms_norm(h, p_l["ln2"], cfg.norm_eps), mi)
        return h, new_cache, cross_kv

    def _decode_trunk(self, params, h, enc_out, *, mode, caches, positions):
        """The decoder stack.  Returns ``(h, new_caches)``: the stacked
        prefill cache (self K/V and cross ``xk``/``xv``), ``caches``
        updated in place (decode), or ``None`` (train)."""
        cfg = self.cfg
        names, layers = _layer_slices(params["dec"], cfg.n_layers)
        new = []
        for i, leaves in enumerate(layers):
            cache, cross = None, None
            if caches is not None:
                cache = L.AttnCache(k=caches["k"][i], v=caches["v"][i],
                                    pos=caches["pos"][i])
                cross = (caches["xk"][i], caches["xv"][i])
            kw = dict(enc_out=enc_out, mode=mode, cache=cache,
                      cross_kv=cross, positions=positions)
            if self._remat(mode):
                h, c, cross = checkpoint(self._dec_block, h, names, *leaves,
                                         use_reentrant=False, **kw)
            else:
                h, c, cross = self._dec_block(h, names, *leaves, **kw)
            if c is not None:
                new.append({"k": c.k, "v": c.v, "pos": c.pos,
                            "xk": cross[0], "xv": cross[1]})
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if caches is not None:
            caches["pos"].copy_(torch.stack([c["pos"] for c in new]))
            return h, caches
        return h, (_stack_caches(new, ("k", "v", "pos", "xk", "xv"))
                   if new else None)

    def _tokens(self, params, tokens):
        S = tokens.shape[1]
        h = L.embed_lookup(self._top(params, "emb"), tokens, self.mi)
        return h + L.sinusoid_pos_emb(S, self.cfg.d_model, h.dtype, h.device)

    def loss(self, params, batch):
        """``(loss, {"ce", "tokens"})`` for ``{"frames", "tokens",
        "labels"}``, as the reference's ``EncDecLM.loss``."""
        enc_out = self._encode(params, batch["frames"], "train")
        h = self._tokens(params, batch["tokens"])
        h, _ = self._decode_trunk(params, h, enc_out, mode="train",
                                  caches=None, positions=None)
        loss, n = L.lm_head_loss(h, self._top(params, "lm_head"),
                                 batch["labels"], self.mi,
                                 vocab_real=self.cfg.vocab)
        return loss, {"ce": loss, "tokens": n}

    @torch.no_grad()
    def prefill(self, params, batch):
        enc_out = self._encode(params, batch["frames"], "prefill")
        h = self._tokens(params, batch["tokens"])
        h, caches = self._decode_trunk(params, h, enc_out, mode="prefill",
                                       caches=None, positions=None)
        logits = L.lm_head_logits(h[:, -1:], self._top(params, "lm_head"),
                                  self.mi, vocab_real=self.cfg.vocab)
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, params, batch, caches):
        """As :meth:`DecoderLM.decode`; the position table is as long as
        the cache."""
        cfg = self.cfg
        h = L.embed_lookup(self._top(params, "emb"), batch["token"], self.mi)
        pos_emb = L.sinusoid_pos_emb(int(caches["k"].shape[2]), cfg.d_model,
                                     h.dtype, h.device)
        h = h + pos_emb[batch["pos"].long()][:, None]
        h, caches = self._decode_trunk(params, h, None, mode="decode",
                                       caches=caches,
                                       positions=batch["pos"][:, None])
        logits = L.lm_head_logits(h, self._top(params, "lm_head"), self.mi,
                                  vocab_real=cfg.vocab)
        return logits[:, 0], caches

    def init_cache(self, B: int, s_max: int):
        cfg, lay = self.cfg, self.lay
        Lr, dt, dev = cfg.n_layers, _dt(cfg), self.device

        def zeros(S):
            return torch.zeros((Lr, B, S, lay.kv_total, cfg.hd), dtype=dt,
                               device=dev)
        return {"k": zeros(s_max), "v": zeros(s_max),
                "pos": torch.zeros((Lr, B), dtype=torch.int32, device=dev),
                "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq)}


# ---------------------------------------------------------------------------
# Mamba2 SSM LM
# ---------------------------------------------------------------------------

_SSM_CACHE = ("state", "conv_x", "conv_B", "conv_C")
# leaves the reference keeps in float32 whatever the model's dtype: the
# decays are exp of them, and a bfloat16 A_log would move every decay
_F32_LEAVES = {"A_log": torch.float32, "dt_bias": torch.float32}


class SSMLM(BaseModel):
    """Mamba2 LM: the embedding, ``n_layers`` pre-norm Mamba2 blocks, the
    final norm and an untied head; no attention and no positions."""

    def __init__(self, cfg: ModelConfig, mi: MeshInfo,
                 device: DeviceLike = None):
        super().__init__(cfg, mi, device)
        if cfg.ssm_heads % self.tp:
            raise ValueError(f"{cfg.name}: ssm heads % tp != 0")
        d = cfg.d_model
        self.emb = self._param((self.v_pad, d))
        self.lm_head = self._param((self.v_pad, d))
        self.final_norm = self._param((d,))
        self.blocks = self._stack(self._block_shapes(), _F32_LEAVES)

    def _block_shapes(self):
        cfg, Lr = self.cfg, self.cfg.n_layers
        d, di, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_conv)
        return {
            "ln": (Lr, d),
            "w_z": (Lr, d, di), "w_x": (Lr, d, di),
            "w_B": (Lr, d, N), "w_C": (Lr, d, N),
            "w_dt": (Lr, d, H), "dt_bias": (Lr, H),
            "A_log": (Lr, H), "D": (Lr, H),
            "conv_x": (Lr, K, di), "conv_B": (Lr, K, N), "conv_C": (Lr, K, N),
            "norm": (Lr, di), "w_out": (Lr, di, d),
        }

    def _block_specs(self):
        return {
            "ln": (None, None),
            "w_z": (None, None, "model"), "w_x": (None, None, "model"),
            "w_B": (None, None, None), "w_C": (None, None, None),
            "w_dt": (None, None, "model"), "dt_bias": (None, "model"),
            "A_log": (None, "model"), "D": (None, "model"),
            "conv_x": (None, None, "model"),
            "conv_B": (None, None, None), "conv_C": (None, None, None),
            "norm": (None, "model"), "w_out": (None, "model", None),
        }

    def param_specs(self):
        return {
            "emb": ("model", None), "lm_head": ("model", None),
            "final_norm": (None,), "blocks": self._block_specs(),
        }

    def block_plan(self):
        return self._memo_plan("block", lambda: self._plan(
            self._block_shapes(), self._block_specs(), stacked=True))

    def full_param_specs(self):
        sp = self.param_specs()
        sp["blocks"] = self._merge_fsdp_specs(
            sp["blocks"], self.block_plan(), self._block_shapes(), offset=1)
        return self._merge_top(sp)

    def cache_specs(self, batch_axes):
        return {
            "state": (None, batch_axes, "model", None, None),
            "conv_x": (None, batch_axes, None, "model"),
            "conv_B": (None, batch_axes, None, None),
            "conv_C": (None, batch_axes, None, None),
        }

    def param_tree(self) -> Params:
        return {"emb": self.emb, "lm_head": self.lm_head,
                "final_norm": self.final_norm,
                "blocks": dict(self.blocks.items())}

    @torch.no_grad()
    def _init_local(self, generator: torch.Generator) -> Params:
        """Fill the parameters in place from ``generator``: the
        reference's distributions and constants (``A_log = log(linspace(1,
        16, H))``, ``dt_bias = 0.5``, ``D = 1``, ``w_out`` at ``0.02 /
        sqrt(2 L)``); returns :meth:`param_tree`."""
        cfg, g = self.cfg, generator
        dt, dev = _dt(cfg), self.device
        blk = self.blocks
        for name, shape in self._block_shapes().items():
            if name in ("ln", "norm", "D"):
                blk[name].fill_(1)
            elif name == "A_log":
                # computed in float64 and rounded once (XLA's float32
                # linspace and log are within a few ulps of this)
                a = torch.linspace(1.0, 16.0, cfg.ssm_heads,
                                   dtype=torch.float64, device=dev)
                blk[name].copy_(torch.log(a).expand(shape))
            elif name == "dt_bias":
                blk[name].fill_(0.5)
            elif name == "w_out":
                _put(blk, name, _dense_init(
                    g, shape, dt, dev, 0.02 / (2 * cfg.n_layers) ** 0.5))
            else:
                _put(blk, name, _dense_init(g, shape, dt, dev))
        self.emb.copy_(_dense_init(g, (self.v_pad, cfg.d_model), dt, dev))
        self.lm_head.copy_(_dense_init(g, (self.v_pad, cfg.d_model), dt,
                                       dev))
        self.final_norm.fill_(1)
        return self.param_tree()

    def kv_duplication(self):
        return {}

    # -- forward ------------------------------------------------------------
    def _mamba_block(self, h, names, *leaves, mode="train", cache=None):
        cfg = self.cfg
        p = L.gather_fsdp(dict(zip(names, leaves)), self.block_plan(), self.mi)
        y, new_cache = L.mamba2_layer(
            p, L.rms_norm(h, p["ln"], cfg.norm_eps), self.mi, cfg,
            mode=mode, cache=cache)
        return h + y, new_cache

    def _mamba_layers(self, h, names, layers, *, mode, caches, new):
        """The Mamba2 blocks ``layers`` (``(index, leaves)`` pairs) in
        turn.  ``caches``: the stacked SSM cache, written in place
        (decode); a prefill's per-layer caches are appended to ``new``."""
        for i, leaves in layers:
            cache = (L.SSMCache(**{k: caches[k][i] for k in _SSM_CACHE})
                     if caches is not None else None)
            if self._remat(mode):
                h, c = checkpoint(self._mamba_block, h, names, *leaves,
                                  use_reentrant=False, mode=mode)
            else:
                h, c = self._mamba_block(h, names, *leaves, mode=mode,
                                         cache=cache)
            if mode == "prefill":
                new.append(c)
        return h

    def _trunk(self, params, h, *, mode, caches=None, positions=None):
        """The block stack.  Returns ``(h, new_caches)``: the stacked
        prefill cache, ``caches`` updated in place (decode), or ``None``
        (train).  ``positions`` is unused: no block has RoPE."""
        cfg = self.cfg
        names, layers = _layer_slices(params["blocks"], cfg.n_layers)
        new = []
        h = self._mamba_layers(h, names, enumerate(layers), mode=mode,
                               caches=caches, new=new)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if caches is not None:
            return h, caches
        return h, (_stack_caches([vars(c) for c in new], _SSM_CACHE)
                   if new else None)

    def loss(self, params, batch):
        """``(loss, {"ce", "tokens"})`` for ``{"tokens", "labels"}``."""
        h = L.embed_lookup(self._top(params, "emb"), batch["tokens"], self.mi)
        h, _ = self._trunk(params, h, mode="train")
        loss, n = L.lm_head_loss(h, self._top(params, "lm_head"),
                                 batch["labels"], self.mi,
                                 vocab_real=self.cfg.vocab)
        return loss, {"ce": loss, "tokens": n}

    @torch.no_grad()
    def prefill(self, params, batch):
        """``(logits (B, V_pad) of the last position, cache)``; the SSM
        cache is ``{"state": (L, B, H, N, P) float32, "conv_x", "conv_B",
        "conv_C": (L, B, K-1, ...)}``: nothing in it grows with the
        sequence.  The prompt's length must be a multiple of
        ``min(ssm_chunk, length)``."""
        h = L.embed_lookup(self._top(params, "emb"), batch["tokens"], self.mi)
        h, caches = self._trunk(params, h, mode="prefill")
        logits = L.lm_head_logits(h[:, -1:], self._top(params, "lm_head"),
                                  self.mi, vocab_real=self.cfg.vocab)
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, params, batch, caches):
        """One token a row: ``batch`` ``{"token": (B, 1)}`` (a ``"pos"``
        is ignored, as the reference ignores it).  Writes into ``caches``
        in place and returns ``(logits (B, V_pad), caches)``."""
        return self._decode(params, batch["token"], caches, None)

    def _decode(self, params, token, caches, positions):
        h = L.embed_lookup(self._top(params, "emb"), token, self.mi)
        h, caches = self._trunk(params, h, mode="decode", caches=caches,
                                positions=positions)
        logits = L.lm_head_logits(h, self._top(params, "lm_head"), self.mi,
                                  vocab_real=self.cfg.vocab)
        return logits[:, 0], caches

    def init_cache(self, B: int, s_max: int):
        cfg, dev = self.cfg, self.device
        dt, Lr, k1 = _dt(cfg), cfg.n_layers, cfg.ssm_conv - 1
        H, N, P, di = (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
                       cfg.d_inner)
        return {
            "state": torch.zeros((Lr, B, H, N, P), dtype=torch.float32,
                                 device=dev),
            "conv_x": torch.zeros((Lr, B, k1, di), dtype=dt, device=dev),
            "conv_B": torch.zeros((Lr, B, k1, N), dtype=dt, device=dev),
            "conv_C": torch.zeros((Lr, B, k1, N), dtype=dt, device=dev),
        }


# ---------------------------------------------------------------------------
# Hybrid (zamba2): Mamba2 stack + one shared attention block every k layers
# ---------------------------------------------------------------------------

class HybridLM(SSMLM):
    """The Mamba2 stack cut into ``n_seg = n_layers / hybrid_period``
    segments, each followed by the one shared attention + GLU-MLP block
    (its parameters under ``shared/``, applied ``n_seg`` times)."""

    def __init__(self, cfg: ModelConfig, mi: MeshInfo,
                 device: DeviceLike = None):
        super().__init__(cfg, mi, device)
        if cfg.n_layers % cfg.hybrid_period:
            raise ValueError("n_layers must divide by hybrid_period")
        self.n_seg = cfg.n_layers // cfg.hybrid_period
        self.lay = head_layout(cfg, self.tp)
        self.shared = self._stack(self._shared_shapes())

    def _shared_shapes(self):
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        sh = {k: v[1:] for k, v in
              attn_param_shapes(cfg, self.lay, 1).items()}  # unstacked
        sh.update({"ln1": (d,), "ln2": (d,), "w_gate": (d, f),
                   "w_up": (d, f), "w_down": (f, d)})
        return sh

    def _shared_specs(self):
        sp = dict(attn_param_specs(self.cfg, stacked=False))
        sp.update({"ln1": (None,), "ln2": (None,),
                   "w_gate": (None, "model"), "w_up": (None, "model"),
                   "w_down": ("model", None)})
        return sp

    def param_specs(self):
        sp = super().param_specs()
        sp["shared"] = self._shared_specs()
        return sp

    def shared_plan(self):
        return self._memo_plan("shared", lambda: self._plan(
            self._shared_shapes(), self._shared_specs(), stacked=False))

    def full_param_specs(self):
        sp = super().full_param_specs()
        sp["shared"] = self._merge_fsdp_specs(
            sp["shared"], self.shared_plan(), self._shared_shapes(),
            offset=0)
        return sp

    def cache_specs(self, batch_axes):
        return {
            "ssm": super().cache_specs(batch_axes),
            "attn": {
                "k": (None, batch_axes, None, "model", None),
                "v": (None, batch_axes, None, "model", None),
                "pos": (None, batch_axes),
            },
        }

    def param_tree(self) -> Params:
        tree = super().param_tree()
        tree["shared"] = dict(self.shared.items())
        return tree

    @torch.no_grad()
    def _init_local(self, generator: torch.Generator) -> Params:
        """:meth:`SSMLM._init_local`, then the shared block: ``wo`` and
        ``w_down`` at ``0.02 / sqrt(2 n_seg)``."""
        super()._init_local(generator)
        cfg, g = self.cfg, generator
        dt, dev = _dt(cfg), self.device
        d, f = cfg.d_model, cfg.d_ff
        scale = 0.02 / (2 * self.n_seg) ** 0.5
        sh = self.shared
        for k, v in init_attn_params(g, cfg, self.lay, 1, scale,
                                     dev).items():
            _put(sh, k, v[0])
        sh["ln1"].fill_(1)
        sh["ln2"].fill_(1)
        _put(sh, "w_gate", _dense_init(g, (d, f), dt, dev))
        _put(sh, "w_up", _dense_init(g, (d, f), dt, dev))
        _put(sh, "w_down", _dense_init(g, (f, d), dt, dev, scale))
        return self.param_tree()

    def kv_duplication(self):
        return {f"shared/{k}": v
                for k, v in kv_duplication(self.cfg, self.lay).items()}

    def _shared_block(self, params, h, *, mode, positions, cache):
        cfg, mi = self.cfg, self.mi
        p = L.gather_fsdp(params["shared"], self.shared_plan(), mi)
        a, new_cache = L.attn_layer(
            p, L.rms_norm(h, p["ln1"], cfg.norm_eps), mi, self.lay, cfg,
            mode=mode, mask_mode="causal", positions=positions, cache=cache)
        h = h + a
        h = h + L.mlp_glu(p, L.rms_norm(h, p["ln2"], cfg.norm_eps), mi)
        return h, new_cache

    def _trunk(self, params, h, *, mode, caches=None, positions=None):
        """As :meth:`SSMLM._trunk`; the cache is ``{"ssm": the SSM cache,
        "attn": {"k", "v": (n_seg, B, S, kv_total, hd), "pos": (n_seg,
        B)}}``, one attention cache a segment."""
        cfg = self.cfg
        per = cfg.hybrid_period
        names, layers = _layer_slices(params["blocks"], cfg.n_layers)
        if positions is None:
            B, S = h.shape[0], h.shape[1]
            positions = torch.arange(S, device=h.device)[None].expand(B, S)
        ssm_c = attn_c = None
        if caches is not None:
            ssm_c, attn_c = caches["ssm"], caches["attn"]
        new_ssm, new_attn = [], []
        for s in range(self.n_seg):
            seg = range(s * per, (s + 1) * per)
            h = self._mamba_layers(h, names, [(i, layers[i]) for i in seg],
                                   mode=mode, caches=ssm_c, new=new_ssm)
            cache = (L.AttnCache(k=attn_c["k"][s], v=attn_c["v"][s],
                                 pos=attn_c["pos"][s])
                     if attn_c is not None else None)
            h, c = self._shared_block(params, h, mode=mode,
                                      positions=positions, cache=cache)
            if c is not None:
                new_attn.append({"k": c.k, "v": c.v, "pos": c.pos})
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        if caches is not None:
            attn_c["pos"].copy_(torch.stack([c["pos"] for c in new_attn]))
            return h, caches
        if mode == "prefill":
            return h, {"ssm": _stack_caches([vars(c) for c in new_ssm],
                                            _SSM_CACHE),
                       "attn": _stack_caches(new_attn)}
        return h, None

    @torch.no_grad()
    def decode(self, params, batch, caches):
        """One token a row: ``batch`` ``{"token": (B, 1), "pos": (B,)}``
        (``pos`` the shared attention's RoPE position and cache slot).
        Writes into ``caches`` in place."""
        return self._decode(params, batch["token"], caches,
                            batch["pos"][:, None])

    def init_cache(self, B: int, s_max: int):
        cfg, lay, dev = self.cfg, self.lay, self.device
        kv = (self.n_seg, B, s_max, lay.kv_total, cfg.hd)
        return {"ssm": super().init_cache(B, s_max), "attn": {
            "k": torch.zeros(kv, dtype=_dt(cfg), device=dev),
            "v": torch.zeros(kv, dtype=_dt(cfg), device=dev),
            "pos": torch.zeros((self.n_seg, B), dtype=torch.int32,
                               device=dev)}}


def build_model(cfg: ModelConfig, mi: MeshInfo,
                device: DeviceLike = None) -> BaseModel:
    """The model for ``cfg`` on ``device`` (default: the card); on a mesh
    its parameters are this rank's shards (uninitialised)."""
    if cfg.family in ("dense", "moe", "vlm"):
        model = DecoderLM(cfg, mi, device)
    elif cfg.family == "encdec":
        model = EncDecLM(cfg, mi, device)
    elif cfg.family == "ssm":
        model = SSMLM(cfg, mi, device)
    elif cfg.family == "hybrid":
        model = HybridLM(cfg, mi, device)
    else:
        raise ValueError(cfg.family)
    if model.sharded:
        _localize(model)
    return model


# ---------------------------------------------------------------------------
# Shards of the reference's global tree
# ---------------------------------------------------------------------------

def _localize(model: BaseModel) -> None:
    """Allocate each (meta) parameter as this rank's shard on the model's
    device."""
    specs = flat_specs(model.full_param_specs())
    for path, prm in flatten_with_paths(model.param_tree()).items():
        shape = local_shape(prm.shape, specs[path], model.mesh)
        new = nn.Parameter(torch.empty(shape, dtype=prm.dtype,
                                       device=model.device))
        *parents, name = path.split("/")
        owner = model
        for part in parents:
            owner = getattr(owner, part)
        if isinstance(owner, nn.ParameterDict):
            owner[name] = new
        else:
            setattr(owner, name, new)


@torch.no_grad()
def _load_shards(model: BaseModel, flat: Dict[str, Any]) -> None:
    """Write this rank's shard of every global leaf in ``flat`` (slash
    paths; tensors or numpy arrays) into the model's parameters."""
    specs = flat_specs(model.full_param_specs())
    for path, prm in flatten_with_paths(model.param_tree()).items():
        x = flat[path]
        if not isinstance(x, torch.Tensor):
            x = _tensor_from_numpy(x)
        prm.copy_(shard_of(x, specs[path], model.mesh).to(prm.dtype))


def shard_params(model: BaseModel, tree_np, mesh=None) -> Params:
    """Load the reference's global parameter tree (numpy leaves, as
    ``params_from_numpy`` takes it) into ``model``, each rank its own
    shards under ``model.full_param_specs()``; returns
    :meth:`~BaseModel.param_tree`.  ``mesh`` defaults to the model's."""
    if not model.sharded:
        return params_from_numpy(model, tree_np)
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("shard_params: the mesh is not the model's")
    like = model.param_tree()
    _tree_from_keys(tree_np, like)
    _load_shards(model, flatten_with_paths(tree_np))
    return model.param_tree()


def _tree_from_keys(node, like) -> None:
    if isinstance(like, dict):
        if set(node) != set(like):
            raise ValueError(f"keys {sorted(node)} are not the model's "
                             f"{sorted(like)}")
        for k, v in like.items():
            _tree_from_keys(node[k], v)


def unshard_params(model: BaseModel, tree=None) -> Params:
    """The global parameter tree, as numpy on every rank (the inverse of
    :func:`shard_params`); ``tree`` (default: the model's parameters) may
    be any tree of the parameters' shapes, e.g. their gradients."""
    tree = model.param_tree() if tree is None else tree
    if not model.sharded:
        return params_to_numpy(tree)
    specs = flat_specs(model.full_param_specs())
    flat = {k: gather_leaf(v, specs[k], model.mesh)
            for k, v in flatten_with_paths(tree).items()}
    return params_to_numpy(unflatten_with_paths(flat, tree))


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
