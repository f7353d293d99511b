"""Roofline terms for one NVIDIA card.

The reference derives its terms from XLA's compiled artifacts against TPU
v5e peaks.  Here the peaks are the card's own, looked up by the name
``torch.cuda.get_device_name`` gives, and the counts come from running the
call under two dispatch modes (:func:`count_call`)::

    compute    = flops      / (peaks.bf16_flops)
    memory     = hbm_bytes  / (peaks.hbm_bytes_s)
    collective = coll_bytes / (peaks.link_bytes_s)

``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count (matrix
products, convolutions and attention); ``hbm_bytes`` sums every aten op's
input and output bytes, i.e. the unfused count, as XLA's CPU ``bytes
accessed`` is.  On one card ``coll_by_op`` is empty: a call on one device
moves nothing over a link.

The analytic estimates (:func:`fused_hbm_estimate`, :func:`_cache_bytes`,
:func:`model_flops_estimate`) are the reference's arithmetic, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one card (no sparsity)."""
    bf16_flops: float       # FLOP/s on the tensor cores, bf16 / fp16
    f32_flops: float        # FLOP/s outside the tensor cores
    f64_flops: float        # FLOP/s outside the tensor cores
    hbm_bytes_s: float      # device memory, B/s
    link_bytes_s: float     # card-to-card link, B/s per direction


# NVIDIA's data sheet for the H100 SXM part at its 700 W limit; NVLink 4
# is 900 GB/s both ways, 450 GB/s per direction.
_PEAKS: Dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(bf16_flops=989e12, f32_flops=67e12,
                                   f64_flops=34e12, hbm_bytes_s=3.35e12,
                                   link_bytes_s=450e9),
}


def peaks_for(device_name: str) -> Peaks:
    """The peaks of the card ``torch.cuda.get_device_name`` calls
    ``device_name``; ``KeyError`` for a card with no entry (a roofline
    share against another card's peaks would be wrong)."""
    try:
        return _PEAKS[device_name]
    except KeyError:
        raise KeyError(f"no published peaks for {device_name!r}; known: "
                       f"{sorted(_PEAKS)}") from None


@dataclasses.dataclass
class Roofline:
    """Per-device quantities of one step; ``model_flops`` is the global
    useful-work estimate and ``peaks`` the card's."""
    flops: float            # counted flops per device per step
    hbm_bytes: float        # unfused bytes per device (every op's I/O)
    coll_bytes: float       # collective operand bytes per device
    chips: int
    model_flops: float      # 6*N*D-style useful flops (global)
    peaks: Peaks
    coll_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    hbm_fused: float = 0.0  # analytic fused HBM estimate (preferred)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peaks.bf16_flops

    @property
    def t_memory(self) -> float:
        return (self.hbm_fused or self.hbm_bytes) / self.peaks.hbm_bytes_s

    @property
    def t_memory_unfused(self) -> float:
        return self.hbm_bytes / self.peaks.hbm_bytes_s

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.peaks.link_bytes_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total counted flops — catches remat/redundancy."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the bound (max term): the score."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        t_useful = self.model_flops / (self.chips * self.peaks.bf16_flops)
        return t_useful / bound if bound else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "hbm_fused_per_dev": self.hbm_fused,
            "coll_bytes_per_dev": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_memory_unfused_s": self.t_memory_unfused,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_by_op": self.coll_by_op,
            "peaks": dataclasses.asdict(self.peaks),
        }


def from_counts(flops: float, hbm_bytes: float, *, chips: int,
                model_flops: float, peaks: Peaks,
                coll_by_op: Dict[str, int] | None = None,
                hbm_fused: float = 0.0) -> Roofline:
    """A :class:`Roofline` from :func:`count_call`'s counts (the twin of
    the reference's ``from_compiled``)."""
    coll = dict(coll_by_op or {})
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    coll_bytes=float(sum(coll.values())), chips=chips,
                    model_flops=model_flops, peaks=peaks, coll_by_op=coll,
                    hbm_fused=hbm_fused)


# -- counting one call ------------------------------------------------------

class CallCount(NamedTuple):
    flops: float            # FlopCounterMode's total
    bytes: float            # every non-view aten op's input + output bytes
    coll_by_op: Dict[str, int]
    ran_on: str             # "meta", or the device the call fell back to


# Ops that allocate without writing: their outputs move no bytes.
_NO_DATA = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided"))


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def _byte_counter():
    """A ``TorchDispatchMode`` that sums each aten op's input and output
    bytes; views (``func.is_view``) and allocations move nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not func.is_view \
                    and func.overloadpacket.__name__ not in _NO_DATA:
                self.total += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                               + _tensor_bytes(out))
            return out

    return _ByteCounter()


def _to_meta(obj):
    if isinstance(obj, torch.Tensor):
        t = torch.empty_like(obj, device="meta")
        return t.requires_grad_(obj.requires_grad) \
            if obj.is_leaf and obj.dtype.is_floating_point else t
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_meta(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_meta(v) for k, v in obj.items()}
    return obj


def _first_device(obj) -> str:
    if isinstance(obj, torch.Tensor):
        return str(obj.device)
    items = obj.values() if isinstance(obj, dict) else (
        obj if isinstance(obj, (list, tuple)) else ())
    for o in items:
        d = _first_device(o)
        if d:
            return d
    return ""


def _count(fn, args, kw) -> tuple:
    from torch.utils.flop_counter import FlopCounterMode
    fc = FlopCounterMode(display=False)
    bc = _byte_counter()
    with fc, bc:
        fn(*args, **kw)
    return float(fc.get_total_flops()), float(bc.total)


def count_call(fn, *args: Any, **kw: Any) -> CallCount:
    """FLOPs and unfused bytes of ``fn(*args, **kw)``.

    The call first runs on ``meta`` copies of every tensor argument
    (nested lists, tuples and dicts included), so a full-width count needs
    no device memory.  Where an op has no meta kernel or the call reads a
    value back to the host, it runs again on the arguments as given, and
    ``ran_on`` names their device."""
    try:
        flops, nbytes = _count(fn, _to_meta(args), _to_meta(kw))
        ran_on = "meta"
    except (NotImplementedError, RuntimeError):
        flops, nbytes = _count(fn, args, kw)
        ran_on = _first_device((args, kw)) or "cpu"
    return CallCount(flops=flops, bytes=nbytes, coll_by_op={},
                     ran_on=ran_on)


# -- the reference's analytic estimates ------------------------------------

def fused_hbm_estimate(cfg, kind: str, batch: int, seq: int,
                       tp: int, data: int) -> float:
    """Analytic per-device HBM traffic assuming full fusion.

    Counts only the tensors that must reach device memory in a fused
    program:

      * weights: each device reads its 1/tp slice; fwd + bwd + one remat
        re-read for training (3x), once for serving.
      * optimizer: local (ZeRO) shard m/v/param fp32 read+write.
      * activations: ~16 materialised (tokens_dev x width) tensors per
        block fwd, x2.5 with bwd+remat for training; attention scores are
        assumed fused (flash) and contribute nothing.
      * logits: tokens_dev x V/tp fp32, x3 for training.
      * decode: full KV-cache / SSM-state read per emitted token.
    """
    dt = 2  # bf16
    d = cfg.d_model
    N_param = cfg.param_count()
    N_active = cfg.active_param_count()
    tokens_dev = max(batch * (seq if kind != "decode" else 1), 1) / data
    w_active_dev = N_active * dt / tp

    if kind == "train":
        weights = 3.0 * w_active_dev
        opt = (N_param / (tp * (data if cfg.fsdp else 1))) * 4 * 6
        act_width = d if cfg.family != "ssm" else cfg.d_inner
        acts = cfg.n_layers * tokens_dev * act_width * dt * 16 * 2.5
        logits = tokens_dev * (cfg.vocab / tp) * 4 * 3
        return weights + opt + acts + logits
    if kind == "prefill":
        weights = 1.0 * w_active_dev
        act_width = d if cfg.family != "ssm" else cfg.d_inner
        acts = cfg.n_layers * tokens_dev * act_width * dt * 16
        cache = _cache_bytes(cfg, batch, seq, tp) / max(data, 1)
        return weights + acts + cache
    # decode: one token; whole weight slice + whole cache read
    cache = _cache_bytes(cfg, batch, seq, tp) / max(data, 1)
    logits = (batch / data) * cfg.vocab * 4
    return w_active_dev + cache + logits


def _cache_bytes(cfg, batch: int, seq: int, tp: int) -> float:
    """Global KV-cache / SSM-state bytes divided by tp (head-sharded)."""
    dt = 2
    if cfg.family == "ssm":
        st = cfg.n_layers * batch * cfg.ssm_heads * cfg.ssm_state * \
            cfg.ssm_head_dim * 4
        return st / tp
    if cfg.family == "hybrid":
        st = cfg.n_layers * batch * cfg.ssm_heads * cfg.ssm_state * \
            cfg.ssm_head_dim * 4
        n_seg = cfg.n_layers // cfg.hybrid_period
        kv_heads = max(cfg.n_kv, 16)
        kv = n_seg * batch * seq * kv_heads * cfg.hd * 2 * dt
        return (st + kv) / tp
    kv_heads = max(cfg.n_kv, 16)
    kv = cfg.n_layers * batch * seq * kv_heads * cfg.hd * 2 * dt
    if cfg.family == "encdec":
        kv += cfg.n_layers * batch * cfg.enc_seq * kv_heads * cfg.hd * 2 * dt
    return kv / tp


def model_flops_estimate(cfg, kind: str, batch: int, seq: int) -> float:
    """6*N_active*tokens for training, 2*N_active*tokens for prefill,
    2*N_active*batch (one token each) for decode; attention KV-cache reads
    are a memory (not flops) cost and are excluded, matching the standard
    MFU convention."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch
