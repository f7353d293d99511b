"""Roofline terms for one NVIDIA card.

The reference derives its terms from XLA's compiled artifacts against TPU
v5e peaks.  Here the peaks are the card's own, looked up by the name
``torch.cuda.get_device_name`` gives, and the counts come from running the
call under two dispatch modes (:func:`count_call`)::

    compute    = flops      / (peaks.bf16_flops)
    memory     = hbm_bytes  / (peaks.hbm_bytes_s)
    collective = coll_bytes / (peaks.link_bytes_s)

``flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s count (matrix
products, convolutions, attention, and the LP kernel ``repro_torch::rgb``
by the reference's per-problem estimate); ``hbm_bytes`` sums every aten
op's input and output bytes, i.e. the unfused count, as XLA's CPU ``bytes
accessed`` is.  ``coll_by_op`` is what the record transport of
:mod:`repro_torch.dist` logged during the call, in the reference's
convention (XLA's op names, result bytes): a call on a
:class:`~repro_torch.launch.mesh.RecordingMesh` fills it, and a call on one
device leaves it empty (nothing crosses a link).  :func:`count_meta` also
gives the high-water mark of live ``meta`` bytes (:class:`LiveBytes`): a
dry run's peak memory per device.

The analytic estimates (:func:`fused_hbm_estimate`, :func:`_cache_bytes`,
:func:`model_flops_estimate`) are the reference's arithmetic, unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import dist as D


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one card (no sparsity)."""
    bf16_flops: float       # FLOP/s on the tensor cores, bf16 / fp16
    f32_flops: float        # FLOP/s outside the tensor cores
    f64_flops: float        # FLOP/s outside the tensor cores
    hbm_bytes_s: float      # device memory, B/s
    link_bytes_s: float     # card-to-card link, B/s per direction
    memory_bytes: float     # device memory, bytes (what a dry run fits to)


# NVIDIA's data sheet for the H100 SXM part at its 700 W limit; NVLink 4
# is 900 GB/s both ways, 450 GB/s per direction; 80 GB of HBM3.
_PEAKS: Dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(bf16_flops=989e12, f32_flops=67e12,
                                   f64_flops=34e12, hbm_bytes_s=3.35e12,
                                   link_bytes_s=450e9, memory_bytes=80e9),
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
    coll_by_op: Dict[str, int]   # the record transport's log of the call
    ran_on: str             # "meta", or the device the call fell back to


# Ops that allocate without writing: their outputs move no bytes.
_NO_DATA = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided"))


def tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (nested lists, tuples and dicts;
    a view counts its own elements)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(tensor_bytes(o) for o in obj.values())
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums each aten op's input and output bytes; views
    (``func.is_view``) and allocations move nothing."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view \
                and func.overloadpacket.__name__ not in _NO_DATA:
            self.total += (tensor_bytes(args) + tensor_bytes(kwargs)
                           + tensor_bytes(out))
        return out


def _tensors_in(tree, out=None) -> list:
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors_in(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors_in(x, out)
    return out


class _MetaMemo(TorchDispatchMode):
    """Outputs of functional ops on ``meta`` from a cache keyed by the
    inputs' dtypes, shapes and strides and the other arguments: a meta op
    computes only its outputs' metadata, which these determine, and many
    elementwise ops compute it in Python (~0.1-0.3 ms an op).  A step
    repeats its layers' ops (and chunked attention its blocks' ops), so
    most calls hit.  An op that mutates, returns a view, returns anything
    but tensors or gives an output sharing an input's storage is never
    cached.  The innermost mode: the counters above it see each op as
    ever.  ``calls`` counts the calls of ops outside ``aten`` (the
    repository's kernels, ``repro_torch::rgb``)."""

    def __init__(self):
        super().__init__()
        self.cache: Dict[Any, Any] = {}
        self.skip = set()
        self.calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace not in ("aten", "prims"):
            name = func._schema.name
            self.calls[name] = self.calls.get(name, 0) + 1
        key = None
        if func not in self.skip:
            try:
                key = (func, _meta_key(args), _meta_key(kwargs))
            except TypeError:
                key = None
            else:
                hit = self.cache.get(key)
                if hit is not None:
                    return _meta_build(hit)
        out = func(*args, **kwargs)
        if key is not None:
            spec = _meta_spec(func, out, args, kwargs)
            if spec is None:
                self.skip.add(func)
            else:
                self.cache[key] = spec
        return out


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not meta")
        return (x.dtype, x.shape, x.stride())
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_meta_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in sorted(x.items()))
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise TypeError(type(x))


def _meta_spec(func, out, args, kwargs):
    """How to rebuild ``out``, or None where it must not be cached."""
    schema = func._schema
    if func.is_view or schema.is_mutable or any(
            r.alias_info is not None for r in schema.returns):
        return None
    ins = {t.untyped_storage()._cdata for t in _tensors_in((args, kwargs))}

    def spec(o):
        if isinstance(o, torch.Tensor):
            if o.device.type != "meta" or o.storage_offset() \
                    or o.untyped_storage()._cdata in ins:
                raise TypeError
            return (o.shape, o.stride(), o.dtype)
        if isinstance(o, (list, tuple)):
            return (type(o), [spec(x) for x in o])
        raise TypeError
    try:
        return spec(out)
    except TypeError:
        return None


def _meta_build(spec):
    if isinstance(spec[0], type):
        return spec[0](_meta_build(x) for x in spec[1])
    size, stride, dtype = spec
    return torch.empty_strided(size, stride, dtype=dtype, device="meta")


# The CUDA caching allocator gives every block a multiple of 512 bytes, and
# ``torch.cuda.max_memory_allocated`` counts the blocks.
ALLOC_ROUND = 512


class LiveBytes(_MetaMemo):
    """The high-water mark of live ``meta`` storage bytes over the ops run
    under it: ``peak``.  A storage counts from the first op that touches
    it (or from :meth:`track`, for a call's arguments) until it is freed,
    rounded up as the card's allocator rounds it, so it models
    ``torch.cuda.max_memory_allocated`` of the same call on the card.  Its
    ops are served as :class:`_MetaMemo` serves them (one mode, not two:
    each mode costs every op its own dispatch)."""

    def __init__(self, roots=()):
        super().__init__()
        self.live = self.peak = 0
        self._held: Dict[int, weakref.finalize] = {}
        self.track(roots)

    def track(self, tree) -> None:
        """Count the storages of every tensor in ``tree`` (nested lists,
        tuples and dicts) as live."""
        for t in _tensors_in(tree):
            if t.device.type == "meta":
                self._hold(t.untyped_storage())
        self.peak = max(self.peak, self.live)

    def _hold(self, st) -> None:
        key = st._cdata
        if key in self._held:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._held[key] = weakref.finalize(st, self._free, key, n)
        self.live += n

    def _free(self, key: int, n: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.track((args, kwargs, out))
        return out

    def __exit__(self, *exc):
        for f in self._held.values():
            f.detach()
        self._held.clear()
        return super().__exit__(*exc)


def _to_meta(obj):
    if isinstance(obj, torch.Tensor):
        t = torch.empty_like(obj, device="meta")
        return t.requires_grad_(obj.requires_grad) \
            if obj.is_leaf and obj.dtype.is_floating_point else t
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return type(obj)(*(_to_meta(o) for o in obj))
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


class MetaCount(NamedTuple):
    flops: float            # FlopCounterMode's total
    bytes: float            # every non-view aten op's input + output bytes
    coll_by_op: Dict[str, int]   # the record transport's log of the call
    peak_bytes: int         # LiveBytes' high water (0 when not asked for)
    kernel_calls: Dict[str, int]  # calls of ops outside aten, by name
    out: Any                # what the call returned


def _recorded_since(before: Dict[str, Dict]) -> Dict[str, int]:
    after = D.coll_by_op(D.recorded())
    old = D.coll_by_op(before)
    return {k: v - old.get(k, 0) for k, v in after.items()
            if v - old.get(k, 0)}


def count_meta(fn, args=(), kw=None, *, live: bool = True,
               ops: bool = True) -> MetaCount:
    """``fn(*args, **kw)`` as given (on ``meta`` tensors: nothing is
    allocated) under the FLOP and byte counters (``ops``) and the
    live-bytes one (``live``; the arguments live from the start); the
    collectives the record transport logged during the call are
    ``coll_by_op``.  A counter not asked for counts 0."""
    from torch.utils.flop_counter import FlopCounterMode
    kw = kw or {}
    before = D.recorded()
    fc = FlopCounterMode(display=False) if ops else None
    bc = _ByteCounter() if ops else None
    memo = LiveBytes((args, kw)) if live else _MetaMemo()
    with contextlib.ExitStack() as stack:
        # the memo (LiveBytes is one) innermost, under the counters
        for mode in (memo, fc, bc):
            if mode is not None:
                stack.enter_context(mode)
        out = fn(*args, **kw)
    return MetaCount(flops=float(fc.get_total_flops()) if ops else 0.0,
                     bytes=float(bc.total) if ops else 0.0,
                     coll_by_op=_recorded_since(before),
                     peak_bytes=memo.peak if live else 0,
                     kernel_calls=dict(memo.calls), out=out)


def count_call(fn, *args: Any, **kw: Any) -> CallCount:
    """FLOPs, unfused bytes and recorded collectives of ``fn(*args,
    **kw)``.

    The call first runs on ``meta`` copies of every tensor argument
    (nested lists, tuples and dicts included), so a full-width count needs
    no device memory.  Where an op has no meta kernel or the call reads a
    value back to the host, it runs again on the arguments as given, and
    ``ran_on`` names their device."""
    try:
        c = count_meta(fn, _to_meta(args), _to_meta(kw), live=False)
        ran_on = "meta"
    except (NotImplementedError, RuntimeError):
        c = count_meta(fn, args, kw, live=False)
        ran_on = _first_device((args, kw)) or "cpu"
    return CallCount(flops=c.flops, bytes=c.bytes, coll_by_op=c.coll_by_op,
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
