"""Model configuration and tensor-parallel layout arithmetic.

Every architecture in the assigned pool is described by one ``ModelConfig``.
The layout helpers here compute how attention heads, KV heads, experts and
vocab rows map onto the ``model`` mesh axis, including the zero-padded-head
scheme for archs whose head counts don't divide the TP degree (DESIGN.md):

* ``rep = tp // n_kv`` ranks share (and redundantly compute) one KV head
  when ``n_kv < tp``; ``kv_local = n_kv // tp`` KV heads live on each rank
  when ``n_kv >= tp``.
* Q heads are padded (zero-initialised wq/wo rows -> exact function
  preservation) so each rank owns ``hq_local`` whole heads whose KV group
  is rank-determined.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    gelu_glu: bool = False  # gemma-style GeGLU instead of SwiGLU
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    rope_theta: float = 1.0e4
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm_eps: float = 1.0e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0  # arctic: parallel dense-FFN residual
    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid: a shared attention block applied every `hybrid_period` layers
    hybrid_period: int = 0
    # encoder-decoder
    enc_layers: int = 0
    enc_seq: int = 0  # fixed encoder length (e.g. whisper frames)
    # VLM prefix-LM
    n_prefix: int = 0  # image-patch prefix tokens (bidirectional attention)
    # distribution / memory policy
    fsdp: bool = False
    fsdp_min_elems: int = 1 << 16  # leaves smaller than this stay replicated
    remat: bool = True
    # cost-probe knobs (launch.dryrun): XLA's cost_analysis counts a while
    # body once regardless of trip count, so probes compile fully-unrolled
    # reduced-depth variants and extrapolate linearly in depth.
    scan_unroll: bool = False
    flash_threshold: int = 4096  # above this seq len attention is chunked
    # numeric
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the 500k-context decode shape?"""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.hd
        total = 2 * V * d  # embed + head
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            att = d * self.n_heads * hd + 2 * d * self.n_kv * hd \
                + self.n_heads * hd * d
        else:
            att = 0
        per_layer = 0
        if self.family == "moe":
            per_layer = att + self.n_experts * 3 * d * f + d * self.n_experts
            if self.moe_dense_ff:
                per_layer += 3 * d * self.moe_dense_ff
        elif self.family in ("dense", "vlm"):
            per_layer = att + 3 * d * f
        elif self.family == "encdec":
            per_layer = att + 2 * d * f  # non-GLU mlp
        elif self.family == "ssm":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * di + 2 * N + H) + di * d
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = d * (2 * di + 2 * N + H) + di * d
        total += L * per_layer
        if self.family == "encdec":
            total += self.enc_layers * (att + 2 * d * f) + att * L  # cross
        if self.family == "hybrid" and self.hybrid_period:
            total += att + 3 * d * self.d_ff  # one shared block
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense = self.param_count() - L * self.n_experts * 3 * d * f
        return dense + L * self.top_k * 3 * d * f


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Axis-name bookkeeping passed into per-rank (shard_map) code.

    bound=True means the code executes inside shard_map (axis names are
    bound), so collectives must run even over size-1 axes to keep vma
    tracking consistent; bound=False (unit tests calling per-rank code
    directly) skips them."""
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)
    model_size: int = 1
    data_size: int = 1  # product over data_axes (incl. pod)
    bound: bool = False

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return self.data_axes + (self.model_axis,)


def ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """How GQA heads map to TP ranks (see module docstring)."""
    tp: int
    h_real: int      # real q heads
    n_kv: int        # real kv heads
    hq_local: int    # q heads per rank (padded layout)
    kv_local: int    # kv heads computed per rank
    rep: int         # ranks sharing one kv group (n_kv < tp)
    h_pad: int       # padded global q heads = tp * hq_local
    ql_per_kv: int   # local q heads per local kv head

    @property
    def kv_total(self) -> int:
        """Global stored kv heads (duplicated ``rep`` times when rep>1)."""
        return self.tp * self.kv_local


CANONICAL_TP = 16  # production model-axis size; padded layouts are always
                   # built for this so parameter shapes are mesh-independent
                   # (checkpoints reshard elastically across tp in {1,2,4,8,16})


def head_layout(cfg: ModelConfig, tp: int, *, n_heads=None, n_kv=None
                ) -> HeadLayout:
    H = n_heads if n_heads is not None else cfg.n_heads
    KV = n_kv if n_kv is not None else cfg.n_kv
    if H % KV:
        raise ValueError(f"{cfg.name}: n_heads {H} % n_kv {KV} != 0")
    canon = max(CANONICAL_TP, tp)
    if canon % tp:
        raise ValueError(f"{cfg.name}: canonical tp {canon} % tp {tp} != 0")
    if KV < canon:
        if canon % KV:
            raise ValueError(f"{cfg.name}: canon {canon} % n_kv {KV} != 0")
        rep_c, kv_local_c = canon // KV, 1
    else:
        if KV % canon:
            raise ValueError(f"{cfg.name}: n_kv {KV} % canon {canon} != 0")
        rep_c, kv_local_c = 1, KV // canon
    gs = H // KV
    hql_c = ceil_to(gs * kv_local_c, rep_c) // rep_c
    h_pad = canon * hql_c
    kv_total = canon * kv_local_c
    hq_local = h_pad // tp
    kv_local = kv_total // tp
    ql_per_kv = h_pad // kv_total
    return HeadLayout(tp=tp, h_real=H, n_kv=KV, hq_local=hq_local,
                      kv_local=kv_local, rep=max(1, kv_total // KV),
                      h_pad=h_pad, ql_per_kv=ql_per_kv)


def q_head_permutation(layout: HeadLayout) -> Sequence[int]:
    """Global padded-q-head slot -> real head index (or -1 for a zero pad).

    Slots are group-major: group g occupies slots [g*rep*hq_local,
    (g+1)*rep*hq_local) so that the ranks holding kv group g own exactly
    those q heads.
    """
    gs = layout.h_real // layout.n_kv
    slots_per_group = layout.h_pad // layout.n_kv
    out = []
    for g in range(layout.n_kv):
        heads = list(range(g * gs, (g + 1) * gs))
        heads += [-1] * (slots_per_group - gs)
        out.extend(heads)
    assert len(out) == layout.h_pad
    return out


def pad_vocab(vocab: int, tp: int) -> int:
    """Pad to a fixed 256 multiple (not tp) so embedding shapes are
    mesh-independent; padded rows are masked out of the softmax."""
    return ceil_to(vocab, 256)


def fsdp_dim(shape: Tuple[int, ...], fsdp_size: int,
             skip_dims: Sequence[int] = ()) -> Optional[int]:
    """Pick the first dimension divisible by the fsdp size (excluding
    model-sharded dims); None if no dim qualifies (param stays replicated
    over data)."""
    for i, s in enumerate(shape):
        if i in skip_dims:
            continue
        if s % fsdp_size == 0 and s >= fsdp_size:
            return i
    return None
