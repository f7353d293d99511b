"""Model layers of every family, in PyTorch: the reference's math.

Counterpart of ``repro.models.layers`` for the dense, MoE, VLM,
encoder-decoder, SSM and hybrid families, in training and in serving
(``attn_layer`` and ``mamba2_layer`` in ``mode="prefill"|"decode"`` with
their ``AttnCache`` / ``SSMCache``, ``decode_attention``,
``ssd_decode_step``, ``lm_head_logits``).  As in the reference, each
function is per-rank code: inputs are this rank's shards, and the
tensor-parallel reductions over the ``model`` axis and the FSDP gathers
over the data axes are explicit, through :mod:`repro_torch.dist` on the
mesh that ``MeshInfo.mesh`` names (the identity on one device).  Where a
model-replicated activation enters model-sharded weights, ``copy_model``
(identity forward, all-reduce backward) is placed before it, so every
replicated tensor holds its full gradient on every rank (see
:mod:`repro_torch.dist`).  Every function is plain PyTorch, as the
reference is plain ``jnp``: no kernel sits behind any of them
(``flash_attention`` is the reference's chunked online softmax in torch
ops, not ``scaled_dot_product_attention``; ``moe_layer`` is the
reference's sort-based grouping in torch ops; ``ssd_chunked`` is the
reference's chunked state-space-duality scan in torch ops, its loop over
chunks a Python loop).

Conventions (the reference's):
  d   = model width, B = batch, S = sequence
  q (B, S, G, Qg, D) grouped by kv head; k/v (B, T, G, D)
  Attention weights are stored in the padded group-major head layout of
  ``models.common.head_layout``; padded q heads have zero wq/wo rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import dist as D
from repro_torch.models.common import HeadLayout, MeshInfo, ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Collective helpers
# ---------------------------------------------------------------------------

def _mesh(mi: MeshInfo, axis_size: int):
    """The mesh whose groups a collective over an axis of ``axis_size``
    ranks uses; ``None`` (the identity) for one rank."""
    if axis_size <= 1:
        return None
    if mi.mesh is None:
        raise ValueError(
            f"an axis of {axis_size} ranks needs the mesh's process groups: "
            f"build the MeshInfo with launch.mesh.mesh_info(DistMesh)")
    return mi.mesh


def psum_model(x, mi: MeshInfo):
    """Sum over the model axis (a row-parallel product's reduction)."""
    mesh = _mesh(mi, mi.model_size)
    return x if mesh is None else D.psum(x, mesh, (mi.model_axis,))


def copy_model(x, mi: MeshInfo):
    """A model-replicated tensor entering model-sharded work: the
    identity, whose gradient is summed over the model axis."""
    mesh = _mesh(mi, mi.model_size)
    return x if mesh is None else D.copy_to(x, mesh, (mi.model_axis,))


def pmax_model(x, mi: MeshInfo):
    mesh = _mesh(mi, mi.model_size)
    return x if mesh is None else D.pmax(x, mesh, (mi.model_axis,))


def model_rank(mi: MeshInfo) -> int:
    mesh = _mesh(mi, mi.model_size)
    return 0 if mesh is None else mesh.index((mi.model_axis,))


def pvary_init(x, mi: MeshInfo):
    """The identity.  The reference marks fresh scan carries as
    device-varying for ``shard_map``'s replication tracking; PyTorch tracks
    no replication, so there is nothing to mark."""
    return x


def gather_fsdp(p: Params, plan, mi: MeshInfo) -> Params:
    """All-gather FSDP-sharded leaves along their sharded dim, over every
    data axis (pod, then data: one group, row-major over the axes, as the
    reference's successive tiled gathers lay them out).  ``plan`` mirrors
    ``p``: -1 (replicated over data) or the dim sharded over the data
    axes.  The gather's backward is a reduce-scatter: ZeRO's gradient."""
    mesh = _mesh(mi, mi.data_size)
    if mesh is None:
        return p
    out = {}
    for k, v in p.items():
        dim = plan.get(k, -1)
        out[k] = v if dim is None or dim < 0 else D.all_gather(
            v, mesh, mi.data_axes, dim)
    return out


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def rms_norm_sharded(x, scale, eps: float, mi: MeshInfo, full_width: int):
    """RMSNorm over a width-sharded activation: the sum of squares is
    reduced over the model axis and divided by the full width (on one
    rank, the width of ``x``)."""
    dt = x.dtype
    x32 = x.float()
    ssq = torch.sum(x32 * x32, dim=-1, keepdim=True)
    mesh = _mesh(mi, mi.model_size)
    if mesh is not None:
        # every rank's shard goes on to use the reduced sum: its gradient
        # is summed too
        ssq = D.psum_all(ssq, mesh, (mi.model_axis,))
    var = ssq / full_width
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


def silu(x):
    return x * torch.sigmoid(x)


def rope_tables(positions, hd: int, theta: float, dtype):
    """positions (..., S) -> cos/sin (..., S, hd//2)."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x (B, S, H, hd); cos/sin (B, S, hd//2) or (S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoid_pos_emb(S: int, d: int, dtype, device=None):
    """(S, d) sinusoidal position table: sines, then cosines."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (1.0e4 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

NEG_INF = -1.0e30


def _mask_bias(sq, sk, q_off, mask_mode: str, prefix: int, dtype,
               device=None):
    """(sq, sk) additive mask.  mask_mode: causal | full | prefix."""
    if mask_mode == "full":
        return torch.zeros((sq, sk), dtype=dtype, device=device)
    qi = q_off + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    causal = kj <= qi
    if mask_mode == "prefix":
        causal = causal | (kj < prefix)
    return torch.where(causal, 0.0, NEG_INF).to(dtype)


def dense_attention(q, k, v, *, mask_mode="causal", prefix=0, q_off=0):
    """q (B,S,G,Qg,D), k/v (B,T,G,D) -> (B,S,G,Qg,D).  fp32 softmax."""
    B, S, G, Qg, D = q.shape
    T = k.shape[1]
    scale = D ** -0.5
    scores = torch.einsum("bsgqd,btgd->bgqst", q, k).float()
    scores = scores * scale + _mask_bias(S, T, q_off, mask_mode, prefix,
                                         torch.float32, q.device)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgqst,btgd->bsgqd", p, v)


def flash_attention(q, k, v, *, mask_mode="causal", prefix=0,
                    chunk_q=1024, chunk_k=1024, static_steps=False):
    """Memory-bounded attention: a loop over q chunks, an inner loop over
    kv chunks with online softmax.  Same signature/layout as
    dense_attention.

    static_steps=True visits every kv chunk (what training uses, as in
    the reference); False skips chunks above the diagonal.
    """
    B, S, G, Qg, D = q.shape
    T_real = k.shape[1]
    cq = min(chunk_q, S)
    ck = min(chunk_k, T_real)
    assert S % cq == 0, (S, cq)
    if T_real % ck:  # pad KV to a chunk multiple; padding is masked out
        pad = ck - T_real % ck
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    T = k.shape[1]
    nq, nk = S // cq, T // ck
    scale = D ** -0.5
    dev = q.device
    outs = []
    for qi in range(nq):
        qc = q[:, qi * cq:(qi + 1) * cq]
        q_off = qi * cq
        m = torch.full((B, G, Qg, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, Qg, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, G, Qg, D), dtype=torch.float32, device=dev)
        if mask_mode == "causal" and not static_steps:
            # only kv chunks up to the diagonal contribute
            n_steps = qi + 1 if nq == nk else nk
        else:
            n_steps = nk
        for kj in range(n_steps):
            ks = k[:, kj * ck:(kj + 1) * ck]
            vs = v[:, kj * ck:(kj + 1) * ck]
            s = torch.einsum("bsgqd,btgd->bgqst", qc, ks).float()
            s = s * scale
            qi_idx = q_off + torch.arange(cq, device=dev)[:, None]
            kj_idx = kj * ck + torch.arange(ck, device=dev)[None, :]
            if mask_mode == "causal":
                ok = kj_idx <= qi_idx
            elif mask_mode == "prefix":
                ok = (kj_idx <= qi_idx) | (kj_idx < prefix)
            else:
                ok = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            ok = ok & (kj_idx < T_real)  # exclude KV padding
            s = torch.where(ok[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bgqst,btgd->bsgqd", p.to(q.dtype), vs).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, pos):
    """q (B,1,G,Qg,D); caches (B,Smax,G,D); pos (B,) current index.
    Attends positions <= pos."""
    B, _, G, Qg, D = q.shape
    Smax = k_cache.shape[1]
    scale = D ** -0.5
    s = torch.einsum("bsgqd,btgd->bgqst", q, k_cache).float()
    s = s * scale
    ok = (torch.arange(Smax, device=q.device)[None, :]
          <= pos.long()[:, None])  # (B, Smax)
    s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgqst,btgd->bsgqd", p, v_cache)


# ---------------------------------------------------------------------------
# Attention layer (projections + the model-axis reduction)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttnCache:
    k: torch.Tensor    # (B, Smax, kv_local, hd)
    v: torch.Tensor
    pos: torch.Tensor  # (B,) int32 next write index


def attn_project_qkv(p: Params, x, layout: HeadLayout, *, qkv_bias: bool):
    B, S, _ = x.shape
    hd = p["wq"].shape[1] // layout.hq_local
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, layout.hq_local, hd)
    k = k.reshape(B, S, layout.kv_local, hd)
    v = v.reshape(B, S, layout.kv_local, hd)
    return q, k, v


def _group_q(q, layout: HeadLayout):
    """(B,S,Hql,hd) -> (B,S,G,Qg,hd) grouped by local kv head."""
    B, S, Hql, hd = q.shape
    return q.reshape(B, S, layout.kv_local, layout.ql_per_kv, hd)


def attn_layer(
    p: Params,
    x,
    mi: MeshInfo,
    layout: HeadLayout,
    cfg: ModelConfig,
    *,
    mode: str = "train",          # train | prefill | decode
    mask_mode: str = "causal",
    prefix: int = 0,
    positions=None,               # (B, S) absolute positions for RoPE
    cache: Optional[AttnCache] = None,
    use_rope: bool = True,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Full GQA attention layer.  Returns ``(out (B,S,d), new_cache)``:
    ``None`` in train mode, the layer's K/V in prefill, and in decode the
    cache with this token's K/V written **in place** at ``cache.pos``
    (the reference returns an updated copy and donates the old one).

    ``kv_override`` (cross-attention) replaces the layer's own K/V and
    turns RoPE off; ``use_rope=False`` (the encoder-decoder) leaves q and
    k unrotated."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"attn_layer mode={mode!r}")
    B, S, _ = x.shape
    hd = cfg.hd
    x = copy_model(x, mi)
    q, k, v = attn_project_qkv(p, x, layout, qkv_bias=cfg.qkv_bias)
    if kv_override is not None:
        k, v = kv_override
    if use_rope and kv_override is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        cos, sin = rope_tables(positions, hd, cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if mode == "decode":
        assert cache is not None and S == 1
        # lax.dynamic_update_slice clamps the start so the update fits;
        # clamping here keeps an out-of-range pos from faulting (a CUDA
        # device-side assert) and matches the reference with no host sync
        idx = cache.pos.long().clamp(0, cache.k.shape[1] - 1)
        rows = torch.arange(B, device=x.device)
        cache.k[rows, idx] = k[:, 0]
        cache.v[rows, idx] = v[:, 0]
        new_cache = AttnCache(k=cache.k, v=cache.v, pos=cache.pos + 1)
        o = decode_attention(_group_q(q, layout), cache.k, cache.v,
                             cache.pos)
    else:
        if mode == "prefill":
            new_cache = AttnCache(
                k=k, v=v, pos=torch.full((B,), S, dtype=torch.int32,
                                         device=x.device))
        qg = _group_q(q, layout)
        T = k.shape[1]
        if max(S, T) > cfg.flash_threshold:
            o = flash_attention(qg, k, v, mask_mode=mask_mode, prefix=prefix,
                                static_steps=(mode == "train"))
        else:
            o = dense_attention(qg, k, v, mask_mode=mask_mode, prefix=prefix)
    o = o.reshape(B, S, layout.hq_local * hd)
    out = psum_model(o @ p["wo"], mi)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_glu(p: Params, x, mi: MeshInfo, *, gelu: bool = False,
            psum: bool = True):
    """SwiGLU / GeGLU (``cfg.gelu_glu``).  ``psum=False`` returns the
    partial (pre-reduction) output so the caller can fuse several
    row-parallel reductions into one."""
    x = copy_model(x, mi)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    act = F.gelu(g, approximate="tanh") if gelu else silu(g)
    out = (act * u) @ p["w_down"]
    return psum_model(out, mi) if psum else out


def mlp_plain(p: Params, x, mi: MeshInfo):
    """fc1 -> gelu -> fc2 (whisper-style)."""
    x = copy_model(x, mi)
    h = F.gelu(x @ p["w_fc1"] + p["b_fc1"], approximate="tanh")
    return psum_model(h @ p["w_fc2"], mi) + p["b_fc2"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def top_k_first(values, k: int):
    """``lax.top_k``: the ``k`` largest entries of the last axis, largest
    first, the lower index first among equal values (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_layer(
    p: Params,
    x,
    mi: MeshInfo,
    cfg: ModelConfig,
    *,
    capacity_factor: float = 1.25,
    gelu: bool = False,
    psum: bool = True,
):
    """Sort-based grouped MoE, the reference's routing step for step.

    p: w_router (d, E); w_gate/w_up (E_local, d, f); w_down (E_local, f, d).
    x: (B, S, d).  Returns ``(y (B, S, d), aux)``.

    Each expert takes at most ``C = int(cf * k * N / E) + 1`` tokens (a
    host integer); the rest drop.  Kept tokens are gathered into their
    expert's slots and each token's ``k`` weighted expert outputs are
    gathered back and summed over ``k`` in the token's top-k order, so no
    scatter-add (atomic, of varying order on a card) decides the result:
    the combine is deterministic, and in float32 equals the reference's
    ``.at[].add`` up to summation order."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_local = p["w_gate"].shape[0]
    N = B * S
    dev = x.device
    xf = x.reshape(N, d)

    logits = (xf @ p["w_router"]).float()  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k_first(probs, k)  # (N, k)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)

    e_start = model_rank(mi) * E_local
    flat_e = top_idx.reshape(N * k)
    # the router is replicated; the combine weights and the tokens feed
    # this rank's experts only, so their gradients are summed over ranks
    flat_w = copy_model(top_vals, mi).reshape(N * k).to(x.dtype)
    xe = copy_model(xf, mi)
    flat_tok = torch.arange(N, device=dev)[:, None].expand(N, k).reshape(-1)

    local_e = flat_e - e_start
    mine = (local_e >= 0) & (local_e < E_local)
    key = torch.where(mine, local_e, E_local)  # non-mine -> overflow bucket
    order = torch.argsort(key, stable=True)     # jnp.argsort is stable
    s_key = key[order]
    s_tok = flat_tok[order]
    s_w = flat_w[order]

    C = int(capacity_factor * k * N / E) + 1
    # jnp.bincount(key, length=E_local + 1), without the host sync that
    # torch.bincount takes on a card to size its output
    counts = torch.zeros(E_local + 1, dtype=torch.long, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * k, device=dev) - starts[s_key]
    keep = (s_key < E_local) & (pos < C)
    slot = torch.where(keep, s_key * C + pos, 0)

    # kept slots are distinct; dropped entries land in a spare last row
    dump = E_local * C
    xb = x.new_zeros((dump + 1, d)).index_put(
        (torch.where(keep, slot, dump),), xe[s_tok])
    xb = xb[:dump].reshape(E_local, C, d)

    g = torch.bmm(xb, p["w_gate"])
    u = torch.bmm(xb, p["w_up"])
    act = F.gelu(g, approximate="tanh") if gelu else silu(g)
    yb = torch.bmm(act * u, p["w_down"]).reshape(E_local * C, d)

    contrib = yb[slot] * (s_w * keep.to(x.dtype))[:, None]
    # back from expert order to (token, choice) order: order is a
    # permutation, so this scatter writes every row once
    per_choice = torch.empty_like(contrib).index_put((order,), contrib)
    y = per_choice.reshape(N, k, d).sum(dim=1)
    if psum:
        y = psum_model(y, mi)

    aux = _load_balance_loss(probs, top_idx, E)
    # mean over data shards, as the reference's; each shard's loss then
    # uses the mean, so its gradient is summed over them too
    mesh = _mesh(mi, mi.data_size)
    if mesh is not None:
        aux = D.psum_all(aux, mesh, mi.data_axes) / mi.data_size
    return y.reshape(B, S, d), aux


def _load_balance_loss(probs, top_idx, E):
    """Switch-style auxiliary load-balancing loss."""
    onehot = F.one_hot(top_idx, E).float()  # (N, k, E)
    k = top_idx.shape[1]
    frac_tokens = torch.mean(torch.sum(onehot, dim=1), dim=0)  # (E,)
    frac_probs = torch.mean(probs, dim=0)
    return E * torch.sum(frac_tokens * frac_probs) / k


# ---------------------------------------------------------------------------
# Mamba2 (SSD) layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SSMCache:
    state: torch.Tensor   # (B, H, d_state, P) float32
    conv_x: torch.Tensor  # (B, K-1, d_inner)
    conv_B: torch.Tensor  # (B, K-1, N)
    conv_C: torch.Tensor  # (B, K-1, N)


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv.  x (B,S,C), w (K,C).  With a cache (B,K-1,C)
    performs the streaming update (S==1) and returns (y, new_cache)."""
    K = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
        xp = torch.cat([pad, x], dim=1)
        y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
        return y, None
    xp = torch.cat([cache, x], dim=1)  # (B, K-1+1, C)
    y = sum(xp[:, i:i + 1, :] * w[i] for i in range(K))
    return y, xp[:, 1:, :]


def _segsum_decay(da):
    """da (..., Q) per-step log-decays -> (..., Q, Q) lower-triangular
    exp(cumsum_i - cumsum_j) factors (j <= i).

    Masked to -inf BEFORE exponentiating: the j > i entries have a
    positive difference that can overflow exp, and a mask applied after it
    would give 0 * inf = NaN in the backward pass."""
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    Q = da.shape[-1]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=da.device))
    diff = torch.where(tri, diff, -torch.inf)
    # jnp.minimum: a tie (the diagonal) splits its gradient, as here
    return torch.exp(torch.minimum(diff, diff.new_zeros(())))


def ssd_chunked(xs, dt, A, Bc, Cc, chunk: int):
    """Chunked state-space duality scan (Mamba2 alg. 1, float32 state).

    xs (B,S,H,P), dt (B,S,H) [post-softplus], A (H,) [negative],
    Bc/Cc (B,S,N).  Returns (y (B,S,H,P), final_state (B,H,N,P)).
    ``S`` must be a multiple of ``min(chunk, S)``."""
    B, S, H, P = xs.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of "
                         f"the chunk {Q}")
    nc = S // Q
    xs_ = xs.reshape(B, nc, Q, H, P).float()
    dt_ = dt.reshape(B, nc, Q, H)
    Bc_ = Bc.reshape(B, nc, Q, N).float()
    Cc_ = Cc.reshape(B, nc, Q, N).float()
    dt_h = dt_.movedim(-1, 2).float()  # (B, nc, H, Q)

    da_h = (dt_ * A[None, None, None, :]).float().movedim(-1, 2)
    Lmat = _segsum_decay(da_h)         # (B, nc, H, Q, Q)
    cs = torch.cumsum(da_h, dim=-1)    # (B, nc, H, Q)
    total = cs[..., -1]                # (B, nc, H)

    # Intra-chunk (quadratic within the chunk, like a masked attention):
    CB = torch.einsum("bcin,bcjn->bcij", Cc_, Bc_)
    Mdt = CB[:, :, None] * Lmat * dt_h[..., None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", Mdt, xs_)

    # Chunk state contribution: sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    w = torch.exp(total[..., None] - cs) * dt_h           # (B, nc, H, Q)
    Sc = torch.einsum("bcjn,bcjhp->bchnp", Bc_,
                      xs_ * w.movedim(2, 3)[..., None])

    decay_chunk = torch.exp(total)     # (B, nc, H)
    state = xs_.new_zeros((B, H, N, P))
    y_inter = []
    for c in range(nc):
        # the inter-chunk output from the incoming state
        y_in = torch.einsum("bin,bhnp->bihp", Cc_[:, c], state)
        y_inter.append(y_in * torch.exp(cs[:, c].movedim(1, -1))[..., None])
        state = state * decay_chunk[:, c][..., None, None] + Sc[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(B, S, H, P).to(xs.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token SSD recurrence, updating ``state`` (B,H,N,P) float32
    **in place**; x_t (B,H,P), dt_t (B,H), B_t/C_t (B,N).  Returns
    ``(state, y (B,H,P))``."""
    dec = torch.exp((dt_t * A[None, :]).float())  # (B, H)
    upd = torch.einsum("bn,bhp->bhnp", B_t.float(),
                       (x_t * dt_t[..., None]).float())
    state.mul_(dec[..., None, None]).add_(upd)
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), state)
    return state, y.to(x_t.dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba2_layer(
    p: Params,
    x,
    mi: MeshInfo,
    cfg: ModelConfig,
    *,
    mode: str = "train",
    cache: Optional[SSMCache] = None,
):
    """Mamba2 block.

    p: w_z/w_x (d, d_inner), w_B/w_C (d, N), w_dt (d, H), dt_bias (H,),
       A_log (H,), D (H,), conv_x (K, d_inner), conv_B/conv_C (K, N),
       norm (d_inner,), w_out (d_inner, d).
    Returns ``(out (B,S,d), new_cache)``: ``None`` in train mode, the
    final state and the last ``K-1`` pre-conv inputs in prefill, and in
    decode ``cache`` itself, its state and conv windows updated **in
    place** (the reference returns a new cache and its serving step
    donates the old one)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mamba2_layer mode={mode!r}")
    B, S, d = x.shape
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    di_l = p["w_x"].shape[1]
    H_l = di_l // P

    # w_B / w_C are replicated; the rest of the block is head-sharded
    xm = copy_model(x, mi)
    z = xm @ p["w_z"]
    xs = xm @ p["w_x"]
    Bc = x @ p["w_B"]
    Cc = x @ p["w_C"]
    dt = _softplus((xm @ p["w_dt"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())  # (H_l,)

    if mode == "decode":
        if cache is None or S != 1:
            raise ValueError("mamba2_layer decode takes one token a row "
                             "and a cache")
        xs, new_cx = _causal_conv(xs, p["conv_x"], cache.conv_x)
        Bc, new_cB = _causal_conv(Bc, p["conv_B"], cache.conv_B)
        Cc, new_cC = _causal_conv(Cc, p["conv_C"], cache.conv_C)
        cache.conv_x.copy_(new_cx)
        cache.conv_B.copy_(new_cB)
        cache.conv_C.copy_(new_cC)
        xs, Bc, Cc = silu(xs), silu(Bc), silu(Cc)
        x_t = xs.reshape(B, H_l, P)
        _, y = ssd_decode_step(cache.state, x_t, dt.reshape(B, H_l), A,
                               Bc.reshape(B, N), Cc.reshape(B, N))
        y = y + x_t * p["D"][None, :, None]
        y = y.reshape(B, 1, di_l)
        new_cache = cache
    else:
        pre = (xs, Bc, Cc)
        xs, _ = _causal_conv(xs, p["conv_x"])
        Bc, _ = _causal_conv(Bc, p["conv_B"])
        Cc, _ = _causal_conv(Cc, p["conv_C"])
        xs, Bc, Cc = silu(xs), silu(Bc), silu(Cc)
        xs_h = xs.reshape(B, S, H_l, P)
        y, state = ssd_chunked(xs_h, dt, A, copy_model(Bc, mi),
                               copy_model(Cc, mi), cfg.ssm_chunk)
        y = y + xs_h * p["D"][None, None, :, None]
        y = y.reshape(B, S, di_l)
        new_cache = None
        if mode == "prefill":
            # carry the last K-1 pre-conv inputs for streaming decode
            k1 = cfg.ssm_conv - 1
            new_cache = SSMCache(state=state, conv_x=pre[0][:, -k1:, :],
                                 conv_B=pre[1][:, -k1:, :],
                                 conv_C=pre[2][:, -k1:, :])

    # gated RMSNorm over the inner width, then the output projection
    y = y * silu(z)
    y = rms_norm_sharded(y, p["norm"], cfg.norm_eps, mi, cfg.d_inner)
    out = psum_model(y @ p["w_out"], mi)
    return out, new_cache


# ---------------------------------------------------------------------------
# Vocab-sharded embedding / loss
# ---------------------------------------------------------------------------

def embed_lookup(table, ids, mi: MeshInfo):
    """table (V_local, d); ids (B, S) global."""
    V_local = table.shape[0]
    r = model_rank(mi)
    loc = ids.long() - r * V_local
    ok = (loc >= 0) & (loc < V_local)
    loc = torch.clamp(loc, 0, V_local - 1)
    out = table[loc]
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    return psum_model(out, mi)


def lm_head_loss(h, table, labels, mi: MeshInfo, *, vocab_real: int):
    """Cross-entropy over the padded vocabulary (padded rows masked out).
    h (B,S,d); table (V_local, d); labels (B,S) with -1 = pad.
    Returns (mean_loss, n_tokens)."""
    B, S, d = h.shape
    V_local = table.shape[0]
    r = model_rank(mi)
    dev = h.device
    hf = copy_model(h, mi).reshape(B * S, d)
    logits = (hf @ table.T).float()  # (N, V_local)
    gid = r * V_local + torch.arange(V_local, device=dev)
    logits = torch.where((gid < vocab_real)[None, :], logits, NEG_INF)

    lab = labels.reshape(B * S).long()
    valid = lab >= 0
    lab = torch.where(valid, lab, 0)

    # stability max carries no gradient (it cancels in the lse identity)
    mloc = torch.amax(logits, dim=-1).detach()
    m = pmax_model(mloc, mi).detach()
    se = torch.sum(torch.exp(logits - m[:, None]), dim=-1)
    lse = m + torch.log(psum_model(se, mi))

    loc = lab - r * V_local
    ok = (loc >= 0) & (loc < V_local)
    loc = torch.clamp(loc, 0, V_local - 1)
    lab_logit = psum_model(
        torch.where(ok, torch.gather(logits, 1, loc[:, None])[:, 0], 0.0),
        mi)

    loss = (lse - lab_logit) * valid
    n = torch.clamp(torch.sum(valid), min=1)
    return torch.sum(loss) / n, n


def lm_head_logits(h, table, mi: MeshInfo, *, vocab_real: int):
    """Full logits for serving, float32, the padded vocabulary's columns
    set to ``NEG_INF``.  h (B, S, d) -> (B, S, V_pad)."""
    logits = torch.einsum("bsd,vd->bsv", h, table).float()
    mesh = _mesh(mi, mi.model_size)
    if mesh is not None:
        logits = D.all_gather(logits, mesh, (mi.model_axis,), dim=-1)
    gid = torch.arange(logits.shape[-1], device=h.device)
    return torch.where((gid < vocab_real)[None, None, :], logits, NEG_INF)
