"""Model layers of the dense decoder, in PyTorch: the reference's math.

Counterpart of ``repro.models.layers`` for the dense family on one card.
The reference writes each function to run inside ``shard_map`` with
explicit collectives over the ``model`` axis; here the collective helpers
are the identity at ``model_size == 1`` and raise for a larger model axis
(multi-card training is a later slice, ROADMAP A9g).  Every function is
plain PyTorch, as the reference is plain ``jnp``: no kernel sits behind
any of them (``flash_attention`` is the reference's chunked online
softmax in torch ops, not ``scaled_dot_product_attention``).

Conventions (the reference's):
  d   = model width, B = batch, S = sequence
  q (B, S, G, Qg, D) grouped by kv head; k/v (B, T, G, D)
  Attention weights are stored in the padded group-major head layout of
  ``models.common.head_layout``; padded q heads have zero wq/wo rows.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import HeadLayout, MeshInfo, ModelConfig

Params = Dict[str, Any]

_MULTI_CARD = ("a model axis larger than 1 needs tensor parallelism over "
               "torch.distributed, which the port does not have yet "
               "(ROADMAP A9g: multi-card training)")


# ---------------------------------------------------------------------------
# Collective helpers (one card)
# ---------------------------------------------------------------------------

def _one_card(mi: MeshInfo) -> None:
    if mi.model_size > 1:
        raise NotImplementedError(_MULTI_CARD)


def psum_model(x, mi: MeshInfo):
    _one_card(mi)
    return x


def pmax_model(x, mi: MeshInfo):
    _one_card(mi)
    return x


def model_rank(mi: MeshInfo) -> int:
    _one_card(mi)
    return 0


def gather_fsdp(p: Params, plan, mi: MeshInfo) -> Params:
    """The identity: with one data shard every leaf is whole.  FSDP over
    several cards is a later slice (ROADMAP A9g)."""
    if mi.data_size > 1:
        raise NotImplementedError(
            "FSDP over several cards is not ported yet (ROADMAP A9g: "
            "multi-card training)")
    return p


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
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


# ---------------------------------------------------------------------------
# Attention layer (projections + the model-axis reduction)
# ---------------------------------------------------------------------------

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
    mode: str = "train",
    mask_mode: str = "causal",
    prefix: int = 0,
    positions=None,               # (B, S) absolute positions for RoPE
):
    """Full GQA attention layer (``mode="train"``; prefill and decode,
    with their cache, are the LM-serving slice, ROADMAP A9b).  Returns
    ``(out (B,S,d), None)`` as the reference does in train mode."""
    if mode != "train":
        raise NotImplementedError(
            f"attn_layer mode={mode!r}: prefill and decode come with LM "
            "serving (ROADMAP A9b)")
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = attn_project_qkv(p, x, layout, qkv_bias=cfg.qkv_bias)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta, x.dtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    qg = _group_q(q, layout)
    T = k.shape[1]
    if max(S, T) > cfg.flash_threshold:
        o = flash_attention(qg, k, v, mask_mode=mask_mode, prefix=prefix,
                            static_steps=True)
    else:
        o = dense_attention(qg, k, v, mask_mode=mask_mode, prefix=prefix)
    o = o.reshape(B, S, layout.hq_local * hd)
    out = psum_model(o @ p["wo"], mi)
    return out, None


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_glu(p: Params, x, mi: MeshInfo, *, gelu: bool = False):
    """SwiGLU / GeGLU (``cfg.gelu_glu``)."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    act = F.gelu(g, approximate="tanh") if gelu else silu(g)
    return psum_model((act * u) @ p["w_down"], mi)


# ---------------------------------------------------------------------------
# Vocab-sharded embedding / loss (one shard here)
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
    hf = h.reshape(B * S, d)
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
