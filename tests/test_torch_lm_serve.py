"""The port's LM serving path (``repro_torch.models`` in prefill and decode,
the ``moe``, ``vlm`` and ``encdec`` families, ``launch.steps``' serving
steps and ``launch.serve``) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's parameters cross with ``params_from_numpy``.  Tolerances (all
float32 unless stated), as measured on the CPU (jax 0.9, torch 2.13):

* layers: ``decode_attention``, ``lm_head_logits``, ``moe_layer`` to
  rtol = atol = 1e-5, the MoE aux loss to 1e-6 (measured: 4e-7, 1e-6,
  5e-8 and 1.2e-7);
* models: prefill and 3 decode steps' logits within 1e-5 of the largest
  |logit| over the real vocabulary, padded columns equal; caches to 1e-5;
* loss and gradients as in ``tests/test_torch_models.py``: the loss to
  rtol 1e-5 and every gradient leaf to 1e-5 of its largest entry in
  float32, 5e-2 in bfloat16.  Key biases of the encoder-decoder (no RoPE)
  have an exact gradient of zero, since softmax is shift-invariant per
  query: both packages hold rounding noise there (up to 3.2e-12 in
  float32, 2.4e-8 in bfloat16), so those leaves are held to an absolute
  1e-9 and 1e-6;
* a streamed decode against a prefill of the longer sequence at the
  reference's 2e-4 (``tests/test_decode_equivalence.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.launch import steps as r_steps
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.launch.serve import _pad_cache as r_pad_cache
from repro.models import MeshInfo as RMeshInfo
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models.common import ModelConfig as RModelConfig
from repro.models.common import head_layout as r_head_layout

from _torch_compat import CPU
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (_serve_cfg, device_memory_bytes,
                                      make_decode_step, make_prefill_step)
from repro_torch.models import (MeshInfo, ModelConfig, build_model,
                                params_from_numpy)
from repro_torch.models import layers as L
from repro_torch.models.common import head_layout
from repro_torch.tree import flatten_with_paths

MI1 = MeshInfo(model_size=1, data_size=1)
RMI1 = RMeshInfo(model_size=1, data_size=1)
F32 = dict(rtol=1e-5, atol=1e-5)
ATTN_ARCHS = sorted(a for a, c in ARCHS.items()
                    if c.family in ("dense", "moe", "vlm", "encdec"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _moe_cfgs(E=8, k=2):
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv=2, d_ff=32, vocab=64, n_experts=E, top_k=k)
    return ModelConfig(**kw), RModelConfig(**kw)


def _moe_params(seed=0, E=8, d=16, f=32):
    return {"w_router": _normal(seed, d, E, scale=0.1),
            "w_gate": _normal(seed + 1, E, d, f, scale=0.1),
            "w_up": _normal(seed + 2, E, d, f, scale=0.1),
            "w_down": _normal(seed + 3, E, f, d, scale=0.1)}


# ---------------------------------------------------------------------------
# Layers against the reference
# ---------------------------------------------------------------------------

def test_decode_attention_matches_the_reference():
    q = _normal(1, 3, 1, 2, 3, 8)
    k = _normal(2, 3, 10, 2, 8)
    v = _normal(3, 3, 10, 2, 8)
    pos = np.array([0, 4, 9], np.int32)
    np.testing.assert_allclose(
        _np(L.decode_attention(_t(q), _t(k), _t(v), _t(pos))),
        _np(RL.decode_attention(*map(jnp.asarray, (q, k, v, pos)))), **F32)


def test_lm_head_logits_and_the_plain_mlp_match_the_reference():
    h = _normal(1, 2, 3, 16)
    table = _normal(2, 40, 16)
    got = _np(L.lm_head_logits(_t(h), _t(table), MI1, vocab_real=30))
    ref = _np(RL.lm_head_logits(jnp.asarray(h), jnp.asarray(table), RMI1,
                                vocab_real=30))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[..., :30], ref[..., :30], **F32)
    np.testing.assert_array_equal(got[..., 30:], ref[..., 30:])
    assert (got[..., 30:] == L.NEG_INF).all()
    p = {"w_fc1": _normal(3, 16, 24, scale=0.2), "b_fc1": _normal(4, 24),
         "w_fc2": _normal(5, 24, 16, scale=0.2), "b_fc2": _normal(6, 16)}
    np.testing.assert_allclose(
        _np(L.mlp_plain({k: _t(v) for k, v in p.items()}, _t(h), MI1)),
        _np(RL.mlp_plain({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(h), RMI1)), **F32)
    np.testing.assert_allclose(
        _np(L.sinusoid_pos_emb(7, 16, torch.float32)),
        _np(RL.sinusoid_pos_emb(7, 16, jnp.float32)), **F32)


@pytest.mark.parametrize("cf,psum,gelu", [
    (8.0, True, False), (8.0, False, False), (1e-9, True, False),
    (1e-9, False, False), (1.25, True, True)])
def test_moe_layer_matches_the_reference(cf, psum, gelu):
    cfg, rcfg = _moe_cfgs()
    p = _moe_params()
    x = _normal(4, 2, 16, 16)
    y, aux = L.moe_layer({k: _t(v) for k, v in p.items()}, _t(x), MI1, cfg,
                         capacity_factor=cf, psum=psum, gelu=gelu)
    ry, raux = RL.moe_layer({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), RMI1, rcfg, capacity_factor=cf,
                            psum=psum, gelu=gelu)
    np.testing.assert_allclose(_np(y), _np(ry), **F32)
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=1e-6)


def test_top_k_breaks_ties_as_lax_top_k():
    v = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]],
                 np.float32)
    vals, idx = L.top_k_first(_t(v), 3)
    rvals, ridx = jax.lax.top_k(jnp.asarray(v), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_moe_routes_tied_tokens_as_the_reference():
    """Every router logit equal: each token's top-k are experts 0..k-1 in
    both packages, and capacity drops the same tokens."""
    cfg, rcfg = _moe_cfgs()
    p = _moe_params()
    p["w_router"] = np.zeros_like(p["w_router"])
    x = _normal(5, 1, 24, 16)
    for cf in (1.25, 0.5):
        y, aux = L.moe_layer({k: _t(v) for k, v in p.items()}, _t(x), MI1,
                             cfg, capacity_factor=cf)
        ry, raux = RL.moe_layer({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), RMI1, rcfg,
                                capacity_factor=cf)
        np.testing.assert_allclose(_np(y), _np(ry), **F32)
        np.testing.assert_allclose(float(aux), float(raux), atol=1e-6)


def _attn_case(seed=0):
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen2-0.5b"]),
                              dtype="float32")
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS["qwen2-0.5b"]),
                               dtype="float32")
    lay = head_layout(cfg, 1)
    d, hd = cfg.d_model, cfg.hd
    p = {"wq": _normal(seed, d, lay.h_pad * hd, scale=0.1),
         "wk": _normal(seed + 1, d, lay.kv_total * hd, scale=0.1),
         "wv": _normal(seed + 2, d, lay.kv_total * hd, scale=0.1),
         "wo": _normal(seed + 3, lay.h_pad * hd, d, scale=0.1),
         "bq": _normal(seed + 4, lay.h_pad * hd, scale=0.1),
         "bk": _normal(seed + 5, lay.kv_total * hd, scale=0.1),
         "bv": _normal(seed + 6, lay.kv_total * hd, scale=0.1)}
    return cfg, rcfg, lay, p


@pytest.mark.parametrize("use_rope", [True, False])
def test_attn_layer_prefill_decode_and_cross_attention_match(use_rope):
    cfg, rcfg, lay, p = _attn_case()
    tp = {k: _t(v) for k, v in p.items()}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    x = _normal(9, 2, 6, cfg.d_model)
    out, c = L.attn_layer(tp, _t(x), MI1, lay, cfg, mode="prefill",
                          use_rope=use_rope)
    rout, rc = RL.attn_layer(rp, jnp.asarray(x), RMI1, lay, rcfg,
                             mode="prefill", use_rope=use_rope)
    np.testing.assert_allclose(_np(out), _np(rout), **F32)
    for a, b in ((c.k, rc.k), (c.v, rc.v)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    assert c.pos.dtype == torch.int32 and c.pos.tolist() == [6, 6]
    # decode into a cache grown to 10; the port writes in place
    grow = [(0, 0), (0, 4), (0, 0), (0, 0)]
    kc, vc = np.pad(_np(c.k), grow), np.pad(_np(c.v), grow)
    cache = L.AttnCache(k=_t(kc), v=_t(vc), pos=c.pos.clone())
    rcache = RL.AttnCache(k=jnp.asarray(kc), v=jnp.asarray(vc), pos=rc.pos)
    xt = _normal(10, 2, 1, cfg.d_model)
    positions = np.full((2, 1), 6, np.int32)
    out, c2 = L.attn_layer(tp, _t(xt), MI1, lay, cfg, mode="decode",
                           positions=_t(positions), cache=cache,
                           use_rope=use_rope)
    rout, rc2 = RL.attn_layer(rp, jnp.asarray(xt), RMI1, lay, rcfg,
                              mode="decode", positions=jnp.asarray(positions),
                              cache=rcache, use_rope=use_rope)
    np.testing.assert_allclose(_np(out), _np(rout), **F32)
    assert c2.k is cache.k and c2.v is cache.v
    np.testing.assert_allclose(_np(c2.k), _np(rc2.k), **F32)
    np.testing.assert_allclose(_np(c2.v), _np(rc2.v), **F32)
    assert c2.pos.tolist() == np.asarray(rc2.pos).tolist() == [7, 7]
    # cross-attention: the given K/V replace the layer's own
    kv = (_normal(11, 2, 5, lay.kv_local, cfg.hd),
          _normal(12, 2, 5, lay.kv_local, cfg.hd))
    out, _ = L.attn_layer(tp, _t(x), MI1, lay, cfg, mode="train",
                          mask_mode="full", use_rope=use_rope,
                          kv_override=tuple(map(_t, kv)))
    rout, _ = RL.attn_layer(rp, jnp.asarray(x), RMI1, lay, rcfg,
                            mode="train", mask_mode="full",
                            use_rope=use_rope,
                            kv_override=tuple(map(jnp.asarray, kv)))
    np.testing.assert_allclose(_np(out), _np(rout), **F32)


def test_decode_write_past_the_cache_is_clamped_as_the_reference():
    """``lax.dynamic_update_slice`` clamps an out-of-range start; so does
    the port (an unclamped index would raise here, and fault on a card)."""
    cfg, rcfg, lay, p = _attn_case(seed=3)
    kc = _normal(1, 2, 5, lay.kv_total, cfg.hd)
    vc = _normal(2, 2, 5, lay.kv_total, cfg.hd)
    pos = np.array([5, 9], np.int32)
    xt = _normal(3, 2, 1, cfg.d_model)
    out, c = L.attn_layer({k: _t(v) for k, v in p.items()}, _t(xt), MI1,
                          lay, cfg, mode="decode",
                          cache=L.AttnCache(_t(kc), _t(vc), _t(pos)))
    rout, rc = RL.attn_layer({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(xt), RMI1, lay, rcfg, mode="decode",
                             cache=RL.AttnCache(jnp.asarray(kc),
                                                jnp.asarray(vc),
                                                jnp.asarray(pos)))
    np.testing.assert_allclose(_np(out), _np(rout), **F32)
    np.testing.assert_allclose(_np(c.k), _np(rc.k), **F32)
    assert not np.allclose(_np(c.k)[:, 4], kc[:, 4])  # the last slot


def test_attn_layer_rejects_an_unknown_mode():
    cfg, _, lay, p = _attn_case()
    with pytest.raises(ValueError, match="mode"):
        L.attn_layer({k: _t(v) for k, v in p.items()},
                     _t(_normal(1, 1, 2, cfg.d_model)), MI1, lay, cfg,
                     mode="serve")


def test_moe_needs_one_data_shard():
    cfg, _ = _moe_cfgs()
    p = {k: _t(v) for k, v in _moe_params().items()}
    # the aux loss is averaged over the data shards: that needs the mesh
    with pytest.raises(ValueError, match="process groups"):
        L.moe_layer(p, _t(_normal(1, 1, 4, 16)), MeshInfo(data_size=2), cfg)


# ---------------------------------------------------------------------------
# The reference's serving layer tests, run against the port
# ---------------------------------------------------------------------------

def test_decode_attention_equals_dense_last_row():
    """Decoding position t must equal row t of dense causal attention."""
    B, S, G, Qg, D = 2, 24, 1, 2, 8
    q = _t(_normal(1, B, S, G, Qg, D))
    k = _t(_normal(2, B, S, G, D))
    v = _t(_normal(3, B, S, G, D))
    dense = L.dense_attention(q, k, v, mask_mode="causal")
    t = S - 1
    out = L.decode_attention(q[:, t:t + 1], k, v,
                             torch.full((B,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(out[:, 0]), _np(dense[:, t]),
                               rtol=2e-5, atol=2e-5)


def test_moe_capacity_and_combination():
    cfg, _ = _moe_cfgs()
    B, S, d, E = 2, 16, 16, 8
    p = {k: _t(v) for k, v in _moe_params().items()}
    x = _t(_normal(4, B, S, d))
    y, aux = L.moe_layer(p, x, MI1, cfg, capacity_factor=8.0)
    assert y.shape == x.shape
    assert torch.isfinite(y).all()
    assert float(aux) >= 0.99  # balance loss >= 1 at optimum E*sum(f*p)

    # oracle: dense per-token expert mixture with the same top-k weights
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf @ p["w_router"], -1)
    tv, ti = torch.topk(probs, cfg.top_k)
    tv = tv / tv.sum(-1, keepdim=True)
    y_ref = torch.zeros_like(xf)
    for e in range(E):
        h = L.silu(xf @ p["w_gate"][e]) * (xf @ p["w_up"][e])
        o = h @ p["w_down"][e]
        w = torch.where(ti == e, tv, 0.0).sum(-1)
        y_ref = y_ref + o * w[:, None]
    np.testing.assert_allclose(_np(y.reshape(-1, d)), _np(y_ref),
                               rtol=2e-4, atol=2e-4)


def test_moe_capacity_drops_tokens():
    """With capacity factor ~0 every token drops -> output ~ 0."""
    cfg, _ = _moe_cfgs()
    p = {"w_router": torch.ones((16, 8)), "w_gate": torch.ones((8, 16, 32)),
         "w_up": torch.ones((8, 16, 32)), "w_down": torch.ones((8, 32, 16))}
    x = torch.ones((1, 64, 16))
    y, _ = L.moe_layer(p, x, MI1, cfg, capacity_factor=1e-9)
    # capacity C=1 -> at most top_k * E tokens receive any output
    nonzero_tokens = int((y.reshape(-1, 16).abs().sum(-1) > 0).sum())
    assert nonzero_tokens <= cfg.top_k * cfg.n_experts, nonzero_tokens


# ---------------------------------------------------------------------------
# The models: prefill and decode against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_init_f32(arch):
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    return jax.jit(r_build_model(rcfg, RMI1).init)(jax.random.key(0))


def _smoke_pair(arch, dtype="float32"):
    """The reference's smoke model and its float32 init (cast to
    ``dtype``), and the port's model holding the same weights."""
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype=dtype)
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]), dtype=dtype)
    rmodel = r_build_model(rcfg, RMI1)
    rparams = jax.tree.map(lambda x: x.astype(dtype), _ref_init_f32(arch))
    model = build_model(cfg, MI1, device="cpu")
    params_from_numpy(model, jax.tree.map(np.asarray, rparams))
    return cfg, rmodel, rparams, model


def _inputs(cfg, B, S, seed=1):
    """Tokens (B, S) and, per family, patches or frames (float32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return toks, extra


def _batches(toks, extra, t):
    rb = {"tokens": jnp.asarray(toks[:, :t])}
    tb = {"tokens": torch.from_numpy(toks[:, :t].copy())}
    for k, v in extra.items():
        rb[k] = jnp.asarray(v)
        tb[k] = torch.from_numpy(v)
    return rb, tb


def _close_logits(got, ref, vocab, rel=1e-5, msg=""):
    """Real columns within ``rel`` of the largest |logit|; padded columns
    equal."""
    got, ref = _np(got), _np(ref)
    scale = np.abs(ref[..., :vocab]).max()
    err = np.abs(got[..., :vocab] - ref[..., :vocab]).max()
    assert err <= rel * scale, (msg, err, scale)
    np.testing.assert_array_equal(got[..., vocab:], ref[..., vocab:])


def _r_grow(cache, n):
    """The reference's cache with ``k``/``v`` grown by ``n`` on axis 2."""
    out = dict(cache)
    for name in ("k", "v"):
        pad = [(0, 0)] * cache[name].ndim
        pad[2] = (0, n)
        out[name] = jnp.pad(cache[name], pad)
    return out


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    cfg, rmodel, rparams, model = _smoke_pair(arch)
    params = model.param_tree()
    B, S0, K = 2, 8, 3
    toks, extra = _inputs(cfg, B, S0 + K)
    rb, tb = _batches(toks, extra, S0)
    rlogits, rcache = jax.jit(rmodel.prefill)(rparams, rb)
    logits, cache = model.prefill(params, tb)
    assert sorted(cache) == sorted(rcache)
    _close_logits(logits, rlogits, cfg.vocab, msg="prefill")
    for k in rcache:
        assert tuple(cache[k].shape) == tuple(rcache[k].shape), k
        np.testing.assert_allclose(_np(cache[k]), _np(rcache[k]), err_msg=k,
                                   **F32)
    cur = int(cache["k"].shape[2])
    rcache, cache = _r_grow(rcache, K), serve_mod.pad_cache(cache, K)
    rdecode = jax.jit(rmodel.decode)
    for t in range(K):
        tok = toks[:, S0 + t][:, None]
        pos = np.full((B,), cur + t, np.int32)
        rlogits, rcache = rdecode(rparams, {"token": jnp.asarray(tok),
                                            "pos": jnp.asarray(pos)}, rcache)
        logits, cache = model.decode(params, {"token": _t(tok),
                                              "pos": _t(pos)}, cache)
        _close_logits(logits, rlogits, cfg.vocab, msg=f"decode {t}")
    for k in rcache:
        np.testing.assert_allclose(_np(cache[k]), _np(rcache[k]), err_msg=k,
                                   **F32)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_streamed_decode_matches_prefill(arch):
    """The reference's decode-equivalence test on the port: prefill 12
    tokens, stream 4 teacher-forced steps, each step's logits equal to a
    prefill of the longer sequence."""
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    model = build_model(cfg, MI1, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S0, K = 2, 12, 4
    toks, extra = _inputs(cfg, B, S0 + K, seed=2)
    logits, cache = model.prefill(params, _batches(toks, extra, S0)[1])
    off = cache["k"].shape[2] - S0   # the VLM's patch prefix
    assert off == (cfg.n_prefix if cfg.family == "vlm" else 0)
    cache = serve_mod.pad_cache(cache, K)
    stream = [logits]
    for t in range(K - 1):
        logits, cache = model.decode(
            params, {"token": _t(toks[:, S0 + t][:, None]),
                     "pos": torch.full((B,), off + S0 + t,
                                       dtype=torch.int32)}, cache)
        stream.append(logits)
    for t in range(K):
        ref, _ = model.prefill(params, _batches(toks, extra, S0 + t)[1])
        np.testing.assert_allclose(
            _np(stream[t]), _np(ref), rtol=2e-4, atol=2e-4,
            err_msg=f"{arch}: step {t} logits diverge from prefill oracle")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b",
                                  "paligemma-3b", "whisper-base"])
@pytest.mark.parametrize("dtype,loss_rtol,grad_rel,zero_atol", [
    ("float32", 1e-5, 1e-5, 1e-9), ("bfloat16", 2e-5, 5e-2, 1e-6)])
def test_loss_and_every_gradient_match_the_reference(arch, dtype, loss_rtol,
                                                     grad_rel, zero_atol):
    cfg, rmodel, rparams, model = _smoke_pair(arch, dtype)
    S = 16
    toks, extra = _inputs(cfg, 2, S + 1, seed=3)
    rb, tb = _batches(toks, extra, S)
    labels = toks[:, 1:S + 1]
    rb["labels"], tb["labels"] = jnp.asarray(labels), _t(labels)
    if "patches" in extra:
        rb["patches"] = rb["patches"].astype(dtype)
        tb["patches"] = tb["patches"].to(getattr(torch, dtype))
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, rb), has_aux=True))(rparams)
    params = model.param_tree()
    loss, met = model.loss(params, tb)
    flat = flatten_with_paths(params)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=loss_rtol)
    assert sorted(met) == sorted(rmet)
    assert int(met["tokens"]) == int(rmet["tokens"]) == labels.size
    if "aux" in met:
        np.testing.assert_allclose(float(met["aux"].detach()),
                                   float(rmet["aux"]),
                                   rtol=loss_rtol * 10)
    rflat = flatten_with_paths(jax.tree.map(
        lambda g: np.asarray(g, np.float32), rgrads))
    assert sorted(rflat) == sorted(flat)
    for path, g in zip(flat, grads):
        assert g.dtype == getattr(torch, dtype)
        ref = rflat[path]
        err = np.abs(_np(g) - ref).max()
        if cfg.family == "encdec" and path.endswith("bk"):
            assert err <= zero_atol, (path, err)   # exact gradient: zero
        else:
            assert err <= grad_rel * np.abs(ref).max(), (path, err)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b",
                                  "paligemma-3b", "whisper-base"])
def test_full_width_parameter_shapes_equal_the_reference(arch):
    """The full config, abstract on both sides: the reference's
    ``jax.eval_shape`` of ``init`` and the port's model on ``meta``."""
    rmodel = r_build_model(R_ARCHS[arch], RMI1)
    rshapes = {k: tuple(s.shape) for k, s in flatten_with_paths(
        jax.eval_shape(lambda: rmodel.init(jax.random.key(0)))).items()}
    model = build_model(ARCHS[arch], MI1, device="meta")
    assert model.param_shapes() == rshapes
    n = sum(int(np.prod(s)) for s in rshapes.values())
    assert n > 0.9 * ARCHS[arch].param_count()
    assert model.kv_duplication() == r_build_model(
        R_ARCHS[arch], RMI1).kv_duplication()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b",
                                  "paligemma-3b", "whisper-base"])
def test_init_cache_equals_the_references_in_shape(arch):
    cfg = smoke_config(ARCHS[arch])
    cache = build_model(cfg, MI1, device="cpu").init_cache(3, 20)
    rcache = r_build_model(r_smoke_config(R_ARCHS[arch]),
                           RMI1).init_cache(3, 20)
    assert sorted(cache) == sorted(rcache)
    for k, v in rcache.items():
        assert tuple(cache[k].shape) == tuple(v.shape), k
        assert str(cache[k].dtype).removeprefix("torch.") == str(v.dtype)
        assert not cache[k].any()


def test_the_ports_moe_and_vlm_init_draw_their_leaves():
    for arch in ("arctic-480b", "paligemma-3b", "whisper-base"):
        model = build_model(smoke_config(ARCHS[arch]), MI1, device="cpu")
        p = flatten_with_paths(model.init(torch.Generator().manual_seed(0)))
        for path, leaf in p.items():
            name = path.rsplit("/", 1)[-1]
            if name.startswith(("ln", "final_norm", "enc_norm")):
                assert torch.equal(leaf, torch.ones_like(leaf)), path
            elif name.startswith("b_fc"):
                assert not leaf.any(), path
            elif name.startswith(("w", "dw", "x_w", "emb", "lm_head",
                                  "vis_")) and "wq" not in name \
                    and "wo" not in name:
                s = float(leaf.detach().float().std())
                assert 0.001 < s < 0.03, (path, s)


# ---------------------------------------------------------------------------
# The serving steps and the serve loop
# ---------------------------------------------------------------------------

def test_serve_cfg_keeps_weights_resident_when_they_fit():
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    fsdp = dataclasses.replace(cfg, fsdp=True)
    assert _serve_cfg(cfg, MI1, None, CPU) is cfg
    assert _serve_cfg(fsdp, MI1, True, CPU).fsdp is False
    assert _serve_cfg(fsdp, MI1, False, CPU).fsdp is True
    # the decision is the device's memory, not a TPU figure
    assert _serve_cfg(fsdp, MI1, None, CPU).fsdp is False
    assert device_memory_bytes(CPU) > 2 * fsdp.param_count()
    huge = dataclasses.replace(ARCHS["arctic-480b"], fsdp=True)
    assert huge.param_count() * 2 > device_memory_bytes(CPU)
    assert _serve_cfg(huge, MI1, None, CPU).fsdp is True
    rstep = r_steps._serve_cfg(dataclasses.replace(
        r_smoke_config(R_ARCHS["olmoe-1b-7b"]), fsdp=True), RMI1, None)
    assert rstep.fsdp is False


def test_serving_steps_share_one_model_and_decode_in_place():
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen2-0.5b"]),
                              dtype="float32")
    mesh = make_host_mesh(1, 1, device="cpu")
    pre = make_prefill_step(cfg, mesh, global_batch=2)
    dec = make_decode_step(cfg, mesh, global_batch=2, model=pre.model)
    assert dec.model is pre.model and pre.jit() is pre.step
    params = pre.model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.arange(16, dtype=np.int32).reshape(2, 8))
    logits, cache = pre.jit()(params, {"tokens": toks})
    assert not logits.requires_grad and not cache["k"].requires_grad
    cache = serve_mod.pad_cache(cache, 4)
    kept = {k: v.clone() for k, v in cache.items()}
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out, new = dec.jit()(params, {"token": tok,
                                  "pos": torch.full((2,), 8,
                                                    dtype=torch.int32)},
                         cache)
    for k in ("k", "v", "pos"):
        assert new[k] is cache[k]    # written in place
    assert new["pos"].tolist() == [[9, 9]] * cfg.n_layers
    assert torch.equal(new["k"][:, :, :8], kept["k"][:, :, :8])
    assert not torch.equal(new["k"][:, :, 8], kept["k"][:, :, 8])
    assert torch.equal(new["k"][:, :, 9:], kept["k"][:, :, 9:])


def test_pad_cache_grows_self_attention_by_its_own_length_only():
    """The encoder-decoder's ``xk``/``xv`` keep the encoder's length even
    when the prompt is as long (the reference's ``== prompt_len`` test
    would grow them too)."""
    cfg = smoke_config(ARCHS["whisper-base"])
    model = build_model(cfg, MI1, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks, extra = _inputs(cfg, 2, cfg.enc_seq)
    _, cache = model.prefill(params, _batches(toks, extra, cfg.enc_seq)[1])
    grown = serve_mod.pad_cache(cache, 5)
    assert grown["k"].shape[2] == grown["v"].shape[2] == cfg.enc_seq + 5
    assert grown["xk"] is cache["xk"] and grown["xv"] is cache["xv"]
    assert torch.equal(grown["k"][:, :, :cfg.enc_seq], cache["k"])
    assert not grown["k"][:, :, cfg.enc_seq:].any()
    rcache = jax.tree.map(lambda t: jnp.asarray(_np(t)), cache)
    rgrown = r_pad_cache(None, rcache, 2, cfg.enc_seq, cfg.enc_seq + 5)
    assert rgrown["xk"].shape[2] == cfg.enc_seq + 5   # the reference's


def _reference_serve(rcfg, rparams, prompts, gen):
    """The reference's ``launch.serve.main`` loop, verbatim but for its
    config and weights (float32, given) and its printing."""
    mesh = r_make_host_mesh(1, 1)
    B = prompts[0].shape[0]
    s_max = prompts[0].shape[1] + gen
    prefill = r_steps.make_prefill_step(rcfg, mesh, global_batch=B).jit()
    decode = r_steps.make_decode_step(rcfg, mesh, global_batch=B).jit()
    model = r_steps.make_prefill_step(rcfg, mesh, global_batch=B).model
    out = []
    for p in prompts:
        prompt_len = p.shape[1]
        logits, cache = prefill(rparams, {"tokens": jnp.asarray(p)})
        cache = r_pad_cache(model, cache, B, prompt_len, s_max)
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        outs = [np.asarray(tok)]
        pos = jnp.full((B,), prompt_len, jnp.int32)
        for t in range(gen - 1):
            logits, cache = decode(rparams, {"token": tok, "pos": pos + t},
                                   cache)
            tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
            outs.append(np.asarray(tok))
        out.append(np.concatenate(outs, axis=1))
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_serve_loop_generates_the_references_tokens(arch):
    cfg, _, rparams, model = _smoke_pair(arch)
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    prompts = serve_mod.make_prompts(cfg.vocab, 6, 3, 10, seed=0)
    rng = np.random.default_rng(0)
    assert all(np.array_equal(p, rng.integers(0, cfg.vocab, (3, 10),
                                              dtype=np.int32))
               for p in prompts)
    ref = _reference_serve(rcfg, rparams, prompts, gen=6)
    mesh = make_host_mesh(1, 1, device="cpu")
    pre = make_prefill_step(cfg, mesh, global_batch=3, model=model)
    dec = make_decode_step(cfg, mesh, global_batch=3, model=model)
    run = serve_mod.serve(model, model.param_tree(), prompts, gen=6,
                          prefill=pre.jit(), decode=dec.jit())
    assert len(run.tokens) == len(ref) == 2
    for got, want in zip(run.tokens, ref):
        assert got.shape == (3, 6) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert run.n_tokens == 36
    assert len(run.prefill_ms) == 2 and [len(d) for d in run.decode_ms] \
        == [5, 5]


def test_paligemma_reference_serve_fault_and_the_ports_fix():
    """The reference's serve loop grows only cache axes equal to the
    prompt length and starts decode at ``prompt_len``.  A VLM's cache is
    ``n_prefix + prompt_len`` long, so it is never grown, the decode write
    is clamped onto the last prompt slot and RoPE's positions are short by
    the prefix: its first decoded logits miss a prefill of the longer
    sequence (by 3.3e-3 on this input).  The port grows the cache by its
    own length and starts at ``n_prefix + prompt_len`` (6e-8 here)."""
    arch, B, P, gen = "paligemma-3b", 2, 8, 2
    cfg, rmodel, rparams, model = _smoke_pair(arch)
    params = model.param_tree()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_prefix, cfg.d_model)
                                  ).astype(np.float32)

    def rbatch(t):
        return {"tokens": jnp.asarray(t), "patches": jnp.asarray(patches)}

    def tbatch(t):
        return {"tokens": _t(t), "patches": _t(patches)}

    # the reference's way
    rlogits, rcache = jax.jit(rmodel.prefill)(rparams, rbatch(toks))
    rtok = np.asarray(jnp.argmax(rlogits, -1))[:, None].astype(np.int32)
    rcache = r_pad_cache(rmodel, rcache, B, P, P + gen)
    assert rcache["k"].shape[2] == cfg.n_prefix + P    # never grown
    rdec, _ = jax.jit(rmodel.decode)(
        rparams, {"token": jnp.asarray(rtok),
                  "pos": jnp.full((B,), P, jnp.int32)}, rcache)
    roracle, _ = jax.jit(rmodel.prefill)(
        rparams, rbatch(np.concatenate([toks, rtok], 1)))
    v = cfg.vocab
    ref_err = float(np.abs(_np(rdec)[:, :v] - _np(roracle)[:, :v]).max())
    # the port's way
    logits, cache = model.prefill(params, tbatch(toks))
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    assert np.array_equal(tok.numpy(), rtok)
    cur = cache["k"].shape[2]
    assert cur == cfg.n_prefix + P
    cache = serve_mod.pad_cache(cache, gen)
    dec, _ = model.decode(params, {"token": tok,
                                   "pos": torch.full((B,), cur,
                                                     dtype=torch.int32)},
                          cache)
    oracle, _ = model.prefill(params, tbatch(np.concatenate(
        [toks, tok.numpy()], 1)))
    port_err = float(np.abs(_np(dec)[:, :v] - _np(oracle)[:, :v]).max())
    assert ref_err > 1e-3, ref_err
    assert port_err <= 1e-6, port_err


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "paligemma-3b", "whisper-base"])
def test_serve_main_on_the_cpu(arch, capsys):
    run = serve_mod.main(["--arch", arch, "--smoke", "--requests", "3",
                          "--batch", "2", "--prompt-len", "6", "--gen", "4"],
                         device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] batch 0: generated (2, 4) tokens; "
                             "sample row: [")
    assert out[1].startswith("[serve] batch 1: generated (2, 4) tokens")
    assert out[2].startswith("[serve] 16 tokens in ")
    cfg = smoke_config(ARCHS[arch])
    assert all(((t >= 0) & (t < cfg.vocab)).all() for t in run.tokens)
    lay = head_layout(cfg, 1)
    s = 6 + 4 + (cfg.n_prefix if cfg.family == "vlm" else 0)
    kv = 2 * cfg.n_layers * 2 * s * lay.kv_total * cfg.hd * 2   # bf16
    if cfg.family == "encdec":
        kv += 2 * cfg.n_layers * 2 * cfg.enc_seq * lay.kv_total * cfg.hd * 2
    assert run.cache_bytes == kv + cfg.n_layers * 2 * 4
    assert r_head_layout(R_ARCHS[arch], 1).kv_total == lay.kv_total
