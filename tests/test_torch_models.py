"""The port's dense LM (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's parameters cross with ``params_from_numpy``.  Tolerances, as
measured on the CPU (jax 0.9, torch 2.13):

* float32: layer outputs to rtol = atol = 1e-5 (attention and the loss
  within 1e-6); the smoke models' loss to rtol 1e-6 (equal or 1 ulp) and
  every gradient leaf to 1e-5 of that leaf's largest entry (measured
  worst 6.5e-7);
* bfloat16: the loss to rtol 2e-5 (measured 3.5e-6) and every gradient
  leaf to 5e-2 of its largest entry (measured 2.1e-2, at ``ln1``/``ln2``:
  XLA and eager torch round bf16 intermediates at different places).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.models import MeshInfo as RMeshInfo
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models.common import head_layout as r_head_layout

import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.configs import (ARCHS, SHAPES, SMOKE_SHAPE, applicable,
                                 input_specs, smoke_config)
from repro_torch.models import (MeshInfo, build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models.common import head_layout, q_head_permutation
from repro_torch.tree import flatten_with_paths

MI1 = MeshInfo(model_size=1, data_size=1)
RMI1 = RMeshInfo(model_size=1, data_size=1)
DENSE = sorted(a for a, c in ARCHS.items() if c.family == "dense")
F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_data():
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import applicable as r_applicable
    assert {k: dataclasses.asdict(v) for k, v in ARCHS.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_ARCHS.items()}
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in R_SHAPES.items()}
    for a in ARCHS:
        assert dataclasses.asdict(smoke_config(ARCHS[a])) == \
            dataclasses.asdict(r_smoke_config(R_ARCHS[a]))
        for s in SHAPES:
            assert applicable(ARCHS[a], SHAPES[s]) == \
                r_applicable(R_ARCHS[a], R_SHAPES[s])
    assert dataclasses.astuple(SMOKE_SHAPE) == ("smoke", "train", 32, 2)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_are_meta_stand_ins_of_the_reference_shapes(arch):
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import input_specs as r_input_specs
    for s in sorted(SHAPES):
        if not applicable(ARCHS[arch], SHAPES[s]):
            continue
        mine = input_specs(ARCHS[arch], SHAPES[s])
        ref = r_input_specs(R_ARCHS[arch], R_SHAPES[s])
        assert sorted(mine) == sorted(ref)
        for k, v in mine.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (s, k)
            assert str(v.dtype).removeprefix("torch.") == str(ref[k].dtype)


def test_head_layouts_all_archs():
    """Layout arithmetic: padded heads cover the real ones for every arch
    at every tp in {1,2,4,8,16}; and equal the reference's."""
    for arch, cfg in ARCHS.items():
        if cfg.is_attention_free:
            continue
        for tp in (1, 2, 4, 8, 16):
            lay = head_layout(cfg, tp)
            assert lay.h_pad >= cfg.n_heads
            assert lay.h_pad % tp == 0
            assert lay.kv_total % tp == 0
            assert lay.hq_local * tp == lay.h_pad
            assert lay.ql_per_kv * lay.kv_total == lay.h_pad
            # mesh-independence: global padded sizes equal the tp=16 ones
            lay16 = head_layout(cfg, 16)
            assert (lay.h_pad, lay.kv_total) == (lay16.h_pad,
                                                 lay16.kv_total)
            assert dataclasses.astuple(lay) == dataclasses.astuple(
                r_head_layout(R_ARCHS[arch], tp))


# ---------------------------------------------------------------------------
# Layers against the reference
# ---------------------------------------------------------------------------

def test_rms_norm_silu_and_rope_match_the_reference():
    x = _normal(1, 2, 8, 16)
    scale = _normal(2, 16) + 1.0
    np.testing.assert_allclose(
        _np(L.rms_norm(_t(x), _t(scale), 1e-5)),
        _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)), **F32)
    np.testing.assert_allclose(_np(L.silu(_t(x))),
                               _np(RL.silu(jnp.asarray(x))), **F32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)
    c, s = L.rope_tables(_t(pos), 16, 1e4, torch.float32)
    rc, rs = RL.rope_tables(jnp.asarray(pos), 16, 1e4, jnp.float32)
    np.testing.assert_allclose(_np(c), _np(rc), **F32)
    np.testing.assert_allclose(_np(s), _np(rs), **F32)
    xh = _normal(3, 2, 8, 2, 16)
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(xh), c, s)),
        _np(RL.apply_rope(jnp.asarray(xh), rc, rs)), **F32)
    # the (S, hd//2) table form
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(xh), c[0], s[0])),
        _np(RL.apply_rope(jnp.asarray(xh), rc[0], rs[0])), **F32)


@pytest.mark.parametrize("mask_mode", ["causal", "full", "prefix"])
def test_mask_and_attention_cores_match_the_reference(mask_mode):
    np.testing.assert_array_equal(
        _np(L._mask_bias(6, 9, 3, mask_mode, 2, torch.float32)),
        _np(RL._mask_bias(6, 9, 3, mask_mode, 2, jnp.float32)))
    q = _normal(1, 2, 40, 2, 3, 16)
    k = _normal(2, 2, 40, 2, 16)
    v = _normal(3, 2, 40, 2, 16)
    ref = RL.dense_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), mask_mode=mask_mode, prefix=5)
    np.testing.assert_allclose(
        _np(L.dense_attention(_t(q), _t(k), _t(v), mask_mode=mask_mode,
                              prefix=5)), _np(ref), **F32)
    # ragged kv chunks (40 % 16 != 0) and both step policies
    for static in (True, False):
        rf = RL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask_mode=mask_mode,
                                prefix=5, chunk_q=8, chunk_k=16,
                                static_steps=static)
        pf = L.flash_attention(_t(q), _t(k), _t(v), mask_mode=mask_mode,
                               prefix=5, chunk_q=8, chunk_k=16,
                               static_steps=static)
        np.testing.assert_allclose(_np(pf), _np(rf), **F32)


def _attn_params(cfg, lay, seed=0):
    d, hd = cfg.d_model, cfg.hd
    p = {"wq": _normal(seed, d, lay.h_pad * hd, scale=0.1),
         "wk": _normal(seed + 1, d, lay.kv_total * hd, scale=0.1),
         "wv": _normal(seed + 2, d, lay.kv_total * hd, scale=0.1),
         "wo": _normal(seed + 3, lay.h_pad * hd, d, scale=0.1),
         "bq": _normal(seed + 4, lay.h_pad * hd, scale=0.1),
         "bk": _normal(seed + 5, lay.kv_total * hd, scale=0.1),
         "bv": _normal(seed + 6, lay.kv_total * hd, scale=0.1)}
    return p


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-8b"])
@pytest.mark.parametrize("flash", [False, True])
def test_attention_layer_matches_the_reference(arch, flash):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32",
                              flash_threshold=8 if flash else 4096)
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32",
                               flash_threshold=8 if flash else 4096)
    lay = head_layout(cfg, 1)
    p = _attn_params(cfg, lay)
    x = _normal(9, 2, 16, cfg.d_model)
    q, k, v = L.attn_project_qkv({n: _t(a) for n, a in p.items()}, _t(x),
                                 lay, qkv_bias=cfg.qkv_bias)
    rq, rk, rv = RL.attn_project_qkv({n: jnp.asarray(a) for n, a in
                                      p.items()}, jnp.asarray(x), lay,
                                     qkv_bias=cfg.qkv_bias)
    for a, b in ((q, rq), (k, rk), (v, rv)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    np.testing.assert_array_equal(_np(L._group_q(q, lay)),
                                  _np(RL._group_q(rq, lay)))
    out, cache = L.attn_layer({n: _t(a) for n, a in p.items()}, _t(x), MI1,
                              lay, cfg, mode="train")
    ref, _ = RL.attn_layer({n: jnp.asarray(a) for n, a in p.items()},
                           jnp.asarray(x), RMI1, lay, rcfg, mode="train")
    assert cache is None
    np.testing.assert_allclose(_np(out), _np(ref), **F32)


@pytest.mark.parametrize("gelu", [False, True])
def test_mlp_glu_matches_the_reference(gelu):
    p = {"w_gate": _normal(1, 16, 24, scale=0.2),
         "w_up": _normal(2, 16, 24, scale=0.2),
         "w_down": _normal(3, 24, 16, scale=0.2)}
    x = _normal(4, 2, 8, 16)
    np.testing.assert_allclose(
        _np(L.mlp_glu({k: _t(v) for k, v in p.items()}, _t(x), MI1,
                      gelu=gelu)),
        _np(RL.mlp_glu({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), RMI1, gelu=gelu)), **F32)


def test_embed_and_lm_head_loss_match_the_reference_with_gradients():
    V, d = 64, 16
    table = _normal(1, V, d, scale=0.5)
    ids = np.random.default_rng(2).integers(0, V, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(L.embed_lookup(_t(table), _t(ids), MI1)),
        _np(RL.embed_lookup(jnp.asarray(table), jnp.asarray(ids), RMI1)))
    h = _normal(3, 2, 8, d)
    labels = ids.copy()
    labels[0, :3] = -1
    ht, tt = _t(h).requires_grad_(), _t(table).requires_grad_()
    loss, n = L.lm_head_loss(ht, tt, _t(labels), MI1, vocab_real=V - 9)
    gh, gt = torch.autograd.grad(loss, [ht, tt])
    (rloss, rn), (rgh, rgt) = jax.value_and_grad(
        lambda a, b: RL.lm_head_loss(a, b, jnp.asarray(labels), RMI1,
                                     vocab_real=V - 9),
        argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(table))
    assert int(n) == int(rn) == 13
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    np.testing.assert_allclose(_np(gh), _np(rgh), **F32)
    np.testing.assert_allclose(_np(gt), _np(rgt), **F32)


def test_collectives_are_identities_on_one_card_and_raise_beyond():
    x = torch.ones(3)
    assert L.psum_model(x, MI1) is x and L.pmax_model(x, MI1) is x
    assert L.model_rank(MI1) == 0
    p = {"w": x}
    assert L.gather_fsdp(p, {"w": 0}, MI1) is p
    # beyond one rank the collectives need the mesh's process groups
    with pytest.raises(ValueError, match="process groups"):
        L.psum_model(x, MeshInfo(model_size=2))
    with pytest.raises(ValueError, match="process groups"):
        L.gather_fsdp(p, {"w": 0}, MeshInfo(data_size=2))


# ---------------------------------------------------------------------------
# The reference's dense layer tests, run against the port
# ---------------------------------------------------------------------------

def test_flash_equals_dense_all_masks():
    q = _t(_normal(1, 2, 128, 2, 3, 16))
    k = _t(_normal(2, 2, 128, 2, 16))
    v = _t(_normal(3, 2, 128, 2, 16))
    for mm in ("causal", "full", "prefix"):
        a = L.dense_attention(q, k, v, mask_mode=mm, prefix=5)
        b = L.flash_attention(q, k, v, mask_mode=mm, prefix=5,
                              chunk_q=32, chunk_k=32)
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-5, atol=2e-5)


def test_rope_preserves_norm_and_relativity():
    B, S, H, D = 2, 32, 2, 16
    x = _t(_normal(0, B, S, H, D))
    pos = torch.arange(S)[None].expand(B, S)
    cos, sin = L.rope_tables(pos, D, 1e4, torch.float32)
    y = L.apply_rope(x, cos, sin)
    np.testing.assert_allclose(np.linalg.norm(_np(y), axis=-1),
                               np.linalg.norm(_np(x), axis=-1), rtol=1e-5)
    # relative property: <R(p)q, R(p+k)v> depends only on k
    q = _t(_normal(1, 1, 1, 1, D))
    v = _t(_normal(2, 1, 1, 1, D))

    def dot_at(p, k):
        c1, s1 = L.rope_tables(torch.full((1, 1), p), D, 1e4, torch.float32)
        c2, s2 = L.rope_tables(torch.full((1, 1), p + k), D, 1e4,
                               torch.float32)
        return float(torch.sum(L.apply_rope(q, c1, s1)
                               * L.apply_rope(v, c2, s2)))
    assert abs(dot_at(3, 5) - dot_at(11, 5)) < 1e-4


def test_ce_loss_matches_naive():
    V, d, N = 50, 8, 12
    rng = np.random.default_rng(0)
    h = _t(_normal(0, 2, N // 2, d))
    table = _t(_normal(1, V, d, scale=0.5))
    labels = torch.as_tensor(rng.integers(0, V - 10, (2, N // 2)))
    loss, n = L.lm_head_loss(h, table, labels, MI1, vocab_real=V - 8)
    logits = (h.reshape(-1, d) @ table.T).double().numpy()
    logits[:, V - 8:] = -np.inf
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    lab = labels.numpy().reshape(-1)
    ref = (lse - logits[np.arange(len(lab)), lab]).mean()
    np.testing.assert_allclose(float(loss), ref, rtol=1e-4)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**30))
def test_masked_labels_excluded(seed):
    V, d = 32, 8
    rng = np.random.default_rng(seed)
    h = _t(rng.standard_normal((1, 8, d)).astype(np.float32))
    table = _t(rng.standard_normal((V, d)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, V, (1, 8)))
    masked = labels.clone()
    masked[0, :4] = -1
    loss_m, n = L.lm_head_loss(h, table, masked, MI1, vocab_real=V)
    loss_h, _ = L.lm_head_loss(h[:, 4:], table, labels[:, 4:], MI1,
                               vocab_real=V)
    assert int(n) == 4
    np.testing.assert_allclose(float(loss_m), float(loss_h), rtol=1e-5)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_init_f32(arch):
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    return jax.jit(r_build_model(rcfg, RMI1).init)(jax.random.key(0))


def _smoke_pair(arch, dtype):
    """The reference's smoke model and its init, and the port's model
    holding the same weights.  The reference draws in float32 and casts
    to the config's dtype, so its bfloat16 init is the float32 one cast."""
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype=dtype)
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]), dtype=dtype)
    rmodel = r_build_model(rcfg, RMI1)
    rparams = jax.tree.map(lambda x: x.astype(dtype), _ref_init_f32(arch))
    model = build_model(cfg, MI1, device="cpu")
    params_from_numpy(model, jax.tree.map(np.asarray, rparams))
    return cfg, rmodel, rparams, model


def _tokens(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


@pytest.mark.parametrize("dtype,loss_rtol,grad_rel", [
    ("float32", 1e-6, 1e-5), ("bfloat16", 2e-5, 5e-2)])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen1.5-0.5b"])
def test_model_loss_and_every_gradient_match_the_reference(
        arch, dtype, loss_rtol, grad_rel):
    cfg, rmodel, rparams, model = _smoke_pair(arch, dtype)
    toks, labs = _tokens(cfg)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, rb), has_aux=True))(rparams)
    params = model.param_tree()
    loss, met = model.loss(params, {"tokens": torch.as_tensor(toks),
                                    "labels": torch.as_tensor(labs)})
    paths = list(flatten_with_paths(params))
    grads = torch.autograd.grad(loss, list(flatten_with_paths(params)
                                           .values()))
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=loss_rtol)
    assert int(met["tokens"]) == int(rmet["tokens"]) == toks.size
    rflat = flatten_with_paths(jax.tree.map(
        lambda g: np.asarray(g, np.float32), rgrads))
    assert sorted(rflat) == sorted(paths)
    for path, g in zip(paths, grads):
        assert g.dtype == getattr(torch, dtype)
        ref = rflat[path]
        err = np.abs(_np(g) - ref).max()
        assert err <= grad_rel * np.abs(ref).max(), (path, err)


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_parameter_shapes_equal_the_reference(arch):
    """The full config, abstract on both sides: the reference's
    ``jax.eval_shape`` of ``init`` and the port's model on ``meta``."""
    rmodel = r_build_model(R_ARCHS[arch], RMI1)
    rshapes = {k: tuple(s.shape) for k, s in flatten_with_paths(
        jax.eval_shape(lambda: rmodel.init(jax.random.key(0)))).items()}
    model = build_model(ARCHS[arch], MI1, device="meta")
    assert model.param_shapes() == rshapes
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(int(np.prod(s)) for s in rshapes.values())
    assert n > 0.9 * ARCHS[arch].param_count()
    if arch == "qwen2-0.5b":
        assert 670e6 < n < 680e6


def test_the_ports_init_pads_zero_ties_kv_and_draws_std_002():
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen2-0.5b"]),
                              d_model=128, d_ff=256, vocab=1000,
                              n_heads=14, n_kv=2, head_dim=0)
    model = build_model(cfg, MI1, device="cpu")
    p = model.init(torch.Generator().manual_seed(0))
    lay, hd, Lr = model.lay, cfg.hd, cfg.n_layers
    pad = [i for i, h in enumerate(q_head_permutation(lay)) if h < 0]
    assert len(pad) == lay.h_pad - cfg.n_heads == 2
    wq = p["blocks"]["wq"].reshape(Lr, cfg.d_model, lay.h_pad, hd)
    wo = p["blocks"]["wo"].reshape(Lr, lay.h_pad, hd, cfg.d_model)
    bq = p["blocks"]["bq"].reshape(Lr, lay.h_pad, hd)
    for i in pad:
        assert not wq[:, :, i].any() and not wo[:, i].any() \
            and not bq[:, i].any()
    rep = lay.kv_total // lay.n_kv
    for nm in ("wk", "wv", "bk", "bv"):
        w = p["blocks"][nm]
        w = w.reshape(w.shape[:-1] + (lay.n_kv, rep, hd))
        assert torch.equal(w, w[..., :1, :].expand_as(w)), nm
    assert model.kv_duplication() == {f"blocks/{n}": rep for n in
                                      ("wk", "wv", "bk", "bv")}
    real = [i for i in range(lay.h_pad) if i not in pad]
    for w in (p["emb"], p["lm_head"], p["blocks"]["w_gate"],
              wq[:, :, real]):
        assert abs(float(w.detach().float().std()) - 0.02) < 0.002
    out = float(p["blocks"]["w_down"].detach().float().std())
    assert abs(out - 0.02 / (2 * Lr) ** 0.5) < 0.1 * out
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    # the same seed draws the same weights
    again = build_model(cfg, MI1, device="cpu")
    again.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


def test_params_cross_both_ways_bit_for_bit():
    cfg, rmodel, rparams, model = _smoke_pair("qwen2-0.5b", "bfloat16")
    back = params_to_numpy(model)
    for path, ref in flatten_with_paths(jax.tree.map(
            lambda x: np.asarray(x, np.float32), rparams)).items():
        got = flatten_with_paths(back)[path]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(model, {"emb": back["emb"]})


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_no_nans(arch):
    cfg = smoke_config(ARCHS[arch])
    model = build_model(cfg, MI1, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks, labs = _tokens(cfg)
    loss, metrics = model.loss(params, {"tokens": torch.as_tensor(toks),
                                        "labels": torch.as_tensor(labs)})
    assert np.isfinite(float(loss.detach())), f"{arch}: loss not finite"
    ce = float(metrics["ce"].detach())
    assert 3.0 < ce < 12.0, f"{arch}: ce {ce} outside sane init range"
    for g in torch.autograd.grad(loss, list(model.parameters())):
        assert torch.isfinite(g.float()).all()


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items()
                                        if c.family != "dense"))
def test_families_not_ported_yet_raise_naming_their_roadmap_item(arch):
    """Every family is ported now (the name is kept from when ``ssm`` and
    ``hybrid`` raised naming ROADMAP A9e): each non-dense family builds,
    on its smoke config and at full width, with the reference's parameter
    shapes, dtypes and duplicated-KV map."""
    for cfg, rcfg in ((smoke_config(ARCHS[arch]),
                       r_smoke_config(R_ARCHS[arch])),
                      (ARCHS[arch], R_ARCHS[arch])):
        rmodel = r_build_model(rcfg, RMI1)
        rp = flatten_with_paths(jax.eval_shape(
            lambda: rmodel.init(jax.random.key(0))))
        model = build_model(cfg, MI1, device="meta")
        assert model.cfg.family == cfg.family
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in flatten_with_paths(model.param_tree()).items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in rp.items()}
        assert model.kv_duplication() == rmodel.kv_duplication()
