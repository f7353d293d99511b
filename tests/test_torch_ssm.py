"""The port's SSM and hybrid families (``repro_torch.models``: the Mamba2
layer, ``SSMLM``, ``HybridLM``) and their serving and training paths
against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's parameters cross with ``params_from_numpy``.  Tolerances, as
measured on the CPU (jax 0.9, torch 2.13):

* the reference's own layer tests on the port: the chunked SSD scan
  against the token-by-token recurrence at rtol = atol = 2e-3, the
  streaming causal conv against the batch one at 1e-5;
* layers against the reference's functions: ``_segsum_decay`` and its
  gradient to rtol = atol = 1e-6; ``ssd_chunked``, ``ssd_decode_step``
  and ``mamba2_layer`` within 1e-5 of the output's largest entry in
  float32 (measured: 2.5e-5 of 4.6 at most: a chunk's sums run in
  another order) and within 2 bf16 ulps of it, 2**-7, in bfloat16 (XLA
  keeps float32 between the elementwise ops it fuses, eager torch rounds
  after each);
* models: prefill and decode logits within 1e-5 of the largest |logit|
  over the real vocabulary, padded columns equal; caches to 1e-5;
* loss and gradients at the bounds of ``tests/test_torch_lm_serve.py``:
  the loss to rtol 1e-5 and every gradient leaf to 1e-5 of its largest
  entry in float32, the loss to rtol 2e-5 and the gradients to 5e-2 in
  bfloat16;
* a streamed decode against a prefill of the longer sequence at the
  reference's 2e-4 (``tests/test_decode_equivalence.py``);
* three LP-clipped train steps at the bounds of
  ``tests/test_torch_train.py``: loss and ``lp_s1`` to 1e-4, every
  parameter leaf to atol 2e-6.
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
from repro.data.pipeline import TokenSource as RTokenSource
from repro.data.pipeline import for_model as r_for_model
from repro.launch import steps as r_steps
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.launch.serve import _pad_cache as r_pad_cache
from repro.models import MeshInfo as RMeshInfo
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.models.common import ModelConfig as RModelConfig
from repro.optim import AdamW as RAdamW

import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import TokenSource, for_model
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import (HybridLM, MeshInfo, ModelConfig, SSMLM,
                                build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.optim import AdamW, sync_duplicated_grads
from repro_torch.tree import flatten_with_paths

MI1 = MeshInfo(model_size=1, data_size=1)
RMI1 = RMeshInfo(model_size=1, data_size=1)
F32 = dict(rtol=1e-5, atol=1e-5)
SSM_ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]
# the reference keeps these leaves in float32 in a bfloat16 model
F32_LEAVES = ("blocks/A_log", "blocks/dt_bias")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, ref, dtype, msg=""):
    """Within 1e-5 (float32) or 2 bf16 ulps, 2**-7 (bfloat16), of the
    largest |ref|."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    rel = 1e-5 if dtype == "float32" else 2 ** -7
    assert err <= rel * np.abs(ref).max(), (msg, err)


# ---------------------------------------------------------------------------
# The reference's layer tests, on the port
# ---------------------------------------------------------------------------

def _ssd_inputs(B=2, S=64, H=3, P=8, N=16, seed=0):
    """xs, dt (post-softplus), A (negative), Bc, Cc as numpy float32."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    return xs, dt, A, Bc, Cc


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_sequential(chunk):
    """Twin of ``tests/test_layers.py::test_ssd_chunked_matches_sequential``:
    the chunked SSD algorithm equals the per-token recurrence (2e-3)."""
    xs, dt, A, Bc, Cc = (_t(a) for a in _ssd_inputs())
    B, S, H, P = xs.shape
    y, state = L.ssd_chunked(xs, dt, A, Bc, Cc, chunk)
    st_ref = torch.zeros((B, H, Bc.shape[-1], P))
    ys = []
    for t in range(S):
        st_ref, yt = L.ssd_decode_step(st_ref, xs[:, t], dt[:, t], A,
                                       Bc[:, t], Cc[:, t])
        ys.append(yt)
    y_ref = torch.stack(ys, dim=1)
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(state), _np(st_ref), rtol=2e-3,
                               atol=2e-3)


def test_causal_conv_streaming_matches_batch():
    """Twin of ``tests/test_layers.py::test_causal_conv_streaming_matches_batch``
    (1e-5)."""
    B, S, C, K = 2, 16, 6, 4
    x, w = _t(_normal(0, B, S, C)), _t(_normal(1, K, C))
    y_full, _ = L._causal_conv(x, w)
    cache = torch.zeros((B, K - 1, C))
    outs = []
    for t in range(S):
        yt, cache = L._causal_conv(x[:, t:t + 1], w, cache)
        outs.append(yt)
    np.testing.assert_allclose(_np(y_full), _np(torch.cat(outs, dim=1)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Layers against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_segsum_decay_and_its_gradient_match_the_reference(scale):
    """At large negative decays (``scale=1e4``: cumulative sums of -1e5)
    the masked entries' exp would overflow; masking before exp keeps the
    gradient finite, as the reference's does."""
    da = -np.abs(_normal(2, 2, 3, 16)) * scale
    ct = _normal(3, 2, 3, 16, 16)
    ref, rvjp = jax.vjp(RL._segsum_decay, jnp.asarray(da))
    (rgrad,) = rvjp(jnp.asarray(ct))
    x = _t(da).requires_grad_(True)
    out = L._segsum_decay(x)
    (grad,) = torch.autograd.grad(out, x, _t(ct))
    assert torch.isfinite(grad).all()
    assert not out.triu(1).any()
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(grad), _np(rgrad), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked_matches_the_reference(dtype, chunk):
    """``xs`` and ``Bc``/``Cc`` in ``dtype`` (``dt`` float32, as the
    layer gives it); the state is float32 in both."""
    xs, dt, A, Bc, Cc = _ssd_inputs(S=64, H=4, P=16)
    r = [jnp.asarray(a) for a in (xs, dt, A, Bc, Cc)]
    r[0], r[3], r[4] = (a.astype(dtype) for a in (r[0], r[3], r[4]))
    ry, rstate = jax.jit(RL.ssd_chunked, static_argnums=5)(*r, chunk)
    tdt = getattr(torch, dtype)
    y, state = L.ssd_chunked(_t(xs).to(tdt), _t(dt), _t(A), _t(Bc).to(tdt),
                             _t(Cc).to(tdt), chunk)
    assert y.dtype == tdt and state.dtype == torch.float32
    _close(y, ry, dtype, "y")
    _close(state, rstate, dtype, "state")


def test_ssd_chunked_refuses_a_length_that_is_not_a_chunk_multiple():
    xs, dt, A, Bc, Cc = (_t(a) for a in _ssd_inputs(S=24))
    with pytest.raises(ValueError, match="multiple"):
        L.ssd_chunked(xs, dt, A, Bc, Cc, 16)
    y, _ = L.ssd_chunked(xs, dt, A, Bc, Cc, 32)   # one chunk of 24
    assert y.shape == xs.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_the_reference_and_updates_in_place(dtype):
    rng = np.random.default_rng(4)
    B, H, N, P = 2, 4, 16, 8
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    x_t = rng.standard_normal((B, H, P)).astype(np.float32)
    dt_t = np.logaddexp(rng.standard_normal((B, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B_t = rng.standard_normal((B, N)).astype(np.float32)
    C_t = rng.standard_normal((B, N)).astype(np.float32)
    rstate, ry = jax.jit(RL.ssd_decode_step)(
        jnp.asarray(state), jnp.asarray(x_t).astype(dtype),
        jnp.asarray(dt_t), jnp.asarray(A), jnp.asarray(B_t).astype(dtype),
        jnp.asarray(C_t).astype(dtype))
    tdt = getattr(torch, dtype)
    st = _t(state)
    out, y = L.ssd_decode_step(st, _t(x_t).to(tdt), _t(dt_t), _t(A),
                               _t(B_t).to(tdt), _t(C_t).to(tdt))
    assert out is st and y.dtype == tdt
    _close(st, rstate, dtype, "state")
    _close(y, ry, dtype, "y")


def _mamba_cfgs(**kw):
    base = dict(name="t", family="ssm", n_layers=1, d_model=64, n_heads=0,
                n_kv=0, d_ff=0, vocab=64, ssm_state=16, ssm_head_dim=16,
                ssm_chunk=16)
    base.update(kw)
    return ModelConfig(**base), RModelConfig(**base)


def _mamba_params(cfg, seed=5):
    """One Mamba2 layer's leaves (numpy float32), scaled so every path
    matters, with the reference's constants for A_log / dt_bias / D."""
    d, di, N, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_conv)
    shapes = {"w_z": (d, di), "w_x": (d, di), "w_B": (d, N), "w_C": (d, N),
              "w_dt": (d, H), "conv_x": (K, di), "conv_B": (K, N),
              "conv_C": (K, N), "norm": (di,), "w_out": (di, d)}
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in shapes.items()}
    p["norm"] += 1.0
    p["A_log"] = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    p["dt_bias"] = np.full(H, 0.5, np.float32)
    p["D"] = np.ones(H, np.float32)
    return p


def _as(p, dtype, lib):
    """Leaves in ``dtype`` but A_log / dt_bias, which stay float32."""
    if lib == "jax":
        return {k: jnp.asarray(v).astype(
            "float32" if k in ("A_log", "dt_bias") else dtype)
            for k, v in p.items()}
    return {k: _t(v).to(torch.float32 if k in ("A_log", "dt_bias")
                        else getattr(torch, dtype)) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_layer_train_prefill_decode_match_the_reference(dtype):
    """Train and prefill outputs on 32 tokens, the prefill's cache, then
    three decode steps from it (the port's cache updated in place)."""
    cfg, rcfg = _mamba_cfgs()
    p = _mamba_params(cfg)
    rp, tp = _as(p, dtype, "jax"), _as(p, dtype, "torch")
    tdt = getattr(torch, dtype)
    x = _normal(6, 2, 35, cfg.d_model)
    rx, tx = jnp.asarray(x).astype(dtype), _t(x).to(tdt)

    def rlayer(mode):
        def fn(p, x, c=None):
            out, new = RL.mamba2_layer(
                p, x, RMI1, rcfg, mode=mode,
                cache=None if c is None else RL.SSMCache(**c))
            return out, None if new is None else dataclasses.asdict(new)
        return jax.jit(fn)

    rout, _ = rlayer("train")(rp, rx[:, :32])
    out, none = L.mamba2_layer(tp, tx[:, :32], MI1, cfg, mode="train")
    assert none is None and out.dtype == tdt
    _close(out, rout, dtype, "train")
    rout, rc = rlayer("prefill")(rp, rx[:, :32])
    out, c = L.mamba2_layer(tp, tx[:, :32], MI1, cfg, mode="prefill")
    _close(out, rout, dtype, "prefill")
    for k, v in rc.items():
        assert getattr(c, k).dtype == (torch.float32 if k == "state"
                                       else tdt), k
        _close(getattr(c, k), v, dtype, k)
    state = c.state
    for t in range(32, 35):
        rout, new = rlayer("decode")(rp, rx[:, t:t + 1], rc)
        rc = new
        out, c2 = L.mamba2_layer(tp, tx[:, t:t + 1], MI1, cfg,
                                 mode="decode", cache=c)
        assert c2 is c and c.state is state      # written in place
        _close(out, rout, dtype, f"decode {t}")
        for k, v in rc.items():
            _close(getattr(c, k), v, dtype, f"{k} after {t}")


def test_mamba2_softplus_is_the_references():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` on both sides of
    ``F.softplus``'s threshold of 20 (within 2 ulps: XLA's exp and log1p
    are its own)."""
    x = np.linspace(-20, 40, 121).astype(np.float32)
    np.testing.assert_array_max_ulp(_np(L._softplus(_t(x))),
                                    np.asarray(jax.nn.softplus(x)), 2)


def test_mamba2_layer_rejects_what_it_cannot_run():
    cfg, _ = _mamba_cfgs()
    tp = _as(_mamba_params(cfg), "float32", "torch")
    x = _t(_normal(7, 2, 4, cfg.d_model))
    with pytest.raises(ValueError, match="mode"):
        L.mamba2_layer(tp, x, MI1, cfg, mode="stream")
    with pytest.raises(ValueError, match="one token"):
        L.mamba2_layer(tp, x, MI1, cfg, mode="decode")


def test_rms_norm_sharded_matches_the_reference():
    x, s = _normal(8, 2, 5, 32), _normal(9, 32) + 1.0
    ref = RL.rms_norm_sharded(jnp.asarray(x), jnp.asarray(s), 1e-5, RMI1, 32)
    got = L.rms_norm_sharded(_t(x), _t(s), 1e-5, MI1, 32)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)


# ---------------------------------------------------------------------------
# The models: parameters, caches and weights across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_full_width_parameter_and_cache_shapes_equal_the_reference(arch):
    """The full config, abstract on both sides: the reference's
    ``jax.eval_shape`` of ``init`` and ``init_cache`` and the port's
    model on ``meta``; dtypes too (A_log / dt_bias float32 in a bfloat16
    model)."""
    rmodel = r_build_model(R_ARCHS[arch], RMI1)
    rp = flatten_with_paths(jax.eval_shape(
        lambda: rmodel.init(jax.random.key(0))))
    model = build_model(ARCHS[arch], MI1, device="meta")
    tp = flatten_with_paths(model.param_tree())
    assert model.param_shapes() == {k: tuple(v.shape) for k, v in rp.items()}
    assert {k: str(v.dtype).removeprefix("torch.") for k, v in tp.items()} \
        == {k: str(v.dtype) for k, v in rp.items()}
    n = sum(int(np.prod(v.shape)) for v in rp.values())
    assert n > 0.9 * ARCHS[arch].param_count()
    if arch == "mamba2-1.3b":
        assert len(rp) == 17 and 1.44e9 < n < 1.45e9
    assert model.kv_duplication() == rmodel.kv_duplication()
    rc = flatten_with_paths(jax.eval_shape(lambda: rmodel.init_cache(8, 544)))
    tc = flatten_with_paths(model.init_cache(8, 544))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tc.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in rc.items()}


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_the_ports_init_keeps_the_references_constants(arch):
    """``A_log = log(linspace(1, 16, H))`` in float32 (within 8 ulps of
    the reference's: XLA's float32 linspace and log round differently
    from the float64-then-once rounding here), ``dt_bias = 0.5`` and
    ``D = 1`` exactly, the random leaves at the reference's scales."""
    cfg = smoke_config(ARCHS[arch])
    model = build_model(cfg, MI1, device="cpu")
    p = flatten_with_paths(model.init(torch.Generator().manual_seed(0)))
    rp = flatten_with_paths(r_build_model(r_smoke_config(R_ARCHS[arch]),
                                          RMI1).init(jax.random.key(0)))
    for k in F32_LEAVES:
        assert p[k].dtype == torch.float32 and rp[k].dtype == jnp.float32
    np.testing.assert_array_max_ulp(p["blocks/A_log"].detach().numpy(),
                                    np.asarray(rp["blocks/A_log"]), 8)
    assert torch.equal(p["blocks/dt_bias"],
                       torch.full((cfg.n_layers, cfg.ssm_heads), 0.5))
    for k in ("blocks/D", "blocks/ln", "blocks/norm", "final_norm"):
        assert torch.equal(p[k], torch.ones_like(p[k])), k
        np.testing.assert_array_equal(_np(p[k]), _np(rp[k]))
    L2 = cfg.n_layers
    stds = {"blocks/w_out": 0.02 / (2 * L2) ** 0.5, "blocks/w_x": 0.02,
            "emb": 0.02}
    if isinstance(model, HybridLM):
        stds["shared/w_down"] = 0.02 / (2 * model.n_seg) ** 0.5
        stds["shared/w_gate"] = 0.02
    for k, want in stds.items():
        got = float(p[k].detach().float().std())
        assert abs(got - want) < 0.15 * want, (k, got, want)
    again = build_model(cfg, MI1, device="cpu")
    again.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


@functools.lru_cache(maxsize=None)
def _ref_init_f32(arch):
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    return jax.jit(r_build_model(rcfg, RMI1).init)(jax.random.key(0))


def _cast(tree, dtype):
    """The reference's float32 init as its ``dtype`` init is: the random
    leaves cast, A_log / dt_bias kept float32."""
    flat = flatten_with_paths(tree)
    out = jax.tree.map(lambda x: x.astype(dtype), tree)
    for k in F32_LEAVES:
        a, b = k.split("/")
        out[a][b] = flat[k]
    return out


def _smoke_pair(arch, dtype="float32"):
    """The reference's smoke model and its init in ``dtype``, and the
    port's model holding the same weights."""
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype=dtype)
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]), dtype=dtype)
    rmodel = r_build_model(rcfg, RMI1)
    rparams = _cast(_ref_init_f32(arch), dtype)
    model = build_model(cfg, MI1, device="cpu")
    params_from_numpy(model, jax.tree.map(np.asarray, rparams))
    return cfg, rmodel, rparams, model


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_params_cross_both_ways_bit_for_bit(arch):
    """bfloat16 leaves and the float32 A_log / dt_bias round-trip in bits
    (a float32 leaf cast to bfloat16 on the way would not)."""
    cfg, rmodel, rparams, model = _smoke_pair(arch, "bfloat16")
    tree = model.param_tree()
    for k in F32_LEAVES:
        assert flatten_with_paths(tree)[k].dtype == torch.float32
    back = flatten_with_paths(params_to_numpy(model))
    ref = flatten_with_paths(jax.tree.map(
        lambda x: np.asarray(x, np.float32), rparams))
    assert sorted(back) == sorted(ref)
    assert len(ref) == (17 if cfg.family == "ssm" else 17 + 9)
    for k, v in ref.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # and once more through the port
    again = build_model(cfg, MI1, device="cpu")
    params_from_numpy(again, params_to_numpy(model))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


# ---------------------------------------------------------------------------
# The models: prefill, decode, loss and gradients against the reference
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _close_logits(got, ref, vocab, rel=1e-5, msg=""):
    got, ref = _np(got), _np(ref)
    scale = np.abs(ref[..., :vocab]).max()
    err = np.abs(got[..., :vocab] - ref[..., :vocab]).max()
    assert err <= rel * scale, (msg, err, scale)
    np.testing.assert_array_equal(got[..., vocab:], ref[..., vocab:])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill 16 tokens (one chunk), grow the cache each package's way
    (the reference's ``_pad_cache`` is right at this length), then 3
    decode steps."""
    cfg, rmodel, rparams, model = _smoke_pair(arch)
    params = model.param_tree()
    B, S0, K = 2, 16, 3
    toks = _tokens(cfg, B, S0 + K)
    rlogits, rcache = jax.jit(rmodel.prefill)(
        rparams, {"tokens": jnp.asarray(toks[:, :S0])})
    logits, cache = model.prefill(params, {"tokens": _t(toks[:, :S0])})
    _close_logits(logits, rlogits, cfg.vocab, msg="prefill")
    rflat, flat = flatten_with_paths(rcache), flatten_with_paths(cache)
    assert sorted(flat) == sorted(rflat)
    for k, v in rflat.items():
        assert tuple(flat[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(_np(flat[k]), _np(v), err_msg=k, **F32)
    cur = serve_mod.prefill_length(cache, S0)
    assert cur == S0
    rcache = r_pad_cache(rmodel, rcache, B, S0, S0 + K)
    cache = serve_mod.pad_cache(cache, K)
    rdecode = jax.jit(rmodel.decode)
    for t in range(K):
        tok = toks[:, S0 + t][:, None]
        pos = np.full((B,), cur + t, np.int32)
        rlogits, rcache = rdecode(rparams, {"token": jnp.asarray(tok),
                                            "pos": jnp.asarray(pos)}, rcache)
        logits, cache = model.decode(params, {"token": _t(tok),
                                              "pos": _t(pos)}, cache)
        _close_logits(logits, rlogits, cfg.vocab, msg=f"decode {t}")
    rflat, flat = flatten_with_paths(rcache), flatten_with_paths(cache)
    for k, v in rflat.items():
        np.testing.assert_allclose(_np(flat[k]), _np(v), err_msg=k, **F32)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_streamed_decode_matches_prefill(arch):
    """The reference's decode-equivalence test (its mamba2 / zamba2 cases)
    on the port: prefill 12 tokens, stream 4 teacher-forced steps, each
    step's logits equal to a prefill of the longer sequence (2e-4)."""
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    model = build_model(cfg, MI1, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, S0, K = 2, 12, 4
    toks = _tokens(cfg, B, S0 + K, seed=2)
    logits, cache = model.prefill(params, {"tokens": _t(toks[:, :S0])})
    cur = serve_mod.prefill_length(cache, S0)
    cache = serve_mod.pad_cache(cache, K)
    stream = [logits]
    for t in range(K - 1):
        logits, cache = model.decode(
            params, {"token": _t(toks[:, S0 + t][:, None]),
                     "pos": torch.full((B,), cur + t, dtype=torch.int32)},
            cache)
        stream.append(logits)
    for t in range(K):
        ref, _ = model.prefill(params, {"tokens": _t(toks[:, :S0 + t])})
        np.testing.assert_allclose(
            _np(stream[t]), _np(ref), rtol=2e-4, atol=2e-4,
            err_msg=f"{arch}: step {t} logits diverge from prefill oracle")


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype,loss_rtol,grad_rel", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 2e-5, 5e-2)])
def test_loss_and_every_gradient_match_the_reference(arch, dtype, loss_rtol,
                                                     grad_rel):
    """32 tokens: two chunks of the smoke config's 16."""
    cfg, rmodel, rparams, model = _smoke_pair(arch, dtype)
    S = 32
    toks = _tokens(cfg, 2, S + 1, seed=3)
    rb = {"tokens": jnp.asarray(toks[:, :S]),
          "labels": jnp.asarray(toks[:, 1:])}
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss(p, rb), has_aux=True))(rparams)
    params = model.param_tree()
    loss, met = model.loss(params, {"tokens": _t(toks[:, :S]),
                                    "labels": _t(toks[:, 1:])})
    flat = flatten_with_paths(params)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=loss_rtol)
    assert sorted(met) == sorted(rmet)
    assert int(met["tokens"]) == int(rmet["tokens"]) == 2 * S
    rflat = flatten_with_paths(jax.tree.map(
        lambda g: np.asarray(g, np.float32), rgrads))
    assert sorted(rflat) == sorted(flat)
    for path, g in zip(flat, grads):
        assert g.dtype == flat[path].dtype
        ref = rflat[path]
        err = np.abs(_np(g) - ref).max()
        assert err <= grad_rel * np.abs(ref).max(), (path, err)


def test_hybrid_duplicated_kv_gradients_are_synced_under_shared():
    """The hybrid's duplicated KV heads sit under ``shared/``: the sync
    finds each path and makes the copies equal, as the reference's."""
    from repro.optim import sync_duplicated_grads as r_sync
    cfg, rmodel, rparams, model = _smoke_pair("zamba2-2.7b")
    dup = model.kv_duplication()
    assert dup == rmodel.kv_duplication() and dup
    assert all(p.startswith("shared/") for p in dup)
    rng = np.random.default_rng(9)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in flatten_with_paths(model.param_tree()).items()}
    nested = {}
    for k, v in grads.items():
        node = nested
        *heads, last = k.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    assert set(dup) <= set(grads)
    out = flatten_with_paths(sync_duplicated_grads(
        jax.tree.map(_t, nested), dup, cfg.hd))
    ref = flatten_with_paths(r_sync(jax.tree.map(jnp.asarray, nested), dup,
                                    cfg.hd))
    for k in grads:
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for k in dup:
        assert not np.array_equal(_np(out[k]), grads[k]), k


# ---------------------------------------------------------------------------
# Training with the LP clip against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_run(arch, steps):
    """The reference's LP-clipped ``make_train_step`` on a 1x1 CPU mesh
    (Auto axes: see ``tests/test_torch_train.py``), float32: its initial
    parameters and, per step, loss, lp_s1 and the parameters after it."""
    from jax.sharding import AxisType
    cfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                              dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    opt = RAdamW()
    prog = r_steps.make_train_step(cfg, mesh, opt, global_batch=2,
                                   lp_clip=True)
    step = prog.jit()
    params = prog.model.init(jax.random.key(0))
    init = jax.tree.map(np.array, params)
    state = opt.init(params)
    src = RTokenSource(r_for_model(cfg, 32, 2))
    out, extra = [], {}
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in src.global_batch(s).items()}
        params, state, m, extra = step(params, state, batch, extra)
        out.append((float(m["loss"]), float(m["lp_s1"]),
                    jax.tree.map(np.array, params)))
    return init, out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_three_train_steps_with_lp_clip_match_the_reference(arch):
    """Loss and ``lp_s1`` to 1e-4, every parameter entry to atol 2e-6
    but at most 4 in the tree, each of which must have a first gradient
    that is not zero but within 10x of AdamW's ``eps`` (1e-8): there
    ``m / (sqrt(v) + eps)`` turns a rounding difference of the gradient
    into an update difference of up to ``lr`` a step, and they are held
    to that (one entry of zamba2's 261,664 here: ``emb``, gradient
    1.07e-8, 1.4e-5 apart after a step)."""
    init, ref = _reference_run(arch, 3)
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    opt = AdamW()
    prog = make_train_step(cfg, make_host_mesh(1, 1, device="cpu"), opt,
                           global_batch=2, lp_clip=True)
    params = params_from_numpy(prog.model, init)
    state = opt.init(params)
    src = TokenSource(for_model(cfg, 32, 2))
    tiny = None
    for s, (rloss, rs1, rp) in enumerate(ref):
        batch = {k: torch.as_tensor(v)
                 for k, v in src.global_batch(s).items()}
        params, state, m, _ = prog.step(params, state, batch, {})
        if tiny is None:   # the first step's m is (1 - b1) g
            g = {k: np.abs(_np(v)) / (1 - opt.b1)
                 for k, v in flatten_with_paths(state.m).items()}
            tiny = {k: (v > 0) & (v < 10 * opt.eps) for k, v in g.items()}
        np.testing.assert_allclose(float(m["loss"]), rloss, rtol=1e-4)
        np.testing.assert_allclose(float(m["lp_s1"]), rs1, rtol=1e-4,
                                   atol=1e-4)
        mine = flatten_with_paths(params_to_numpy(params))
        theirs = flatten_with_paths(rp)
        assert sorted(mine) == sorted(theirs)
        n_off = 0
        for k, v in theirs.items():
            err = np.abs(mine[k] - v)
            off = err > 2e-6
            n_off += int(off.sum())
            assert tiny[k][off].all(), (s, k, err.max())
            assert err.max() <= opt.lr * (s + 1), (s, k)
        assert n_off <= 4, (s, n_off)
    if arch == "zamba2-2.7b":
        assert ref[0][1] < 0.999, "the trust region should bind at step 0"


# ---------------------------------------------------------------------------
# Serving: the cache helpers, the loop, the reference's padding fault
# ---------------------------------------------------------------------------

def test_pad_cache_grows_only_attention_sequence_axes_by_name():
    """An SSM cache passes through untouched (same tensors); the hybrid's
    ``attn.k``/``attn.v`` grow by their own prefill length and its SSM
    half and positions stay."""
    cfg = smoke_config(ARCHS["mamba2-1.3b"])
    model = build_model(cfg, MI1, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, cache = model.prefill(params, {"tokens": _t(_tokens(cfg, 2, 8))})
    grown = serve_mod.pad_cache(cache, 5)
    assert sorted(grown) == sorted(cache)
    assert all(grown[k] is cache[k] for k in cache)
    assert serve_mod.prefill_length(cache, 8) == 8
    cfg = smoke_config(ARCHS["zamba2-2.7b"])
    model = build_model(cfg, MI1, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, cache = model.prefill(params, {"tokens": _t(_tokens(cfg, 2, 8))})
    grown = serve_mod.pad_cache(cache, 5)
    assert all(grown["ssm"][k] is cache["ssm"][k] for k in cache["ssm"])
    assert grown["attn"]["pos"] is cache["attn"]["pos"]
    for k in ("k", "v"):
        assert grown["attn"][k].shape[2] == 8 + 5
        assert torch.equal(grown["attn"][k][:, :, :8], cache["attn"][k])
        assert not grown["attn"][k][:, :, 8:].any()
    assert serve_mod.prefill_length(cache, 8) == 8
    assert serve_mod.cache_bytes(grown) == sum(
        t.numel() * t.element_size()
        for t in flatten_with_paths(grown).values())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_writes_the_cache_in_place(arch):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    mesh = make_host_mesh(1, 1, device="cpu")
    pre = make_prefill_step(cfg, mesh, global_batch=2)
    dec = make_decode_step(cfg, mesh, global_batch=2, model=pre.model)
    assert isinstance(pre.model, SSMLM)
    params = pre.model.init(torch.Generator().manual_seed(0))
    logits, cache = pre.jit()(params, {"tokens": _t(_tokens(cfg, 2, 8))})
    cache = serve_mod.pad_cache(cache, 3)
    before = flatten_with_paths(cache)
    kept = {k: v.clone() for k, v in before.items()}
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _, new = dec.jit()(params, {"token": tok,
                                "pos": torch.full((2,), 8,
                                                  dtype=torch.int32)}, cache)
    after = flatten_with_paths(new)
    for k, v in before.items():
        assert after[k] is v, k
        if not k.endswith("pos"):
            assert not torch.equal(v, kept[k]), f"{k} was not written"


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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_loop_generates_the_references_tokens(arch):
    """At a prompt of 10 tokens the reference's padding is right (10 is
    neither the smoke config's 8 SSM heads nor its conv window of 3)."""
    cfg, _, rparams, model = _smoke_pair(arch)
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    prompts = serve_mod.make_prompts(cfg.vocab, 6, 3, 10, seed=0)
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
    assert [len(d) for d in run.decode_ms] == [5, 5]


def _first_decode_err(decode, oracle, vocab):
    return float(np.abs(_np(decode)[:, :vocab] - _np(oracle)[:, :vocab]
                        ).max())


def test_reference_serve_pads_ssm_caches_wrongly_and_the_port_does_not():
    """The reference's serve loop grows every cache axis 2 equal to
    ``--prompt-len``.  mamba2's smoke config, float32, B = 2:

    * ``--prompt-len 3`` = the conv window ``K-1``: the windows grow to
      ``3 + gen`` zero-padded rows, the decode step convolves the stale
      window and a zero row instead of the new token, and its first
      decoded logits miss a prefill of the longer sequence by 0.114 (the
      largest |logit| is 0.503) on this input; the port's by 0.0;
    * ``--prompt-len 8`` = the SSM heads: the state's head axis grows to
      ``8 + gen`` and the reference's decode step cannot broadcast it
      against the 8 heads' decays: it raises ``TypeError``.  The port
      decodes (0.0 from the oracle here; held to 1e-6).
    """
    arch, B, gen = "mamba2-1.3b", 2, 2
    cfg, rmodel, rparams, model = _smoke_pair(arch)
    params = model.param_tree()
    assert cfg.ssm_conv - 1 == 3 and cfg.ssm_heads == 8
    errs = {}
    for P in (3, 8):
        toks = _tokens(cfg, B, P, seed=4)
        rlogits, rcache = jax.jit(rmodel.prefill)(
            rparams, {"tokens": jnp.asarray(toks)})
        rtok = np.asarray(jnp.argmax(rlogits, -1))[:, None].astype(np.int32)
        rcache = r_pad_cache(rmodel, rcache, B, P, P + gen)
        longer = np.concatenate([toks, rtok], 1)
        oracle, _ = model.prefill(params, {"tokens": _t(longer)})
        step = {"token": jnp.asarray(rtok), "pos": jnp.full((B,), P,
                                                            jnp.int32)}
        if P == 3:
            assert rcache["conv_x"].shape[2] == 3 + gen   # grown
            rdec, _ = jax.jit(rmodel.decode)(rparams, step, rcache)
            errs["reference"] = _first_decode_err(rdec, oracle, cfg.vocab)
        else:
            assert rcache["state"].shape[2] == 8 + gen   # the head axis
            with pytest.raises((TypeError, ValueError)):
                jax.jit(rmodel.decode)(rparams, step, rcache)
        logits, cache = model.prefill(params, {"tokens": _t(toks)})
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        assert np.array_equal(tok.numpy(), rtok)
        cache = serve_mod.pad_cache(cache, gen)
        dec, _ = model.decode(params, {"token": tok, "pos": torch.full(
            (B,), P, dtype=torch.int32)}, cache)
        errs[f"port {P}"] = _first_decode_err(dec, oracle, cfg.vocab)
    assert errs["reference"] > 1e-2, errs
    assert errs["port 3"] <= 1e-6 and errs["port 8"] <= 1e-6, errs


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_main_on_the_cpu(arch, capsys):
    run = serve_mod.main(["--arch", arch, "--smoke", "--requests", "3",
                          "--batch", "2", "--prompt-len", "16", "--gen",
                          "4"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] batch 0: generated (2, 4) tokens; "
                             "sample row: [")
    assert out[2].startswith("[serve] 16 tokens in ")
    cfg = smoke_config(ARCHS[arch])
    assert all(((t >= 0) & (t < cfg.vocab)).all() for t in run.tokens)
    # the SSM cache: float32 state and bf16 conv windows, whatever the
    # prompt; the hybrid's attention cache grows to 16 + 4 slots
    Lr, k1, H, N, P, di = (cfg.n_layers, cfg.ssm_conv - 1, cfg.ssm_heads,
                           cfg.ssm_state, cfg.ssm_head_dim, cfg.d_inner)
    want = Lr * 2 * H * N * P * 4 + Lr * 2 * k1 * (di + 2 * N) * 2
    if cfg.family == "hybrid":
        lay = HybridLM(cfg, MI1, device="meta").lay
        n_seg = cfg.n_layers // cfg.hybrid_period
        want += 2 * n_seg * 2 * 20 * lay.kv_total * cfg.hd * 2 + n_seg * 2 * 4
    assert run.cache_bytes == want
