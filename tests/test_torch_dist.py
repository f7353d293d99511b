"""The port's multi-rank half (``repro_torch.dist``, ``launch.mesh``,
``launch.steps`` on a mesh, ``optim.compress``, the sharded checkpoint)
on four gloo ranks of the CPU, against the JAX reference on one CPU device
and the port on one.

One world of 4 ranks (``tests/_torch_dist_worker.py``, started once for
the module) runs every case; the tests compare what the ranks wrote.
Inputs are made from numpy seeds and the reference's init.  Tolerances:

* gradients on (1, 4), (2, 2) and (4, 1), gathered whole: within 2e-3 of
  each leaf's largest entry against the reference's single-device
  ``jax.grad`` (the reference's own bar, ``tests/test_distribution.py``)
  and within 1e-4 against the port's one-card gradients, float32 (the
  encoder-decoder's key biases, whose exact gradient is zero, to an
  absolute 1e-9, as ``tests/test_torch_lm_serve.py`` holds them);
* a (2, 2) LP-clipped train step: loss and ``lp_s1`` within 1e-4 of the
  one-card steps, every leaf after step 1 within 1e-4 of its largest
  entry, the LP batch equal in bits on every rank;
* ``manual_comm`` within 1e-3 of the automatic path after 3 steps (the
  reference's bar);
* serving on (1, 4) / (4, 1): every logit within 1e-5 of the largest one
  of the one-card run;
* ``make_lp_step`` on (2, 2): rtol = atol = 1e-5 against the reference
  (its bar), equal in bits to the port's one-rank solve;
* the elastic reshard: equal in bits.
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
from repro.core import normalize_batch, random_feasible_lp, shuffle_batch
from repro.models import MeshInfo as RMeshInfo
from repro.models import build_model as r_build_model
from repro.solver import SolverSpec as RSolverSpec
from repro.solver import get_solver as r_get_solver

import _torch_compat  # noqa: F401  (this worker's torch threads)
import _torch_dist_worker as W
from repro_torch import dist as D
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.core.lp import LPBatch
from repro_torch.core.seidel import solve_naive, solve_rgb
from repro_torch.launch import steps
from repro_torch.launch.mesh import RecordingMesh, make_host_mesh
from repro_torch.models import MeshInfo, build_model
from repro_torch.models.transformer import params_to_numpy
from repro_torch.optim import (AdamW, dequantize_int8, init_error_state,
                               quantize_int8)

RMI1 = RMeshInfo(model_size=1, data_size=1)
B, S = 4, 32

GRAD_ARCHS = {"granite-8b": {"fsdp": True, "fsdp_min_elems": 1},
              "qwen2-0.5b": {}, "mamba2-1.3b": {}, "zamba2-2.7b": {},
              "whisper-base": {}, "paligemma-3b": {}}
# the MoE only on (1, 4): one data shard keeps each expert's capacity (a
# function of the local token count) the one-card capacity
GRAD_CASES = ([(a, s, e) for a, e in GRAD_ARCHS.items() for s in W.MESHES]
              + [("olmoe-1b-7b", (1, 4), {})])
SERVE_CASES = [("qwen2-0.5b", (1, 4), 2), ("olmoe-1b-7b", (1, 4), 2),
               ("mamba2-1.3b", (1, 4), 2), ("qwen2-0.5b", (4, 1), 4)]
TRAIN_ARCHS = ("qwen2-0.5b", "qwen1.5-0.5b")
HOST = make_host_mesh(1, 1, device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    p = jax.jit(r_build_model(rcfg, RMI1).init)(jax.random.key(0))
    return jax.tree.map(np.asarray, p)


def _batch(arch):
    cfg = ARCHS[arch]
    rng = np.random.default_rng([7, len(arch)])
    out = {"tokens": rng.integers(0, 257, (B, S)).astype(np.int32),
           "labels": rng.integers(0, 257, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, 8, 64)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, 16, 64)).astype(np.float32)
    return out


def _serve_inputs(arch, Bs):
    rng = np.random.default_rng([9, Bs, len(arch)])
    return {"prompt": rng.integers(0, 257, (Bs, 16)).astype(np.int32),
            "next": rng.integers(0, 257, (Bs, 4)).astype(np.int32)}


def _lp_arrays():
    lp = shuffle_batch(jax.random.key(5), normalize_batch(
        random_feasible_lp(jax.random.key(0), 64, 24)))
    return {k: np.asarray(getattr(lp, k)) for k in ("A", "b", "c",
                                                    "m_valid")}, lp


def _inputs():
    archs = sorted({a for a, _, _ in GRAD_CASES} | set(TRAIN_ARCHS)
                   | {a for a, _, _ in SERVE_CASES})
    return {"grad_cases": GRAD_CASES, "serve_cases": SERVE_CASES,
            "weights": {a: _ref_init(a) for a in archs},
            "batch": {a: _batch(a) for a in archs},
            "serve": {(a, b): _serve_inputs(a, b) for a, _, b in SERVE_CASES},
            "lp": _lp_arrays()[0]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    inputs = _inputs()
    return inputs, W.run_world("dist", inputs, root), root


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    rcfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                               dtype="float32")
    model = r_build_model(rcfg, RMI1)
    batch = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
    g = jax.jit(jax.grad(lambda p: model.loss(p, batch)[0]))(
        jax.tree.map(jnp.asarray, _ref_init(arch)))
    return jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("arch,shape,extra", GRAD_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _ in GRAD_CASES])
def test_sharded_grads_match_the_reference_and_one_card(world, arch, shape,
                                                        extra):
    inputs, ranks, _ = world
    loss, g = ranks[0][("grad", arch, shape)]
    one_loss, one = W.grads_case({shape: HOST}, inputs, arch, shape, extra)
    ref = _ref_grads(arch)
    np.testing.assert_allclose(loss, one_loss, rtol=1e-5)
    for (path, a), (_, b), (_, r) in zip(_leaves(g), _leaves(one),
                                         _leaves(ref), strict=True):
        assert a.shape == r.shape, path
        if ARCHS[arch].family == "encdec" and path.endswith("bk"):
            # an exact zero (softmax is shift-invariant per query): every
            # side holds rounding noise there
            assert np.abs(a - r).max() <= 1e-9, path
            continue
        assert _rel(r, a) < 2e-3, (path, _rel(r, a))
        assert _rel(b, a) < 1e-4, (path, _rel(b, a))
    # every rank's gathered gradients are the same
    for other in ranks[1:]:
        for (path, a), (_, b) in zip(_leaves(g), _leaves(
                other[("grad", arch, shape)][1])):
            np.testing.assert_array_equal(a, b, err_msg=path)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def test_train_step_on_2x2_reduces_the_loss_and_matches_one_card(world):
    inputs, ranks, _ = world
    mine = ranks[0]["train_lp"]
    one = W.train_case(HOST, inputs, "qwen2-0.5b", 5, lp_clip=True)
    assert mine["loss"][-1] < mine["loss"][0], mine["loss"]
    np.testing.assert_allclose(mine["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(mine["s1"], one["s1"], atol=1e-4)
    assert min(one["s1"]) < 0.999, "the trust region should bind"
    for (path, a), (_, b) in zip(_leaves(mine["params_1"]),
                                 _leaves(one["params_1"]), strict=True):
        assert _rel(b, a) < 1e-4, (path, _rel(b, a))


def test_every_rank_poses_the_same_lp_batch_once_a_step(world):
    _, ranks, _ = world
    first = ranks[0]["train_lp"]
    assert len(first["lp"]) == 5
    for r in ranks[1:]:
        mine = r["train_lp"]
        assert mine["s1"] == first["s1"]
        assert len(mine["lp"]) == 5
        for step_a, step_b in zip(first["lp"], mine["lp"]):
            for a, b in zip(step_a, step_b):
                assert a.tobytes() == b.tobytes()


def test_a_train_step_counts_its_collectives(world):
    counts = world[1][0]["train_counts"]
    # TP reductions, the data-axis gradient sums, the clip's statistics
    assert counts["all_reduce"]["calls"] > 0
    assert counts["all_reduce"]["bytes"] > 0
    # the duplicated KV heads are gathered over the model axis to sync
    assert counts["all_gather"]["calls"] > 0


# ---------------------------------------------------------------------------
# The record transport against the real ranks
# ---------------------------------------------------------------------------

def _meta_batch(arch):
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta") for k, v in _batch(arch).items()}


def _recorded_train(arch, axes, shape, n_steps, extra_cfg=None, **kw):
    """``dist.counts()`` of ``n_steps`` train steps on rank 0 of a
    RecordingMesh, on meta tensors (no weights: counts need none)."""
    mesh = RecordingMesh(axes, shape)
    opt = AdamW(lr=1e-3)
    prog = steps.make_train_step(W.cfg_of(arch, extra_cfg or {}), mesh, opt,
                                 global_batch=B, **kw)
    params = prog.model.param_tree()
    state = opt.init(params)
    extra = ({"err": init_error_state(params)} if kw.get("manual_comm")
             else {})
    batch = _meta_batch(arch)
    D.reset_counts()
    for _ in range(n_steps):
        params, state, _, extra = prog.step(params, state, batch, extra)
    return D.counts()


@pytest.mark.parametrize("case", ["tp_dp_lp_clip", "fsdp_lp_clip",
                                  "pod_compressed", "pod_plain",
                                  "manual_comm"])
def test_recording_mesh_counts_what_the_ranks_issued(world, case):
    """The same steps on rank 0 of a RecordingMesh, on meta: every op's
    calls and bytes equal to what the four gloo ranks counted."""
    real, args = {
        "tp_dp_lp_clip": ("train_lp", ("qwen2-0.5b", ("data", "model"),
                                       (2, 2), 5, None,
                                       {"lp_clip": True})),
        "fsdp_lp_clip": ("train_fsdp", (
            "granite-8b", ("data", "model"), (2, 2), 2,
            {"fsdp": True, "fsdp_min_elems": 1}, {"lp_clip": True})),
        "pod_compressed": (("pod", True), (
            "qwen1.5-0.5b", ("pod", "data", "model"), (2, 2, 1), 3, None,
            {"manual_comm": True, "compress_pod": True})),
        "pod_plain": (("pod", False), (
            "qwen1.5-0.5b", ("pod", "data", "model"), (2, 2, 1), 3, None,
            {"manual_comm": True})),
        "manual_comm": (("manual", True), (
            "qwen1.5-0.5b", ("data", "model"), (2, 2), 3, None,
            {"manual_comm": True})),
    }[case]
    arch, axes, shape, n, extra_cfg, kw = args
    counts = world[1][0][real]["counts"]
    assert counts and all(c["calls"] > 0 for c in counts.values())
    assert _recorded_train(arch, axes, shape, n, extra_cfg, **kw) == counts
    for r in world[1][1:]:  # every rank issues the same collectives
        assert r[real]["counts"] == counts


@pytest.mark.parametrize("arch,shape,Bs", SERVE_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _ in SERVE_CASES])
def test_recording_mesh_counts_what_serving_ranks_issued(world, arch, shape,
                                                         Bs):
    from repro_torch.launch.serve import pad_cache
    real = world[1][0][("serve_counts", arch, shape)]
    mesh = RecordingMesh(("data", "model"), shape)
    cfg = W.cfg_of(arch, {})
    pre = steps.make_prefill_step(cfg, mesh, global_batch=Bs)
    dec = steps.make_decode_step(cfg, mesh, global_batch=Bs,
                                 model=pre.model)
    params = pre.model.param_tree()
    s = _serve_inputs(arch, Bs)
    rec = {}
    D.reset_counts()
    _, cache = pre.step(params, {"tokens": torch.empty(
        s["prompt"].shape, dtype=torch.int32, device="meta")})
    rec["prefill"] = D.counts()
    cache = pad_cache(cache, s["next"].shape[1])
    D.reset_counts()
    for _ in range(s["next"].shape[1]):
        _, cache = dec.step(params, {
            "token": torch.empty((Bs, 1), dtype=torch.int32, device="meta"),
            "pos": torch.empty((Bs,), dtype=torch.int32, device="meta")},
            cache)
    rec["decode"] = D.counts()
    assert rec == real


def test_manual_comm_matches_the_automatic_path(world):
    _, ranks, _ = world
    auto = ranks[0][("manual", False)]["loss"][-1]
    manual = ranks[0][("manual", True)]["loss"][-1]
    assert abs(auto - manual) < 1e-3, (auto, manual)


def test_compress_pod_runs_on_a_pod_mesh_and_its_error_is_bounded(world):
    _, ranks, _ = world
    plain = ranks[0][("pod", False)]
    comp = ranks[0][("pod", True)]
    assert all(np.isfinite(comp["loss"]))
    assert comp["loss"][-1] < comp["loss"][0]
    assert abs(comp["loss"][-1] - plain["loss"][-1]) < 5e-3
    # the carried residual is a rounding error of each leaf's scale
    assert max(comp["err_max"]) > 0
    assert max(comp["err_ratio"]) <= 0.5 + 1e-5, max(comp["err_ratio"])
    assert plain["err_max"] == [0.0] * 3 and not plain["err_ratio"]


def test_compressed_psum_over_pods_feeds_its_error_back(world):
    for r in world[1]:
        c = r["compress"]
        for k, true in c["true"].items():
            # the running sum of compressed means tracks the true mean:
            # what is left is the last residual, a rounding error
            drift = np.abs(c["acc"][k] / c["steps"] - true).max()
            assert drift < 2e-3, (k, drift)
            assert np.isfinite(c["err"][k]).all()
    # every pod gets the same reduced gradient
    for k in world[1][0]["compress"]["first"]:
        np.testing.assert_array_equal(world[1][0]["compress"]["first"][k],
                                      world[1][3]["compress"]["first"][k])


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**30))
def test_int8_quantization_error_bounded(seed):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(128)
                         .astype(np.float32) * 10)
    q, s = quantize_int8(g)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates():
    """With error feedback, the sum of compressed steps converges to the
    sum of true gradients (the reference's law, through quantize_int8)."""
    true = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                            .astype(np.float32))
    e = torch.zeros_like(true)
    acc = torch.zeros_like(true)
    for _ in range(300):
        q, s = quantize_int8(true + e)
        e = (true + e) - dequantize_int8(q, s)
        acc += dequantize_int8(q, s)
    np.testing.assert_allclose((acc / 300).numpy(), true.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# Checkpoints, the LP step, serving
# ---------------------------------------------------------------------------

def test_elastic_reshard_restores_bits_on_other_meshes(world):
    _, ranks, root = world
    out = ranks[0]["reshard"]
    for shape in ((4, 1), (1, 4)):
        for (path, a), (_, b) in zip(_leaves(out["saved"]),
                                     _leaves(out[shape]), strict=True):
            assert a.tobytes() == b.tobytes(), (shape, path)
    # the files are whole leaves: the one-card loader reads them
    cfg = W.cfg_of("granite-8b", {"fsdp": True, "fsdp_min_elems": 1})
    model = build_model(cfg, MeshInfo(), device="cpu")
    loaded, _ = Checkpointer(root / "ckpt").load(model.param_tree())
    for (path, a), (_, b) in zip(_leaves(out["saved"]),
                                 _leaves(params_to_numpy(loaded)),
                                 strict=True):
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("method", ["rgb", "naive"])
def test_make_lp_step_on_2x2_matches_one_rank(world, method):
    _, ranks, _ = world
    out = ranks[0][("lp", method)]
    arrays, rlp = _lp_arrays()
    ref = r_get_solver(RSolverSpec(backend=method, tile=32, chunk=0,
                                   normalize=False)).solve(rlp)
    np.testing.assert_allclose(out["x"], np.asarray(ref.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(out["feasible"], np.asarray(ref.feasible))
    solve = solve_rgb if method == "rgb" else solve_naive
    one = solve(LPBatch(**{k: torch.from_numpy(v)
                           for k, v in arrays.items()}))
    assert out["x"].tobytes() == one.x.numpy().tobytes()
    for r in ranks[1:]:
        assert r[("lp", method)]["x"].tobytes() == out["x"].tobytes()


@pytest.mark.parametrize("arch,shape,Bs", SERVE_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _ in SERVE_CASES])
def test_serving_on_a_mesh_matches_one_card(world, arch, shape, Bs):
    inputs, ranks, _ = world
    mine = ranks[0][("serve", arch, shape)]
    one = W.serve_case(HOST, inputs, arch, Bs)
    assert len(mine) == 5
    vocab = ARCHS[arch].vocab
    for a, b in zip(mine, one, strict=True):
        a, b = a[:, :vocab], b[:, :vocab]
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    for r in ranks[1:]:
        for a, b in zip(mine, r[("serve", arch, shape)]):
            np.testing.assert_array_equal(a, b)


def test_train_entry_point_on_2x2_logs_on_rank_0_and_resumes(world):
    _, ranks, _ = world
    first, again = (ranks[0]["entry_points"][k] for k in ("train_3",
                                                          "train_5"))
    assert first[1].count("[train] step") == 3 and "done" in first[1]
    assert "resumed from step 3" in again[1]
    assert again[1].count("[train] step") == 2
    for r in ranks[1:]:
        ep = r["entry_points"]
        assert ep["train_3"][1] == ep["train_5"][1] == ep["serve"][1] == ""
        assert ep["train_5"][0] == again[0]
    # the same run on one card, its checkpoint resumed the same way
    import contextlib
    import io
    import tempfile

    from repro_torch.launch.train import main as train_main
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "4", "--seq",
                "32", "--lp-clip", "--ckpt-dir", d]
        with contextlib.redirect_stdout(io.StringIO()):
            train_main(argv + ["--steps", "3"], device="cpu")
            one = train_main(argv + ["--steps", "5"], device="cpu")
    np.testing.assert_allclose(again[0], one, rtol=1e-4)


def test_serve_entry_point_on_the_ranks_mesh_matches_one_card(world):
    _, ranks, _ = world
    import contextlib
    import io

    from repro_torch.launch.serve import main as serve_main
    with contextlib.redirect_stdout(io.StringIO()):
        one = serve_main(["--arch", "qwen2-0.5b", "--smoke", "--requests",
                          "8", "--batch", "4", "--prompt-len", "16", "--gen",
                          "4"], device="cpu")
    tokens, log = ranks[0]["entry_points"]["serve"]
    assert "[serve] 32 tokens" in log
    for a, b in zip(tokens, one.tokens, strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Specs and plans: the reference's, at the production mesh's sizes
# ---------------------------------------------------------------------------

def _as_tuples(tree):
    """Specs as tuples, a one-axis entry as its name (``PartitionSpec``
    normalises ``("data",)`` to ``"data"``)."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tree)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_plans_are_the_references(arch, multi_pod):
    axes = ("pod", "data") if multi_pod else ("data",)
    size = 32 if multi_pod else 16
    rm = r_build_model(R_ARCHS[arch], RMeshInfo(
        model_size=16, data_axes=axes, data_size=size, bound=True))
    pm = build_model(ARCHS[arch], MeshInfo(
        model_size=16, data_axes=axes, data_size=size, bound=True),
        device="meta")
    assert _as_tuples(rm.full_param_specs()) == _as_tuples(
        pm.full_param_specs())
    assert _as_tuples(rm.param_specs()) == _as_tuples(pm.param_specs())
    for bax in (axes, None):
        assert _as_tuples(rm.cache_specs(bax)) == _as_tuples(
            pm.cache_specs(bax))
    plans = [n for n in ("block_plan", "top_plan", "enc_plan", "dec_plan",
                         "shared_plan") if hasattr(rm, n)]
    for name in plans:
        assert getattr(rm, name)() == getattr(pm, name)(), name
