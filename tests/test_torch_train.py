"""The port's training path (``repro_torch.optim``, ``data``, ``ckpt``,
``launch``) against the JAX reference on the CPU.

Inputs are made with numpy from a seed (or by the reference's own data
pipeline) and handed to both packages.  Tolerances: AdamW and the
duplicated-KV sync to rtol = atol = 1e-6 (float32 elementwise math on the
same inputs); the LP clip's ``lp_s1`` and scaled updates to 1e-4 (the
solver's tolerance) with ``feasible`` equal; three whole float32 train
steps with the LP clip to rtol 1e-4 on the loss and ``lp_s1``, and every
parameter leaf to atol 2e-6 (measured on the CPU: the loss within 3e-7
relative, leaves within 7e-7); tokens and checkpoints bit for bit.

The reference's train step runs on a 1x1 mesh whose axes are ``Auto``:
under jax 0.9 ``make_host_mesh`` builds ``Explicit`` axes, and then the
reference's ``lp_constrain_updates`` cannot ``ravel`` a model-sharded
leaf from the second step on (ROADMAP C).
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import Checkpointer as RCheckpointer
from repro.configs import ARCHS as R_ARCHS
from repro.configs import smoke_config as r_smoke_config
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import TokenSource as RTokenSource
from repro.data.pipeline import for_model as r_for_model
from repro.launch import steps as r_steps
from repro.optim import AdamW as RAdamW
from repro.optim import lp_constrain_updates as r_lp_constrain_updates
from repro.optim import sync_duplicated_grads as r_sync_duplicated_grads
from repro.solver import SolverSpec as RSolverSpec
from repro.solver import get_solver as r_get_solver
from repro.core.lp import make_batch as r_make_batch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import (DataConfig, TokenSource, data_stream,
                                       for_model)
from repro_torch.launch.elastic import Heartbeat, StragglerMonitor, Supervisor
from repro_torch.launch.mesh import (batch_axes, make_host_mesh,
                                     make_production_mesh, mesh_info)
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.optim import (AdamW, AdamWState, apply_updates,
                               lp_constrain_updates, lp_problems,
                               sync_duplicated_grads)
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map

CPU = torch.device("cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_trees(port, ref, **tol):
    pf, rf = flatten_with_paths(port), flatten_with_paths(ref)
    assert sorted(pf) == sorted(rf)
    for k in pf:
        np.testing.assert_allclose(_np(pf[k]), _np(rf[k]), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# The reference's substrate tests (outside optim/compress), on the port
# ---------------------------------------------------------------------------

def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8, seed=3)
    s1 = TokenSource(cfg)
    s2 = TokenSource(cfg)
    for step in (0, 5, 1000):
        a = s1.global_batch(step)
        b = s2.global_batch(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_data_host_sharding_partitions_global():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=12, seed=1)
    src = TokenSource(cfg)
    g = src.global_batch(7)
    parts = [src.host_batch(7, h, 4) for h in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), g["tokens"])


def test_data_labels_shifted():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2, seed=0)
    b = TokenSource(cfg).global_batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_file_source(tmp_path):
    toks = np.arange(10000, dtype=np.uint32)
    p = tmp_path / "toks.bin"
    toks.tofile(p)
    cfg = DataConfig(vocab=50000, seq_len=8, global_batch=2,
                     source="file", path=str(p))
    b0 = TokenSource(cfg).global_batch(0)
    assert b0["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(b0["tokens"][0, :3], [0, 1, 2])


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.zeros((2,), dtype=torch.int32)}}


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def test_ckpt_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(5, tree, extra={"next_step": 5}, blocking=True)
    out, extra = ck.load(_meta(tree))
    assert extra["next_step"] == 5
    for k, a, b in (("a", tree["a"], out["a"]),
                    ("c", tree["b"]["c"], out["b"]["c"]),
                    ("d", tree["b"]["d"], out["b"]["d"])):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert a.dtype == b.dtype, k


def test_ckpt_latest_pointer_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(), blocking=True)
    assert ck.latest_step() == 4
    dirs = sorted(p.name for p in tmp_path.glob("step_*"))
    assert dirs == ["step_00000003", "step_00000004"]


def test_ckpt_crash_safety(tmp_path):
    """A stale .tmp dir from a crashed save must not break the next one."""
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree(), blocking=True)
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "junk.npy").write_bytes(b"xx")
    ck.save(2, _tree(), blocking=True)
    assert ck.latest_step() == 2
    out, _ = ck.load(_meta(_tree()))
    assert out["a"].shape == (2, 3)


def test_ckpt_async(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(7, _tree(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 7


def test_ckpt_namedtuple_state(tmp_path):
    opt = AdamW()
    params = {"w": torch.ones((3, 3))}
    state = opt.init(params)
    ck = Checkpointer(tmp_path)
    ck.save(1, (params, state), blocking=True)
    (p2, s2), _ = ck.load((params, state))
    assert type(s2).__name__ == "AdamWState"
    np.testing.assert_array_equal(_np(s2.m["w"]), _np(state.m["w"]))
    assert s2.step.shape == () and s2.step.dtype == torch.int32


def test_adamw_reduces_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
    assert float(params["w"].abs().max()) < 1e-2


def test_sync_duplicated_grads():
    hd = 4
    g = {"blocks": {"wk": torch.arange(2 * 3 * 16, dtype=torch.float32)
                    .reshape(2, 3, 16)}}
    out = sync_duplicated_grads(g, {"blocks/wk": 2}, hd)
    w = out["blocks"]["wk"].numpy().reshape(2, 3, 2, 2, hd)
    np.testing.assert_allclose(w[..., 0, :], w[..., 1, :])
    # averaging preserves the mean
    np.testing.assert_allclose(out["blocks"]["wk"].numpy().sum(),
                               g["blocks"]["wk"].numpy().sum(), rtol=1e-6)


def test_lp_constrained_updates_shrink_when_binding():
    """Huge proposed update vs tiny params -> trust region must bind and
    scale the update down (s1 < 1)."""
    params = {"w": torch.ones((8,)) * 1e-3}
    updates = {"w": torch.ones((8,)) * 10.0}
    grads = {"w": -torch.ones((8,))}
    momenta = {"w": torch.zeros((8,))}
    new, s1 = lp_constrain_updates(updates, grads, momenta, params,
                                   delta=0.05)
    assert float(s1) < 0.05
    assert float(new["w"].abs().max()) < 1.0


def test_lp_constrained_updates_identity_when_safe():
    params = {"w": torch.ones((8,)) * 100.0}
    updates = {"w": -torch.ones((8,)) * 1e-3}
    grads = {"w": torch.ones((8,))}
    momenta = {"w": torch.ones((8,)) * 1e-6}
    new, s1 = lp_constrain_updates(updates, grads, momenta, params)
    assert float(s1) > 0.99
    np.testing.assert_allclose(new["w"].numpy(), updates["w"].numpy(),
                               rtol=0.15)


def test_heartbeat(tmp_path):
    hb = Heartbeat(tmp_path / "hb.json")
    assert hb.age() == float("inf")
    hb.beat(12)
    assert hb.age() < 5
    assert hb.read()["step"] == 12


def test_straggler_monitor():
    m = StragglerMonitor(threshold=3.0)
    for i in range(20):
        assert not m.record(i, 0.1)
    assert m.record(20, 1.0)  # 10x median
    assert m.flagged == [20]
    assert not m.record(21, 0.12)


def test_supervisor_restarts(tmp_path):
    """A trainer that crashes once, then succeeds — supervisor must restart
    it and return 0."""
    marker = tmp_path / "crashed_once"
    hb = tmp_path / "hb.json"
    code = (
        "import json,sys,time,os\n"
        f"m = {str(marker)!r}\n"
        f"hb = {str(hb)!r}\n"
        "open(hb,'w').write(json.dumps({'step':0,'t':time.time()}))\n"
        "if not os.path.exists(m):\n"
        "    open(m,'w').write('x'); sys.exit(3)\n"
        "sys.exit(0)\n")
    sup = Supervisor([sys.executable, "-c", code], hb,
                     stall_timeout=60, max_restarts=3, poll=0.1)
    assert sup.run() == 0
    assert sup.restarts == 1


# ---------------------------------------------------------------------------
# Data: the port's tokens are the reference's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "paligemma-3b",
                                  "whisper-base"])
def test_tokens_equal_the_references_bit_for_bit(arch, tmp_path):
    seq = ARCHS[arch].n_prefix + 40   # paligemma: a patch prefix first
    dcfg = for_model(ARCHS[arch], seq, 4, seed=11)
    rcfg = r_for_model(R_ARCHS[arch], seq, 4, seed=11)
    assert dataclasses.astuple(dcfg) == dataclasses.astuple(rcfg)
    mine, ref = TokenSource(dcfg), RTokenSource(rcfg)
    for step in (0, 1, 37):
        a, b = mine.global_batch(step), ref.global_batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    it = data_stream(dcfg, start_step=3, host_id=1, n_hosts=2)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  ref.host_batch(3, 1, 2)["tokens"])
    p = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 2**32, 5000,
                                      dtype=np.uint32).tofile(p)
    f = DataConfig(vocab=1000, seq_len=16, global_batch=3, source="file",
                   path=str(p))
    rf = RDataConfig(vocab=1000, seq_len=16, global_batch=3, source="file",
                     path=str(p))
    for step in (0, 9):
        np.testing.assert_array_equal(
            TokenSource(f).global_batch(step)["tokens"],
            RTokenSource(rf).global_batch(step)["tokens"])


# ---------------------------------------------------------------------------
# Optimizer and LP clip against the reference
# ---------------------------------------------------------------------------

def _trees(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def leaf(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(dtype)
    params = {"w": leaf(6, 8, scale=0.1), "b": leaf(8, scale=0.01),
              "blocks": {"wk": leaf(2, 8, 16, scale=0.1),
                         "ln": leaf(2, 8) + 1.0}}
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01
                                    ).astype(dtype), params)
    return params, grads


def test_adamw_update_matches_the_reference_over_three_steps():
    params, grads = _trees()
    opt, ropt = AdamW(lr=1e-2, grad_clip=0.05), RAdamW(lr=1e-2,
                                                      grad_clip=0.05)
    p, rp = _to_torch(params), jax.tree.map(jnp.asarray, params)
    st, rst = opt.init(p), ropt.init(rp)
    for i in range(3):
        g = jax.tree.map(lambda x: x * (i + 1), grads)
        upd, st = opt.update(_to_torch(g), st, p)
        rupd, rst = ropt.update(jax.tree.map(jnp.asarray, g), rst, rp)
        _close_trees(upd, rupd, rtol=1e-6, atol=1e-9)
        _close_trees(st.m, rst.m, rtol=1e-6, atol=1e-12)
        _close_trees(st.v, rst.v, rtol=1e-6, atol=1e-15)
        assert int(st.step) == int(rst.step) == i + 1
        assert st.step.dtype == torch.int32
        p = apply_updates(p, upd)
        rp = jax.tree.map(lambda a, u: (a.astype(jnp.float32) + u
                                        ).astype(a.dtype), rp, rupd)
        _close_trees(p, rp, rtol=1e-6, atol=1e-8)


def test_sync_duplicated_grads_matches_the_reference():
    _, grads = _trees(3)
    dup = {"blocks/wk": 2, "missing/path": 4}
    out = sync_duplicated_grads(_to_torch(grads), dup, 4)
    ref = r_sync_duplicated_grads(jax.tree.map(jnp.asarray, grads), dup, 4)
    _close_trees(out, ref, rtol=1e-6, atol=1e-9)
    assert sync_duplicated_grads(grads, {}, 4) is grads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lp_clip_matches_the_reference_leaf_by_leaf(seed):
    """Leaves whose trust region binds to different degrees: each leaf's
    scaled update, hence LP ``i`` <-> leaf ``i``, equals the
    reference's."""
    params, grads = _trees(seed)
    rng = np.random.default_rng(100 + seed)
    updates = jax.tree.map(lambda p: (rng.standard_normal(p.shape)
                                      * rng.uniform(1e-3, 0.2)
                                      ).astype(np.float32), params)
    momenta = jax.tree.map(lambda p: rng.standard_normal(p.shape
                                                         ).astype(np.float32),
                           params)
    new, s1 = lp_constrain_updates(*map(_to_torch, (updates, grads,
                                                    momenta, params)))
    rnew, rs1 = r_lp_constrain_updates(
        *(jax.tree.map(jnp.asarray, t) for t in (updates, grads, momenta,
                                                  params)))
    np.testing.assert_allclose(float(s1), float(rs1), rtol=1e-4, atol=1e-4)
    assert float(s1) < 0.999     # some trust region binds
    _close_trees(new, rnew, rtol=1e-4, atol=1e-6)
    # The batch itself, solved by both packages' solvers: feasible equal.
    A, b, c = lp_problems(*map(_to_torch, (updates, grads, momenta,
                                           params)))
    assert A.shape == (4, 6, 2) and b.shape == (4, 6) and c.shape == (4, 2)
    ref = r_get_solver(RSolverSpec(backend="rgb", M=10.0))(
        r_make_batch(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()),
                     jnp.asarray(c.numpy())))
    for method in ("rgb", "kernel"):   # "kernel": its plain version here
        from repro_torch.core.lp import make_batch
        from repro_torch.solver import SolverSpec, get_solver
        sol = get_solver(SolverSpec(backend=method, M=10.0),
                         device="cpu")(make_batch(A, b, c))
        np.testing.assert_array_equal(sol.feasible.numpy(),
                                      np.asarray(ref.feasible))
        np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x),
                                   rtol=1e-4, atol=1e-4)


def test_lp_problem_i_is_leaf_i_in_sorted_key_order():
    params, grads = _trees(5)
    updates = jax.tree.map(lambda g: -g, grads)
    A, b, _ = lp_problems(*map(_to_torch, (updates, grads, grads, params)))
    for i, (k, u) in enumerate(sorted(flatten_with_paths(updates).items())):
        np.testing.assert_allclose(float(A[i, 0, 0]), np.linalg.norm(u),
                                   rtol=1e-5)
        pn = np.linalg.norm(flatten_with_paths(params)[k])
        np.testing.assert_allclose(float(b[i, 0]), 0.05 * (pn + 1e-3),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# Whole train steps against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_run(arch, steps, lp_clip):
    """The reference's ``make_train_step`` on a 1x1 CPU mesh (Auto axes),
    float32: its initial parameters and, per step, loss, lp_s1 and the
    parameters after the step (numpy)."""
    from jax.sharding import AxisType
    cfg = dataclasses.replace(r_smoke_config(R_ARCHS[arch]),
                              dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    opt = RAdamW()
    prog = r_steps.make_train_step(cfg, mesh, opt, global_batch=2,
                                   lp_clip=lp_clip)
    step = prog.jit()
    params = prog.model.init(jax.random.key(0))
    # copies: the step donates its inputs, and on the CPU np.asarray may
    # alias the donated buffer
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


def _port_run(arch, steps, lp_clip, init, device=CPU):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    opt = AdamW()
    prog = make_train_step(cfg, make_host_mesh(1, 1, device=device), opt,
                           global_batch=2, lp_clip=lp_clip)
    step = prog.jit()
    params = params_from_numpy(prog.model, init)
    state = opt.init(params)
    src = TokenSource(for_model(cfg, 32, 2))
    out, extra = [], {}
    for s in range(steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in src.global_batch(s).items()}
        params, state, m, extra = step(params, state, batch, extra)
        out.append((float(m["loss"]), float(m["lp_s1"]),
                    params_to_numpy(params)))
    return out


def test_three_train_steps_with_lp_clip_match_the_reference():
    init, ref = _reference_run("qwen2-0.5b", 3, True)
    mine = _port_run("qwen2-0.5b", 3, True, init)
    assert ref[0][1] < 0.999, "the trust region should bind at step 0"
    for (loss, s1, p), (rloss, rs1, rp) in zip(mine, ref):
        np.testing.assert_allclose(loss, rloss, rtol=1e-4)
        np.testing.assert_allclose(s1, rs1, rtol=1e-4, atol=1e-4)
        _close_trees(p, rp, rtol=0, atol=2e-6)


def test_train_step_without_lp_clip_reports_s1_one():
    init, ref = _reference_run("qwen2-0.5b", 3, True)
    mine = _port_run("qwen2-0.5b", 1, False, init)
    assert mine[0][1] == 1.0
    np.testing.assert_allclose(mine[0][0], ref[0][0], rtol=1e-4)


def test_one_card_mesh_and_what_needs_more_cards():
    mesh = make_host_mesh(1, 1, device="cpu")
    mi = mesh_info(mesh)
    assert (mi.model_size, mi.data_size, mi.data_axes) == (1, 1, ("data",))
    assert batch_axes(mesh, 7) == ("data",)
    for bad in ((2, 1), (1, 2)):
        with pytest.raises(NotImplementedError, match="A9"):
            make_host_mesh(*bad, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        make_production_mesh(multi_pod=True)
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    prog = make_train_step(cfg, mesh, global_batch=2)
    assert prog.jit() is prog.step
    for kw in ({"manual_comm": True}, {"compress_pod": True}):
        with pytest.raises(NotImplementedError, match="A9"):
            make_train_step(cfg, mesh, global_batch=2, **kw)


# ---------------------------------------------------------------------------
# Checkpoints cross between the packages
# ---------------------------------------------------------------------------

def _mixed_state():
    """Parameters with a bfloat16 leaf and an AdamWState, from numpy."""
    params = {"w": torch.from_numpy(
                  np.random.default_rng(0).standard_normal((4, 3))
                  .astype(np.float32)).to(torch.bfloat16),
              "blocks": {"b": torch.arange(5, dtype=torch.float32)}}
    opt = AdamW()
    state = opt.init(params)
    g = {"w": torch.full((4, 3), 0.5, dtype=torch.bfloat16),
         "blocks": {"b": torch.linspace(-1, 1, 5)}}
    _, state = opt.update(g, state, params)
    return params, state


def test_a_checkpoint_written_by_the_port_loads_in_the_reference(tmp_path):
    params, state = _mixed_state()
    Checkpointer(tmp_path).save(3, (params, state), extra={"next_step": 3},
                                blocking=True)
    rlike = (jax.tree.map(lambda t: jax.ShapeDtypeStruct(
                 tuple(t.shape), jnp.dtype(str(t.dtype).removeprefix(
                     "torch."))), params),
             RAdamW().init(jax.tree.map(
                 lambda t: jnp.zeros(tuple(t.shape), jnp.float32), params)))
    (rp, rst), extra = RCheckpointer(tmp_path).load(rlike)
    assert extra == {"next_step": 3}
    assert rp["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(rp["w"]), _np(params["w"]))
    np.testing.assert_array_equal(_np(rp["blocks"]["b"]),
                                  _np(params["blocks"]["b"]))
    assert type(rst).__name__ == "AdamWState" and int(rst.step) == 1
    assert rst.step.shape == () and rst.step.dtype == jnp.int32
    _close_trees(state.m, rst.m, rtol=0, atol=0)
    _close_trees(state.v, rst.v, rtol=0, atol=0)


def test_a_checkpoint_written_by_the_reference_loads_in_the_port(tmp_path):
    params, state = _mixed_state()
    rparams = {"w": jnp.asarray(_np(params["w"])).astype(jnp.bfloat16),
               "blocks": {"b": jnp.asarray(_np(params["blocks"]["b"]))}}
    ropt = RAdamW()
    rstate = ropt.init(rparams)
    _, rstate = ropt.update({"w": jnp.full((4, 3), 0.5, jnp.bfloat16),
                             "blocks": {"b": jnp.linspace(-1, 1, 5)}},
                            rstate, rparams)
    RCheckpointer(tmp_path).save(4, (rparams, rstate),
                                 extra={"next_step": 4}, blocking=True)
    ck = Checkpointer(tmp_path)
    assert ck.latest_step() == 4
    (p, st), extra = ck.load((params, state))
    assert extra == {"next_step": 4}
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], params["w"])
    assert isinstance(st, AdamWState) and st.step.dtype == torch.int32
    assert st.step.shape == () and int(st.step) == 1
    _close_trees(st.m, rstate.m, rtol=0, atol=0)
    _close_trees(st.v, rstate.v, rtol=0, atol=0)


def test_resume_gives_the_parameters_of_a_continuous_run(tmp_path, capsys):
    common = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq",
              "16", "--lp-clip", "--log-every", "1", "--ckpt-every", "2"]
    train_main(common + ["--steps", "4", "--ckpt-dir",
                         str(tmp_path / "a")], device="cpu")
    train_main(common + ["--steps", "2", "--ckpt-dir",
                         str(tmp_path / "b")], device="cpu")
    train_main(common + ["--steps", "4", "--ckpt-dir",
                         str(tmp_path / "b")], device="cpu")
    assert "[train] resumed from step 2" in capsys.readouterr().out
    like = _meta_tree()
    a, _ = Checkpointer(tmp_path / "a").load(like)
    b, _ = Checkpointer(tmp_path / "b").load(like)
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


def _meta_tree():
    """The on-disk layout of (params, AdamWState) for the smoke model."""
    from repro_torch.models import MeshInfo, build_model
    model = build_model(smoke_config(ARCHS["qwen2-0.5b"]), MeshInfo(),
                        device="meta")
    params = model.param_tree()
    f32 = tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
    return (params, AdamWState(step=torch.empty((), dtype=torch.int32,
                                                device="meta"),
                               m=f32, v=f32))


def test_train_loss_decreases():
    """A few steps of real training on the smoke config must reduce loss
    (end-to-end integration across data/optim/model)."""
    loss = train_main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps",
                       "30", "--batch", "8", "--seq", "64",
                       "--log-every", "29"], device="cpu")
    assert loss < 5.2, f"loss {loss} did not decrease from ~5.55 init"


def test_entry_points_need_the_card_unless_told_the_cpu(monkeypatch):
    """No silent CPU fallback: ``build_model``, ``make_host_mesh`` and the
    trainer go to the card unless the caller passes ``device="cpu"``."""
    from repro_torch.models import MeshInfo, build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(ARCHS["qwen2-0.5b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg, MeshInfo())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])
    assert build_model(cfg, MeshInfo(), device="cpu").device == CPU
