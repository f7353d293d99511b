"""The slice as a whole: the port's ``SolverSpec``/``Solver`` front end against
the reference's on the same numpy arrays, both on the CPU.

Inputs are made by the reference's generators and handed to both sides with
``shuffle=False`` (a ``jax.random`` stream cannot be reproduced by torch).
Tolerances are the reference's own kernel-test tolerances (``feasible``
exactly, ``x`` 1e-4, ``objective`` 2e-4 in float32): FMA contraction and
reduction order differ between XLA's fused CPU code and eager torch ops, the
algorithm does not.  Inside the port, packed-vs-AoS solves are bit-identical.
"""
import dataclasses
import pathlib
import re

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core as rc
import repro.solver as rs
import repro_torch.core as tc
import repro_torch.solver as ts
from repro_torch.device import (as_device, card_info, default_device,
                                default_devices)
from repro_torch.kernels.batch_lp import (DEFAULT_TILE, finish_cuda,
                                          prep_cuda, rgb_cuda)
from repro_torch.tune import (TableEntry, TableKey, TuningTable,
                              active_table, bucket_pow2, default_table,
                              device_platform, normalize_device_kind,
                              use_table)
from _torch_compat import (CPU, assert_solutions_close, to_torch_batch,
                           to_torch_packed)

REPO = pathlib.Path(__file__).resolve().parents[1]


# -- the port stands alone ------------------------------------------------

def test_port_imports_neither_jax_nor_the_reference():
    """No file of the port (nor ``chip_smoke.py``, nor the port's examples)
    imports ``jax`` or the ``repro`` package — not even a JAX-free module
    of it."""
    pat = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
        r"|from\s+repro(\s|\.))", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "tune_table.py"]
    files += sorted((REPO / "examples").glob("*_torch.py"))
    assert len(files) > 20
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert hits == []
    # the pattern itself catches what it should and spares the port
    for bad in ("import jax", "from jax import numpy", "import repro",
                "from repro import core", "from repro.core import lp",
                "    import jax.numpy as jnp"):
        assert pat.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import lp",
               "# import jaxtyping", "import jaxlib_like"):
        assert not pat.search(ok), ok


def test_default_device_raises_without_a_card():
    """No silent CPU fallback: every entry point that is not told
    ``device="cpu"`` needs the card."""
    assert as_device("cpu") == CPU
    assert as_device("cuda") == torch.device("cuda", 0)
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda", 0)
        assert default_devices()[0] == default_device()
        return
    for entry in (default_device, default_devices,
                  lambda: as_device(None),
                  lambda: ts.SolverSpec(backend="rgb").build(),
                  lambda: ts.get_solver(ts.SolverSpec(backend="rgb")),
                  lambda: tc.infeasible_lp(2, 4),
                  lambda: tc.random_feasible_lp(torch.Generator(), 2, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert card_info() is None or isinstance(card_info(), str)


# -- SolverSpec: field for field -------------------------------------------

def test_spec_fields_match_reference():
    names = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert names(ts.SolverSpec) == names(rs.SolverSpec)
    for kw in (dict(), dict(backend="rgb", tile=8, chunk=64, seed=3,
                            shuffle=True),
               dict(backend="kernel", interpret=True, M=5e3,
                    normalize=False),
               dict(backend="pdhg", iter_block=32, restart_period=0,
                    tol=1e-6, max_iters=500)):
        ref, port = rs.SolverSpec(**kw), ts.SolverSpec(**kw)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        # asdict of one builds the other
        assert ts.SolverSpec(**dataclasses.asdict(ref)) == port
        assert rs.SolverSpec(**dataclasses.asdict(port)) == ref


@pytest.mark.parametrize("kw", [
    dict(backend="bogus"), dict(tile=0), dict(tile=2.5), dict(chunk=-1),
    dict(M=0.0), dict(M=-5.0), dict(dtype="int32"), dict(seed="zero"),
    dict(backend="rgb", tol=1e-6), dict(backend="auto", iter_block=64),
    dict(backend="kernel", restart_period=512, max_iters=100),
    dict(backend="pdhg", iter_block=0), dict(backend="pdhg",
                                             restart_period=-1),
    dict(backend="pdhg", tol=0.0), dict(backend="pdhg", max_iters=0),
])
def test_spec_validation_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref:
        rs.SolverSpec(**kw)
    with pytest.raises(ValueError) as port:
        ts.SolverSpec(**kw)
    assert str(port.value) == str(ref.value)


def test_spec_hashable_value_semantics():
    a = ts.SolverSpec(backend="rgb", tile=8, chunk=64)
    b = ts.SolverSpec(backend="rgb", tile=8, chunk=64)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != ts.SolverSpec(backend="rgb", tile=16, chunk=64)
    assert ts.SolverSpec(M=10000) == ts.SolverSpec(M=10000.0)
    assert isinstance(ts.SolverSpec(M=10000).M, float)


def test_spec_resolution_per_platform():
    auto = ts.SolverSpec(backend="auto")
    on_card, on_cpu = auto.resolve("cuda"), auto.resolve("cpu")
    assert (on_card.backend, on_card.interpret) == ("kernel", False)
    assert (on_cpu.backend, on_cpu.interpret) == ("rgb", False)
    assert on_card.is_resolved and on_cpu.is_resolved
    k = ts.SolverSpec(backend="kernel")
    assert k.resolve("cpu").interpret is True
    assert k.resolve("cuda").interpret is False
    # interpret=True is the one explicit way to ask for the plain version
    assert ts.SolverSpec(backend="kernel",
                         interpret=True).resolve("cuda").interpret is True
    assert ts.SolverSpec(backend="rgb",
                         interpret=True).resolve("cpu").interpret is False
    assert on_cpu.resolve("cpu") is on_cpu
    with pytest.raises(ValueError, match="platform"):
        auto.resolve("tpu")
    # inert fields canonicalise, unset launch geometry survives
    assert ts.SolverSpec(backend="rgb", seed=5).resolve("cpu") == \
        ts.SolverSpec(backend="rgb").resolve("cpu")
    assert ts.SolverSpec(backend="rgb", seed=5, shuffle=True).resolve(
        "cpu") != ts.SolverSpec(backend="rgb", shuffle=True).resolve("cpu")
    assert k.resolve("cuda").tile is None and k.resolve("cuda").chunk is None
    # the same canonical form as the reference resolves to on its CPU
    ref = rs.SolverSpec(backend="auto").resolve("cpu")
    assert dataclasses.asdict(ref) == dataclasses.asdict(on_cpu)


def test_spec_resolve_for_shape_heuristics_and_table():
    with use_table(TuningTable()):       # table misses: the heuristics
        r = ts.SolverSpec(backend="rgb").resolve_for_shape(21, 9, "cpu")
        assert r.is_shape_resolved and (r.tile, r.chunk) == (32, 0)
        k = ts.SolverSpec(backend="kernel").resolve_for_shape(200, 64,
                                                              "cuda")
        assert (k.tile, k.chunk, k.interpret) == (DEFAULT_TILE, 0, False)
        small = ts.SolverSpec(backend="kernel").resolve_for_shape(200, 3,
                                                                  "cuda")
        assert small.tile == 3
        e = ts.SolverSpec(backend="rgb", tile=8,
                          chunk=64).resolve_for_shape(21, 9, "cpu")
        assert (e.tile, e.chunk) == (8, 64)
        assert r.resolve_for_shape(21, 9, "cpu") is r
        p = ts.SolverSpec(backend="pdhg").resolve_for_shape(21, 9, "cpu")
        q = rs.SolverSpec(backend="pdhg").resolve_for_shape(21, 9, "cpu")
        assert (p.iter_block, p.restart_period) == (q.iter_block,
                                                    q.restart_period)
    entry = TableEntry(TableKey("cpu", "rgb", "float32", m_bucket=32,
                                batch_bucket=16), tile=4, chunk=16,
                       us_per_lp=1.0)
    with use_table(TuningTable([entry])):
        t = ts.SolverSpec(backend="rgb").resolve_for_shape(21, 9, "cpu")
        assert (t.tile, t.chunk) == (4, 16)
        x = ts.SolverSpec(backend="rgb", tile=8).resolve_for_shape(21, 9,
                                                                  "cpu")
        assert (x.tile, x.chunk) == (8, 16)       # explicit beats the table


def test_bundled_table_has_no_rows_and_keys_cards_as_gpu():
    """The bundled table holds rows measured on an NVIDIA card only (none
    for the CPU, no family rows, no heuristic seeds), so on the CPU every
    lookup misses and resolution stays on the heuristics.  (The name is
    the one this check has carried since the first slice, whose bundled
    table had no rows.)"""
    rows = default_table().entries()
    assert rows and all(e.source == "measured" for e in rows)
    assert all(device_platform(e.key.device_kind) == "gpu"
               and e.key.device_kind.startswith("nvidia-") for e in rows)
    for e in rows:
        assert active_table().lookup(
            backend=e.key.backend, dtype=e.key.dtype, m=e.key.m_bucket,
            batch=e.key.batch_bucket or None, device_kind="cpu") is None
    assert normalize_device_kind("NVIDIA H100 80GB HBM3") == \
        "nvidia-h100-80gb-hbm3"
    assert device_platform("NVIDIA H100 80GB HBM3") == "gpu"
    assert device_platform("cpu") == "cpu"
    assert [bucket_pow2(n, 8) for n in (1, 8, 9, 100, 128, 129)] == \
        [8, 8, 16, 128, 128, 256]
    # a family row written for "gpu" answers a lookup for any card's name
    row = TableEntry(TableKey("gpu", "kernel", "float32", m_bucket=256,
                              batch_bucket=0), tile=16, chunk=128,
                     us_per_lp=1.0)
    got = TuningTable([row]).lookup(
        backend="kernel", dtype="float32", m=200, batch=64,
        device_kind="NVIDIA H100 80GB HBM3")
    assert got is not None and (got.tile, got.chunk) == (16, 128)


# -- solves against the reference -------------------------------------------

def _ref_batch(kind):
    return {"feasible": lambda: rc.random_feasible_lp(jax.random.key(1), 24,
                                                      40),
            "ragged": lambda: rc.ragged_feasible_lp(jax.random.key(13), 24,
                                                    40, m_min=2),
            "adversarial": lambda: rc.adversarial_lp(6, 24),
            "infeasible": lambda: rc.infeasible_lp(5, 12)}[kind]()


def _spec_kw(backend):
    return {"naive": dict(backend="naive"),
            "rgb": dict(backend="rgb", tile=8),
            "rgb-chunked": dict(backend="rgb", tile=8, chunk=16),
            "kernel": dict(backend="kernel", tile=8, interpret=True),
            "kernel-chunked": dict(backend="kernel", tile=8, chunk=128,
                                   interpret=True)}[backend]


@pytest.mark.parametrize("backend", ["naive", "rgb", "rgb-chunked", "kernel",
                                     "kernel-chunked"])
@pytest.mark.parametrize("kind", ["feasible", "ragged", "adversarial",
                                  "infeasible"])
def test_solve_matches_reference_on_every_ported_backend(kind, backend):
    """AoS and packed solves of the port against the reference's, and
    packed-vs-AoS bit-identity inside the port."""
    lp = _ref_batch(kind)
    kw = _spec_kw(backend)
    ref = rs.SolverSpec(**kw).build().solve(lp)
    solver = ts.SolverSpec(**kw).build(device="cpu")
    aos = solver.solve(to_torch_batch(lp))
    soa = solver.solve(to_torch_packed(rc.pack(lp)))
    assert_solutions_close(ref, aos)
    assert aos.x.dtype == torch.float32 and aos.feasible.dtype == torch.bool
    assert aos.x.shape == (lp.batch, 2) and aos.feasible.shape == (lp.batch,)
    for f in ("x", "feasible", "objective"):
        assert torch.equal(getattr(aos, f), getattr(soa, f)), f
    if kind == "infeasible":
        assert not aos.feasible.any()
    else:
        assert aos.feasible.all()


def test_solve_one_and_call_agree_with_solve():
    lp = _ref_batch("feasible")
    tlp = to_torch_batch(lp)
    solver = ts.SolverSpec(backend="rgb", tile=8).build(device="cpu")
    sol = solver.solve(tlp)
    same = solver(tlp)
    assert torch.equal(sol.x, same.x)
    one = solver.solve_one(np.asarray(lp.A[2]), np.asarray(lp.b[2]),
                           np.asarray(lp.c[2]))
    assert one.x.shape == (2,) and one.feasible.shape == ()
    np.testing.assert_allclose(one.x.numpy(), sol.x[2].numpy(), rtol=1e-5,
                               atol=1e-5)
    ref_one = rs.SolverSpec(backend="rgb", tile=8).build().solve_one(
        lp.A[2], lp.b[2], lp.c[2])
    np.testing.assert_allclose(one.x.numpy(), np.asarray(ref_one.x),
                               rtol=1e-4, atol=1e-4)
    assert bool(one.feasible) == bool(ref_one.feasible)


def test_auto_on_the_cpu_is_rgb_and_kernel_is_plain_there():
    tlp = to_torch_batch(_ref_batch("ragged"))
    auto = ts.SolverSpec(backend="auto").build(device="cpu")
    assert (auto.spec.backend, auto.device) == ("rgb", CPU)
    rgb = ts.SolverSpec(backend="rgb").build(device="cpu").solve(tlp)
    assert torch.equal(auto.solve(tlp).x, rgb.x)
    # backend="kernel" on CPU tensors runs the plain version: no launch
    kern = ts.SolverSpec(backend="kernel").build(device="cpu")
    assert kern.spec.interpret is True
    n0 = rgb_cuda.launches
    fronts = (prep_cuda.launches, finish_cuda.launches)
    k = kern.solve(tlp)
    assert rgb_cuda.launches == n0
    assert torch.equal(k.feasible, rgb.feasible)
    np.testing.assert_allclose(k.x.numpy(), rgb.x.numpy(), rtol=1e-4,
                               atol=1e-4)
    # ... and so does a kernel spec that resolved for the card but was
    # handed CPU tensors through the pure function (the wrapper, not a
    # fallback: it looks only at where the tensors lie)
    card = ts.SolverSpec(backend="kernel", interpret=False)
    k2 = ts.solve_with_spec(card, tlp)
    assert rgb_cuda.launches == n0 and torch.equal(k2.x, k.x)
    # neither takes the card's fused front end: no prep, no finish
    assert (prep_cuda.launches, finish_cuda.launches) == fronts


@pytest.mark.parametrize("case,fused", [
    (dict(), True),
    (dict(backend="rgb"), False),
    (dict(backend="naive"), False),
    (dict(backend="pdhg"), False),
    (dict(interpret=True), False),
    (dict(device="cpu"), False),
    (dict(device="meta"), False),
    (dict(shuffled=True), False),
    (dict(batch=0), False),
    (dict(m=0), False),
])
def test_only_the_kernel_on_the_card_takes_the_fused_front_end(case, fused):
    """The fused front end (prep, kernel, finish) is chosen from what the
    solve can see alone: the kernel backend, not ``interpret``, tensors on
    the card, no shuffle generator, something to solve.  Every other call
    runs the eager chain."""
    from repro_torch.solver.solver import _takes_fused
    spec = ts.SolverSpec(backend=case.get("backend", "kernel"),
                         interpret=case.get("interpret", False))
    gen = torch.Generator() if case.get("shuffled") else None
    assert _takes_fused(spec, torch.device(case.get("device", "cuda")), gen,
                        case.get("batch", 16), case.get("m", 8)) is fused


# -- the fused path's launch plans ---------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(tile=16), dict(chunk=128),
                                dict(tile=4, chunk=128)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [3, 64, 256, 2048])
@pytest.mark.parametrize("B", [1, 7, 16384])
@pytest.mark.parametrize("layout", ["aos", "packed"])
def test_plan_shape_is_what_each_call_resolved(layout, B, m, dtype, kw):
    """A plan holds what the fused path resolved on every call before it:
    the spec pinned for the shape (a packed batch is keyed by its padded
    width), the tile, the padding to LANE columns and whole tiles, and the
    kernel's launch geometry."""
    from repro_torch.kernels.batch_lp import LANE, _pick_tile, launch_geometry
    from repro_torch.solver.solver import plan_shape
    width = -(-m // LANE) * LANE if layout == "packed" else m
    spec = ts.SolverSpec(backend="kernel", dtype=dtype, **kw)
    want = spec.resolve_for_shape(width, B, platform="cuda")
    tile = want.tile or _pick_tile(B)
    m_pad = -(-width // LANE) * LANE
    got = plan_shape(spec, B, width)
    assert got.spec == want
    assert (got.tile, got.m_pad, got.b_pad) == (
        tile, m_pad, -(-B // tile) * tile)
    assert got.geometry == launch_geometry(
        m_pad, 4 if dtype == "float32" else 8, tile)
    assert got.b_pad % got.tile == 0 and got.m_pad % LANE == 0


def test_a_table_change_makes_a_new_plan():
    """The key carries the active table's version: a table swapped in by
    ``use_table`` (and out again), a ``put`` or a ``merge`` into the active
    table each give a new key, and the plan made for it resolves the new
    tile at once; a ``put`` into a table that is not active changes
    nothing."""
    from repro_torch.solver.solver import _key, plan_shape
    from repro_torch.tune import current_device_kind, table_version
    spec = ts.SolverSpec(backend="kernel")
    lp = tc.infeasible_lp(64, 200, device="cpu")
    tensors = (lp.A, lp.b, lp.c, lp.m_valid)
    key = lambda: _key(spec, False, tensors)
    kind = current_device_kind()      # what a solve on the card looks up
    row = lambda tile: TableEntry(TableKey(kind, "kernel", "float32",
                                           m_bucket=256, batch_bucket=64),
                                  tile=tile, chunk=0, us_per_lp=1.0)
    with use_table(TuningTable()):
        k0 = key()
        assert key() == k0 and plan_shape(spec, 64, 200).tile == DEFAULT_TILE
        idle = TuningTable()
        idle.put(row(2))
        assert key() == k0
    with use_table(TuningTable([row(4)])) as table:
        k1 = key()
        assert k1 != k0 and plan_shape(spec, 64, 200).tile == 4
        table.put(row(16))
        k2 = key()
        assert k2 != k1 and plan_shape(spec, 64, 200).tile == 16
        table.merge(TuningTable([row(32)]))
        assert key() != k2
    assert key() not in (k0, k1, k2)
    v = table_version()
    ts.SolverSpec(backend="kernel").resolve_for_shape(200, 64, "cuda")
    assert table_version() == v          # a lookup is no change


def test_only_unwatched_tensors_take_the_direct_launch():
    """The routing rule of the planned path: plain tensors with no mode
    active launch the kernel directly; a ``FlopCounterMode``, any other
    dispatch mode, a function mode (``torch.device`` as a context is one),
    fake tensors and tensor subclasses keep ``torch.ops.repro_torch.rgb``,
    so whatever counts the dispatcher's operators sees it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.solver.solver import unwatched

    class Passing(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    class Functions(TorchFunctionMode):
        pass

    t = (torch.zeros(4, 3, 2), torch.zeros(4, 3), torch.zeros(4, 2))
    assert unwatched(t)
    for mode in (FlopCounterMode(display=False), Passing(), Functions(),
                 torch.device("cpu")):
        with mode:
            assert not unwatched(t)
    assert unwatched(t)
    with FakeTensorMode() as fake:
        ft = tuple(fake.from_tensor(x) for x in t)
    assert not unwatched(ft)
    assert not unwatched(t[:2] + (torch.nn.Parameter(t[2]),))


@pytest.mark.parametrize("case", ["cpu", "generator", "shuffle"])
def test_no_plan_key_off_the_card_or_under_a_shuffle(case):
    """A plan serves only unshuffled solves on the card: on the CPU, with
    a generator or under a shuffled spec the call has no key and runs as
    before."""
    from repro_torch.solver.solver import _plan_key
    spec = ts.SolverSpec(backend="kernel", shuffle=case == "shuffle")
    gen = torch.Generator() if case == "generator" else None
    lp = tc.infeasible_lp(8, 6, device="cpu")
    assert _plan_key(spec, lp, gen) is None
    assert _plan_key(spec, lp.pack(), gen) is None


def test_the_plan_cache_is_bounded(monkeypatch):
    """``_keep`` holds at most ``PLAN_CACHE_SIZE`` plans, dropping the
    oldest first, and counts each plan it keeps as a miss."""
    from repro_torch.solver import solver as S
    monkeypatch.setattr(S, "_plans", {})
    n0 = S.solve_with_spec.plan_misses
    extra = 5
    for i in range(S.PLAN_CACHE_SIZE + extra):
        S._keep(("key", i), f"plan {i}")
    assert len(S._plans) == S.PLAN_CACHE_SIZE
    assert all(("key", i) not in S._plans for i in range(extra))
    assert S._plans[("key", S.PLAN_CACHE_SIZE + extra - 1)] == \
        f"plan {S.PLAN_CACHE_SIZE + extra - 1}"
    S._keep(("key", extra), "again")             # an update evicts none
    assert len(S._plans) == S.PLAN_CACHE_SIZE and ("key", extra + 1) in \
        S._plans
    assert S.solve_with_spec.plan_misses == n0 + S.PLAN_CACHE_SIZE + extra + 1


def test_the_plan_cache_under_threads(monkeypatch):
    """Threads that keep plans at once (the scheduler's dispatch threads
    share the cache) lose no count and never pass the bound."""
    import sys
    import threading
    from repro_torch.solver import solver as S
    monkeypatch.setattr(S, "_plans", {})
    n0 = S.solve_with_spec.plan_misses
    workers, each = 16, 200
    go = threading.Barrier(workers)

    def keep(w):
        go.wait()
        for i in range(each):
            S._keep((w, i % 40), i)
            assert len(S._plans) <= S.PLAN_CACHE_SIZE

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=keep, args=(w,))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert S.solve_with_spec.plan_misses == n0 + workers * each
    assert len(S._plans) == S.PLAN_CACHE_SIZE


def test_solver_bookkeeping_and_shared_instances():
    solver = ts.SolverSpec(backend="rgb").build(device="cpu")
    mk = lambda b: tc.infeasible_lp(b, 6, device="cpu")
    solver.solve(mk(4)), solver.solve(mk(4))
    assert solver.cache_info()["n_entries"] == 1
    solver.solve(mk(8))
    assert solver.cache_info()["n_entries"] == 2
    solver.solve(mk(4), generator=torch.Generator().manual_seed(0))
    assert solver.cache_info()["n_entries"] == 3
    solver.solve(mk(4).pack())
    assert solver.cache_info()["n_entries"] == 4
    assert "rgb" in repr(solver) and "cpu" in repr(solver)
    assert ts.get_solver(ts.SolverSpec(backend="rgb"), "cpu") is \
        ts.get_solver(ts.SolverSpec(backend="rgb"), "cpu")
    assert ts.get_solver(ts.SolverSpec(backend="auto"), "cpu") is \
        ts.get_solver(ts.SolverSpec(backend="rgb"), "cpu")
    with pytest.raises(TypeError):
        ts.Solver("rgb", device="cpu")


def test_shuffle_policy_inside_the_port():
    """Spec-level shuffle equals an explicit generator with the spec's seed;
    packed and AoS draw the same permutation; the optimum is order-invariant
    to tolerance."""
    tlp = to_torch_batch(_ref_batch("ragged"))
    base = ts.SolverSpec(backend="rgb").build(device="cpu")
    shuf = ts.SolverSpec(backend="rgb", shuffle=True,
                         seed=7).build(device="cpu")
    a = shuf.solve(tlp)
    b = base.solve(tlp, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.x, shuf.solve(tlp.pack()).x)
    plain = base.solve(tlp)
    assert torch.equal(a.feasible, plain.feasible)
    np.testing.assert_allclose(a.objective.numpy(), plain.objective.numpy(),
                               rtol=5e-4, atol=5e-4)


def test_dtype_cast_on_entry_and_float64_needs_no_switch():
    lp = _ref_batch("feasible")
    tlp = to_torch_batch(lp)
    mixed = tc.LPBatch(A=tlp.A, b=tlp.b.to(torch.bfloat16),
                       c=tlp.c.to(torch.float16), m_valid=tlp.m_valid)
    want = tc.LPBatch(A=tlp.A, b=tlp.b.to(torch.bfloat16).float(),
                      c=tlp.c.to(torch.float16).float(),
                      m_valid=tlp.m_valid)
    solver = ts.SolverSpec(backend="rgb").build(device="cpu")
    got = solver.solve(mixed)
    assert got.x.dtype == torch.float32
    assert torch.equal(got.x, solver.solve(want).x)
    s64 = ts.SolverSpec(backend="kernel", dtype="float64",
                        interpret=True).build(device="cpu").solve(tlp)
    assert s64.x.dtype == torch.float64
    ref32 = rs.SolverSpec(backend="kernel", interpret=True).build().solve(lp)
    np.testing.assert_array_equal(s64.feasible.numpy(),
                                  np.asarray(ref32.feasible))
    np.testing.assert_allclose(s64.x.numpy(), np.asarray(ref32.x),
                               rtol=1e-3, atol=1e-3)


@settings(max_examples=10, deadline=None)
@given(kind=st.sampled_from(("random", "ragged", "infeasible")),
       seed=st.integers(0, 2**30), batch=st.integers(1, 12),
       m=st.integers(3, 40))
def test_backends_agree_property(kind, seed, batch, m):
    """Inside the port: naive, rgb (dense and chunked) and the kernel
    backend's plain version, each shuffling with the spec's seed, agree on
    feasibility and on the objective to the paper's 5-significant-figure
    tolerance; pack/unpack is lossless."""
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        lp = tc.random_feasible_lp(g, batch, m, device="cpu")
    elif kind == "ragged":
        lp = tc.ragged_feasible_lp(g, batch, max(m, 5), m_min=2,
                                   device="cpu")
    else:
        lp = tc.infeasible_lp(batch, m, device="cpu")
    rt = tc.unpack(tc.pack(lp))
    for f in ("A", "b", "c", "m_valid"):
        assert torch.equal(getattr(rt, f), getattr(lp, f)), f
    sweep = (
        ts.SolverSpec(backend="naive", shuffle=True, seed=seed),
        ts.SolverSpec(backend="rgb", shuffle=True, seed=seed),
        ts.SolverSpec(backend="rgb", tile=8, chunk=64, shuffle=True,
                      seed=seed),
        ts.SolverSpec(backend="kernel", interpret=True, shuffle=True,
                      seed=seed),
        ts.SolverSpec(backend="kernel", interpret=True, chunk=128,
                      dtype="float64"),
    )
    sols = [s.build(device="cpu").solve(lp) for s in sweep]
    ref = sols[0]
    assert bool(ref.feasible.any()) == (kind != "infeasible")
    for spec, sol in zip(sweep[1:], sols[1:]):
        assert torch.equal(ref.feasible, sol.feasible), spec
        feas = ref.feasible.numpy()
        np.testing.assert_allclose(
            sol.objective.numpy()[feas], ref.objective.numpy()[feas],
            rtol=5e-4, atol=5e-4, err_msg=str(spec))


def test_pdhg_is_a_legal_value_but_not_ported():
    """Since the pdhg slice the value builds and solves like the others
    (the name is the one this check has carried since the first slice)."""
    spec = ts.SolverSpec(backend="pdhg", tol=1e-5)
    solver = spec.build(device="cpu")
    assert solver.spec.backend == "pdhg" and solver.device == CPU
    inf = ts.solve_with_spec(spec, tc.infeasible_lp(2, 4, device="cpu"))
    assert not bool(inf.feasible.any())
    lp = to_torch_batch(_ref_batch("feasible"))
    sol, ref = solver.solve(lp), ts.SolverSpec(
        backend="rgb").build(device="cpu").solve(lp)
    assert torch.equal(sol.feasible, ref.feasible)
    np.testing.assert_allclose(sol.objective.numpy(), ref.objective.numpy(),
                               rtol=2e-3, atol=2e-3)
