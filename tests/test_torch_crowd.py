"""``repro_torch.crowd`` against the plain float64 reference
(``tests/crowd_orca_ref.py``) on the CPU, at 256 agents (RVO2's Blocks
layout, 4 groups of 8 x 8): each ORCA branch's row, the grid's neighbour
lists against a brute force, the direct and the served step in bits, a
step's answers within the configuration's limits, the spans, and the
benchmark's copy of the reference.  On a card (``gpu``): the grid's kernel
against its plain version in bits, eager and replayed from the build's CUDA
graph, and against the brute force where the plain version's second pass
runs out."""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import torch

import crowd_orca_ref as ref
from _torch_compat import CPU
from repro_torch.crowd import (CrowdParams, CrowdState, grid, orca_rows,
                               step_direct, step_served)
from repro_torch.kernels.crowd_grid import neighbours_cuda
from repro_torch.obs import default_tracer
from repro_torch.serve_lp import BatchScheduler
from repro_torch.solver import SolverSpec

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "lpbench" / "configs" /
                     "crowd-16384.json").read_text())
AGENTS = dict(CONFIG["agents"], timeStep=CONFIG["timeStep"])
P = CrowdParams()


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def blocks(side=8, seed=0):
    """Blocks' layout (groups of ``side`` x ``side``), goals opposite."""
    pos = [(sx * (55.0 + 10.0 * i), sy * (55.0 + 10.0 * j))
           for i in range(side) for j in range(side)
           for sx, sy in ((1, 1), (-1, 1), (1, -1), (-1, -1))]
    pos = torch.tensor(pos)
    g = torch.Generator().manual_seed(seed)
    eps = (torch.rand(len(pos), 2, generator=g) - 0.5) * 1e-4
    return CrowdState.start(pos, -pos, eps)


def jammed(n=256, box=40.0, seed=1, speed=2.0):
    """A crossing jammed in a ``box`` metre square: positions at least
    ``2 radius`` apart where the draw allows, velocities up to ``speed``."""
    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand(n, 2, generator=g) - 0.5) * box
    ang = torch.rand(n, generator=g) * 2 * math.pi
    vel = torch.stack([ang.cos(), ang.sin()], 1) * speed * torch.rand(
        n, 1, generator=g)
    st = CrowdState.start(pos, -pos * 20, torch.zeros(n, 2))
    return CrowdState(pos=pos, vel=vel, goal=st.goal, eps=st.eps,
                      unplaced=st.unplaced)


def crowded(n=256, packed=60, seed=2):
    """``packed`` agents overlapping within 5 m in one cell, the rest
    around them."""
    st = jammed(n, 60.0, seed)
    g = torch.Generator().manual_seed(seed + 1)
    pos = st.pos.clone()
    pos[:packed] = 3.0 + torch.rand(packed, 2, generator=g) * 5.0
    return CrowdState(pos=pos, vel=st.vel, goal=st.goal, eps=st.eps,
                      unplaced=st.unplaced)


def _neighbours(st, **kw):
    args = dict(dist=P.neighbor_dist, k=P.max_neighbors, world=P.world,
                capacity=P.capacity, fallback=P.fallback)
    args.update(kw)
    return grid.neighbours(st.pos, **args)


# -- ORCA's rows, branch by branch --------------------------------------------

# Agent 0 at the origin, agent 1 at p with velocity 0; agent 0's velocity
# picks the branch (R = 4, tau = 5, dt = 0.25).
BRANCHES = {
    "overlap": ((3.0, 0.0), (1.0, 0.5)),    # |p| < R
    "cutoff": ((10.0, 0.0), (0.5, 0.0)),    # w = (-1.5, 0): behind the circle
    "left_leg": ((10.0, 0.0), (3.0, 1.0)),  # w = (1, 1): det(p, w) > 0
    "right_leg": ((10.0, 0.0), (3.0, -1.0)),
}


def _ref_orca(p, v):
    return ref.orca(torch.tensor([[0.0, 0.0], p]),
                    torch.tensor([v, [0.0, 0.0]]), torch.tensor([[1], [0]]),
                    radius=P.radius, tau=P.time_horizon, dt=P.time_step,
                    speed=P.max_speed)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_each_orca_branch_gives_the_references_row(branch):
    p, v = BRANCHES[branch]
    a, b = orca_rows(torch.tensor([[0.0, 0.0], p]),
                     torch.tensor([v, [0.0, 0.0]]), torch.tensor([[1], [0]]),
                     radius=P.radius, tau=P.time_horizon, dt=P.time_step)
    o = _ref_orca(p, v)
    assert int(o["pick"][0, 0]) == list(BRANCHES).index(branch)
    assert not (o["unsure"] | o["open"]).any()
    torch.testing.assert_close(a.double(), o["A"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b.double(), o["b"], rtol=1e-6, atol=1e-6)
    # the four cases are four different rows for agent 0
    rows = {k: _ref_orca(q, u)["A"][0, 0] for k, (q, u) in BRANCHES.items()}
    assert all(not torch.allclose(rows[branch], r, atol=1e-3)
               for k, r in rows.items() if k != branch)


def test_contact_is_open_between_branches_that_differ():
    """Just outside contact (|p| - R at float32's rounding) the overlap
    test is rounding's: with the agents sliding past each other its two
    sides give different rows, and both enter the tight LP; at rest at
    exact contact every branch gives one row."""
    sliding = _ref_orca((4.0000005, 0.0), (0.0, 0.2))
    assert bool(sliding["open"][0, 0]) and not sliding["unsure"].any()
    assert int(sliding["pick"][0, 0]) != 0 and bool(sliding["cand"][0, 0, 0])
    resting = _ref_orca((4.0, 0.0), (0.0, 0.0))
    assert int(resting["pick"][0, 0]) == 0
    assert bool(resting["cand"][0, 0].all()) and not resting["open"].any()


# -- the grid against the brute force -----------------------------------------

@pytest.mark.parametrize("state", ["spawn", "jammed", "crowded"])
def test_grid_neighbours_equal_the_brute_force(state):
    st = {"spawn": blocks, "jammed": jammed, "crowded": crowded}[state]()
    nb = _neighbours(st)
    idx, valid, unsure = ref.neighbours(st.pos, dist=P.neighbor_dist,
                                        k=P.max_neighbors)
    sure = ~unsure
    assert sure.float().mean() > 0.95
    assert torch.equal(nb.valid[sure], valid[sure])
    assert torch.equal(torch.where(nb.valid, nb.idx, -1)[sure],
                       torch.where(valid, idx, -1)[sure])
    assert int(nb.unplaced) == 0
    if state == "spawn":       # the lattice: 3 to 8 neighbours, none unsure
        assert bool(sure.all()) and 3 <= int(nb.count.min())
        assert int(nb.count.max()) == 8
    if state == "jammed":      # more than 10 in range: the 10 nearest kept
        assert int((nb.count == P.max_neighbors).sum()) > 100
    if state == "crowded":     # a cell over capacity, placed by the 2nd pass
        assert int(nb.over_cells) >= 1


def test_agents_the_second_pass_cannot_take_are_counted():
    nb = _neighbours(crowded(), fallback=8)
    assert int(nb.over_cells) >= 1 and int(nb.unplaced) > 0


def test_the_cpu_takes_the_plain_version_and_launches_nothing():
    before = neighbours_cuda.launches
    st = jammed()
    nb = _neighbours(st)
    plain = grid.neighbours_plain(st.pos, dist=P.neighbor_dist,
                                  k=P.max_neighbors, world=P.world,
                                  capacity=P.capacity, fallback=P.fallback)
    for key in ("idx", "valid", "count", "over_cells", "unplaced"):
        assert torch.equal(getattr(nb, key), getattr(plain, key)), key
    assert neighbours_cuda.launches == before


def test_the_kernels_wrapper_refuses_cpu_tensors():
    """No fallback: the wrapper launches on a card or raises."""
    before = neighbours_cuda.launches
    st = blocks()
    G, _, cell, order, counts, start = grid._bins(st.pos, P.neighbor_dist,
                                                  P.world)
    with pytest.raises(ValueError, match="unsupported device"):
        neighbours_cuda(st.pos, cell, order, start, counts, grid=G,
                        dist=P.neighbor_dist, k=P.max_neighbors)
    assert neighbours_cuda.launches == before


# -- the two steps -----------------------------------------------------------

def _rgb():
    return SolverSpec(backend="rgb", M=4.0)


def test_direct_and_served_steps_agree_in_bits():
    spec = _rgb()
    solver = spec.build(device=CPU)
    sched = BatchScheduler(spec, max_batch=256, devices=[CPU])
    try:
        a = b = jammed()
        for _ in range(2):
            a, lp_a, sa = step_direct(a, solver, P)
            b, lp_b, sb = step_served(b, sched, P)
            assert torch.equal(lp_a.A, lp_b.A) and torch.equal(lp_a.b, lp_b.b)
            assert torch.equal(sa.x, sb.x)
            assert torch.equal(sa.feasible, sb.feasible)
            assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
        assert a.step == b.step == 2
    finally:
        sched.close()


@pytest.mark.parametrize("state", ["spawn", "jammed"])
def test_a_steps_answers_meet_the_configurations_limits(state):
    st = {"spawn": blocks, "jammed": jammed}[state]()
    _, lp, sol = step_direct(st, _rgb().build(device=CPU), P)
    r = ref.rows(st.pos, st.vel, st.goal, st.eps, AGENTS)
    sel = torch.nonzero(~r["unsure"])[:, 0]
    assert len(sel) > 0.95 * len(st.pos)
    closed = sel[r["open"][sel] == 0]
    assert torch.equal(lp.m_valid[closed], r["m_valid"][closed])
    judge = _load("crowd_test_judge", "lpbench/judge.py")
    tally = judge.Tally(ref)
    ref.add(tally, {k: v[sel] for k, v in r.items()}, sol.x[sel],
            sol.feasible[sel], sol.objective[sel], CONFIG)
    correct, checks = judge.verdict(tally, 0, CONFIG["limits"])
    assert correct and tally.compared == len(sel), checks


# -- spans --------------------------------------------------------------------

def test_spans_record_under_a_profiler_and_not_without():
    tracer = default_tracer()
    tracer.reset()
    spec = _rgb()
    solver = spec.build(device=CPU)
    sched = BatchScheduler(spec, max_batch=256, devices=[CPU])
    try:
        st = jammed()
        st, _, _ = step_direct(st, solver, P)
        st, _, _ = step_served(st, sched, P)
        assert tracer.spans_started == 0
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            st, _, _ = step_direct(st, solver, P)
            st, _, _ = step_served(st, sched, P)
    finally:
        sched.close()
    spans = tracer.spans()
    tracer.reset()
    by_id = {s.span_id: s for s in spans}
    tops = [s for s in spans if s.name == "crowd.step"]
    assert len(tops) == 2
    stages = [sorted(s.name for s in spans if s.parent_id == t.span_id)
              for t in tops]
    assert stages == [
        ["crowd.apply", "crowd.build", "crowd.solve"],
        ["crowd.apply", "crowd.build", "crowd.submit", "crowd.wait"]]
    build = [s for s in spans if s.name in ("crowd.neighbours", "crowd.orca")]
    assert len(build) == 4
    assert all(by_id[s.parent_id].name == "crowd.build" for s in build)
    solve = [s for s in spans if s.name == "solve"
             and s.parent_id in by_id]
    assert by_id[solve[0].parent_id].name == "crowd.solve"
    direct, served = tops
    assert direct.attrs == {"n_agents": 256, "episode_step": 2}
    assert served.attrs["rows"] >= 8 * 256
    assert served.attrs["episode_step"] == 3
    assert {"n_infeasible", "n_unsure_cells"} <= set(served.attrs)


# -- the benchmark's copy of the reference ------------------------------------

def test_the_benchmarks_reference_gives_the_same_rows():
    sys.path.insert(0, str(REPO))
    try:
        bench = _load("crowd_test_bench_ref",
                      "lpbench/reference/crowd_orca.py")
    finally:
        sys.path.remove(str(REPO))
    st = jammed(seed=7)
    st = CrowdState(pos=st.pos, vel=st.vel, goal=st.goal,
                    eps=(torch.rand(256, 2, generator=torch.Generator()
                                    .manual_seed(7)) - 0.5) * 1e-4,
                    unplaced=st.unplaced)
    ours, theirs = (m.rows(st.pos, st.vel, st.goal, st.eps, AGENTS)
                    for m in (ref, bench))
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_the_captured_build_equals_the_eager_one_and_never_syncs():
    """On a card the build replays CUDA graphs: the same LPs in bits as
    the eager functions, and a direct step waits for nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    from repro_torch.crowd import step as crowd_step
    dev = torch.device("cuda", 0)
    st = jammed()
    st = CrowdState(pos=st.pos.to(dev), vel=st.vel.to(dev),
                    goal=st.goal.to(dev), eps=st.eps.to(dev),
                    unplaced=st.unplaced.to(dev))
    lp, nb = crowd_step.build(st, P)
    eager = crowd_step._rows(st.pos, st.vel, st.goal, st.eps,
                             crowd_step._neighbours(st.pos, P), P)
    for k in ("A", "b", "c", "m_valid"):
        assert torch.equal(getattr(lp, k), getattr(eager, k)), k
    solver = SolverSpec(backend="kernel", M=4.0).build(device=dev)
    st = step_direct(st, solver, P)[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st = step_direct(st, solver, P)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st.unplaced) == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the grid's CUDA kernel has no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _on(st, dev):
    return CrowdState(pos=st.pos.to(dev), vel=st.vel.to(dev),
                      goal=st.goal.to(dev), eps=st.eps.to(dev),
                      unplaced=st.unplaced.to(dev))


def _lead(dev):
    """The cell's lead state: RVO2's Blocks at 16,384 agents after the
    configuration's lead steps, the groups in contact at the centre."""
    spawn = _load("crowd_test_blocks", "lpbench/problems/crowd_blocks.py")
    pos, goal, eps = spawn.spawn(CONFIG["problem"], 3000000019)
    st = CrowdState.start(pos.to(dev), goal.to(dev), eps.to(dev))
    solver = SolverSpec(backend="kernel", M=float(CONFIG["M"])).build(
        device=dev)
    for _ in range(int(CONFIG["episode"]["lead_steps"])):
        st = step_direct(st, solver, P)[0]
    return st


@pytest.mark.gpu
@pytest.mark.parametrize("state", ["spawn", "jammed", "lead", "crowded"])
def test_the_kernel_equals_the_plain_version_in_bits(state):
    dev = _card()
    if state == "lead":
        st = _lead(dev)
    else:
        st = _on({"spawn": blocks, "jammed": jammed,
                  "crowded": crowded}[state](), dev)
    fallback = st.n_agents if state == "crowded" else P.fallback
    plain = grid.neighbours_plain(st.pos, dist=P.neighbor_dist,
                                  k=P.max_neighbors, world=P.world,
                                  capacity=P.capacity, fallback=fallback)
    before = neighbours_cuda.launches
    nb = _neighbours(st, fallback=fallback)
    assert neighbours_cuda.launches == before + 1
    assert int(plain.unplaced) == 0 and int(nb.unplaced) == 0
    for key in ("idx", "valid", "count", "over_cells"):
        assert torch.equal(getattr(nb, key), getattr(plain, key)), key
    if state == "crowded":
        assert int(nb.over_cells) >= 1


@pytest.mark.gpu
def test_the_kernel_is_exact_where_the_second_pass_runs_out():
    """``crowded`` with a second pass of 8: the plain version leaves agents
    unplaced, the kernel equals the brute force on every sure agent."""
    dev = _card()
    st = crowded()
    nb = _neighbours(_on(st, dev), fallback=8)
    idx, valid, unsure = ref.neighbours(st.pos, dist=P.neighbor_dist,
                                        k=P.max_neighbors)
    sure = ~unsure
    assert int(nb.unplaced) == 0 and int(nb.over_cells) >= 1
    assert sure.float().mean() > 0.95
    assert torch.equal(nb.valid.cpu()[sure], valid[sure])
    assert torch.equal(torch.where(nb.valid, nb.idx, -1).cpu()[sure],
                       torch.where(valid, idx, -1)[sure])


@pytest.mark.gpu
def test_a_replayed_grid_equals_an_eager_one_and_launches_once_a_step():
    """A direct step's grid, replayed from its CUDA graph, equals an eager
    call in bits; each step adds one launch of the kernel and runs no
    top-k."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.crowd import step as crowd_step
    dev = _card()
    st = _on(jammed(), dev)
    solver = SolverSpec(backend="kernel", M=4.0).build(device=dev)
    st = step_direct(st, solver, P)[0]          # captures the graphs
    for _ in range(3):
        before = neighbours_cuda.launches
        new = step_direct(st, solver, P)[0]
        assert neighbours_cuda.launches == before + 1
        replayed = st.graphs[P].nb
        eager = crowd_step._neighbours(st.pos, P)
        for key in ("idx", "valid", "count", "over_cells", "unplaced"):
            assert torch.equal(getattr(replayed, key),
                               getattr(eager, key)), key
        st = new
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = step_direct(st, solver, P)[0]
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("neighbours_kernel" in n for n in names) == 1, names
    assert not [n for n in names if "topk" in n.lower()], names


@pytest.mark.gpu
def test_the_kernels_wrapper_refuses_float16_strided_and_too_many():
    dev = _card()
    st = _on(jammed(), dev)
    G, _, cell, order, counts, start = grid._bins(st.pos, P.neighbor_dist,
                                                  P.world)
    args = (cell, order, start, counts)
    kw = dict(grid=G, dist=P.neighbor_dist, k=P.max_neighbors)
    with pytest.raises(TypeError, match="float32"):
        neighbours_cuda(st.pos.half(), *args, **kw)
    strided = torch.empty((2, st.n_agents), device=dev).t()
    strided.copy_(st.pos)
    with pytest.raises(ValueError, match="contiguous"):
        neighbours_cuda(strided, *args, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        neighbours_cuda(st.pos, cell[::1].repeat(2)[::2], order, start,
                        counts, **kw)
    with pytest.raises(ValueError, match="k <= 16"):
        neighbours_cuda(st.pos, *args, **dict(kw, k=17))
