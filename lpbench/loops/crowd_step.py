"""``crowd_step``: one caller runs a crowd simulation's steps back to back.

The configuration is a crowd deployment (``repro_torch.crowd``): the
problem kind spawns the agents from the seed, ``lead_steps`` direct steps
bring them to where the timing starts (set-up, untimed), and each timed
episode runs ``episode_steps`` steps from that lead state before it starts
again from it.  The loop is closed: each step's LPs come from the last
step's answers.  The mix's ``path`` says how a step solves its LPs:

* ``direct``: one ``Solver.solve`` of every agent's LP; the loop never
  waits for the device inside the window and syncs once at its end, as a
  simulation does; the steps counted are those launched before the end;
* ``served``: every agent's LP through ``BatchScheduler.submit_many``, a
  flush, and the futures' answers back onto the device.

``lps_per_s`` is the agents times the steps, over the window.  The state
before each of ``check_steps`` steps drawn from the seed and that step's
answers are kept; after the window the reference rebuilds those steps'
LPs from the states and judges the answers of the agents it is sure of.
A traced run profiles ``trace_steps`` more steps after the window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import torch

from lpbench import crowd_trace, drivers
from lpbench import trace as tr


def params(cfg: dict):
    """The program's ``CrowdParams`` of a configuration."""
    from repro_torch.crowd import CrowdParams
    a, g = cfg["agents"], cfg["grid"]
    return CrowdParams(
        neighbor_dist=float(a["neighborDist"]),
        max_neighbors=int(a["maxNeighbors"]),
        time_horizon=float(a["timeHorizon"]), radius=float(a["radius"]),
        max_speed=float(a["maxSpeed"]), time_step=float(cfg["timeStep"]),
        world=float(g["world"]), capacity=int(g["capacity"]),
        fallback=int(g["fallback"]))


def reference_params(cfg: dict) -> dict:
    """What the reference's ``rows`` takes: RVO2's agent parameters and the
    time step."""
    return dict(cfg["agents"], timeStep=cfg["timeStep"])


def judge(r: drivers.Run, held: List) -> None:
    """The kept steps' answers against the reference's rows, for the
    agents it is sure of (:func:`lpbench.reference.crowd_orca.add`);
    raises where it is unsure of more than the configuration's
    ``unsure_share``."""
    cfg = r.config
    unsure = agents = opened = 0
    for before, sol in held:
        ref = r.reference.rows(before.pos, before.vel, before.goal,
                               before.eps, reference_params(cfg))
        sel = torch.nonzero(~ref["unsure"])[:, 0]
        agents += int(ref["unsure"].shape[0])
        unsure += int(ref["unsure"].sum())
        opened += int((ref["open"] > 0).sum())
        r.reference.add(r.tally, {k: v[sel] for k, v in ref.items()},
                        sol.x[sel], sol.feasible[sel], sol.objective[sel],
                        cfg)
    share = unsure / agents if agents else 0.0
    r.info.update(unsure=unsure, unsure_share=share, open_agents=opened,
                  checked_steps=len(held))
    if share > float(cfg["tolerance"]["unsure_share"]):
        raise RuntimeError(
            f"crowd: the reference is unsure of {unsure} of {agents} agents "
            f"({share:.4%}), over {cfg['tolerance']['unsure_share']:.2%}")


def run(r: drivers.Run, seed: int, seconds: float, trace: bool,
        device: torch.device, clock: Callable[[], float]) -> drivers.Run:
    from repro_torch.crowd import CrowdState, step_direct, step_served
    from repro_torch.serve_lp import BatchScheduler
    from repro_torch.solver import SolverSpec

    cfg, mix = r.config, r.traffic
    path = mix["path"]
    if path not in crowd_trace.STAGES:
        raise KeyError(f"crowd_step: no path {path!r}")
    prm = params(cfg)
    pos, goal, eps = r.problem.spawn(cfg["problem"], seed)
    state = CrowdState.start(pos.to(device), goal.to(device), eps.to(device))
    n = state.n_agents
    r.setup["inputs"] = clock()
    spec = SolverSpec(backend=cfg["solver"]["backend"], M=float(cfg["M"]),
                      dtype=cfg["dtype"])
    solver = spec.build(device=device)
    sync = drivers.sync_fn(device)
    for _ in range(int(cfg["episode"]["lead_steps"])):
        state = step_direct(state, solver, prm)[0]
    sync()
    lead = dataclasses.replace(state, step=0)
    r.setup["lead"] = clock()
    sched = None
    if path == "served":
        sched = BatchScheduler(
            spec, max_batch=int(cfg["scheduler"]["max_batch"]),
            devices=[device])

        def step(s):
            return step_served(s, sched, prm)
    else:
        def step(s):
            return step_direct(s, solver, prm)
    warm = lead
    for _ in range(2):
        warm = step(warm)[0]
    sync()
    if trace:
        tr.warm(sync)
    r.setup["warm"] = clock()
    episode = int(cfg["episode"]["episode_steps"])

    def next_of(s):
        if s.step < episode:
            return s
        return dataclasses.replace(lead, unplaced=s.unplaced)

    held = drivers.Reservoir(int(mix["check_steps"]), seed)
    before = drivers.counters(sched) if sched is not None else None
    state = lead
    t0 = drivers.open_window(r, clock)
    t_end = t0 + seconds
    i = 0
    with drivers.GCWatch() as gcw:
        while True:
            if i and time.perf_counter() >= t_end:
                break
            state = next_of(state)
            new, _, sol = step(state)
            held.offer((state, sol))
            state = new
            i += 1
        sync()
    r.window_s = time.perf_counter() - t0
    r.info["gc"] = gcw.summary(t0)
    r.info["steps"] = i
    r.lps_done = r.attempted = i * n
    r.counters = ({} if sched is None else
                  drivers.counters_diff(before, drivers.counters(sched)))

    if trace:
        k = int(mix["trace_steps"])
        rows: List[torch.Tensor] = []

        def traced() -> int:
            nonlocal state
            for _ in range(k):
                state = next_of(state)
                with tr.span("lpbench.step", True):
                    state, lp, _ = step(state)
                rows.append(lp.m_valid.sum())   # lp is the next build's
            return k
        r.slice, dev_s, ranges = crowd_trace.profile(traced, sync)
        r.counters["crowd"] = {
            "agents": n, "steps": k, "build_device_s": dev_s,
            "build_ranges": ranges,
            "rows": int(sum(int(m) for m in rows))}

    r.memory_peak_bytes = drivers.peak(device)
    if sched is not None:
        sched.close()
    unplaced = int(state.unplaced)
    if unplaced:
        raise RuntimeError(f"crowd: {unplaced} agents were next to a grid "
                           f"cell over capacity beyond the second pass")
    del solver
    drivers.free(device)
    judge(r, held.items)
    return r
