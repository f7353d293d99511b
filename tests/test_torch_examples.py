"""The port's examples (``examples/*_torch.py``) on the CPU.

The crowd simulation's constraints are held against the reference's
``examples/crowd_sim.py`` on the same jittered positions (the same
neighbours in the same order; ``A``, ``b``, ``c`` within 1e-6: a norm and a
division in float32), and one direct step against the reference's
``sim_step`` (``backend="rgb"`` on both sides) within 1e-4, the solver's
tolerance.  Within the port, the direct and served paths print the same
step lines and reach the same positions bit for bit.  The quickstart and
both training examples run end to end with their own checks.
"""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")
sys.path.insert(0, EXAMPLES)

import crowd_sim_torch as crowd                     # noqa: E402
import lp_constrained_training_torch as lp_train    # noqa: E402
import quickstart_torch as quickstart               # noqa: E402
import train_lm_torch as train_lm                   # noqa: E402
from _torch_compat import CPU                       # noqa: E402


@pytest.fixture(scope="module")
def ref_crowd():
    spec = importlib.util.spec_from_file_location(
        "ref_crowd_sim", os.path.join(EXAMPLES, "crowd_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _positions(n, seed):
    """The spawn grid, and a denser jittered cloud where agents crowd."""
    pos, goal = crowd.spawn(n, seed)
    rng = np.random.default_rng(seed + 1)
    cloud = rng.uniform(-4.0, 4.0, (n, 2)).astype(np.float32)
    return ((pos, goal), (cloud, goal))


def test_constants_are_the_references(ref_crowd):
    assert (crowd.RADIUS, crowd.V_MAX, crowd.TAU, crowd.K_NEIGH) == (
        ref_crowd.RADIUS, ref_crowd.V_MAX, ref_crowd.TAU, ref_crowd.K_NEIGH)
    got, want = crowd.spec_for(CPU), ref_crowd.SPEC
    assert (got.backend, got.tile, got.chunk, got.M) == (
        want.backend, want.tile, want.chunk, want.M)
    assert crowd.spec_for(torch.device("cuda", 0)).backend == "kernel"
    pos, goal = crowd.spawn(64, 3)
    # the reference builds its spawn inline in main(); same draws
    rng = np.random.default_rng(3)
    rows = int(np.ceil(np.sqrt(32)))
    ij = np.stack(np.meshgrid(np.arange(rows), np.arange(rows)),
                  -1).reshape(-1, 2)[:32]
    p = ij * 1.0 + rng.uniform(-0.15, 0.15, (32, 2))
    p[:, 0] -= 12.0
    p[:, 1] -= rows / 2
    np.testing.assert_array_equal(pos[:32], p.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_step_constraints_match_the_reference(ref_crowd, seed):
    for pos, goal in _positions(96, seed):
        lp = crowd.step_constraints(torch.as_tensor(pos),
                                    torch.as_tensor(goal - pos))
        idx, _, _ = crowd.nearest(torch.as_tensor(pos))
        ref = ref_crowd.step_constraints(jnp.asarray(pos),
                                         jnp.asarray(goal - pos))
        # the reference's neighbour choice, written out from its body
        jp = jnp.asarray(pos)
        diff = jp[None, :, :] - jp[:, None, :]
        dist = jnp.linalg.norm(diff, axis=-1) + 1e-9
        dist = dist.at[jnp.arange(96), jnp.arange(96)].set(jnp.inf)
        _, ridx = jax.lax.top_k(-dist, crowd.K_NEIGH)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        for got, want in ((lp.A, ref.A), (lp.b, ref.b), (lp.c, ref.c)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
        assert lp.m_valid.tolist() == np.asarray(ref.m_valid).tolist()


def test_one_direct_step_matches_the_reference(ref_crowd):
    pos, goal = crowd.spawn(64, 0)
    solver = crowd.spec_for(CPU).build(device=CPU)
    got = crowd.sim_step(torch.as_tensor(pos), torch.as_tensor(goal),
                         solver)
    want = ref_crowd.sim_step(jnp.asarray(pos), jnp.asarray(goal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert not np.array_equal(got.numpy(), pos)     # the agents moved


def test_direct_and_served_paths_print_the_same_lines(capsys):
    served = crowd.main(["--agents", "64", "--steps", "20"], device=CPU)
    direct = crowd.main(["--agents", "64", "--steps", "20", "--direct"],
                        device=CPU)
    assert served["lines"] == direct["lines"] and len(direct["lines"]) == 2
    assert torch.equal(served["pos"], direct["pos"])
    assert direct["min_gap"] > 2 * crowd.RADIUS * 0.95
    out = capsys.readouterr().out
    assert "NO collisions" in out and "[serve_lp] solved 1280 LPs" in out


def test_min_pairwise_distance_blocks():
    pos = torch.as_tensor(np.random.default_rng(4).uniform(
        -5, 5, (37, 2)).astype(np.float32))
    d = torch.linalg.vector_norm(pos[None] - pos[:, None], dim=-1)
    d.fill_diagonal_(float("inf"))
    for rows in (1, 8, 64):
        assert crowd.min_pairwise_distance(pos, rows=rows) == d.min()


def test_quickstart_reduced():
    out = quickstart.main(["--batch", "64", "--m", "16"], device=CPU)
    assert out["feasible"] == {"naive": 64, "rgb": 64, "kernel": 64}
    assert out["max_objective_diff"] <= 5e-4


def test_examples_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    for run in (lambda: quickstart.main(["--batch", "8", "--m", "8"]),
                lambda: crowd.main(["--agents", "8", "--steps", "1"]),
                lambda: train_lm.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_train_lm_three_steps(tmp_path):
    loss = train_lm.main(["--steps", "3", "--ckpt-dir", str(tmp_path),
                          "--heartbeat", str(tmp_path / "hb.json")],
                         device=CPU)
    # below a uniform guess over the smoke vocabulary after three steps
    assert np.isfinite(loss) and loss < np.log(257)
    assert (tmp_path / "hb.json").exists()


def test_lp_constrained_training_three_steps():
    loss_a, loss_b = lp_train.main(["--steps", "3"], device=CPU)
    assert np.isfinite(loss_a) and np.isfinite(loss_b)
    assert loss_a != loss_b            # the LP clip changed the updates
