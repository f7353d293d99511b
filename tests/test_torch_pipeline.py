"""``repro_torch.launch.pipeline``: GPipe over four gloo ranks of the CPU
against the sequential stack (the reference's ``tests/test_pipeline.py``):
the last stage's outputs within rtol = atol = 1e-5 and every stage's
gradient within 1e-5 of the sequential one (float32), and
``bubble_fraction``."""
import numpy as np
import pytest
import torch

import _torch_compat  # noqa: F401  (this worker's torch threads)
from _torch_dist_worker import run_world
from repro_torch.launch.pipeline import bubble_fraction

S, LPS, D, M, MB = 4, 2, 16, 8, 4  # stages, layers a stage, width, ...


def _inputs():
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((S * LPS, D, D)) / D ** 0.5).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return {"W": W.reshape(S, LPS, D, D), "x": x}


def _sequential(W, x):
    h = x.reshape(M * MB, D)
    for w in W.reshape(S * LPS, D, D):
        h = torch.relu(h @ w)
    return h.reshape(M, MB, D)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_world("pipeline", inputs,
                             tmp_path_factory.mktemp("pipe"))


def test_gpipe_matches_sequential(world):
    inputs, ranks = world
    W = torch.from_numpy(inputs["W"]).requires_grad_(True)
    ref = _sequential(W, torch.from_numpy(inputs["x"]))
    (g_ref,) = torch.autograd.grad(torch.sum(ref ** 2), [W])
    for r in ranks:  # the masked psum replicates the outputs on every stage
        np.testing.assert_allclose(r["out"], ref.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        # gradients flow back through the schedule (ppermute's backward)
        np.testing.assert_allclose(r["grad"], g_ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_gpipe_moves_activations_point_to_point(world):
    _, ranks = world
    for r in ranks:
        c = r["counts"]
        # one ppermute a tick forward and one a tick backward (the last
        # tick's send has no consumer, so no cotangent comes back)
        assert c["ppermute"]["calls"] == 2 * (M + S - 1) - 1
        assert c["ppermute"]["bytes"] == c["ppermute"]["calls"] * MB * D * 4


def test_recording_mesh_counts_what_the_pipeline_ranks_issued(world):
    """The same schedule on rank 0 of a RecordingMesh, on meta: the
    collectives equal those of the four gloo ranks."""
    from repro_torch import dist
    from repro_torch.launch.mesh import RecordingMesh
    from repro_torch.launch.pipeline import gpipe
    mesh = RecordingMesh(("pipe",), (S,))
    Wl = torch.empty((LPS, D, D), device="meta", requires_grad=True)
    x = torch.empty((M, MB, D), device="meta")

    def stage_fn(ws, h):
        for w in ws:
            h = torch.relu(h @ w)
        return h

    dist.reset_counts()
    out = gpipe(stage_fn, Wl, x, n_stages=S, mesh=mesh)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), [Wl])
    dist.gather_leaf(g[None], ("pipe",), mesh)
    for r in world[1]:
        assert dist.counts() == r["counts"]
    rec = dist.recorded()["collective-permute"]
    assert rec["calls"] == 2 * (M + S - 1) - 1


def test_bubble_fraction():
    assert bubble_fraction(4, 8) == 3 / 11
    assert bubble_fraction(1, 8) == 0.0
    # more microbatches -> smaller bubble
    assert bubble_fraction(4, 64) < bubble_fraction(4, 8)
