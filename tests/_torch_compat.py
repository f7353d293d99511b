"""Helpers shared by the ``test_torch_*`` parity tests.

The JAX reference (``repro``) and the PyTorch port (``repro_torch``) run in
one process, both on the CPU; data crosses between them as numpy arrays.
Random inputs are generated (and shuffled) by the reference, because a
``jax.random`` stream cannot be reproduced by ``torch``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core import batch_from_numpy, packed_from_numpy

CPU = torch.device("cpu")

# xdist workers share the cores, and OpenMP pools that spin oversubscribe
# them: a worker's torch takes its share (outside xdist, torch's default).
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
THREADS = (max(1, len(os.sched_getaffinity(0)) // int(_WORKERS))
           if _WORKERS else None)
if THREADS is not None:
    torch.set_num_threads(THREADS)

# Tolerances of the reference's own kernel tests: FMA contraction and
# reduction order differ between XLA's fused CPU code and eager torch ops;
# the algorithm does not.
X_TOL = dict(rtol=1e-4, atol=1e-4)
OBJ_TOL = dict(rtol=2e-4, atol=2e-4)


def to_torch_batch(lp):
    """Reference ``LPBatch`` -> port ``LPBatch`` on the CPU."""
    return batch_from_numpy(np.asarray(lp.A), np.asarray(lp.b),
                            np.asarray(lp.c), np.asarray(lp.m_valid),
                            device=CPU)


def to_torch_packed(pb):
    """Reference ``PackedLPBatch`` -> port ``PackedLPBatch`` on the CPU."""
    return packed_from_numpy(np.asarray(pb.L), np.asarray(pb.c),
                             np.asarray(pb.m_valid), device=CPU)


def assert_solutions_close(ref_sol, port_sol, *, check_x=True):
    """Reference ``LPSolution`` (jax) vs port ``LPSolution`` (torch):
    ``feasible`` exactly; ``x`` and ``objective`` to the stated
    tolerances where feasible (x is documented garbage elsewhere)."""
    rf = np.asarray(ref_sol.feasible).astype(bool)
    pf = port_sol.feasible.numpy().astype(bool)
    np.testing.assert_array_equal(rf, pf)
    if check_x:
        np.testing.assert_allclose(port_sol.x.numpy()[rf],
                                   np.asarray(ref_sol.x)[rf], **X_TOL)
    np.testing.assert_allclose(port_sol.objective.numpy()[rf],
                               np.asarray(ref_sol.objective)[rf], **OBJ_TOL)
