"""Unified front end for the batch 2-D LP solver stack.

One operation, many LPs, every backend::

    from repro_torch.solver import SolverSpec

    solver = SolverSpec(backend="auto", shuffle=True).build()   # on the card
    sol = solver.solve(batch)            # AoS or packed
    one = solver.solve_one(A, b, c)      # single-LP convenience
    sol = solver.solve(batch.pack())     # packed SoA batches solve
                                         # bit-identically, no repack
    cpu = SolverSpec(backend="rgb").build(device="cpu")

    # same problem, every ported backend, bit-for-bit comparable:
    sols = [SolverSpec(backend=b).build().solve(batch)
            for b in ("naive", "rgb", "kernel")]

:class:`SolverSpec` is frozen and hashable — use it as an
executable-cache key (the serving layer's ``ExecSpec`` embeds one).

The exact Seidel backends (``naive``/``rgb``/``kernel``) answer to
machine precision at 2-D/small-m; ``backend="pdhg"`` (restarted
first-order) answers to a relative KKT tolerance and is the large-``m``
contender.  ``backend="auto"`` routes each input shape to
the fastest *measured* backend when the tuning table has entries, else to
the CUDA kernel on a card and to ``rgb`` on the CPU.

Launch geometry left unset (``tile``/``chunk`` ``None``) is pinned per
input shape with the precedence *explicit > measured tuning table >
heuristic* (see :mod:`repro_torch.tune` and
:meth:`SolverSpec.resolve_for_shape`).
"""
from repro_torch.solver.solver import Solver, solve_with_spec
from repro_torch.solver.spec import (BACKENDS, DEFAULT_M, SolverSpec,
                                     get_solver)

__all__ = [
    "BACKENDS", "DEFAULT_M", "Solver", "SolverSpec", "get_solver",
    "solve_with_spec",
]
