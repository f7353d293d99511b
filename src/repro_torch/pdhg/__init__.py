"""repro_torch.pdhg — restarted first-order (PDHG) backend for batched LP.

Matrix-free primal-dual hybrid gradient over the packed component rows,
with cuPDLP-style averaging, adaptive restarts and primal-weight
rebalancing, in plain PyTorch ops (the reference has no kernel here).
Reached through the unified front end as ``SolverSpec(backend="pdhg")``;
import this package directly for the per-problem convergence certificate
(:func:`solve_pdhg_with_stats`).
"""
from repro_torch.pdhg.iteration import (EPS_GUARD, kkt_residuals_rows,
                                        matvec_rows, pdhg_step,
                                        rmatvec_rows, spectral_norm_rows)
from repro_torch.pdhg.solve import (DEFAULT_ITER_BLOCK,
                                    DEFAULT_RESTART_PERIOD, FEAS_EPS_REL,
                                    PDHGStats, default_max_iters,
                                    default_tol, solve_pdhg,
                                    solve_pdhg_packed,
                                    solve_pdhg_with_stats)

__all__ = [
    "DEFAULT_ITER_BLOCK", "DEFAULT_RESTART_PERIOD", "EPS_GUARD",
    "FEAS_EPS_REL", "PDHGStats", "default_max_iters", "default_tol",
    "kkt_residuals_rows", "matvec_rows", "pdhg_step", "rmatvec_rows",
    "solve_pdhg", "solve_pdhg_packed", "solve_pdhg_with_stats",
    "spectral_norm_rows",
]
