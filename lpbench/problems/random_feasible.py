"""Random feasible LPs, the paper's figure-3 problems: an interior point in
``[-radius/2, radius/2]^2``, normals uniform on the circle, slack
``U(slack_lo, slack_hi)``, the objective at a uniform angle
(:func:`lpbench.reference.generators.random_feasible_lp`).

``batch`` draws one batch on the generator's device; the configuration's
``problem`` holds ``radius``, ``slack_lo`` and ``slack_hi``.
"""
from lpbench.reference import generators


def batch(generator, n: int, m: int, dtype, params: dict):
    """``A (n, m, 2)``, ``b (n, m)``, ``c (n, 2)``."""
    return generators.random_feasible_lp(
        generator, n, m, dtype=dtype, radius=float(params["radius"]),
        slack_lo=float(params["slack_lo"]), slack_hi=float(params["slack_hi"]))
