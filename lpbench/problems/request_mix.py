"""Serving requests of the repo's serving benchmark: feasible, infeasible
and degenerate LPs in the proportions of the configuration's
``problem["kind_mix"]`` (:func:`lpbench.reference.generators.requests`).

``requests`` draws ``n`` requests of ``m`` constraints on the host, the
mix exact in every draw: the first ``round(n * share)`` of each kind in
turn, the last kind taking the rest.
"""
import numpy as np

from lpbench.reference import generators


def requests(rng: np.random.Generator, n: int, m: int, params: dict):
    """float32 ``A (n, m, 2)``, ``b (n, m)``, ``c (n, 2)``, and the kind of
    each as an index into :data:`generators.KINDS`."""
    mix = params["kind_mix"]
    if len(mix) != len(generators.KINDS):
        raise ValueError(f"kind_mix needs {len(generators.KINDS)} shares")
    counts = [int(round(n * f)) for f in mix[:-1]]
    counts.append(n - sum(counts))
    parts = [generators.requests(rng, kind, k, m)
             for kind, k in zip(generators.KINDS, counts) if k]
    kind = np.repeat(np.arange(len(counts)), counts).astype(np.int8)
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]), kind)
