"""Frozen copies of the generators the benchmark's inputs are drawn from.

* :func:`random_feasible_lp` is the figure-3 generator
  (``repro_torch.core.lp.random_feasible_lp``): an interior point in
  ``[-radius/2, radius/2]^2``, normals uniform on the circle, slack
  ``U(slack_lo, slack_hi)``, the objective at a uniform angle.  It draws on
  the generator's own device in a few large calls.
* :func:`requests` draws many serving requests of one size and kind at once:
  the serving benchmark's ``_feasible``, ``_infeasible`` and ``_degenerate``
  (``repro_torch.serve_lp.bench``), vectorised with numpy.

They are copied, not imported, so the yardstick stays put when the program
changes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

KINDS = ("feasible", "infeasible", "degenerate")


def random_feasible_lp(generator: torch.Generator, batch: int, m: int, *,
                       dtype=torch.float32, radius: float = 100.0,
                       slack_lo: float = 0.1, slack_hi: float = 5.0):
    """``A (batch, m, 2)``, ``b (batch, m)``, ``c (batch, 2)`` on the
    generator's device."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
        return u * (hi - lo) + lo

    xstar = uniform((batch, 1, 2), -radius / 2, radius / 2)
    theta = uniform((batch, m), 0.0, 2.0 * math.pi)
    A = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    s = uniform((batch, m), slack_lo, slack_hi)
    b = (A * xstar).sum(dim=-1) + s
    phi = uniform((batch,), 0.0, 2.0 * math.pi)
    c = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    return A, b, c


def requests(rng: np.random.Generator, kind: str, n: int, m: int):
    """``n`` requests of ``m`` constraints of one ``kind``: float32
    ``A (n, m, 2)``, ``b (n, m)``, ``c (n, 2)``.

    feasible: an interior point in [-50, 50]^2, normals uniform on the
    circle, slack U(0.1, 5), objective at a uniform angle.  infeasible: the
    same with rows 0 and 1 replaced by x <= -1 and -x <= -1.  degenerate:
    the same normals made tight at a second point, so the feasible set is
    that one point (to rounding)."""
    if kind not in KINDS:
        raise ValueError(f"unknown request kind {kind!r}")
    xstar = rng.uniform(-50.0, 50.0, (n, 2))
    theta = rng.uniform(0.0, 2.0 * np.pi, (n, m))
    A = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    s = rng.uniform(0.1, 5.0, (n, m))
    b = np.einsum("nmk,nk->nm", A, xstar) + s
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    c = np.stack([np.cos(phi), np.sin(phi)], axis=-1).astype(np.float32)
    A = A.astype(np.float32)
    b = b.astype(np.float32)
    if kind == "degenerate":
        x2 = rng.uniform(-50.0, 50.0, (n, 2)).astype(np.float32)
        b = np.einsum("nmk,nk->nm", A, x2).astype(np.float32)
    elif kind == "infeasible":
        A[:, 0] = (1.0, 0.0)
        b[:, 0] = -1.0
        A[:, 1] = (-1.0, 0.0)
        b[:, 1] = -1.0
    return A, b, c
