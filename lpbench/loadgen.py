"""The one generator: a cell's inputs from its configuration, its traffic
mix and the seed.  What a problem looks like is the configuration's
``problem["kind"]``: ``lpbench/problems/<kind>.py``, passed in as
``problem``.

* :func:`batch_inputs`: ``traffic["rotate"]`` distinct batches of
  ``traffic["batch"]`` problems of the configuration's size, made on the
  device by the kind's ``batch``.
* :func:`request_pool`: the serving pool.  Every seed gets the same sizes
  and kinds (``traffic["pool"]`` requests, an equal share for each of the
  configuration's ``sizes``, each share drawn by the kind's ``requests``),
  in an order drawn from the seed.
* :func:`arrivals`: an open loop's due times.  Every seed gets the same set
  of gaps (exponential quantiles at the mix's rate) in an order drawn from
  the seed, so runs differ in order, not in work.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _drawer(problem: ModuleType, what: str) -> Callable:
    fn = getattr(problem, what, None)
    if fn is None:
        raise KeyError(f"problems/{Path(problem.__file__).name} has no "
                       f"{what}(), which this loop draws with")
    return fn


def batch_inputs(config: dict, traffic: dict, seed: int, device: torch.device,
                 problem: ModuleType) -> List[Tuple]:
    """``[(A, b, c, m_valid), ...]`` on ``device``, one per rotated batch."""
    draw = _drawer(problem, "batch")
    gen = torch.Generator(device=device).manual_seed(seed)
    B, m = int(traffic["batch"]), int(config["m"])
    out = []
    for _ in range(int(traffic["rotate"])):
        A, b, c = draw(gen, B, m, DTYPES[config["dtype"]], config["problem"])
        mv = torch.full((B,), m, dtype=torch.int32, device=device)
        out.append((A, b, c, mv))
    return out


@dataclasses.dataclass
class Pool:
    """Requests kept by size: group ``g`` holds ``A[g] (n, sizes[g], 2)``,
    ``b[g]``, ``c[g]`` and ``kind[g]``; position ``i`` of the stream is
    request ``order[i % len(order)]``, which lies in group ``idx // per``
    at row ``idx % per``."""
    sizes: List[int]
    per: int
    A: List[np.ndarray]
    b: List[np.ndarray]
    c: List[np.ndarray]
    kind: List[np.ndarray]
    order: np.ndarray

    def __len__(self) -> int:
        return len(self.order)

    def index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def request(self, i: int):
        k = self.index(i)
        g, j = divmod(k, self.per)
        return self.A[g][j], self.b[g][j], self.c[g][j]


def request_pool(config: dict, traffic: dict, seed: int,
                 problem: ModuleType) -> Pool:
    draw = _drawer(problem, "requests")
    sizes = [int(m) for m in config["sizes"]]
    per = int(traffic["pool"]) // len(sizes)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5E7]))
    As, bs, cs, ks = [], [], [], []
    for m in sizes:
        A, b, c, kind = draw(rng, per, m, config["problem"])
        As.append(A)
        bs.append(b)
        cs.append(c)
        ks.append(kind)
    order = rng.permutation(per * len(sizes))
    return Pool(sizes, per, As, bs, cs, ks, order)


def arrivals(rate: float, n: int, seed: int) -> np.ndarray:
    """Due times (seconds from the start) of ``n`` arrivals at ``rate``."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA77]))
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])
