"""The bytes a crowd step's LP build needs: the roofline side of
``crowd_build_roofline.lps``, kept with the benchmark so that it counts the
same work whatever implements the build (torch operations today, a
hand-written kernel later).

Each agent's state is read once: position, velocity, goal and
perturbation, two values each.  Its LP is written once: three values
(``a_x``, ``a_y``, ``b``) a row it holds, counted from ``m_valid`` and not
from the padding, its objective ``c`` and its ``m_valid`` (int32).  The
neighbour search's own traffic is the build's business, as a kernel's
re-reads are in :mod:`lpbench.peaks`.
"""
from __future__ import annotations

from lpbench.peaks import ITEMSIZE

STATE_VALUES = 4 * 2   # position, velocity, goal, perturbation


def build_bytes(n_agents: int, rows: float, dtype: str) -> float:
    """Bytes of one step's build: ``n_agents`` states in, ``rows``
    (the sum of ``m_valid``) rows and each agent's ``c`` and ``m_valid``
    out."""
    item = ITEMSIZE[dtype]
    return n_agents * (STATE_VALUES * item + 2 * item + 4) + 3 * rows * item
