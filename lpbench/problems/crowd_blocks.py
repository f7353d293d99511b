"""RVO2's ``Blocks`` layout (``examples/Blocks.cpp``), scaled: four groups
of ``side`` x ``side`` agents at ``spacing`` metres, their inner corners at
``(+-corner, +-corner)``, added in Blocks' order (row ``i``, column ``j``,
then the four groups).  Each agent's goal is the opposite of its start,
so each group crosses to the opposite corner in formation, and each gets
a fixed perturbation of its preferred direction: an angle uniform on
``[0, 2 pi)`` and a length uniform on ``[0, perturbation]``, drawn from the
seed as Blocks draws them from ``rand()``.

``spawn`` gives ``(pos, goal, eps)``, float32 ``(N, 2)`` on the CPU; the
configuration's ``problem`` holds ``side``, ``spacing``, ``corner`` and
``perturbation``.
"""
from __future__ import annotations

import math

import torch

# Blocks' four groups: the signs of their corners, in the order it adds
# them.
GROUPS = ((1, 1), (-1, 1), (1, -1), (-1, -1))


def spawn(params: dict, seed: int):
    side = int(params["side"])
    spacing = float(params["spacing"])
    corner = float(params["corner"])
    pos = []
    for i in range(side):
        for j in range(side):
            for sx, sy in GROUPS:
                pos.append((sx * (corner + i * spacing),
                            sy * (corner + j * spacing)))
    pos = torch.tensor(pos, dtype=torch.float64)
    g = torch.Generator().manual_seed(int(seed))
    n = pos.shape[0]
    angle = torch.rand(n, generator=g, dtype=torch.float64) * 2 * math.pi
    length = torch.rand(n, generator=g, dtype=torch.float64) * float(
        params["perturbation"])
    eps = torch.stack([length * torch.cos(angle),
                       length * torch.sin(angle)], dim=1)
    return pos.float(), (-pos).float(), eps.float()
