"""The mesh the port trains on: one card.

Counterpart of ``repro.launch.mesh``.  The reference builds JAX meshes of
``(data, model)`` devices; the port so far trains on one device, so
``make_host_mesh(1, 1)`` is the one mesh it builds, and ``mesh_info`` /
``batch_axes`` answer for it as the reference's do for a 1x1 mesh.
Larger meshes and the production mesh raise: multi-card training over
``torch.distributed`` is a later slice (ROADMAP A9g).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, as_device
from repro_torch.models.common import MeshInfo

_MULTI_CARD = ("multi-card training (FSDP/TP over torch.distributed) is "
               "not ported yet: ROADMAP A9g")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The ``(data, model) = (1, 1)`` mesh: one device."""
    device: torch.device


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        f"the production mesh ({'2x16x16' if multi_pod else '16x16'}): "
        + _MULTI_CARD)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None) -> HostMesh:
    """The one-device mesh on ``device`` (default: the card)."""
    if (data, model) != (1, 1):
        raise NotImplementedError(f"a {data}x{model} mesh: " + _MULTI_CARD)
    return HostMesh(device=as_device(device))


def mesh_info(mesh: HostMesh) -> MeshInfo:
    return MeshInfo(model_axis="model", data_axes=("data",), model_size=1,
                    data_size=1, bound=True)


def batch_axes(mesh: HostMesh, batch: int) -> Optional[Tuple[str, ...]]:
    """The data axes a global batch shards over: with one data shard,
    every batch."""
    return mesh_info(mesh).data_axes
