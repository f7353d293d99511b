"""The meshes the port trains and serves on.

Counterpart of ``repro.launch.mesh``.  The reference lays JAX devices out
as ``(data, model)`` (or ``(pod, data, model)``); the port lays out the
ranks of an initialised ``torch.distributed`` process group the same way,
row-major, one rank a card (:class:`DistMesh`).  Without a process group
the one mesh is :class:`HostMesh`, ``(1, 1)`` on one device, which every
one-card caller uses.  A :class:`RecordingMesh` is one rank of a world of
any size on ``meta``, with no process group: its collectives are recorded,
not issued (the dry run's mesh, where the reference forces 512 host
devices).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 ...

(``init_process_group`` reads torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``; each rank takes card ``LOCAL_RANK % device_count``.)
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.device import DeviceLike, as_device
from repro_torch.models.common import MeshInfo

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The ``(data, model) = (1, 1)`` mesh: one device, no process group."""
    device: torch.device


class _AxesMesh:
    """Named axes laid out row-major over ``world`` ranks (the last axis
    varies fastest, as ``jax.make_mesh`` lays out devices), seen from
    ``rank``: what a :class:`DistMesh` and a :class:`RecordingMesh`
    share."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 rank: int, device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.rank = rank
        self.world = math.prod(self.shape)
        self.coords = tuple(int(c) for c in _unravel(self.rank, self.shape))
        self.device = device

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise KeyError(f"no axis {a!r} in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[self.axis_names.index(a)] > 1)

    def _members(self, axes, coords) -> List[int]:
        """Global ranks sharing ``coords`` off ``axes``, row-major over
        ``axes``."""
        idx = [self.axis_names.index(a) for a in axes]
        out = []
        for sub in itertools.product(*(range(self.shape[i]) for i in idx)):
            c = list(coords)
            for i, v in zip(idx, sub):
                c[i] = v
            out.append(_ravel(c, self.shape))
        return out

    def size(self, axes) -> int:
        """Ranks along ``axes`` (1 for none)."""
        key = self._key(axes)
        return math.prod(self.shape[self.axis_names.index(a)] for a in key)

    def group_ranks(self, axes) -> List[int]:
        """The global ranks of this rank's group over ``axes``, in index
        order."""
        key = self._key(axes)
        return self._members(key, self.coords) if key else [self.rank]

    def index(self, axes) -> int:
        """This rank's index in its group over ``axes`` (``axis_index``)."""
        return self.group_ranks(axes).index(self.rank)

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                    self.shape))
        return (f"{type(self).__name__}({dims}; rank {self.rank} at "
                f"{self.coords}, {self.backend}, {self.device})")


class DistMesh(_AxesMesh):
    """The ranks of the initialised process group as a mesh of named axes,
    with one process group for every set of axes larger than one rank.
    ``device`` is this rank's device."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 device: torch.device):
        world = tdist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                             f"world size {math.prod(shape)}; the process "
                             f"group has {world}")
        super().__init__(axis_names, shape, tdist.get_rank(), device)
        self.backend = str(tdist.get_backend())
        self._groups: Dict[Tuple[str, ...], object] = {}
        live = [a for a, s in zip(self.axis_names, self.shape) if s > 1]
        # every rank creates every group, in the same order
        for r in range(1, len(live) + 1):
            for axes in itertools.combinations(live, r):
                self._groups[axes] = self._make_group(axes)

    def _make_group(self, axes):
        if len(axes) == len([s for s in self.shape if s > 1]):
            return tdist.group.WORLD
        seen, lists = set(), []
        for rank in range(self.world):
            members = self._members(axes, _unravel(rank, self.shape))
            if members[0] not in seen:
                seen.add(members[0])
                lists.append(members)
        group, _ = tdist.new_subgroups_by_enumeration(lists,
                                                      backend=self.backend)
        return group

    def group(self, axes):
        """The process group over ``axes``; ``None`` where it is one rank."""
        key = self._key(axes)
        return self._groups[key] if key else None


class RecordingMesh(_AxesMesh):
    """Rank ``rank`` of a mesh of any size on ``meta``, with
    :class:`DistMesh`'s interface and no process group: ``backend`` is
    ``"record"``, so :mod:`repro_torch.dist` records each collective
    instead of issuing it (``dist.recorded``).  A step built on it runs on
    ``meta`` tensors and allocates nothing."""

    backend = "record"

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 *, rank: int = 0):
        super().__init__(axis_names, shape, rank, torch.device("meta"))
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} is not in a world of "
                             f"{self.world}")

    def group(self, axes):
        """The axes' key where they span more than one rank (what the
        record transport logs), else ``None``."""
        key = self._key(axes)
        return key or None


def _unravel(rank: int, shape) -> List[int]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return out[::-1]


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def rank_device(device: DeviceLike = None) -> torch.device:
    """``device``, or this rank's card: ``LOCAL_RANK % device_count``
    (raises without a card, as every entry point does)."""
    if device is not None:
        return as_device(device)
    as_device(None)  # raises without a card
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_process_group(device: DeviceLike = None, *,
                       backend: Optional[str] = None) -> torch.device:
    """Initialise the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) unless one
    is initialised already; the backend is NCCL for a card and gloo for the
    CPU unless ``backend`` names one.  Returns this rank's device."""
    dev = rank_device(device)
    if not tdist.is_initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        tdist.init_process_group(backend)
    return dev


def _world() -> Optional[int]:
    return tdist.get_world_size() if tdist.is_initialized() else None


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None, record: bool = False):
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods =
    512 ranks with a leading "pod" axis (outer data / hierarchical
    all-reduce axis).  Raises unless the process group has that world;
    ``record=True`` gives rank 0 of it as a :class:`RecordingMesh`
    instead (no process group, no device)."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if record:
        return RecordingMesh(axes, shape)
    need = math.prod(shape)
    world = _world()
    if world != need:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} needs world "
            f"size {need}; " + ("no process group is initialised"
                                if world is None else f"this one has {world}"))
    return DistMesh(axes, shape, rank_device(device))


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None):
    """A ``(data, model)`` mesh over the process group's ranks, which must
    number ``data * model``; without a process group, only ``(1, 1)``: the
    :class:`HostMesh` on ``device`` (default: the card)."""
    world = _world()
    if world is None:
        if (data, model) != (1, 1):
            raise ValueError(
                f"a {data}x{model} mesh needs world size {data * model}; no "
                f"process group is initialised (torchrun --nproc-per-node "
                f"{data * model}, then init_process_group())")
        return HostMesh(device=as_device(device))
    return DistMesh(("data", "model"), (data, model), rank_device(device))


def mesh_info(mesh) -> MeshInfo:
    if isinstance(mesh, HostMesh):
        return MeshInfo(model_axis="model", data_axes=("data",),
                        model_size=1, data_size=1, bound=True)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    data_axes = tuple(n for n in mesh.axis_names if n != "model")
    return MeshInfo(model_axis="model", data_axes=data_axes,
                    model_size=sizes.get("model", 1),
                    data_size=math.prod(sizes[n] for n in data_axes),
                    bound=True, mesh=mesh)


def batch_axes(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """The data axes a global batch can shard over (None -> replicate,
    e.g. batch=1 long-context decode)."""
    mi = mesh_info(mesh)
    if batch % mi.data_size == 0:
        return mi.data_axes
    # try the innermost data axis alone (e.g. batch 16 on a 2x16 data mesh)
    last = mi.data_axes[-1]
    size = dict(zip(mesh.axis_names, mesh.shape))[last]
    if batch % size == 0:
        return (last,)
    return None
