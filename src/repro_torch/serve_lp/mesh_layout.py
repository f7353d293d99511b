"""MeshLayout: how a flush's packed rows map onto a device mesh.

The serving layer packs every flush into SoA buffers ``(L (B, 4, m_pad),
c (B, 2), mv (B, 1))`` whose leading axis is *problems*.  Batch LP is
embarrassingly parallel across that axis, so sharding a flush is purely
a layout question: which contiguous row range does each device own?
This module answers it with a tiny size/stride layout algebra (in the
CuTe spirit: a layout is shapes + strides mapping logical coordinates
to offsets) instead of the single implicit answer "split evenly over
all local devices".

:func:`plan_layout` turns ``(rows, tile, n_devices)`` into a
:class:`MeshLayout`:

* **padding is owned here** — ``rows`` is rounded up to a whole number
  of kernel tiles (``b_pad``), never to a whole number of
  ``tile * n_devices`` blocks, so a prime-sized flush on 4 devices is
  legal and costs at most ``tile - 1`` pad rows;
* **shards may be uneven** — tile-units are dealt round-robin, so
  devices get ``q`` or ``q + 1`` tiles each and devices past the tile
  count get zero rows (an underfull flush simply doesn't use them);
* **launches are grouped** — consecutive devices with equal shard
  sizes form one :class:`LaunchGroup`, dispatched together over a
  contiguous run of devices (one kernel launch per member device, each
  on its own stream).  The q/q+1 deal means a layout never needs more
  than two groups (an even split would instead *pad* to the worst
  device).

Devices
-------
A "mesh" here is a plain list of :class:`torch.device`; the reference's
``make_mesh`` (a 1-D JAX mesh) has no counterpart.  Layouts are 1-D over
the :data:`DATA_AXIS` ("data") axis of local devices; :data:`HOST_AXIS`
stays reserved for a multi-host extension (rows dealt to hosts first).
Nothing in the planner assumes a single host: shards are plain
per-device row counts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

# Mesh axis names.  DATA_AXIS is the (only) axis current layouts shard
# over; HOST_AXIS is reserved for the documented multi-host extension.
DATA_AXIS = "data"
HOST_AXIS = "hosts"


@dataclasses.dataclass(frozen=True)
class LaunchGroup:
    """A contiguous run of devices with identical shard sizes — one
    dispatch over a run of devices.

    ``start`` is the first device index, ``n_devices`` the sub-mesh
    width, ``rows_per_device`` the (even, by construction) rows each
    member owns, and ``offset`` the global row offset of the group's
    slice ``[offset, offset + rows)``.
    """

    start: int
    n_devices: int
    rows_per_device: int
    offset: int

    @property
    def rows(self) -> int:
        return self.n_devices * self.rows_per_device

    @property
    def sizes(self) -> Tuple[int, int]:
        """Layout shape ``(device, row)`` of the group."""
        return (self.n_devices, self.rows_per_device)

    @property
    def strides(self) -> Tuple[int, int]:
        """Strides mapping a ``(device, row)`` coordinate to a global
        row: ``offset + d * rows_per_device + r``."""
        return (self.rows_per_device, 1)

    @property
    def device_indices(self) -> Tuple[int, ...]:
        """The global device indices this group's launch runs on —
        what a per-launch ``device.solve`` span reports as its device
        track membership."""
        return tuple(range(self.start, self.start + self.n_devices))


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Per-device row counts for one flush, plus the derived launch
    plan.  ``shards[i]`` is the number of packed rows device ``i``
    owns; zeros are legal (the device takes no part in the flush).
    Every shard is a whole number of ``tile``-row kernel tiles.
    """

    shards: Tuple[int, ...]
    tile: int

    def __post_init__(self):
        if self.tile < 1:
            raise ValueError(f"tile={self.tile} < 1")
        if not self.shards:
            raise ValueError("layout needs at least one device")
        for i, s in enumerate(self.shards):
            if s < 0 or s % self.tile:
                raise ValueError(
                    f"shard[{i}]={s} is not a non-negative multiple of "
                    f"tile={self.tile}")
        if sum(self.shards) < 1:
            raise ValueError("layout carries zero rows")

    @property
    def b_pad(self) -> int:
        """Total padded rows the layout carries."""
        return sum(self.shards)

    @property
    def n_devices(self) -> int:
        return len(self.shards)

    @property
    def used_devices(self) -> int:
        return sum(1 for s in self.shards if s)

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Global row offset of each device's slice (exclusive scan)."""
        out, acc = [], 0
        for s in self.shards:
            out.append(acc)
            acc += s
        return tuple(out)

    @property
    def groups(self) -> Tuple[LaunchGroup, ...]:
        """Consecutive equal-sized non-empty shards, merged: the
        launch plan.  The q/q+1 deal in :func:`plan_layout` guarantees
        at most two groups."""
        groups: List[LaunchGroup] = []
        offsets = self.offsets
        i = 0
        while i < len(self.shards):
            s = self.shards[i]
            if s == 0:
                i += 1
                continue
            j = i
            while j + 1 < len(self.shards) and self.shards[j + 1] == s:
                j += 1
            groups.append(LaunchGroup(
                start=i, n_devices=j - i + 1, rows_per_device=s,
                offset=offsets[i]))
            i = j + 1
        return tuple(groups)

    @property
    def n_launches(self) -> int:
        return len(self.groups)

    def global_row(self, device: int, local_row: int) -> int:
        """Apply the layout: map a ``(device, local_row)`` coordinate
        to the global packed-row index."""
        if not 0 <= device < len(self.shards):
            raise IndexError(f"device {device} out of range")
        if not 0 <= local_row < self.shards[device]:
            raise IndexError(
                f"row {local_row} out of range for shard of "
                f"{self.shards[device]}")
        return self.offsets[device] + local_row

    def pad_rows(self, rows: int) -> int:
        """Pad rows the layout adds on top of ``rows`` real rows."""
        return self.b_pad - rows

    def describe(self) -> str:
        """One-line human layout, e.g. ``64 rows = [16 16 16 16] @
        tile=16, 1 launch``."""
        shard_s = " ".join(str(s) for s in self.shards)
        n = self.n_launches
        return (f"{self.b_pad} rows = [{shard_s}] @ tile={self.tile}, "
                f"{n} launch{'es' if n != 1 else ''}")


def plan_layout(rows: int, tile: int, n_devices: int) -> MeshLayout:
    """Plan how ``rows`` packed problems (real + any bucket padding the
    caller already applied) spread over ``n_devices`` devices.

    The planner owns padding: ``rows`` is rounded up to whole
    ``tile``-row units — *not* to ``tile * n_devices`` — then the tile
    units are dealt over ``min(n_devices, n_tiles)`` devices as ``q``
    or ``q + 1`` tiles each (larger shards first, so group boundaries
    are contiguous).  Devices beyond the tile count get zero rows.
    """
    if rows < 1:
        raise ValueError(f"rows={rows} < 1")
    if tile < 1:
        raise ValueError(f"tile={tile} < 1")
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} < 1")
    n_tiles = -(-rows // tile)
    k = min(n_devices, n_tiles)
    q, r = divmod(n_tiles, k)
    shards = tuple(
        ((q + 1) * tile if i < r else q * tile) if i < k else 0
        for i in range(n_devices))
    return MeshLayout(shards=shards, tile=tile)
