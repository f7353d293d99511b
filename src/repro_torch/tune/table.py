"""Persisted per-device timing tables — the measurement artifact that
replaces launch-geometry guessing.

A :class:`TuningTable` maps a :class:`TableKey` — ``(device_kind,
backend, dtype, m_bucket, batch_bucket)`` — to the fastest measured
``(tile, chunk)`` for that shape class, together with the measurement
statistics ``(us_per_lp median, us_iqr, k repetitions)`` so merges can
tell a real improvement from timing noise.  Shape dimensions are
bucketed on the same geometric ladders the serving layer uses (double
from a small base), so one entry covers every shape that lands in its
bucket and the table stays a few dozen rows per device.

Tables serialise to versioned JSON (:meth:`TuningTable.save` /
:meth:`TuningTable.load`), merge monotonically with a noise dead zone
(a new entry wins only when faster by more than the larger of the two
IQRs, so re-running the tuner can only genuinely improve the table),
and ship with a bundled default (``default_table.json``).  The port's
bundled table holds rows measured on an NVIDIA H100 by
``scripts/tune_table.py``, keyed by that card's name; no timing taken on
another kind of device carries over, so elsewhere every lookup misses.
Rows written before the stats slice load unchanged —
``us_iqr``/``k`` default to ``0.0``/``1`` (no spread recorded).

The process-wide *active table* is what
:meth:`repro_torch.solver.SolverSpec.resolve_for_shape` consults.  It is the
bundled default, optionally overlaid with the file named by the
``REPRO_TORCH_TUNE_TABLE`` environment variable; tests and callers can pin a
specific table with :func:`set_active_table` or the :func:`use_table`
context manager.  A lookup miss is never an error — resolution falls
back to the static heuristics.  :func:`table_version` counts every change
of what resolution reads (a table swapped in, a ``put`` or ``merge`` into
the active one), so a cache of resolved shapes can key on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

SCHEMA_VERSION = 1

# Bucketing bases: m doubles from 8 (the dense serving ladder; kernel
# shapes land on 128+ rungs of the same ladder), batch doubles from 8.
M_BUCKET_BASE = 8
BATCH_BUCKET_BASE = 8

# Environment override: a JSON table merged over the bundled default.
ENV_TABLE_VAR = "REPRO_TORCH_TUNE_TABLE"

_DEFAULT_TABLE_PATH = Path(__file__).with_name("default_table.json")


def bucket_pow2(x: int, base: int) -> int:
    """Round ``x`` up the geometric ladder {base, 2*base, 4*base, ...}."""
    if x < 1:
        raise ValueError(f"bucket_pow2({x}): need x >= 1")
    b = base
    while b < x:
        b *= 2
    return b


def normalize_device_kind(kind: str) -> str:
    """Canonical table key form of a device name string (lower-case,
    spaces/underscores collapsed to dashes):
    ``"NVIDIA H100 80GB HBM3" -> "nvidia-h100-80gb-hbm3"``."""
    return "-".join(str(kind).lower().replace("_", " ").split())


def device_platform(kind: str) -> str:
    """The platform family of a (normalized) device kind — the fallback
    lookup key that lets one "cpu"/"gpu" row cover every model of the
    family.  CUDA device names do not start with their family
    (``torch.cuda.get_device_name`` gives ``"NVIDIA H100 80GB HBM3"``),
    so an ``nvidia-…`` name maps to ``"gpu"``."""
    k = normalize_device_kind(kind)
    for fam in ("tpu", "gpu", "cpu"):
        if k.startswith(fam):
            return fam
    if k.startswith("nvidia") or k.startswith("cuda"):
        return "gpu"
    # Anything unrecognised keys on its own normalized name only.
    return k


def current_device_kind() -> str:
    """Normalized name of the first CUDA device
    (``torch.cuda.get_device_name(0)``), or ``"cpu"`` when there is none
    — a table key, not a place to run."""
    import torch  # deferred so table manipulation needs no backend
    if torch.cuda.is_available():
        return normalize_device_kind(torch.cuda.get_device_name(0))
    return "cpu"


@dataclasses.dataclass(frozen=True)
class TableKey:
    """Everything a timing record is conditioned on."""

    device_kind: str   # normalized (see normalize_device_kind)
    backend: str       # "naive" | "rgb" | "kernel" | "pdhg"
    dtype: str         # "float32" | "float64"
    m_bucket: int      # bucket_pow2(m_pad, M_BUCKET_BASE)
    batch_bucket: int  # bucket_pow2(batch, BATCH_BUCKET_BASE); 0 = any

    def __post_init__(self):
        object.__setattr__(self, "device_kind",
                           normalize_device_kind(self.device_kind))


@dataclasses.dataclass(frozen=True)
class TableEntry:
    """One measured (or seeded) winning configuration.

    For ``backend="pdhg"`` rows the ``(tile, chunk)`` slots carry the
    iteration schedule ``(iter_block, restart_period)`` — same shape,
    same validation (``iter_block >= 1``, ``restart_period >= 0``), no
    schema bump; ``SolverSpec.resolve_for_shape`` reads them back into
    the pdhg knobs."""

    key: TableKey
    tile: int
    chunk: int
    us_per_lp: float          # measured median microseconds per LP
    source: str = "measured"  # "measured" | "heuristic-seed"
    us_iqr: float = 0.0       # interquartile range of the µs/LP samples
    k: int = 1                # timing repetitions behind the median

    def __post_init__(self):
        if self.tile < 1:
            raise ValueError(f"tile={self.tile} < 1")
        if self.chunk < 0:
            raise ValueError(f"chunk={self.chunk} < 0")
        if not self.us_per_lp >= 0.0:
            raise ValueError(f"us_per_lp={self.us_per_lp} must be >= 0")
        if not self.us_iqr >= 0.0:
            raise ValueError(f"us_iqr={self.us_iqr} must be >= 0")
        if self.k < 1:
            raise ValueError(f"k={self.k} < 1")

    @property
    def noise_band_us(self) -> float:
        """The spread below which two medians of this entry are
        statistically indistinguishable (its IQR; 0 for single-shot
        or seeded entries — they carry no spread information)."""
        return self.us_iqr


class TuningTable:
    """An in-memory set of timing records with JSON persistence.

    ``put`` overwrites; ``merge`` keeps the faster record per key, so
    ``table.merge(rerun)`` is monotone — stale slow entries can only be
    replaced by better measurements.
    """

    def __init__(self, entries: Iterable[TableEntry] = ()):
        self._entries: Dict[TableKey, TableEntry] = {}
        for e in entries:
            self.put(e)

    def __len__(self) -> int:
        return len(self._entries)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TuningTable)
                and self._entries == other._entries)

    def entries(self) -> List[TableEntry]:
        return sorted(
            self._entries.values(),
            key=lambda e: dataclasses.astuple(e.key))

    def put(self, entry: TableEntry) -> None:
        self._entries[entry.key] = entry
        _changed(self)

    def get(self, key: TableKey) -> Optional[TableEntry]:
        return self._entries.get(key)

    def merge(self, other: "TuningTable") -> "TuningTable":
        """Fold ``other`` into this table in place; returns self for
        chaining.

        A new entry wins only when it is faster *beyond the noise
        band* — the larger of the two entries' recorded IQRs — so
        re-running the tuner on a noisy machine cannot churn the table
        with statistically meaningless "improvements" (merge stays
        monotone in measured speed, now with a dead zone).  Two
        exceptions keep the table honest: a measured entry always
        replaces a heuristic seed (seeds carry sentinel timings, not
        measurements), and a seed never replaces a measurement."""
        for key, entry in other._entries.items():
            mine = self._entries.get(key)
            if mine is None:
                self._entries[key] = entry
                continue
            if entry.source == "heuristic-seed":
                if mine.source == "heuristic-seed" \
                        and entry.us_per_lp < mine.us_per_lp:
                    self._entries[key] = entry
                continue
            if mine.source == "heuristic-seed":
                self._entries[key] = entry
                continue
            band = max(entry.noise_band_us, mine.noise_band_us)
            if entry.us_per_lp < mine.us_per_lp - band:
                self._entries[key] = entry
        _changed(self)
        return self

    # -- lookup ----------------------------------------------------------

    def lookup(self, *, backend: str, dtype: str, m: int,
               batch: Optional[int] = None,
               device_kind: Optional[str] = None) -> Optional[TableEntry]:
        """Best recorded config for a shape class, or None (a miss is
        the caller's cue to fall back to heuristics, never an error).

        Tries the exact device kind first, then its platform family
        ("nvidia-h100-80gb-hbm3" -> "gpu"); within a device, the exact batch bucket
        first, then the batch-wildcard rung (batch_bucket=0).
        """
        if device_kind is None:
            device_kind = current_device_kind()
        device_kind = normalize_device_kind(device_kind)
        mb = bucket_pow2(m, M_BUCKET_BASE)
        bbs = ([bucket_pow2(batch, BATCH_BUCKET_BASE)]
               if batch is not None else [])
        bbs.append(0)
        kinds = [device_kind]
        fam = device_platform(device_kind)
        if fam != device_kind:
            kinds.append(fam)
        for kind in kinds:
            for bb in bbs:
                hit = self._entries.get(TableKey(
                    device_kind=kind, backend=backend, dtype=dtype,
                    m_bucket=mb, batch_bucket=bb))
                if hit is not None:
                    return hit
        return None

    def lookup_best_backend(self, *, dtype: str, m: int,
                            batch: Optional[int] = None,
                            device_kind: Optional[str] = None,
                            backends: Iterable[str] = ("naive", "rgb",
                                                       "kernel", "pdhg"),
                            ) -> Optional[TableEntry]:
        """Fastest recorded entry across backends for a shape class —
        what ``backend="auto"`` resolution uses when measurements
        exist."""
        hits = [e for e in (self.lookup(backend=b, dtype=dtype, m=m,
                                        batch=batch,
                                        device_kind=device_kind)
                            for b in backends) if e is not None]
        if not hits:
            return None
        return min(hits, key=lambda e: e.us_per_lp)

    # -- persistence -----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "version": SCHEMA_VERSION,
            "entries": [
                {**dataclasses.asdict(e.key), "tile": e.tile,
                 "chunk": e.chunk, "us_per_lp": e.us_per_lp,
                 "source": e.source, "us_iqr": e.us_iqr, "k": e.k}
                for e in self.entries()
            ],
        }

    @classmethod
    def from_json(cls, doc: dict) -> "TuningTable":
        version = doc.get("version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"tuning table schema version {version!r} != "
                f"{SCHEMA_VERSION}; regenerate with the tuner")
        entries = []
        for row in doc.get("entries", []):
            row = dict(row)
            key = TableKey(
                device_kind=row.pop("device_kind"),
                backend=row.pop("backend"), dtype=row.pop("dtype"),
                m_bucket=int(row.pop("m_bucket")),
                batch_bucket=int(row.pop("batch_bucket")))
            # us_iqr/k default for rows written before the stats slice
            # (same version: old tables load, their entries just carry
            # no spread and merge with a zero noise band).
            entries.append(TableEntry(
                key=key, tile=int(row["tile"]), chunk=int(row["chunk"]),
                us_per_lp=float(row["us_per_lp"]),
                source=str(row.get("source", "measured")),
                us_iqr=float(row.get("us_iqr", 0.0)),
                k=int(row.get("k", 1))))
        return cls(entries)

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=2,
                                   sort_keys=True) + "\n")
        return path

    @classmethod
    def load(cls, path) -> "TuningTable":
        return cls.from_json(json.loads(Path(path).read_text()))


def check_round_trip(table: TuningTable) -> None:
    """Raise ``ValueError`` unless ``table`` survives save -> load ->
    merge unchanged, to the byte of its JSON (the table contract the
    reference's ``benchmarks/tune_cli.py`` asserts)."""
    with tempfile.TemporaryDirectory() as td:
        p1 = table.save(Path(td) / "t1.json")
        loaded = TuningTable.load(p1)
        if loaded != table:
            raise ValueError("save -> load changed the table")
        merged = TuningTable().merge(loaded).merge(table)
        if merged != table:
            raise ValueError("merge is not idempotent")
        p2 = merged.save(Path(td) / "t2.json")
        if p2.read_text() != p1.read_text():
            raise ValueError("round-tripped JSON differs")


# -- the process-wide active table ----------------------------------------

_lock = threading.Lock()
_active: Optional[TuningTable] = None
_version = 0


def table_version() -> int:
    """A number that changes whenever what :func:`active_table` resolves
    against may have: a table set or swapped in (:func:`set_active_table`,
    :func:`use_table` on entry and exit), or a ``put`` or ``merge`` into
    the active table.  It never repeats within a process."""
    return _version


def _changed(table: Optional[TuningTable]) -> None:
    """Bump the version if ``table`` is the active one."""
    global _version
    if table is _active:
        with _lock:
            _version += 1


def default_table() -> TuningTable:
    """The bundled table (fresh copy; missing/corrupt file -> empty)."""
    try:
        return TuningTable.load(_DEFAULT_TABLE_PATH)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return TuningTable()


def _initial_table() -> TuningTable:
    table = default_table()
    env_path = os.environ.get(ENV_TABLE_VAR)
    if env_path:
        try:
            table.merge(TuningTable.load(env_path))
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            pass  # a broken override must never take the solver down
    return table


def active_table() -> TuningTable:
    """The table solver resolution consults (lazily initialised to the
    bundled default + ``REPRO_TORCH_TUNE_TABLE`` overlay)."""
    global _active
    with _lock:
        if _active is None:
            _active = _initial_table()
        return _active


def set_active_table(table: Optional[TuningTable]) -> None:
    """Pin the process-wide table (``None`` resets to lazy default).

    The solver's launch plans key on :func:`table_version`, which this
    bumps, so a change takes effect at the next solve.
    """
    global _active, _version
    with _lock:
        _active = table
        _version += 1


@contextlib.contextmanager
def use_table(table: Optional[TuningTable]):
    """Scoped :func:`set_active_table` (restores the previous table)."""
    global _active, _version
    with _lock:
        prev = _active
        _active = table
        _version += 1
    try:
        yield table
    finally:
        with _lock:
            _active = prev
            _version += 1


def lookup(*, backend: str, dtype: str, m: int,
           batch: Optional[int] = None,
           device_kind: Optional[str] = None) -> Optional[TableEntry]:
    """Module-level convenience over ``active_table().lookup``."""
    return active_table().lookup(backend=backend, dtype=dtype, m=m,
                                 batch=batch, device_kind=device_kind)
