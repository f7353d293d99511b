"""repro_torch.tune — measured launch geometry for the solver.

:mod:`~repro_torch.tune.table` persists winning ``(tile, chunk)``
choices in a versioned JSON :class:`TuningTable` keyed by
``(device_kind, backend, dtype, m bucket, batch bucket)``, with
load/merge/save.  The bundled default table is empty: no tuner has run on
an NVIDIA card yet (the candidate space and the timing runner are not
ported), so every lookup misses and resolution falls back to the static
heuristics.

Resolution precedence is *explicit > table > heuristic*:
:meth:`repro_torch.solver.SolverSpec.resolve_for_shape` consults the
active table only for fields the user left unset, and a table miss
silently falls back to the static heuristics — tuning can change
performance, never availability.

Pin a table per process with :func:`set_active_table`/:func:`use_table`
or the ``REPRO_TORCH_TUNE_TABLE`` environment variable.
"""
from repro_torch.tune.table import (SCHEMA_VERSION, TableEntry, TableKey,
                                    TuningTable, active_table, bucket_pow2,
                                    current_device_kind, default_table,
                                    device_platform, lookup,
                                    normalize_device_kind, set_active_table,
                                    use_table)

__all__ = [
    "SCHEMA_VERSION", "TableEntry", "TableKey", "TuningTable",
    "active_table", "bucket_pow2", "current_device_kind", "default_table",
    "device_platform", "lookup", "normalize_device_kind",
    "set_active_table", "use_table",
]
