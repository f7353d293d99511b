"""repro_torch.tune — measured launch geometry for the solver.

Replaces the static tile/chunk heuristics with a *measured* per-device
timing table:

* :mod:`~repro_torch.tune.space` enumerates the valid ``(backend, tile,
  chunk)`` candidates for a shape class (kernel tiles from the Hopper
  kernel's launch geometry);
* :mod:`~repro_torch.tune.runner` times them over representative packed
  batches on the card (warmup, ``torch.cuda.synchronize`` fences,
  median-of-k) and keeps the heuristic's candidate unless another beats
  it beyond the noise band;
* :mod:`~repro_torch.tune.table` persists the winners in a versioned
  JSON :class:`TuningTable` keyed by ``(device_kind, backend, dtype,
  m bucket, batch bucket)``, with load/merge/save.  The bundled
  ``default_table.json`` holds rows measured on an NVIDIA H100 by
  ``scripts/tune_table.py``; no row is a heuristic seed.

Resolution precedence is *explicit > table > heuristic*:
:meth:`repro_torch.solver.SolverSpec.resolve_for_shape` consults the
active table only for fields the user left unset, and a table miss
silently falls back to the static heuristics — tuning can change
performance, never availability.

Regenerate the bundled table on a card with ``python3
scripts/tune_table.py``; pin a table per process with
:func:`set_active_table`/:func:`use_table` or the
``REPRO_TORCH_TUNE_TABLE`` environment variable.
"""
from repro_torch.tune.runner import (TuneResult, candidate_spec, measure,
                                     measure_stats, measure_stats_many,
                                     representative_batch,
                                     results_to_entries, time_candidate,
                                     time_candidate_stats, tune,
                                     tune_shape, winner_entries)
from repro_torch.tune.space import (Candidate, candidate_space,
                                    default_backends, heuristic_candidate)
from repro_torch.tune.table import (SCHEMA_VERSION, TableEntry, TableKey,
                                    TuningTable, active_table, bucket_pow2,
                                    check_round_trip, current_device_kind,
                                    default_table,
                                    device_platform, lookup,
                                    normalize_device_kind, set_active_table,
                                    table_version, use_table)

__all__ = [
    "Candidate", "SCHEMA_VERSION", "TableEntry", "TableKey",
    "TuneResult", "TuningTable", "active_table", "bucket_pow2",
    "candidate_space", "candidate_spec", "check_round_trip",
    "current_device_kind", "default_backends", "default_table",
    "device_platform", "heuristic_candidate", "lookup",
    "measure", "measure_stats", "measure_stats_many",
    "normalize_device_kind",
    "representative_batch", "results_to_entries", "set_active_table",
    "table_version", "time_candidate", "time_candidate_stats", "tune",
    "tune_shape",
    "use_table", "winner_entries",
]
