"""Core batch 2-D LP library (the paper's contribution, in PyTorch)."""
from repro_torch.core.lp import (
    LPBatch,
    LPSolution,
    adversarial_lp,
    batch_from_numpy,
    concat_batches,
    infeasible_lp,
    make_batch,
    normalize_batch,
    pad_batch,
    pad_batch_dim,
    ragged_feasible_lp,
    random_feasible_lp,
    replicated_lp,
    shuffle_batch,
    split_batch,
)
from repro_torch.core.packed import (
    PackedLPBatch,
    concat_packed,
    normalize_packed,
    pack,
    pack_call_count,
    packed_from_numpy,
    pad_packed,
    pad_packed_batch_dim,
    shuffle_packed,
    split_packed,
    unpack,
)
from repro_torch.core.seidel import (solve_naive, solve_naive_packed, solve_rgb,
                               solve_rgb_packed)

__all__ = [
    "LPBatch", "LPSolution", "PackedLPBatch", "adversarial_lp",
    "batch_from_numpy",
    "concat_batches", "concat_packed", "infeasible_lp", "make_batch",
    "normalize_batch", "normalize_packed", "pack", "pack_call_count",
    "packed_from_numpy",
    "pad_batch", "pad_batch_dim", "pad_packed", "pad_packed_batch_dim",
    "ragged_feasible_lp", "random_feasible_lp", "replicated_lp",
    "shuffle_batch", "shuffle_packed", "split_batch", "split_packed",
    "solve_naive", "solve_naive_packed", "solve_rgb",
    "solve_rgb_packed", "unpack",
]
