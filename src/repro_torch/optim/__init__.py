"""Optimizer: AdamW on parameter trees and the LP trust-region clip (the
paper's batch solver inside the training step).  ``optim.compress`` (int8
error-feedback compression across pods) belongs to multi-card training,
a later slice (ROADMAP A9g)."""
from repro_torch.optim.adamw import (AdamW, AdamWState, apply_updates,
                                     global_norm, sync_duplicated_grads)
from repro_torch.optim.lp_clip import lp_constrain_updates, lp_problems

__all__ = ["AdamW", "AdamWState", "apply_updates", "global_norm",
           "sync_duplicated_grads", "lp_constrain_updates", "lp_problems"]
