"""Optimizer: AdamW on parameter trees, the LP trust-region clip (the
paper's batch solver inside the training step) and int8 error-feedback
gradient compression across pods."""
from repro_torch.optim.adamw import (AdamW, AdamWState, apply_updates,
                                     global_norm, sync_duplicated_grads)
from repro_torch.optim.compress import (compressed_psum, dequantize_int8,
                                        init_error_state, quantize_int8)
from repro_torch.optim.lp_clip import lp_constrain_updates, lp_problems

__all__ = ["AdamW", "AdamWState", "apply_updates", "global_norm",
           "sync_duplicated_grads", "compressed_psum", "dequantize_int8",
           "init_error_state", "quantize_int8", "lp_constrain_updates",
           "lp_problems"]
