"""Mamba2-1.3B [arXiv:2405.21060]: 48L d2048 attention-free SSD,
ssm_state=128, expand=2 (d_inner 4096, 64 heads of 64), vocab 50280."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)
