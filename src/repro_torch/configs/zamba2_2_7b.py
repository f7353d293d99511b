"""Zamba2-2.7B [arXiv:2411.15242; hf]: 54 Mamba2 layers d2560
(ssm_state=64, d_inner 5120, 80 heads of 64) + one SHARED attention+MLP
block (32H GQA kv=32, d_ff=10240) applied every 6 layers."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_period=6,
)
