"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: 35L d7168
56H (GQA kv=8) MoE 128 experts top-2 with a parallel dense-FFN residual
(d_ff=4864).  FSDP is mandatory: 480B bf16 params only fit when sharded
over all 512 chips."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dense_ff=4864,
    fsdp=True,
)
