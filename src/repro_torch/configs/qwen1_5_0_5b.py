"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: 24L d1024 16H (GQA kv=16)
d_ff=2816 vocab 151936, QKV bias (MHA)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
)
