"""Qwen2-0.5B [arXiv:2407.10671; hf]: 24L d896 14H (GQA kv=2) d_ff=4864
vocab 151936, QKV bias.  14 heads pad to 16 zero-heads for TP-16
(DESIGN.md: zero wq/wo rows keep the function exact)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
)
