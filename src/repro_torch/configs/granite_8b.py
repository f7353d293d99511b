"""Granite-8B code [arXiv:2405.04324; hf]: llama-arch 36L d4096 32H
(GQA kv=8) d_ff=14336 vocab 49152."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=49152,
    fsdp=True,
)
