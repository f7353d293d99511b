"""PaliGemma-3B [arXiv:2407.07726; hf]: gemma backbone 18L d2048 8H
(GQA kv=1, head_dim 256) d_ff=16384 vocab 257216; SigLIP vision frontend
is a STUB (input_specs() provides 256 precomputed patch embeddings) with
prefix-LM masking over the patch prefix."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    gelu_glu=True,
    embed_scale=True,
    n_prefix=256,
)
