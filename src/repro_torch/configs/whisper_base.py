"""Whisper-base [arXiv:2212.04356]: enc-dec, 6+6L d512 8H d_ff=2048
vocab 51865.  The conv audio frontend is a STUB per the brief:
input_specs() provides precomputed frame embeddings (B, enc_seq, d)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,       # decoder layers
    enc_layers=6,
    enc_seq=1504,     # whisper's 1500 frames, padded to a flash-chunk mult
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_ff=2048,
    vocab=51865,
    qkv_bias=True,
)
