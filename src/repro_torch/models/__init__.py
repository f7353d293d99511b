"""The attention-based model families of the JAX package, in PyTorch (one
card): the decoder LM (dense, MoE, VLM) and the encoder-decoder."""
from repro_torch.models.common import (HeadLayout, MeshInfo, ModelConfig,
                                       head_layout)
from repro_torch.models.transformer import (DecoderLM, EncDecLM, build_model,
                                            params_from_numpy,
                                            params_to_numpy)

__all__ = ["HeadLayout", "MeshInfo", "ModelConfig", "head_layout",
           "DecoderLM", "EncDecLM", "build_model", "params_from_numpy",
           "params_to_numpy"]
