"""The dense decoder LM of the JAX package, in PyTorch (one card)."""
from repro_torch.models.common import (HeadLayout, MeshInfo, ModelConfig,
                                       head_layout)
from repro_torch.models.transformer import (DecoderLM, build_model,
                                            params_from_numpy,
                                            params_to_numpy)

__all__ = ["HeadLayout", "MeshInfo", "ModelConfig", "head_layout",
           "DecoderLM", "build_model", "params_from_numpy",
           "params_to_numpy"]
