"""The model families of the JAX package, in PyTorch, on one card or as one
rank's shards of a mesh: the decoder LM (dense, MoE, VLM), the
encoder-decoder, the Mamba2 LM and the hybrid."""
from repro_torch.models.common import (HeadLayout, MeshInfo, ModelConfig,
                                       head_layout)
from repro_torch.models.transformer import (DecoderLM, EncDecLM, HybridLM,
                                            SSMLM, build_model,
                                            params_from_numpy,
                                            params_to_numpy, shard_params,
                                            unshard_params)

__all__ = ["HeadLayout", "MeshInfo", "ModelConfig", "head_layout",
           "DecoderLM", "EncDecLM", "SSMLM", "HybridLM", "build_model",
           "params_from_numpy", "params_to_numpy", "shard_params",
           "unshard_params"]
