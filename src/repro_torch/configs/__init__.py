"""Architecture registry, input shapes, meta-tensor input stand-ins and
reduced smoke configs for the 10 assigned architectures.

The same data as ``repro.configs``: ``ARCHS``, ``SHAPES``, ``applicable``
and ``smoke_config`` are identical; ``input_specs`` returns
``torch.empty(..., device="meta")`` stand-ins (shape and dtype, no
allocation) where the reference returns ``jax.ShapeDtypeStruct``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.common import ModelConfig

from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen15
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _olmoe, _arctic, _granite, _qwen2, _internlm2, _qwen15,
        _whisper, _mamba2, _zamba2, _paligemma,
    )
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k needs sub-quadratic sequence mixing: run for SSM/hybrid,
    skip for pure full-attention archs (DESIGN.md section 4)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input: shape and dtype, no
    device allocation."""
    B = batch if batch is not None else shape.batch
    S = shape.seq
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)
    d = cfg.d_model

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {
            "token": spec((B, 1), i32),
            "pos": spec((B,), i32),
        }

    specs: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        s_text = S - cfg.n_prefix
        specs["tokens"] = spec((B, s_text), i32)
        specs["patches"] = spec((B, cfg.n_prefix, d), act)
        if shape.kind == "train":
            specs["labels"] = spec((B, s_text), i32)
    elif cfg.family == "encdec":
        specs["tokens"] = spec((B, S), i32)
        specs["frames"] = spec((B, cfg.enc_seq, d), act)
        if shape.kind == "train":
            specs["labels"] = spec((B, S), i32)
    else:
        specs["tokens"] = spec((B, S), i32)
        if shape.kind == "train":
            specs["labels"] = spec((B, S), i32)
    return specs


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny embedding tables."""
    common = dict(n_layers=2, d_model=64, vocab=257, fsdp=False)
    if cfg.family in ("dense", "vlm"):
        kw = dict(common, n_heads=4, n_kv=min(max(cfg.n_kv, 1), 2),
                  d_ff=96, head_dim=16 if cfg.head_dim else 0)
        if cfg.family == "vlm":
            kw["n_prefix"] = 8
        return dataclasses.replace(cfg, **kw)
    if cfg.family == "moe":
        return dataclasses.replace(
            cfg, **common, n_heads=4, n_kv=2, d_ff=48, n_experts=8,
            top_k=2, moe_dense_ff=32 if cfg.moe_dense_ff else 0)
    if cfg.family == "encdec":
        return dataclasses.replace(
            cfg, **common, enc_layers=2, enc_seq=16, n_heads=4, n_kv=4,
            d_ff=96)
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, **common, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=4, d_model=64, vocab=257, fsdp=False,
            n_heads=4, n_kv=4, d_ff=96, ssm_state=16, ssm_head_dim=16,
            ssm_chunk=16, hybrid_period=2)
    raise ValueError(cfg.family)


SMOKE_SHAPE = InputShape("smoke", "train", 32, 2)
