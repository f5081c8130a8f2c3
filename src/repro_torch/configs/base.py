"""Config system: one frozen dataclass per architecture, explicit segments.

The port's copy of the reference's ``configs/base.py``, without its
``jax.numpy`` import.  A model is a stack of *segments*; each segment is
a repeating unit of layer specs run ``repeats`` times.  ``LayerSpec``
picks the sequence mixer (attn / mla / mamba / rwkv) and the MLP kind
(dense / moe / rwkv_cmix) per layer.  The field names and defaults are
the reference's, so a config compares field for field across the two
packages.

This slice of the port serves ``smollm-135m`` only: :func:`load_config`
raises for any other architecture.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

import torch

Mixer = Literal["attn", "mla", "mamba", "rwkv"]
MLPKind = Literal["dense", "moe", "rwkv_cmix"]

#: architectures whose config module the port carries
PORTED_ARCHS = ("smollm-135m",)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    mlp: MLPKind = "dense"


@dataclasses.dataclass(frozen=True)
class Segment:
    unit: tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.unit) * self.repeats


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_fn: str = "softmax"
    normalize_weights: bool = True
    dispatch_dtype: str = "bf16"
    route_groups: int = 0
    route_device_limit: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int = 0
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0
    scan_impl: str = "sequential"
    chunk: int = 16


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // num_heads
    segments: tuple[Segment, ...] = ()
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    attention: str = "gqa"            # "gqa" | "mla"
    attn_impl: str = "auto"           # "auto" | "full" | "chunked" | "pallas"
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "silu"
    rope_theta: float = 1e4
    parallel_block: bool = False      # Cohere-style attn ∥ mlp
    tie_embeddings: bool = False
    frontend_stub: bool = False       # audio/vlm: inputs are embeddings
    rwkv_heads: int = 0
    rwkv_decay_lora: int = 64
    dtype: str = "bfloat16"
    mtp_depth: int = 0                # DeepSeek multi-token-prediction heads
    source: str = ""                  # citation tag
    mla_absorbed: bool = False        # absorbed MLA decode (latent-space)
    kv_cache_dtype: str = "bf16"      # "bf16" | "int8" quantized KV cache
    remat: bool = False               # activation checkpointing per layer

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if not self.segments:
            object.__setattr__(
                self, "segments",
                (Segment(unit=(LayerSpec(),), repeats=self.num_layers),))
        total = sum(s.num_layers for s in self.segments)
        if total != self.num_layers:
            raise ValueError(f"{self.name}: segments cover {total} != "
                             f"{self.num_layers}")

    @property
    def torch_dtype(self) -> torch.dtype:
        """The parameters' and activations' dtype (the reference's
        ``np_dtype``)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def load_config(arch: str) -> ModelConfig:
    """``repro_torch/configs/<arch>.py``'s CONFIG (dashes → underscores)."""
    if arch not in PORTED_ARCHS:
        raise NotImplementedError(
            f"{arch}: the port serves {', '.join(PORTED_ARCHS)} so far; the "
            f"other architectures arrive with their mixers and MLPs "
            f"(ROADMAP: \"The rest of the model stack\")")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, *, d_model: int = 64,
            max_repeats: int = 2) -> ModelConfig:
    """Shrink a config for CPU tests exactly as the reference's
    ``reduced`` does: the same segment/unit pattern and mixer/MLP kinds,
    fewer repeats, tiny widths, float32, ``attn_impl="full"``."""
    heads = 4
    kv = max(1, heads * cfg.num_kv_heads // cfg.num_heads)
    if cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    new_segments = tuple(
        dataclasses.replace(s, repeats=min(s.repeats, max_repeats))
        for s in cfg.segments)
    num_layers = sum(s.num_layers for s in new_segments)
    changes: dict = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=2 * d_model,
        vocab_size=256,
        segments=new_segments,
        dtype="float32",
        attn_impl="full",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff=2 * d_model)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
        changes["head_dim"] = 16
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_inner=2 * d_model, d_state=8, dt_rank=8)
    if cfg.rwkv_heads:
        changes["rwkv_heads"] = heads
        changes["num_heads"] = heads
        changes["num_kv_heads"] = heads
        changes["rwkv_decay_lora"] = 16
    return dataclasses.replace(cfg, **changes)
