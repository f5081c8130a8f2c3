"""Config system: one frozen dataclass per architecture, explicit segments.

The port's copy of the reference's ``configs/base.py``, without its
``jax.numpy`` import.  A model is a stack of *segments*; each segment is
a repeating unit of layer specs run ``repeats`` times.  ``LayerSpec``
picks the sequence mixer (attn / mla / mamba / rwkv) and the MLP kind
(dense / moe / rwkv_cmix) per layer.  The field names and defaults are
the reference's, so a config compares field for field across the two
packages.  ``ARCH_IDS`` names the ten architectures, one config module
each, and ``SHAPES`` the input shapes every LM architecture is assigned.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

import torch

Mixer = Literal["attn", "mla", "mamba", "rwkv"]
MLPKind = Literal["dense", "moe", "rwkv_cmix"]

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

    @property
    def subquadratic(self) -> bool:
        """True if decode state does not grow with context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math)."""
        return self._param_count_exact()

    def _param_count_exact(self) -> int:
        d = self.d_model
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d

        def layer_params(spec: LayerSpec) -> int:
            p = 0
            if spec.mixer == "attn":
                p += d * self.num_heads * self.head_dim
                p += 2 * d * self.num_kv_heads * self.head_dim
                p += self.num_heads * self.head_dim * d
            elif spec.mixer == "mla":
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                p += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                p += self.num_heads * m.v_head_dim * d
            elif spec.mixer == "mamba":
                s = self.ssm
                p += d * 2 * s.d_inner
                p += s.d_inner * (s.dt_rank + 2 * s.d_state)
                p += s.dt_rank * s.d_inner + s.d_inner * d
            elif spec.mixer == "rwkv":
                p += 5 * d * d + 2 * d * self.rwkv_decay_lora
            if spec.mlp == "dense":
                p += (3 if self.act == "silu" else 2) * d * self.d_ff
            elif spec.mlp == "moe":
                m = self.moe
                p += d * m.num_experts
                p += m.num_experts * 3 * d * m.d_ff
                p += m.num_shared * 3 * d * m.d_ff
            elif spec.mlp == "rwkv_cmix":
                p += 2 * d * int(3.5 * d) + d * d
            return p

        for seg in self.segments:
            n += seg.repeats * sum(layer_params(s) for s in seg.unit)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self._param_count_exact()
        d = self.d_model
        m = self.moe
        full_expert = m.num_experts * 3 * d * m.d_ff
        active_expert = m.top_k * 3 * d * m.d_ff
        n_moe_layers = sum(
            seg.repeats * sum(1 for s in seg.unit if s.mlp == "moe")
            for seg in self.segments)
        return (self._param_count_exact()
                - n_moe_layers * (full_expert - active_expert))


# ---------------------------------------------------------------------------
# Input shapes (assigned to every LM arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


ARCH_IDS = [
    "jamba-1.5-large-398b",
    "qwen2.5-14b",
    "olmo-1b",
    "smollm-135m",
    "command-r-plus-104b",
    "rwkv6-1.6b",
    "deepseek-v3-671b",
    "llama4-scout-17b-a16e",
    "musicgen-large",
    "chameleon-34b",
]


def load_config(arch: str) -> ModelConfig:
    """``repro_torch/configs/<arch>.py``'s CONFIG (dashes → underscores)."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def cell_is_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k requires sub-quadratic decode state (SSM/hybrid)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True


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
