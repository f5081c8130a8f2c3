"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887, 2408.12570; hf].

Hybrid Mamba+attention, 1:7 attn:mamba interleave, MoE every other layer
(16 experts, top-2).  72 layers = 9 repeats of an 8-layer unit with the
attention layer at unit position 4 (the published Jamba block layout).
"""

from .base import LayerSpec, ModelConfig, MoEConfig, Segment, SSMConfig

_D = 8192

_UNIT = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"),
              mlp=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=_D,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    segments=(Segment(unit=_UNIT, repeats=9),),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
    ssm=SSMConfig(d_inner=2 * _D, d_state=16, d_conv=4, dt_rank=_D // 16),
    rope_theta=1e4,
    source="arXiv:2403.19887; hf",
)
