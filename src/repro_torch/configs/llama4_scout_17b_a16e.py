"""Llama-4 Scout 17B-active/16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE 16 experts top-1 + shared expert every layer, GQA 40/8, early-fusion
multimodal (text path only here; vision frontend is out of backbone scope).
"""

from .base import LayerSpec, ModelConfig, MoEConfig, Segment

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    segments=(Segment(unit=(LayerSpec(mixer="attn", mlp="moe"),),
                      repeats=48),),
    moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192, num_shared=1),
    rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
