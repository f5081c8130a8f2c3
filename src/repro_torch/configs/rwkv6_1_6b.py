"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892; unverified].

Attention-free: data-dependent decay WKV recurrence + channel mix.
d_ff=7168 corresponds to the 3.5x channel-mix hidden size.
"""

from .base import LayerSpec, ModelConfig, Segment

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # wkv heads (head_dim 64)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    segments=(Segment(unit=(LayerSpec(mixer="rwkv", mlp="rwkv_cmix"),),
                      repeats=24),),
    rwkv_heads=32,
    rwkv_decay_lora=64,
    norm="layernorm",
    source="arXiv:2404.05892; unverified",
)
