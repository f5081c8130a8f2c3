"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified].

Dense, GQA 96/8, parallel attention+FFN blocks, no bias, 256k vocab.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,
    norm="layernorm",
    rope_theta=75e4,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
