"""Chameleon-34B [arXiv:2405.09818; unverified].

Early-fusion mixed-modal decoder; VQ image tokens share the 65536 vocab.
The VQ-GAN image tokenizer is a STUB per the assignment: input_specs
provides precomputed patch/token embeddings for train/prefill.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    frontend_stub=True,
    rope_theta=1e4,
    source="arXiv:2405.09818; unverified",
)
