"""MusicGen-Large [arXiv:2306.05284; hf:facebook/musicgen-large].

Decoder-only transformer over EnCodec tokens (vocab 2048).  The EnCodec
frontend is a STUB per the assignment: input_specs provides precomputed
frame embeddings for train/prefill; decode operates on codebook token ids.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend_stub=True,
    norm="layernorm",
    act="gelu",
    rope_theta=1e4,
    source="arXiv:2306.05284; hf",
)
