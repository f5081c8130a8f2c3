"""OLMo-1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

Dense, MHA (16 heads, kv=16), non-parametric LayerNorm, SwiGLU, no biases.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",
    rope_theta=1e4,
    source="arXiv:2402.00838; hf",
)
