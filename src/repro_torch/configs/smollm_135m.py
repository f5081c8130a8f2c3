"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M].

Llama-architecture small model: GQA 9/3, tied embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=1e4,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
