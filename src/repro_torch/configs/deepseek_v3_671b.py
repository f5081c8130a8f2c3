"""DeepSeek-V3 671B [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

MLA attention (q_lora 1536, kv_lora 512, rope 64), 61 layers with the first
3 dense (d_ff 18432), then MoE: 1 shared + 256 routed experts (d_ff 2048),
top-8, sigmoid router; MTP head depth 1.
"""

from .base import (LayerSpec, MLAConfig, ModelConfig, MoEConfig, Segment)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,            # dense layers
    vocab_size=129280,
    attention="mla",
    segments=(
        Segment(unit=(LayerSpec(mixer="mla", mlp="dense"),), repeats=3),
        Segment(unit=(LayerSpec(mixer="mla", mlp="moe"),), repeats=58),
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff=2048, num_shared=1,
                  router_fn="sigmoid", normalize_weights=True),
    mtp_depth=1,
    rope_theta=1e4,
    source="arXiv:2412.19437; hf",
)
