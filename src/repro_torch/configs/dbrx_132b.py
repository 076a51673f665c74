"""dbrx-132b [hf:databricks/dbrx-base]: 16-expert top-4 fine-grained MoE,
GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, moe_d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, rope_theta=500000.0,
)
