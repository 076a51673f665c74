"""qwen3-14b [hf:Qwen/Qwen3-8B family]: dense, GQA kv=8, qk_norm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1e6,
)
