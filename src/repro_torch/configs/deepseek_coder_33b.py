"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch dense, GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, rope_theta=100000.0,
)
