"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]: mistral-7b
backbone; anyres vision tiling STUBBED as precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, rope_theta=1e6,
    n_patches=576,  # one anyres base tile of 24x24 patches (stub frontend)
)
