"""whisper-base [arXiv:2212.04356]: encoder-decoder, conv frontend stubbed
(precomputed frame embeddings per the assignment)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, norm="layernorm", act="gelu",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    n_audio_frames=1500,
)
