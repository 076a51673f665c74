"""recurrentgemma-9b [arXiv:2402.19427 Griffin]: RG-LRU + local attention,
1 attention block per 2 recurrent blocks (pattern rec,rec,attn), MQA kv=1."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, act="swiglu",
    block_pattern=("rec", "rec", "attn"), d_rnn=4096, local_window=2048,
    conv_width=4,
)
