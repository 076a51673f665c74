"""xlstm-1.3b [arXiv:2405.04517]: sLSTM + mLSTM blocks (1 sLSTM per 8),
matrix-memory mLSTM with proj factor 2; no separate FFN (d_ff=0)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_every=8, proj_factor=2.0,
    # §Perf cell C: chunk 2048 adopted (temp −54%, t_comp −40% vs the
    # chunk-256 baseline recorded in EXPERIMENTS.md)
    mlstm_chunk=2048,
)
