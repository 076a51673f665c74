"""Architecture and input-shape configs, copied from ``repro/configs/base.py``.

The reference module imports no JAX, but the port imports nothing of
``repro``, so it keeps this copy; ``tests/test_torch_lm.py`` holds it equal
to the reference.  ``dtype`` stays a string (``"bfloat16"``,
``"float32"``); the port maps it to a torch dtype where it is used
(:func:`repro_torch.nn.layers.torch_dtype`).
"""
from __future__ import annotations

import dataclasses

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention details
    qk_norm: bool = False           # qwen3-style per-head RMS on q/k
    qkv_bias: bool = False          # qwen2.5-style bias on qkv projections
    rope_theta: float = 10000.0
    local_window: int = 0           # >0: sliding-window attention
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    n_shared_experts: int = 0
    moe_group_size: int = 2048      # GShard dispatch group
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"        # einsum (baseline) | gather (optimized)
    # encoder-decoder (audio family)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500      # stub frontend output length
    # VLM
    n_patches: int = 0              # stub anyres patch embeddings
    # hybrid (recurrentgemma): block pattern within a scanned group
    block_pattern: tuple[str, ...] = ("attn",)   # e.g. ("rec","rec","attn")
    d_rnn: int = 0
    conv_width: int = 4
    # ssm (xlstm)
    slstm_every: int = 0            # one sLSTM per this many blocks (0: none)
    proj_factor: float = 2.0        # mLSTM up-projection factor
    mlstm_chunk: int = 256          # chunkwise-parallel mLSTM chunk length
    # numerics / training
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save MXU outputs, skip fwd recompute)
    attn_chunk: int = 1024          # q-chunk for streaming attention (0: full)
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 so the LM head / embedding shard
        over the model axis (Megatron-style vocab padding; padded logits are
        masked to -inf in the loss).  whisper's 51865 is the only assigned
        vocab that doesn't already divide 16."""
        return (self.vocab_size + 127) // 128 * 128

    @property
    def q_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def n_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "ssm":
            # mLSTM block: up-proj 2x, qkv over inner dim, gates, down-proj
            di = int(self.proj_factor * d)
            per_blk = d * di * 2 + 3 * di * di // max(1, 1) + di * d
            return emb + self.n_layers * per_blk
        ff_mult = 3 if self.act == "swiglu" else 2
        per_mlp = ff_mult * d * self.d_ff
        if self.family == "moe":
            per_mlp = ff_mult * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
        n = emb + self.n_layers * (per_attn + per_mlp)
        if self.family == "hybrid":
            rec_frac = sum(1 for b in self.block_pattern if b == "rec") / len(self.block_pattern)
            dr = self.d_rnn or d
            per_rec = 2 * d * dr + dr * d + 2 * dr  # in x2, out, gates(diag-ish)
            n = emb + int(self.n_layers * rec_frac) * (per_rec + per_mlp) + \
                int(self.n_layers * (1 - rec_frac)) * (per_attn + per_mlp)
        if self.family == "audio":
            n += self.n_encoder_layers * (per_attn + per_mlp)
            n += self.n_layers * per_attn  # decoder cross-attention
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        ff_mult = 3 if self.act == "swiglu" else 2
        hd = self.resolved_head_dim
        per_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        act_mlp = ff_mult * d * self.moe_d_ff * (self.top_k + self.n_shared_experts)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (per_attn + act_mlp)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode


# The four assigned LM shapes (identical across the 10 archs).
LM_SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention: run for ssm/hybrid, skip for
    pure full-attention archs (documented in DESIGN.md §4)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "O(S^2) full attention at S=524288 is infeasible by design"
    return True, ""


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4 if cfg.slstm_every == 0 else 4),
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_group_size=16,
        vocab_size=256,
        d_rnn=64 if cfg.d_rnn else 0,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        n_audio_frames=8 if cfg.family == "audio" else cfg.n_audio_frames,
        n_patches=4 if cfg.family == "vlm" else 0,
        slstm_every=min(cfg.slstm_every, 2) if cfg.slstm_every else 0,
        attn_chunk=0,
        dtype="float32",
    )
