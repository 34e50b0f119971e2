"""seamless-m4t-medium [audio] — 12L d_model=1024 16H d_ff=4096 vocab=256206.

Encoder-decoder; the speech frontend is a STUB supplying precomputed frame
embeddings to the 12-layer encoder; 12-layer text decoder with
cross-attention [arXiv:2308.11596; hf].  LayerNorm + non-gated GELU (4x).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=("attn",),
    encoder_layers=12,
    encoder_pattern=("attn",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    frontend="audio_stub",
    train_accum=4,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        encoder_layers=2,
        xent_chunk=0,
        remat="none",
    )
