"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  SwiGLU, partial rotary 25%, untied head
[hf:stabilityai/stablelm-2-12b; hf].
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=10000.0,
    rope_fraction=0.25,
    tie_embeddings=False,
    train_accum=4,
    attn_chunk_threshold=4096,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="stablelm-12b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        xent_chunk=0,
        remat="none",
    )
