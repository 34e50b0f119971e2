"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.  Local/global alternating, softcaps, GeGLU, post-norms,
query scale 1/sqrt(d_model/num_heads) [arXiv:2408.00118; hf].
"""

import math

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=("local", "attn"),
    window=4096,
    mlp_kind="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    rope_theta=10000.0,
    query_scale=1.0 / math.sqrt(4608 / 32),  # 27b uses d_model/num_heads
    tie_embeddings=True,
    embed_scale=math.sqrt(4608),
    train_accum=4,
    attn_chunk_threshold=4096,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-27b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        window=8,
        query_scale=1.0 / math.sqrt(16),
        embed_scale=8.0,
        xent_chunk=0,
        remat="none",
    )
