"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local(4096)/global alternating attention, attn-logit softcap 50, final
softcap 30, GeGLU, sandwich post-norms, head_dim 256 [arXiv:2408.00118; hf].
"""

import math

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=("local", "attn"),  # alternating sliding-window / global
    window=4096,
    mlp_kind="geglu",
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    rope_theta=10000.0,
    query_scale=1.0 / math.sqrt(256),
    tie_embeddings=True,
    embed_scale=math.sqrt(2304),
    train_accum=2,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-2b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=8,
        query_scale=1.0 / math.sqrt(16),
        embed_scale=8.0,
        xent_chunk=0,
        remat="none",
    )
