"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  RG-LRU recurrent blocks + local attention in a 2:1 pattern
(rec, rec, attn), window 2048, GeGLU, d_rnn=2560, conv width 4
[arXiv:2402.19427; hf].  Sub-quadratic: runs long_500k.

26 layers does not divide the 3-layer pattern; following the published
model, the final truncated unit is dropped to 24 repeated layers + 2 prefix
(rec, rec) layers = 26.
"""

import math

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rec", "rec", "local"),
    prefix=("rec", "rec"),
    prefix_dense_ff=7680,
    window=2048,
    mlp_kind="geglu",
    d_rnn=2560,
    conv_width=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=math.sqrt(2560),
    query_scale=1.0 / math.sqrt(256),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-smoke",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=8,
        d_rnn=64,
        embed_scale=8.0,
        query_scale=1.0 / math.sqrt(16),
        xent_chunk=0,
        remat="none",
    )
