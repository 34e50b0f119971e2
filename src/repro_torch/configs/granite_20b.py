"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Code LM, llama-arch per the assignment [arXiv:2405.04324; hf].  d_ff = 4x
d_model -> non-gated GELU MLP; MQA (kv=1); RoPE; untied head.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=("attn",),
    mlp_kind="gelu",
    rope_theta=10000.0,
    tie_embeddings=False,
    train_accum=4,
    attn_chunk_threshold=4096,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="granite-20b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        xent_chunk=0,
        remat="none",
    )
