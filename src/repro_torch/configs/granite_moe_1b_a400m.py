"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=("attn",),
    num_experts=32,
    num_shared_experts=0,
    top_k=8,
    d_ff_expert=512,
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=512,
        num_experts=4,
        top_k=2,
        d_ff_expert=64,
        xent_chunk=0,
        remat="none",
    )
