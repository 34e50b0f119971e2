"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  Mistral-nemo-style backbone (head_dim 128, SwiGLU); the
pixtral-ViT frontend is a STUB supplying 256 precomputed patch embeddings
prepended to the text sequence [hf:mistralai/Pixtral-12B-2409; unverified].
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    pattern=("attn",),
    mlp_kind="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision_stub",
    num_prefix_embeddings=256,
    train_accum=4,
    attn_chunk_threshold=4096,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="pixtral-12b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_prefix_embeddings=8,
        xent_chunk=0,
        remat="none",
    )
