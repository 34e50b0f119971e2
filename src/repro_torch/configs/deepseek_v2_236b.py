"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160e top-6, MLA kv_lora=512, 2 shared experts
[arXiv:2405.04434; hf].

Notes: the assignment's d_ff=1536 is the routed-expert intermediate size;
the first layer is dense with intermediate 12288 (per the HF config).
MLA: q_lora 1536, kv_lora 512, rope_head 64, nope_head 128, v_head 128.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,  # nope 128 + rope 64 (scoring dim)
    d_ff=1536,  # routed expert intermediate
    vocab_size=102400,
    pattern=("attn",),
    prefix=("attn",),  # dense first layer
    prefix_dense_ff=12288,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    mlp_kind="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
    train_accum=8,
    attn_chunk_threshold=4096,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-smoke",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=24,
        d_ff=64,
        prefix_dense_ff=128,
        vocab_size=512,
        q_lora_rank=32,
        kv_lora_rank=16,
        rope_head_dim=8,
        nope_head_dim=16,
        v_head_dim=16,
        num_experts=8,
        num_shared_experts=1,
        top_k=2,
        d_ff_expert=64,
        xent_chunk=0,
        remat="none",
    )
