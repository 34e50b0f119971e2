"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.

Alternating mLSTM / sLSTM blocks [arXiv:2405.04517; unverified].  d_ff=0:
blocks are self-contained (mLSTM block carries a 2x up/down projection;
sLSTM block a 4/3 gated post-FFN).  Fully recurrent decode state ->
sub-quadratic; runs long_500k.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    conv_width=4,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        vocab_size=512,
        xent_chunk=0,
        remat="none",
    )
