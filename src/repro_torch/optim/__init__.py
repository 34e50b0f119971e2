"""AdamW with global-norm clipping, the LR schedule and gradient
compression: the port's copy of the reference's ``optim/``."""

from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import warmup_cosine
from .compress import compress_bf16, compress_int8_ef, decompress_int8

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "warmup_cosine",
    "compress_bf16",
    "compress_int8_ef",
    "decompress_int8",
]
