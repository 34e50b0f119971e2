"""The LM model stack: the layers, attention (``attn``/``local``/cross,
GQA and MLA), mixture-of-experts MLPs, the recurrent blocks (RG-LRU, mLSTM,
sLSTM), the decoder assembly, the encoder-decoder and the frontend stubs:
every family the reference assigns."""

from .config import ModelConfig
from .encdec import EncoderDecoder, encdec_decode_step, encdec_prefill, init_encdec, init_encdec_cache
from .transformer import LanguageModel, decode_step, init_cache, init_lm, lm_spec, prefill

__all__ = [
    "EncoderDecoder",
    "LanguageModel",
    "ModelConfig",
    "decode_step",
    "encdec_decode_step",
    "encdec_prefill",
    "init_cache",
    "init_encdec",
    "init_encdec_cache",
    "init_lm",
    "lm_spec",
    "prefill",
]
