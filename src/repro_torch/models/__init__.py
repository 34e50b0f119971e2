"""The LM model stack, ported slice by slice: so far the layers,
attention (``attn``/``local``, GQA and MLA), mixture-of-experts MLPs, the
RG-LRU block and the decoder assembly that serve the dense, MoE, MLA and
hybrid decoders."""

from .config import ModelConfig
from .transformer import LanguageModel, decode_step, init_cache, init_lm, lm_spec, prefill

__all__ = ["LanguageModel", "ModelConfig", "decode_step", "init_cache", "init_lm", "lm_spec", "prefill"]
