"""Serving: the single-replica prefill/decode engine.

The port's copy of the reference's ``ServeEngine``
(``src/repro/runtime/serve_loop.py:60-93``): prefill the prompt into a
fixed KV budget, then decode greedily one token at a time.  Where the
reference jit-compiles prefill and decode, the port runs them eagerly
under ``torch.inference_mode``; on the card prefill reaches the
``flash_attention`` and ``rglru_scan`` kernels and decode runs plain torch.

``ReplicaDispatcher`` (DFPA over request chunks) comes later
(ROADMAP queue 1, item 8: serving dispatch).
"""

from __future__ import annotations

import torch

from ..core.modelbank_torch import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_cache, prefill

__all__ = ["ServeEngine"]


class ServeEngine:
    """Single-replica engine: prefill + greedy decode with a fixed KV budget,
    on ``device`` (the model's parameters must already lie there)."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int, seq_budget: int, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        off = {p.device for p in params.parameters()} - {self.device}
        if off:
            raise ValueError(f"parameters lie on {sorted(map(str, off))}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.seq_budget = seq_budget

    def new_cache(self):
        return init_cache(self.cfg, self.batch, self.seq_budget, self.cfg.dtype, self.device)

    def generate(self, tokens: torch.Tensor, max_new: int, *, greedy: bool = True) -> torch.Tensor:
        """tokens: (B, S_prompt) -> (B, max_new) generated ids.

        As in the reference, the prompt plus the new tokens may run past
        ``seq_budget``: a local layer keeps a ring of ``min(seq_budget,
        window)`` slots and the RG-LRU state does not depend on the budget."""
        if not greedy:
            raise NotImplementedError("only greedy decoding, as in the reference")
        B, S = tokens.shape
        if B != self.batch:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not fit batch {self.batch}")
        tokens = tokens.to(self.device)
        with torch.inference_mode():
            logits, caches = prefill(self.params, self.cfg, tokens, self.new_cache())
            tok = torch.argmax(logits, -1)[:, None]
            out = [tok]
            pos = S
            for _ in range(1, max_new):
                logits, caches = decode_step(self.params, self.cfg, tok, pos, caches)
                tok = torch.argmax(logits, -1)[:, None]
                out.append(tok)
                pos += 1
            return torch.cat(out, dim=1)
