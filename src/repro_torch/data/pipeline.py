"""Deterministic synthetic LM data pipeline with unit-based microbatching.

The port's copy of the reference's ``data/pipeline.py``, numpy only, so a
batch is bit for bit the reference's.  The DFPA "computation unit" in
training is ONE MICROBATCH (fixed shape ``(micro_batch, seq)``); a global
step consists of ``n`` units distributed ``d_1..d_p`` across heterogeneous
groups.  The pipeline is:

  * deterministic & resumable — batch ``i`` is a pure function of
    (seed, i), so restarts and elastic re-partitions replay identically;
  * shift-labelled — ``labels[t] = tokens[t+1]``, last position ignored;
  * frontend-aware — vlm/audio configs get stub prefix/frame embeddings.

Synthetic tokens follow a Zipf-ish distribution with a Markov drift so the
loss is learnable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from ..models.config import ModelConfig

__all__ = ["SyntheticLMData", "UnitBatcher"]


@dataclass
class SyntheticLMData:
    """Batch ``i`` = f(seed, i).  State = next index (one int → trivially
    checkpointable)."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    next_index: int = 0

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index]))
        V = self.cfg.vocab_size
        # Zipf-ish unigram with per-batch Markov drift (learnable structure).
        base = rng.zipf(1.3, size=(self.batch, self.seq + 1)).astype(np.int64)
        drift = rng.integers(0, 17, size=(self.batch, 1))
        toks = ((base + drift) % V).astype(np.int32)
        out: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": np.concatenate(
                [toks[:, 1:-1], np.full((self.batch, 1), -1, np.int32)], axis=1
            ),
        }
        if self.cfg.frontend == "vision_stub":
            P = self.cfg.num_prefix_embeddings
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, P, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        elif self.cfg.frontend == "audio_stub":
            out["frames"] = rng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model)
            ).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def next(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.next_index)
        self.next_index += 1
        return b

    # -- checkpointable state ------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {"next_index": self.next_index, "seed": self.seed}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        self.next_index = int(s["next_index"])
        self.seed = int(s["seed"])


@dataclass
class UnitBatcher:
    """Slices a global step's units across heterogeneous groups.

    One *unit* = one microbatch of shape (micro_batch, seq).  For a step
    with distribution ``d`` (from DFPA), group ``i`` receives a stacked
    array of ``d[i]`` units: shape (d[i], micro_batch, seq).
    """

    data: SyntheticLMData
    micro_batch: int

    def global_step_units(self, n_units: int, step: int) -> Dict[str, np.ndarray]:
        """All units for one global step, stacked: (n_units, mb, seq)."""
        saved = self.data.next_index
        self.data.next_index = step * n_units
        outs: List[Dict[str, np.ndarray]] = []
        for _ in range(n_units):
            outs.append(self.data.next())
        self.data.next_index = saved
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}

    def split(self, units: Dict[str, np.ndarray], d: List[int]) -> List[Dict[str, np.ndarray]]:
        """Split stacked units by the DFPA distribution ``d``."""
        offs = np.cumsum([0] + list(d))
        return [
            {k: v[offs[i] : offs[i + 1]] for k, v in units.items()}
            for i in range(len(d))
        ]
