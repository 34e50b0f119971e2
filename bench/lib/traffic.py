"""The general generator: every traffic mix is a JSON file of parameters
under ``bench/traffic/``, read here and by the systems.  Keys:

* ``platform``: the ``r_i`` of the application's processors (processor
  ``i`` runs its share ``r_i`` times over).
* ``requests_per_epoch``, ``prompt_tokens``, ``new_tokens``: a serving
  epoch's requests, all arriving together at its start (a closed loop over
  epochs), their prompt lengths and the tokens each is served to.
  ``replicas``: the ``r_i`` of the serving replicas.
* The comparison's sample: ``check_pool`` rows of the output drawn from
  the seed and ``check_rows`` of them read after each iteration;
  ``check_requests`` served requests, run through the reference
  ``check_batch`` at a time.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one purpose (``stream``) of one run's seed."""
    s = int(seed)
    return np.random.default_rng([s & (2**63 - 1), (s >> 63) & (2**63 - 1), stream])


def device_generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % 2**63)
    return g


def epochs(mix: Dict, seed: int, vocab: int, device: torch.device) -> Iterator[torch.Tensor]:
    """Each serving epoch's prompts, ``(requests_per_epoch, prompt_tokens)``
    token ids drawn on the device from the seed."""
    g = device_generator(seed, 2, device)
    shape = (int(mix["requests_per_epoch"]), int(mix["prompt_tokens"]))
    while True:
        yield torch.randint(0, vocab, shape, generator=g, device=device)

