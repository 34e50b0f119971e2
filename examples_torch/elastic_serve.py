"""DFPA-balanced serving dispatch + elastic replica membership.

A fleet of heterogeneous serving replicas (nonlinear throughput vs load:
the FPM of serving).  The dispatcher's ``Scheduler`` session splits request
chunks via DFPA; a replica then joins mid-run (``join``) and the warm
session rebalances from the surviving estimates — no cold restart.  Also
runs a REAL greedy generation on the smoke model to show the engine behind
each replica.

The PyTorch twin of ``examples/elastic_serve.py``.  The engine serves the
smoke stablelm-12b on the card (bf16, 4 query heads over 2 K/V heads of
head_dim 16, so its prefill goes through the flash kernel), and the
dispatcher's session keeps its bank there.  The weights come from a
``torch.Generator`` seeded 0 and the prompt from numpy's seeded 1, so the
sample tokens are not the reference's (its weights and prompt come from
``jax.random``); everything the dispatcher prints is.

    PYTHONPATH=src python examples_torch/elastic_serve.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import imbalance
from repro_torch.core.modelbank_torch import resolve_device
from repro_torch.models.transformer import LanguageModel
from repro_torch.nn.convert import unstack_tree
from repro_torch.nn.params import init_tree
from repro_torch.runtime.serve_loop import ReplicaDispatcher, ServeEngine
from repro_torch.runtime.train_loop import model_spec_for

ARCH = "stablelm-12b"


def main(device="cuda", *, dtype=None, params=None, prompt=None) -> dict:
    """``dtype`` overrides the smoke config's (bf16); ``params`` is a state
    dict of the model (for example ``nn.params_from_reference`` of the
    reference's weights) in place of the seeded draw; ``prompt`` a
    ``(2, 16)`` array of token ids in place of the seeded one."""
    dev = resolve_device(device)
    # --- 1. a real engine: prefill + greedy decode on the smoke model -------
    cfg = get_smoke_config(ARCH)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = unstack_tree(init_tree(model_spec_for(cfg), gen, dev), cfg)
    model = LanguageModel.from_state_dict(cfg, {k: v.to(dev) for k, v in params.items()})
    engine = ServeEngine(cfg, model, batch=2, seq_budget=48, device=dev)
    if prompt is None:
        prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    out = engine.generate(torch.tensor(np.asarray(prompt), dtype=torch.int64), max_new=16)
    tokens = out.cpu().numpy()
    print(f"engine: generated {out.shape[1]} tokens/request; sample {tokens[0][:8]}")

    # --- 2. DFPA dispatch across 4 heterogeneous replicas -------------------
    rng = np.random.default_rng(0)
    base = rng.uniform(2e-4, 8e-4, 5)
    knee = rng.integers(20, 48, 5)

    def replica_run(i, x):
        t = x * base[i]
        if x > knee[i]:
            t += (x - knee[i]) * base[i] * 4.0  # HBM-spill knee
        return t

    disp = ReplicaDispatcher(replica_run, 4, eps=0.1, device=dev)
    res = disp.balance(96)
    print(f"\n4 replicas: d={res.allocations} iters={res.iterations} imb={res.imbalance:.3f}")

    # --- 3. elastic join: replica 5 arrives; warm rebalance -----------------
    sched = disp.scheduler  # the warm session autotune left behind
    sched.join(1)
    for _ in range(6):
        times = [replica_run(i, d) for i, d in enumerate(sched.d)]
        sched.observe(times)
    times = [replica_run(i, d) for i, d in enumerate(sched.d)]
    imb = imbalance([t for t in times if t > 0])
    print(f"after join: d={sched.d} imb={imb:.3f}")
    print("the newcomer was folded in from a donor estimate — no cold restart.")
    return {
        "claims": {"16_tokens_per_request": tokens.shape == (2, 16)},
        "tokens": tokens,
        "new_tokens": int(out.shape[1]),
        "d": list(res.allocations),
        "iterations": res.iterations,
        "after_join": list(sched.d),
        "imbalance_after_join": imb,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
