"""A prefill pool: replicas of one model serving prompts to their first
token, balanced by DFPA, emulated on one card.

The model is the port's ``LanguageModel`` under the configuration's port
name, cut to the file's sizes, its float32 weights made by the benchmark
(``bench/reference/<reference>.py``'s ``make_weights``) from the seed on the
card.  Replica ``i`` serves its share of an epoch's requests as one batch
through the program's ``ServeEngine.generate`` ``r_i`` times over (its
slowness), timed by CUDA events.  The program's ``ReplicaDispatcher`` runs
the replicas: at the window's start ``balance`` runs DFPA from a cold
bank, each of its rounds an epoch of real requests; then every epoch
serves at the scheduler's distribution and folds its times in through
``Scheduler.observe``.

A request's time to its first token, in platform time, is the scheduler's
time before its epoch plus its replica's time.  The check compares the
served token of a sample of requests (drawn from the seed) with the plain
reference's logits, and replays every distribution with the frozen
partitioner.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Policy, Scheduler, SpeedStore
from repro_torch.models.transformer import LanguageModel
from repro_torch.runtime import ReplicaDispatcher, ServeEngine

from bench.lib import counts, loader, traffic
from bench.lib.clock import SchedClock, Span, sync
from bench.reference.partitioner import replay

SCHED_METHODS = ("fold_in", "partition_units")
# the configuration file's keys (the published config's names) -> the port's ModelConfig fields
FIELDS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model", "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "partial_rotary_factor": "rope_fraction", "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
}


def model_config(cfg: Dict):
    """The port's config of ``cfg["port_config"]`` with the file's sizes."""
    mc = get_config(cfg["port_config"]).replace(**{f: cfg[k] for k, f in FIELDS.items()})
    if mc.head_dim * mc.num_heads != mc.d_model:
        mc = mc.replace(head_dim=mc.d_model // mc.num_heads)
    return mc


def reference(cfg: Dict):
    return loader.load_module(loader.BENCH / "reference" / f"{cfg['reference']}.py", f"bench_ref_{cfg['reference']}")


class Pool(ReplicaDispatcher):
    """The program's ``ReplicaDispatcher``, each of whose rounds is one
    epoch of the benchmark's requests."""

    bench = None

    def run(self, d):
        self.bench.start_epoch(d)
        with torch.profiler.record_function("bench.epoch"):
            times = super().run(d)
        self.bench.end_epoch(list(d), list(times))
        return times


class System:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device):
        t0 = time.perf_counter()
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.mc = model_config(cfg)
        self.ref = reference(cfg)
        self.weights = self.ref.make_weights(cfg, traffic.device_generator(seed, 0, device), device)
        self.model = LanguageModel.from_state_dict(self.mc, self.weights)
        self.repeats = [int(r) for r in mix["replicas"]]
        self.n, self.eps, self.min_units = int(mix["requests_per_epoch"]), float(cfg["eps"]), int(cfg["min_units"])
        self.prompt, self.new = int(mix["prompt_tokens"]), int(mix["new_tokens"])
        self.clock = SchedClock(device)
        self.epochs = traffic.epochs(mix, seed, self.mc.vocab_size, device)
        self.rounds: List[Dict] = []
        self.prompts: List[torch.Tensor] = []
        self.served: List[List] = []
        sync(device)
        self.stages = {"weights_s": time.perf_counter() - t0}
        self.warm_up()
        self.stages["warm_up_s"] = time.perf_counter() - t0 - self.stages["weights_s"]

    # -- set-up -----------------------------------------------------------------

    def warm_up(self) -> None:
        """A prefill of one request (the kernels load; timed apart) and one at
        the largest batch an even split gives (the allocator takes its pool), then a
        scheduler session on a stand-in platform, so that every program the
        scheduler runs has run once."""
        toks = next(traffic.epochs(self.mix, self.seed + 1, self.mc.vocab_size, self.device))
        for x in (1, self.n // len(self.repeats)):
            t0 = time.perf_counter()
            ServeEngine(self.mc, self.model, batch=x, seq_budget=self.prompt + self.new,
                        device=self.device).generate(toks[:x], self.new)
            sync(self.device)
            self.stages[f"prefill_batch{x}_s"] = time.perf_counter() - t0
        stand_in = ReplicaDispatcher(lambda i, x: (1.0 + x) * (i + 1) * 1e-3, len(self.repeats), eps=self.eps,
                                     device=self.device)
        stand_in.balance(self.n, min_units=self.min_units)
        stand_in.scheduler.observe(stand_in.run(stand_in.scheduler.d))
        sync(self.device)

    # -- the window -------------------------------------------------------------

    def replica_run(self, i: int, x: int) -> float:
        toks = self.tokens[self.offset:self.offset + x]
        self.offset += x
        eng = ServeEngine(self.mc, self.model, batch=x, seq_budget=self.prompt + self.new, device=self.device)
        with torch.profiler.record_function("bench.replica"), Span(self.device) as span:
            for _ in range(self.repeats[i]):
                out = eng.generate(toks, self.new)
        self.served[-1].append(out)
        return span.seconds()

    def start_epoch(self, d) -> None:
        self.tokens, self.offset = next(self.epochs), 0
        self.prompts.append(self.tokens)
        self.served.append([])
        self.sched_before = self.clock.take()

    def end_epoch(self, d, times) -> None:
        self.rounds.append({"phase": self.phase, "d": d, "times": times, "makespan_s": max(times),
                            "sched_s": self.sched_before})

    def window(self, seconds: float) -> Dict:
        t_end = time.perf_counter() + seconds
        store = self.clock.timed("create", SpeedStore.empty)(len(self.repeats), backend="torch", device=self.device)
        self.clock.wrap(store, *SCHED_METHODS)
        pool = Pool(self.replica_run, len(self.repeats), eps=self.eps, device=self.device)
        pool.bench = self
        pool.scheduler = Scheduler(store, policy=Policy.DFPA, eps=self.eps, min_units=self.min_units,
                                   device=self.device)
        self.phase = "balance"
        pool.balance(self.n, min_units=self.min_units)
        self.balance_rounds = len(self.rounds)
        self.phase = "serve"
        while time.perf_counter() < t_end:
            pool.scheduler.observe(pool.run(pool.scheduler.d))
        tail = self.clock.take()
        sync(self.device)
        for k, r in enumerate(self.rounds):
            print(f"bench: epoch {k} {r['phase']} d={r['d']} makespan {1e3 * r['makespan_s']:.1f} ms "
                  f"scheduler {1e3 * r['sched_s']:.1f} ms", file=sys.stderr)
        return self._record(tail)

    def _record(self, tail: float) -> Dict:
        m = self.mc
        ttft, flops, card_s, bound_s, launches = [], 0.0, 0.0, 0.0, 0
        per_forward = {}
        for rnd in self.rounds:
            for i, (x, t) in enumerate(zip(rnd["d"], rnd["times"])):
                if x <= 0:
                    continue
                ttft += [rnd["sched_s"] + t] * x
                if x not in per_forward:
                    per_forward[x] = (
                        counts.dense_prefill_flops(x, self.prompt, layers=m.num_layers, d=m.d_model,
                                                   heads=m.num_heads, kv_heads=m.num_kv_heads, head_dim=m.head_dim,
                                                   d_ff=m.d_ff, vocab=m.vocab_size),
                        counts.attention_bound_s(x, m.num_heads, m.num_kv_heads, self.prompt, m.head_dim),
                    )
                f, b = per_forward[x]
                flops += f * self.repeats[i]
                bound_s += b * self.repeats[i] * m.num_layers
                launches += self.repeats[i] * m.num_layers
                card_s += t
        return {
            "requests": {"ttft_s": ttft, "prompt_tokens": self.prompt * len(ttft)},
            "attempted": len(ttft),
            "failed": 0,
            "iterations": len(self.rounds),
            "balance_rounds": self.balance_rounds,
            "sched_s": [r["sched_s"] for r in self.rounds] + [tail],
            "platform_s": sum(r["makespan_s"] + r["sched_s"] for r in self.rounds) + tail,
            "work": {"serve": {"flops": flops, "card_s": card_s}},
            "bounds": {"flash_attention": {"launches": launches, "bound_s": bound_s}},
        }

    # -- after the window ---------------------------------------------------------

    def release(self) -> None:
        """Frees the program's state (the model object; the weights are the
        benchmark's inputs and stay for the reference)."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """The requests the check compares, drawn from the seed among all
        the window served: their prompts and served first tokens."""
        ids = [(e, j) for e in range(len(self.rounds)) for j in range(self.n)]
        size = min(int(self.mix["check_requests"]), len(ids))
        chosen = sorted(ids[k] for k in traffic.rng(self.seed, 4).choice(len(ids), size=size, replace=False))
        served = {e: torch.cat(self.served[e]) for e in {e for e, _ in chosen}}
        return (torch.stack([self.prompts[e][j] for e, j in chosen]),
                torch.stack([served[e][j, 0] for e, j in chosen]))

    def check(self, record: Dict, tokens: Optional[torch.Tensor] = None) -> List[Dict]:
        """The served token of a sample of the requests (or ``tokens``,
        another computation's in their place) against the plain reference's
        logits (how far below the reference's best it lies), and every
        distribution against the frozen partitioner's replay."""
        prompts, served = self._sample()
        tokens = served if tokens is None else tokens
        worst = float(gaps(self.ref, self.weights, self.cfg, prompts, tokens, int(self.mix["check_batch"])).max())
        faults = replay([(r["d"], r["times"]) for r in self.rounds], n=self.n, eps=self.eps, min_units=self.min_units,
                        balance_rounds=self.balance_rounds, observe=True)
        limits = self.cfg["limits"]
        return [
            {"name": "served_logit_gap", "value": worst, "limit": limits["served_logit_gap"],
             "ok": bool(np.isfinite(worst)) and worst <= limits["served_logit_gap"]},
            {"name": "allocations_unlike_replay", "value": len(faults), "limit": 0, "ok": not faults,
             "detail": faults[:5]},
        ]

    def control(self, record: Dict) -> List[Dict]:
        """The check with the control in the program's place: each sampled
        request's served token is the one the reference computed in fp8
        puts first at the prompt's last position."""
        prompts, _ = self._sample()
        batch = int(self.mix["check_batch"])
        first = torch.cat([self.ref.forward(self.weights, self.cfg, prompts[lo:lo + batch], precision="fp8").argmax(-1)
                           for lo in range(0, len(prompts), batch)])
        return self.check(record, first)

def gaps(ref, weights, cfg, prompts: torch.Tensor, tokens: torch.Tensor, batch: int) -> torch.Tensor:
    """For each prompt, how far the logit of its served token lies below the
    reference's largest logit."""
    out = []
    for lo in range(0, len(prompts), batch):
        logits = ref.forward(weights, cfg, prompts[lo:lo + batch])
        best = logits.max(-1).values
        out.append(best - logits.gather(-1, tokens[lo:lo + batch, None].long())[:, 0])
    return torch.cat(out)
