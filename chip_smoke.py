"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout: it builds ``src/repro_torch/csrc`` with
``nvcc`` into ``build/repro_torch/``, then runs twenty phases, each printing
JSON lines and its seconds, and fails (non-zero exit, no result line) at
the first fault:

  1. ``device``     — the card's name, power limit, capability (must be 9.0)
                      and the software versions;
  2. ``build``      — the three kernels' build (``matmul_update``,
                      ``flash_attention``, ``rglru_scan``): seconds and the
                      ``ptxas -v`` register / spill / shared-memory report,
                      plus the dynamic shared memory of the wgmma kernels
                      and the scan's chunk length;
  3. ``kernels``    — each CUDA kernel against its plain PyTorch version on
                      the card: ``matmul_update`` on the reference's test
                      shapes, two ragged ones and two larger ones on the
                      ``"wgmma"`` route, each launched twice on the same inputs
                      (the two results bit-identical), and the
                      indivisible-shape refusal; at the three DFPA panels
                      (32, 992, 2048 rows) it is timed beside ``addmm_`` and
                      must take the ``"wgmma"`` route, and at 2048 rows a
                      plain version that drops the last 64-deep slice of K
                      must fail the same check; ``flash_attention`` on the
                      reference's ``FLASH_CASES`` x float32 (2e-5) /
                      bfloat16 (2e-2) plus
                      a window whose first key tile is fully masked for some
                      rows, ragged lengths and head_dim 256 cases (an odd
                      group count, softcap, GQA), and head_dim 160 and 192
                      cases (the decoders' ``"wgmma"`` head dims), each
                      launched twice (bit-identical) on the route the
                      wrapper picks; at bf16's 2e-2 on ``"wgmma"``, head
                      dims 16 and 32 (the model twins' captured shapes,
                      GQA with a window and softcap, ragged lengths) and
                      K/V broadcast over heads (a zero head stride, passed
                      as the one-head view) at 16, 32, 64, 128 and 256;
                      ``rglru_scan`` on ``RGLRU_CASES`` at 1e-5 plus
                      ``h0``, ragged, shorter-than-a-chunk and long cases,
                      and the serve shape with decays near 1 (log_a scaled
                      by 0.002, so every chunk's carry reaches the chunk's
                      far end), each launched twice (bit-identical).
                      Times at the main paths' shapes, beside the plain
                      version's, one PyTorch call's and the bound;
                      at the serve shape flash is held at atol 2e-3, rtol
                      2e-2, and a plain version whose window is one 64-key
                      tile short must fail that check; the scan is held at
                      1e-5, and a plain version that loses the carry at the
                      chunk boundary in mid-sequence must fail it; causal
                      attention with Sq > Sk must raise ``ValueError``;
                      flash is also timed at stablelm-12b's and
                      deepseek-v2's prefill shapes (head_dim 160 and 192,
                      2 x 1,024, causal) and at head_dim 16 and 32 where
                      the card sets the time (B 4, H 32, Kv 8, S 4,096,
                      causal), where a plain version that drops the first
                      64-key tile must fail the same check;
  4. ``bank``       — the device bank (float64) against the host numpy bank
                      at p=10^5 (threshold completion) and p=10^4 (greedy),
                      contract: bit-identical allocations and t*;
  5. ``hcl_golden`` — ``Scheduler(backend="torch", device="cuda").autotune``
                      on the HCL simulator reproduces tests/golden/dfpa_hcl.json;
  6. ``dfpa``       — the paper's main path: the DFPA loop balancing
                      ``matmul_update`` row panels across eight "processors"
                      that share the card and repeat their panel r_i times,
                      timed by the card's clock.  It must converge at eps=0.1,
                      launch the kernel exactly as often as the rounds say,
                      every launch on the ``"wgmma"`` route, and the final
                      distribution, measured again, must stay within 2*eps;
  7. ``serve``      — the model stack's main path: recurrentgemma-2b at its
                      published width and depth (random weights, seed 0)
                      served by ``ServeEngine.generate`` — a 4096-token
                      prompt for a batch of 4, then 32 greedy tokens.  One
                      ``generate`` must launch ``flash_attention`` exactly 8
                      times, all on ``"wgmma"``, and ``rglru_scan`` (its one
                      kernel) 18 times; two give identical
                      tokens; prefill(4096) + one decode step agree with the
                      full forward over 4097 tokens (rel 0.05); the kernels'
                      inputs captured from a real prefill agree with the plain
                      versions (flash as at the serve shape); and the
                      smoke-width model in float32 gives the CPU's tokens
                      (plain versions) on the card (kernels).  Times come
                      from CUDA events around ``generate``: prefill is one
                      of a single token, a decode step the rest of one of 32
                      tokens over 31;
  8. ``paper``      — the paper's six tables (``repro_torch.launch.
                      paper_tables``: Tables 2-5, Figs. 6 and 10), each at
                      the smallest size it lists, with every bank on the
                      card (``backend="torch"``), each CSV equal character
                      for character to the numpy backend's on the host in
                      the same run; the wall seconds of each on both (the
                      CSVs' own seconds are simulated seconds of the paper's
                      clusters, not times of the card).  The whole tables
                      come from ``python -m repro_torch.launch.paper_tables
                      --device cuda``;
  9. ``grid``       — the 2-D grid partitioner: (a) ``partition_grid`` on
                      the HCL 4x4 grid at M = N = 512 under GRID2D, CPM and
                      FFMPA, bank on the card, bit-identical to numpy on the
                      host; (b) ``repartition_grid`` of q = 16 columns of
                      p = 4096 random monotone estimates (8 knots) as one
                      stacked device bank, no column differing from numpy,
                      timed cold and warm beside numpy; (c) the paper's 2-D
                      application (``repro_torch.launch.matmul_grid``): a
                      2 x 4 grid of processors sharing the card, processor
                      (i, j) running ``matmul_update`` on its (r*128) x
                      (w*128) x 4096 bf16 block r_ij times (r = [[1, 2, 3,
                      4], [4, 3, 2, 1]]), each evaluation of a speed
                      function one untimed run of the block and then the
                      median of three CUDA-event timings enqueued back to
                      back,
                      balanced by ``partition_grid`` (GRID2D, eps 0.1,
                      M = N = 128 units of 128), whose columns' inner loops
                      run as jobs of one ``FleetScheduler`` per outer round
                      (the fleet rounds are counted from a telemetry sink's
                      ``fleet.round`` spans and printed).  It must converge, launch
                      the kernel exactly as often as the speed functions'
                      evaluations times their repeats times four, every
                      launch on ``"wgmma"``, and the
                      final partition, measured again five times, must have
                      median imbalance <= 2*eps; the CPM partition's
                      measured makespan is printed beside it;
 10. ``energy``     — the time/energy Pareto front (``SpeedStore.
                      pareto_front``, 33 points) on the reference's sweep
                      fixture at p = 8 and p = 1024 (n = 100 p), banks on
                      the card in float64 (the interior thresholds as one
                      stacked [T, p, k] partition) against numpy on the
                      host: times, energies and every allocation row
                      bit-identical, strictly monotone, index 0 the
                      time-optimal partition, index -1 the energy-optimal
                      one, and ``Scheduler.partition(objective="pareto",
                      energy_cap=...)`` equal to numpy's; cold and warm ms
                      on both;
 11. ``hier``       — the two-level partitioner: (a) ``Hierarchy`` at
                      p = 10^4 random monotone estimates (4 knots) in
                      groups of 1000, n = 20 p: the card's allocations,
                      t_outer and aggregate bank bit-identical to the
                      host's, makespan within 1.05x the flat device
                      partition's, and one group of all p equal to the
                      flat device partition, with cold and warm ms of each;
                      (b) the ``dfpa`` phase's loop once more with
                      ``Scheduler(groups=[0, 0, 1, 1, 2, 2, 3, 3])``, so
                      every round after the first runs under the two-level
                      partitioner, held to the ``dfpa`` phase's gates;
 12. ``obs``        — the ``dfpa`` phase's loop once more with a
                      ``repro_torch.obs`` sink installed: the Chrome trace
                      (``build/obs_trace.json``) is valid JSON with one
                      ``scheduler.autotune`` span, one
                      ``speedstore.partition`` span per call of the store's
                      ``partition_units`` (and no ``scheduler.partition``),
                      and ``speedstore.fold_in`` counts the rounds; the
                      ``dfpa`` phase's gates hold; and what the sink costs;
 13. ``straggler``  — the serving loop's order on the DFPA panels
                      (``straggler_actions`` before ``observe``) under a
                      ``FlightRecorder``: the eight processors converge,
                      processor 0 then runs its panel 2, 4, 8, ... times
                      more each round until QUARANTINE lands on it
                      (REPROFILE first), ``leave`` drops it, and the seven
                      survivors converge within eps and re-measure within
                      2*eps; launches as the rounds account for, all
                      ``"wgmma"``; the recorder's dump
                      (``build/straggler.flightrec.json``) names it;
 14. ``fleet``      — the multi-tenant fleet (``repro_torch.fleet``), carry
                      on the card: (a) in float64, the reference's
                      ``parity_gate`` (q = 8 jobs, p = 100: equal to eight
                      numpy ``autotune`` loops and the numpy fleet bit for
                      bit, and as many device solves as the reference's
                      fleet counts), ``hier_parity_gate`` (q = 4: one group
                      equals flat, four groups within 1.05x its makespan and
                      equal to numpy) and ``bucket_gate`` (lane buckets equal
                      no buckets, with the reference's restack count); (b)
                      ``make_tenants(q=16, p=1000)`` measurement rounds,
                      torch fleet (CUDA events and host walls) beside the
                      numpy fleet, under exact times (with 16 sequential
                      torch sessions beside them) and under 2 % noise, the
                      torch fleet's allocations equal to numpy's after
                      every round; (c) three tenants with their own repeats
                      sharing the ``dfpa`` phase's eight processors and
                      panels, measured through a ``BatchedSimulatedExecutor2D``
                      that times each panel with CUDA events after one
                      warm-up per tenant and processor: all converge at
                      eps 0.1, launches as the rounds and warm-ups account
                      for, all ``"wgmma"``, each tenant's final distribution
                      re-measured within 2*eps; (d) the pipelined rounds:
                      ``parity_gate``'s case with ``pipeline=True`` at depth
                      0 and 1, each bit-identical to the sync fleet with the
                      reference's counts (``FLEET_PIPELINE_*``), every
                      pre-dispatched partition queued under sync debug mode
                      ``"error"`` (host ms beside its CUDA-event ms); the
                      q = 16 x p = 1000 serving cycle (``rebalance`` +
                      ``observe``), sync beside depth 1 under exact times and
                      2 % noise and depth 0 under exact times (equal to
                      sync), every allocation summing to n and no
                      pre-dispatch reading a carry more than one generation
                      old; and (c) again at ``pipeline_depth=0``, its
                      launches counted in the phase's;
 15. ``dispatch``   — the serving dispatch (``ReplicaDispatcher``): (a)
                      ``dispatch_parity_gate`` — host-simulated replicas
                      (the reference's serving demo, 4 replicas and 64
                      chunks; tests/test_fleet_pipeline.py's two tenants),
                      the bank on the card in float64 beside numpy on the
                      host: ``balance`` and ``balance_fleet`` in sync and at
                      pipeline depth 0 and 1 bit-identical, a repeated
                      ``balance_fleet`` on the same session with no restack
                      and no new CUDA graph, and REPROFILE on the decayed
                      replica within patience, on no other, before and
                      after a resize; (b) ``balance`` over four
                      recurrentgemma-2b replicas at full width sharing the
                      card (one set of weights, seed 0): replica i serves
                      its x chunks of 128 prompt tokens as one batch to
                      their first token, r_i = 1, 2, 3, 4 times, each call
                      the median of 3 CUDA-event timings; n = 192, eps 0.1:
                      converged, the final distribution re-measured 5
                      times within 2*eps, ``flash_attention`` 8 and
                      ``rglru_scan`` 18 launches per prefill, flash all
                      ``"wgmma"``; (c) two tenants on those replicas
                      through ``balance_fleet`` (``chat``: 192 chunks of
                      128 tokens, ``summarize``: 48 of 512), then 3 steady
                      epochs of ``rebalance``, time-sliced serving
                      (``run_jobs``), ``straggler_actions`` and
                      ``observe``: every allocation sums to n, no straggler
                      action, each round's wall cost the busiest replica's
                      sum, launches as in (b);
 16. ``decoders``   — the dense, MoE and MLA decoders (``DECODERS``, random
                      weights, seed 0, each freed before the next): (a)
                      gemma2-2b as published (26 layers, 2.6 B fp32
                      parameters), batch 2, an 8,192-token prompt (past
                      its local layers' window of 4,096) and 32 tokens;
                      (b) granite-moe-1b-a400m as published (24 layers, 32
                      experts, top-8), batch 4, 2,048 tokens, 16 new; (c)
                      gemma2-27b, granite-20b and stablelm-12b at full
                      width and 4 layers, deepseek-v2-236b at full width
                      and 2 layers (its dense prefix layer and one MoE
                      layer of 160 experts), batch 2, 1,024 tokens, 8 new.
                      Each: one ``generate`` must launch ``flash_attention``
                      once per attention layer, all on ``"wgmma"`` (at
                      stablelm's head_dim 160 and MLA's 192 too), three
                      give identical tokens,
                      prefill + one decode step agree with the full
                      forward (rel 0.05; MoE at capacity factor 8), and
                      the kernel agrees with its plain version on the
                      prefill's own inputs of the last local and global
                      layer (as at the serve shape), timed beside it and,
                      without softcap or window, beside SDPA; then
                      the kernel at gemma2-2b's prefill shape timed beside
                      the plain version, SDPA (no softcap) and its bound;
                      (d) the six smoke models in float32 give the CPU's
                      tokens on the card;
 17. ``train``      — the training path (``repro_torch.launch.train``),
                      random weights, seed 0, each model freed before the
                      next: (a) gemma2-2b as published (26 layers,
                      ``remat="full"``, ``xent_chunk`` 512) through
                      ``train_single`` (the in-place AdamW update), 6 steps
                      of batch 8 x 1,024: the loss finite and falling, and
                      exactly 26 x 2 ``flash_attention`` launches a step
                      (the forward and the remat recompute), all
                      ``"wgmma"``; step ms, tokens/s, peak memory; (b)
                      granite-moe-1b-a400m as published through
                      ``train_hetero``: four groups with slowdowns 1.0 /
                      1.4 / 2.0 / 3.1 share the card, 16 units of 2 x 512
                      tokens a step, 8 steps, eps 0.15: at least one
                      rebalance, ``d[3] < d[0]`` at the end, every ``d``
                      summing to 16, the loss falling, 24 x 2 flash
                      launches a unit; (c) recurrentgemma-2b at full width
                      cut to its two prefix layers and one pattern unit
                      (5 layers), 2 steps of 4 x 1,024: ``rglru_scan`` 3
                      launches a recurrent layer a step (forward, remat,
                      the backward's reversed recurrence); (d) on inputs
                      captured from (a) and (c): flash's ``Function``
                      forward (the kernel, ``"wgmma"``) against
                      ``flash_attention_ref`` on float32 copies, as the
                      serve phase holds it, with a planted forward fault (the first key tile
                      dropped: at 1,024 tokens both windows cover every
                      key), and bit-identical to ``flash_attention_cuda``
                      with the model's arguments; each kernel's
                      ``autograd.Function`` against autograd through its
                      plain version (flash on float32 copies: the kernel
                      and the backward take the logits in fp32;
                      ``dq``/``dk``/``dv`` rel 2e-2,
                      the scan's ``dlog_a``/``db``/``dh0`` rel 1e-4), a
                      planted fault failing each check (a backward without
                      the causal mask; a reversed recurrence whose decays
                      are not shifted), timed beside the plain versions;
                      and a smoke-width checkpoint saved, restored bit for
                      bit and resumed to the uninterrupted step's loss;
 18. ``families``   — the xLSTM, encoder-decoder and vision-prefix
                      families (``FAMILY_*``, random weights, seed 0, each
                      freed before the next): (a) xlstm-350m as published
                      (24 layers, 0.39 B parameters) served by
                      ``ServeEngine``, batch 4, a 1,024-token prompt, 16
                      tokens: no kernel launched, two ``generate`` calls
                      identical, a 768-token prefill and 256 teacher-forced
                      decode steps within rel 0.05 of the full forward
                      (decode timed over those steps); (b)
                      seamless-m4t-medium as published (12 + 12 layers,
                      0.61 B) through ``encdec_prefill`` and
                      ``encdec_decode_step``: frames 2 x 1,024, a prompt of
                      128, 16 tokens; 36 flash launches a run (12 encoder,
                      12 decoder, 12 cross), all ``"wgmma"``; two runs
                      identical; prefill + decode within rel 0.05 of the
                      full decoder; the kernel on the prefill's own
                      encoder, decoder and cross inputs and on random
                      operands at (Sq, Sk) = (1,000, 130) and (130, 1,000),
                      each with its planted fault; (c) pixtral-12b at full
                      width cut to 4 layers, 256 prefix embeddings + 1,024
                      text tokens, batch 2, 8 tokens: 4 ``"wgmma"``
                      launches, identical runs, rel 0.05 to the full
                      forward, the kernel on its prefill's inputs; (d)
                      ``train_single`` of xlstm-350m and seamless-m4t-medium
                      as published, 2 steps of 4 x 512: losses finite and
                      falling, no launch (xLSTM) and 144 ``"wgmma"``
                      launches (seamless: forward and remat), then
                      ``FlashAttention``'s gradients on (b)'s captured
                      cross inputs (Sq 128, Sk 1,024) within
                      ``TRAIN_GRAD_TOL`` with the causal-mask fault
                      planted; (e) the three smoke models in float32 give
                      the CPU's tokens on the card.

 19. ``dryrun``     — the dry run (``repro_torch.launch.dryrun``) held
                      against the card: (a) ``launch.mesh.HW.HBM_BYTES``
                      equals the card's ``total_memory``; every
                      architecture at decode_32k and the cells of (b)
                      traced on meta tensors (each ends ``ok`` or
                      ``skipped``, never ``error``; the full 40-cell sweep
                      takes minutes, ``python -m repro_torch.launch.dryrun
                      --arch all --shape all``); (b) the 1-unit variants of
                      ``DRYRUN_REAL`` (a train, a prefill and a decode
                      cell, flash in the first two) run for real with
                      random weights: the peak allocated above the
                      phase's baseline within ``DRYRUN_MEM_TOL`` (10 %) of
                      the trace's resident bytes, the CUDA-event wall at
                      least the trace's ``compute_s``, and the kernels
                      launched as often as the trace called them.
 20. ``examples``   — the ten twins in ``examples_torch/``, each through its
                      ``main(device="cuda")`` (the printed lines go to
                      ``build/examples/<name>.txt``): (a) each twin's own
                      claims (quickstart converged within eps, DFPA's 2-D
                      time below CPM's, one group = flat and torch = numpy
                      in the hierarchy, the energy budgets met, the warm
                      fleet session faster than the cold one, Part 1's
                      pipeline counters the reference's, replica 2
                      quarantined in obs and serve_trace, 16 tokens per
                      request, the slowest training group ending with the
                      fewest units); (b) the flash launches of the two
                      model twins (the smoke stablelm-12b served, the smoke
                      granite-20b trained: bf16 at head_dim 16) by route,
                      all on ``"wgmma"``, none in the other eight, and the
                      kernel on each one's first captured flash call held
                      against its plain version at bf16's 2e-2, timed
                      beside it, SDPA and its bound; (c) each twin's
                      seconds and fleet_pipeline's sync and pipelined ms
                      per epoch.

Then it prints the ``kernels`` summary line (with the launches by route of
the kernels that have routes, ``matmul_update``'s by phase, ``dfpa``,
``grid``, ``hier``, ``obs``, ``straggler`` and ``fleet``, and
``flash_attention``'s and ``rglru_scan``'s, ``serve``, ``dispatch``,
``decoders``, ``train``, ``families``, ``dryrun`` and (flash only)
``examples``; flash's row also carries
``decoders_timing``), the card's name and power limit
as ``nvidia-smi`` gives them, and, last, ``{"ok": true, "device": ...}``.
It imports only ``repro_torch``, ``torch``, ``numpy`` and, by path, the
twins in ``examples_torch/`` (which import the same), and reads the golden
trace as data.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import pathlib
import platform
import subprocess
import sys
import time
import weakref
from typing import Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import _build  # noqa: E402  (needs the checkout's src/ on the path)
from repro_torch.core import (  # noqa: E402
    BatchedSimulatedExecutor2D,
    CallableExecutor,
    Hierarchy,
    ModelBank,
    PiecewiseLinearFPM,
    Policy,
    Scheduler,
    SimulatedExecutor,
    SpeedStore,
    TorchModelBank,
    imbalance,
    make_hcl_time_fns,
)
from repro_torch.core.energy import energy_model  # noqa: E402
from repro_torch.core import modelbank_torch as mbt  # noqa: E402
from repro_torch.core.modelbank_torch import numpy_sum_block, np_order_sum  # noqa: E402
from repro_torch.core.partition import _partition_units_bank  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.fleet import FleetScheduler, JobSpec  # noqa: E402
from repro_torch.kernels import flash_attention, matmul_update, ops, rglru_scan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    attention_backward,
    flash_attention_cuda,
    flash_attention_route,
    launch_operands,
)
from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS as FLASH_WGMMA_HEAD_DIMS  # noqa: E402
from repro_torch.kernels.flash_attention import wgmma_registers as flash_wgmma_registers  # noqa: E402
from repro_torch.kernels.flash_attention import wgmma_smem_bytes as flash_wgmma_smem_bytes  # noqa: E402
from repro_torch.kernels.matmul_update import (  # noqa: E402
    matmul_update_cuda,
    matmul_update_route,
    wgmma_smem_bytes,
)
from repro_torch.kernels.ref import flash_attention_ref, matmul_update_ref, rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rglru import RGLRUScan, chunk_steps, rglru_scan_cuda  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch.train import train_hetero, train_single  # noqa: E402
from repro_torch.nn import tree_leaves  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.runtime import init_train_state, make_train_step  # noqa: E402
from repro_torch.launch import dryrun, paper_tables  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402
from repro_torch.launch.matmul_grid import GRID_EPS, GRID_UNITS, MatmulGrid  # noqa: E402
from repro_torch.launch.serve import demo_replica_run, kernels_for  # noqa: E402
from repro_torch.obs import FlightRecorder, Telemetry, export_chrome_trace, use  # noqa: E402
from repro_torch.obs.report import MetricsSnapshot  # noqa: E402
from repro_torch.models import transformer as lm_module  # noqa: E402
from repro_torch.models.encdec import (  # noqa: E402
    EncoderDecoder,
    _cross_kv_all,
    _dec_logits,
    apply_decoder,
    encdec_decode_step,
    encdec_prefill,
    encode,
    init_encdec,
    init_encdec_cache,
)
from repro_torch.models.frontends import stub_frame_embeddings, stub_patch_embeddings  # noqa: E402
from repro_torch.models.moe import router_probs, top_k as moe_top_k  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    LanguageModel,
    apply_lm,
    decode_step,
    init_cache,
    init_lm,
    lm_logits,
    prefill,
)
from repro_torch.runtime import ReplicaDispatcher, ServeEngine, StragglerAction  # noqa: E402

# the H100 SXM's published dense peaks and memory rate (launch.mesh.HW)
PEAK_FLOPS = {torch.bfloat16: HW.PEAK_FLOPS_BF16, torch.float32: HW.PEAK_FLOPS_FP32}
PEAK_BYTES = HW.HBM_BW

MATMUL_CASES = [  # (M, N, K, bm, bn, bk): the reference's cases, then ragged ones
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 128, 256, 128),
    (512, 256, 1024, 256, 256, 512),
    (128, 1024, 256, 64, 512, 256),
    (100, 96, 40, 256, 256, 512),  # blocks clip to the shape; wgmma route
    (72, 90, 36, 256, 256, 512),  # K, N not multiples of 8; "tile" route
    (1024, 4096, 256, 1024, 4096, 256),  # wgmma route, 512 blocks
    (1000, 4000, 200, 1000, 4000, 200),  # wgmma route, ragged M, N and K
]
ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # times sqrt(K); rtol 2e-2

# the main path: N x N bf16 panels, 512 units of 32 rows, eight processors
DFPA_N = 16384
DFPA_UNIT_ROWS = 32
DFPA_UNITS = DFPA_N // DFPA_UNIT_ROWS
DFPA_BLOCKS = dict(bm=32, bn=256, bk=512)
DFPA_REPEATS = [1, 1, 2, 2, 3, 3, 4, 4]
DFPA_EPS = 0.1
DFPA_MAX_OBSERVE_ROUNDS = 20  # the grouped loop's rounds (observe has no probe escape)

# the reference's FLASH_CASES and RGLRU_CASES (tests/test_kernels.py), as data
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# at the serve shape (bf16, up to 2048 visible keys a row) outputs average
# many values and are small: atol 2e-3, rtol 2e-2 (see _check_serve_flash)
SERVE_FLASH_TOL = (2e-3, 2e-2)
FLASH_CASES = [  # (B, H, Kv, Sq, Sk, D, kwargs, blocks)
    (1, 2, 2, 128, 128, 64, dict(causal=True), 64),
    (2, 4, 2, 128, 128, 64, dict(causal=True), 64),  # GQA
    (2, 4, 1, 128, 128, 32, dict(causal=True), 64),  # MQA
    (1, 2, 2, 128, 128, 64, dict(causal=True, window=32), 64),  # sliding window
    (1, 2, 2, 128, 128, 64, dict(causal=True, softcap=30.0), 64),  # gemma softcap
    (1, 2, 2, 128, 128, 64, dict(causal=False), 64),  # encoder
    (1, 2, 2, 64, 256, 64, dict(causal=True), 64),  # right-aligned queries
    # the window's first key tile fully masked for most rows of a query tile
    (1, 2, 1, 256, 256, 64, dict(causal=True, window=40), None),
    # ragged lengths no block divides, at the model's head_dim and heads
    (2, 10, 1, 333, 333, 256, dict(causal=True, window=100, scale=0.0625), None),
    # the "wgmma" route at head_dim 256: an odd group count, softcap, GQA
    # with lengths no 128-row or 64-key tile divides
    (2, 3, 1, 200, 200, 256, dict(causal=True), None),
    (1, 2, 1, 190, 190, 256, dict(causal=True, softcap=30.0), None),
    (1, 4, 2, 97, 161, 256, dict(causal=True, window=50), None),
    # the decoders' head dims on the "wgmma" route: stablelm-12b's 160 and
    # deepseek-v2's MLA scores at 192, lengths no tile divides
    (2, 8, 2, 300, 300, 160, dict(causal=True), None),
    (1, 4, 1, 190, 190, 160, dict(causal=True, softcap=30.0, window=70), None),
    (2, 4, 4, 300, 300, 192, dict(causal=True, scale=192 ** -0.5), None),
    (1, 4, 2, 97, 161, 192, dict(causal=True, window=50), None),
]
# stablelm-12b's and deepseek-v2's prefill shapes at the decoders phase's
# batch and prompt: (arch, B, S); H, Kv and D from the config (MLA's scores
# at nope + rope)
FLASH_WIDE_TIMING = [("stablelm-12b", 2, 1024), ("deepseek-v2-236b", 2, 1024)]
# head_dim 16 and 32 on "wgmma" at bf16 (FLASH_TOL), each launched twice:
# (B, H, Kv, Sq, Sk, D, kwargs, K/V broadcast over heads, the model's views)
FLASH_SMALL_CASES = [
    (2, 4, 2, 16, 16, 16, dict(causal=True), False, True),  # the smoke stablelm-12b served
    (2, 4, 1, 32, 32, 16, dict(causal=True), False, True),  # the smoke granite-20b trained, MQA
    (1, 8, 2, 300, 300, 16, dict(causal=True, window=70, softcap=30.0), False, False),
    (2, 6, 3, 97, 161, 32, dict(causal=True, window=50), False, True),
    (2, 4, 4, 200, 130, 32, dict(causal=False), False, False),
    # K/V broadcast over heads (a zero head stride): the one-head view
    (2, 8, 4, 150, 150, 16, dict(causal=True), True, False),
    (2, 8, 4, 150, 150, 32, dict(causal=True, window=70), True, False),
    (2, 8, 4, 150, 150, 64, dict(causal=True), True, False),
    (1, 10, 2, 150, 150, 128, dict(causal=True, softcap=30.0), True, False),
    (1, 10, 2, 150, 150, 256, dict(causal=True, window=70), True, False),
]
# where the card sets the time at head_dim 16 and 32: (B, H, Kv, S), causal
FLASH_SMALL_TIMING = (4, 32, 8, 4096)
RGLRU_CASES = [  # (B, S, D, bs, bd, with_h0)
    (1, 128, 128, 64, 128, False),
    (2, 256, 512, 128, 256, False),
    (3, 512, 256, 256, 128, False),
    (2, 256, 512, 128, 256, True),  # an initial state, as the model's cache carries
    (2, 77, 130, None, None, True),  # ragged
    (3, 50, 200, None, None, True),  # S below one 64-step chunk
    (3, 130, 300, None, None, True),  # B * D not a multiple of the 128-channel tile
    (2, 4096, 64, None, None, True),  # a long sequence at a narrow D
]
RGLRU_NEAR_ONE = 0.002  # log_a scaled by this keeps a near 1 (the model's decays)

# the serving path: recurrentgemma-2b at full width and depth
SERVE_ARCH = "recurrentgemma-2b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 4096, 32
SERVE_LAUNCHES = {"flash_attention": 8, "rglru_scan": 18}  # one per local / rec layer
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW = 2, 24, 8

# the stacked repartition: q columns of p rows of random monotone estimates
REPART_Q, REPART_P, REPART_KNOTS = 16, 4096, 8
FFMPA_ANALYTIC_TOL = 0.005  # grid (a): FFMPA's analytic models sample-and-banked onto the bank

# the time/energy front: the reference's sweep fixture at two sizes
ENERGY_PS = (8, 1024)
ENERGY_POINTS = 33
# the hierarchy: p = 10^4 random monotone estimates (4 knots) in groups of
# 1000, and the DFPA loop's eight processors in pairs of like ones
HIER_P, HIER_KNOTS, HIER_GROUP, HIER_SEED = 10_000, 4, 1000, 4
HIER_DFPA_GROUPS = [0, 0, 1, 1, 2, 2, 3, 3]
# the straggler phase: processor 0 of the DFPA loop (r = 1, the most units)
# runs its panel 2, 4, 8, ... times more from the round after the loop
# converges (doubling each round, capped at 256x) until QUARANTINE lands
STRAGGLER_PROC, STRAGGLER_CAP, STRAGGLER_MAX_SLOW_ROUNDS = 0, 256, 12
# the fleet: the reference's fleet_scale.py fixtures (parity_gate,
# hier_parity_gate, bucket_gate; make_tenants for the scale rounds), and
# three tenants sharing the DFPA phase's eight processors and panels
FLEET_PARITY = dict(q=8, p=100, seed=11)
FLEET_HIER = dict(q=4, p=100, seed=23)
FLEET_BUCKET = dict(p=50, seed=41)
FLEET_EPS, FLEET_MAX_ITER = 0.03, 8
# what the reference's jax fleet counts on parity_gate and bucket_gate
# (tests/test_torch_fleet.py holds these numbers against it)
FLEET_PARITY_DISPATCHES, FLEET_BUCKET_RESTACKS = 15, 2
# ... and on parity_gate's case with pipeline=True at depth 0 and 1
# (tests/test_torch_fleet_pipeline.py holds these against it)
FLEET_PIPELINE_DEPTH0 = dict(rounds=8, device_dispatches=15, predispatches=7, stale_reads=0, speculative_misses=0)
FLEET_PIPELINE_DEPTH1 = dict(rounds=8, device_dispatches=21, predispatches=7, stale_reads=0, speculative_misses=6)
FLEET_SERVE_WARMUP, FLEET_SERVE_EPOCHS = 2, 3  # part (d)'s serving epochs: untimed, then timed
FLEET_SCALE_Q, FLEET_SCALE_P, FLEET_SCALE_ROUNDS = 16, 1000, 3
FLEET_TENANT_REPEATS = [DFPA_REPEATS, DFPA_REPEATS[::-1], [2, 3, 4, 1, 2, 3, 4, 1]]
ARTIFACTS = ROOT / "build"  # the obs trace and the flight recorder's dump
# the serving dispatch: (a) host-simulated replicas, src/repro/launch/serve.py's
# demo (4 replicas, 64 chunks) and tests/test_fleet_pipeline.py's tenants;
# (b) DFPA over four full-width recurrentgemma-2b replicas sharing the card,
# replica i serving its x chunks (requests of 128 prompt tokens, to their
# first token) as one batch r_i times, each call the median of 3 CUDA-event
# timings; (c) two tenants through balance_fleet, then steady epochs
DISPATCH_DEMO_CHUNKS, DISPATCH_DEMO_EPS = 64, 0.1
DISPATCH_TENANTS, DISPATCH_TENANTS_EPS = {"chat": 48, "embed": 96}, 0.15
DISPATCH_REPEATS = [1, 2, 3, 4]
DISPATCH_N, DISPATCH_PROMPT, DISPATCH_SAMPLES = 192, 128, 3
DISPATCH_EPS, DISPATCH_REMEASURE = 0.1, 5
DISPATCH_CYCLE = {"chat": (192, 128), "summarize": (48, 512)}  # tenant: (chunks, prompt tokens)
DISPATCH_EPOCHS = 3
# before (b) and (c), each kernel against its plain version at the batches
# the phase can give it, (batch, prompt): one chunk, the largest share seen
# (r = 1), and every chunk of a tenant, at both prompt lengths
DISPATCH_KERNEL_SHAPES = [(1, 128), (97, 128), (192, 128), (1, 512), (25, 512), (48, 512)]
# the dense, MoE and MLA decoders at full width: (arch, layers (None: the
# published depth), batch, prompt, new tokens, the route their prefill's
# flash attention takes).  The last four do not fit the card in fp32 at
# their published depth (108, 80, 48 and 944 GB), so they run cut to a few
# layers (deepseek-v2: its dense prefix layer and one MoE layer).
DECODERS = [
    ("gemma2-2b", None, 2, 8192, 32, "wgmma"),
    ("granite-moe-1b-a400m", None, 4, 2048, 16, "wgmma"),
    ("gemma2-27b", 4, 2, 1024, 8, "wgmma"),
    ("granite-20b", 4, 2, 1024, 8, "wgmma"),
    ("stablelm-12b", 4, 2, 1024, 8, "wgmma"),
    ("deepseek-v2-236b", 2, 2, 1024, 8, "wgmma"),
]
# the MoE capacity factor of the prefill + decode vs full forward check
# (capacity drops depend on the sequence length; tests/test_models.py:87-91)
DECODER_CHECK_CAPACITY = 8.0
# ... and the least share of (token, choice) pairs routed alike there in
# bfloat16 (tests/test_torch_decoders.py holds the port to the reference so)
ROUTING_AGREEMENT = 0.99
# the train phase: (a) gemma2-2b as published through train_single (the
# reference CLI's batch 8, seq 1024); (b) granite-moe-1b-a400m as published
# through train_hetero; (c) recurrentgemma-2b cut to its prefix and one
# pattern unit through train_single
TRAIN_SINGLE = dict(arch="gemma2-2b", batch=8, seq=1024, steps=6, lr=3e-3)
TRAIN_HETERO = dict(arch="granite-moe-1b-a400m", groups=4, hetero=[1.0, 1.4, 2.0, 3.1], units=16,
                    micro_batch=2, seq=512, steps=8, eps=0.15, lr=3e-3)
TRAIN_REC = dict(arch="recurrentgemma-2b", batch=4, seq=1024, steps=2, lr=3e-3)
# (d): a kernel's autograd.Function against autograd through its plain
# version on the captured inputs, max |got - want| over max |want|
TRAIN_GRAD_TOL = {"flash_attention": 2e-2, "rglru_scan": 1e-4}
# the families phase: (a) xlstm-350m as published through ServeEngine (the
# decode check: a prefill of 768 tokens and 256 teacher-forced steps, since
# the mLSTM's 256-position chunks must divide a prefill); (b)
# seamless-m4t-medium as published through encdec_prefill /
# encdec_decode_step, and flash on random operands with Sq != Sk both ways;
# (c) pixtral-12b at full width cut to 4 layers (49 GB in fp32 at its
# published 40), its 256 prefix embeddings + text; (d) train_single of
# xlstm-350m and seamless-m4t-medium as published
FAMILY_XLSTM = dict(arch="xlstm-350m", batch=4, prompt=1024, new=16, check_prefill=768)
FAMILY_SEAMLESS = dict(arch="seamless-m4t-medium", batch=2, frames=1024, prompt=128, new=16)
FAMILY_RANDOM_CROSS = [(2, 16, 16, 1000, 130, 64), (2, 16, 16, 130, 1000, 64)]  # (B, H, Kv, Sq, Sk, D)
FAMILY_PIXTRAL = dict(arch="pixtral-12b", layers=4, batch=2, text=1024, new=8)
FAMILY_TRAIN = (dict(arch="xlstm-350m", batch=4, seq=512, steps=2, lr=3e-3),
                dict(arch="seamless-m4t-medium", batch=4, seq=512, steps=2, lr=3e-3))
# the dryrun phase: (a) every architecture at DRYRUN_SHAPE traced; (b) the
# 1-unit variants of these cells, the ones that fit the card at one unit
# (a train cell, a prefill and a decode; flash in the first two), run for
# real and held to the trace's resident bytes and compute bound
DRYRUN_SHAPE = "decode_32k"
DRYRUN_REAL = [("seamless-m4t-medium", "train_4k"), ("seamless-m4t-medium", "prefill_32k"),
               ("recurrentgemma-2b", "decode_32k")]
DRYRUN_MEM_TOL = 0.10
# the ``examples`` phase: the ten twins in ``examples_torch/``, the two that
# run a model (flash at head_dim 16, the ``"wgmma"`` route) among them
EXAMPLES = ["quickstart", "matmul_2d_dfpa", "hierarchy_walkthrough", "energy_pareto_walkthrough",
            "fleet_serve", "fleet_pipeline_walkthrough", "obs_walkthrough", "serve_trace_walkthrough",
            "elastic_serve", "hetero_train"]
EXAMPLE_MODELS = ("elastic_serve", "hetero_train")
# beside each twin's own claims: what the reference's script prints for these
# deterministic counters (Part 1's stale reads, misses and pre-dispatches; the
# obs session's device programs, as the reference's jax fleet counts them)
EXAMPLE_COUNTERS = {"fleet_pipeline_walkthrough": {"stale_reads": 10, "speculative_misses": 4, "predispatches": 16},
                    "obs_walkthrough": {"device_dispatches": 8}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(M: int, N: int, K: int, dtype) -> tuple:
    """Least time the card needs for C += A.B: operations over the peak of
    their type, or the bytes (A, B, C read once, C written once) over the
    memory rate — whichever is larger, in ms."""
    elt = torch.finfo(dtype).bits // 8
    t_ops = 2.0 * M * N * K / PEAK_FLOPS[dtype]
    t_bytes = elt * (M * K + K * N + 2 * M * N) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    emit({
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "capability": list(cap),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": platform.python_version(), "numpy": np.__version__,
    })
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (Hopper), got {cap}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: float32 matmuls must not run in TF32")
    return smi


def phase_build() -> None:
    for name, built in _build.build().items():
        emit({
            "phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
            "library": str(built.path.relative_to(ROOT)), "seconds": built.seconds,
            "ptxas": built.ptxas_lines(),
        })
    emit({
        "phase": "build", "matmul_update_wgmma_dynamic_smem_bytes": wgmma_smem_bytes(),
        "flash_attention_wgmma_dynamic_smem_bytes": {D: flash_wgmma_smem_bytes(D) for D in FLASH_WGMMA_HEAD_DIMS},
        # [given by ptxas, needed by the setmaxnreg split]: the library loads only if every pair holds
        "flash_attention_wgmma_registers": {D: list(flash_wgmma_registers(D)) for D in FLASH_WGMMA_HEAD_DIMS},
        "rglru_scan_chunk_steps": chunk_steps(),
    })


def _operands(M, N, K, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
        for shape in ((M, N), (M, K), (K, N))
    )


def _within(got, want, K, dtype) -> tuple:
    """The reference's check, ``|got - want| <= atol sqrt(K) + 2e-2 |want|``,
    and the largest absolute error."""
    err = (got.float() - want).abs()
    return bool((err <= ATOL[dtype] * float(np.sqrt(K)) + 2e-2 * want.abs()).all()), float(err.max())


def _check_parity(M, N, K, blocks, dtype, seed=0, planted_fault=False, phase="kernels") -> float:
    """The kernel against its plain version, launched twice on the same
    inputs (bit-identical results), through the route the wrapper picks.
    With ``planted_fault`` a plain version that drops the last 64-deep
    slice of K (a lost pipeline stage) must fail the same check."""
    c, a, b = _operands(M, N, K, dtype, seed)
    want = matmul_update_ref(c, a, b).float()
    fault = matmul_update_ref(c, a[:, : K - 64], b[: K - 64]).float() if planted_fault else None
    again = c.clone()
    before = dict(matmul_update_cuda.launches_by_route)
    got = matmul_update(c, a, b, impl="cuda", **blocks)
    matmul_update(again, a, b, impl="cuda", **blocks)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in matmul_update_cuda.launches_by_route.items()}
    route = matmul_update_route(M, N, K, dtype, (c.data_ptr(), a.data_ptr(), b.data_ptr()))
    ok, max_err = _within(got, want, K, dtype)
    row = {
        "phase": phase, "case": [M, N, K], "blocks": [blocks["bm"], blocks["bn"], blocks["bk"]],
        "dtype": _dtype_name(dtype), "route": route, "launches_by_route": routes,
        "max_abs_err": max_err,
        "tol": f"atol {ATOL[dtype]}*sqrt(K), rtol 2e-2", "ok": ok, "repeat_bit_identical": torch.equal(got, again),
    }
    if planted_fault:
        row["k_slice_dropped_passes"], row["k_slice_dropped_max_abs_err"] = _within(got, fault, K, dtype)
    emit(row)
    if not ok:
        raise SystemExit(f"chip_smoke: matmul_update disagrees with its plain version at {(M, N, K)}")
    if not row["repeat_bit_identical"]:
        raise SystemExit(f"chip_smoke: two matmul_update launches on the same inputs differ at {(M, N, K)}")
    if routes != {r: 2 * (r == route) for r in routes}:
        raise SystemExit(f"chip_smoke: matmul_update at {(M, N, K)} launched {routes}, not twice on {route!r}")
    if planted_fault and row["k_slice_dropped_passes"]:
        raise SystemExit("chip_smoke: the matmul_update check cannot tell a dropped 64-deep K slice")
    return max_err


def _timing(M, N, K, blocks, dtype, planted_fault=False) -> dict:
    """Parity, then times at a main-path shape (bf16, aligned): every timed
    launch must take the ``"wgmma"`` route."""
    max_err = _check_parity(M, N, K, blocks, dtype, seed=1, planted_fault=planted_fault)
    c, a, b = _operands(M, N, K, dtype, 2)
    reps = 20
    before = dict(matmul_update_cuda.launches_by_route)
    ms = cuda_ms(lambda: matmul_update(c, a, b, impl="cuda", **blocks), reps)
    routes = {r: n - before[r] for r, n in matmul_update_cuda.launches_by_route.items()}
    if routes["tile"] or not routes["wgmma"]:
        raise SystemExit(f"chip_smoke: matmul_update timed at {(M, N, K)} launched {routes}, not all 'wgmma'")
    plain_ms = cuda_ms(lambda: matmul_update_ref(c, a, b), reps)
    library_ms = cuda_ms(lambda: c.addmm_(a, b), reps)  # yardstick only
    bound_ms, bound_by = bound(M, N, K, dtype)
    row = {
        "shape": [M, N, K], "dtype": _dtype_name(dtype), "max_abs_err": max_err,
        "route": "wgmma",
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "ratio_to_library": ms / library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "tflops": 2.0 * M * N * K / (ms * 1e-3) / 1e12,
        "gbps": torch.finfo(dtype).bits // 8 * (M * K + K * N + 2 * M * N) / (ms * 1e-3) / 1e9,
    }
    emit({"phase": "kernels", "timing": row})
    return row


def phase_kernels() -> dict:
    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K, bm, bn, bk in MATMUL_CASES:
            _check_parity(M, N, K, dict(bm=bm, bn=bn, bk=bk), dtype)
    c, a, b = _operands(100, 128, 128, torch.bfloat16, 0)
    try:
        matmul_update(c, a, b, impl="cuda", bm=64, bn=64, bk=64)
    except ValueError as exc:
        emit({"phase": "kernels", "indivisible_raises": str(exc)})
    else:
        raise SystemExit("chip_smoke: an indivisible shape did not raise ValueError")
    even_rows = DFPA_UNIT_ROWS * (DFPA_UNITS // len(DFPA_REPEATS))
    main = _timing(even_rows, DFPA_N, DFPA_N, DFPA_BLOCKS, torch.bfloat16, planted_fault=True)
    for rows in (DFPA_UNIT_ROWS, DFPA_UNIT_ROWS * 31):  # the smallest and the slowest's panel
        _timing(rows, DFPA_N, DFPA_N, DFPA_BLOCKS, torch.bfloat16)
    _timing(1024, 8192, 8192, dict(bm=256, bn=256, bk=512), torch.bfloat16)
    _flash_refuses_rows_without_keys()
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            _flash_parity(*case, dtype)
    for case in RGLRU_CASES:
        _rglru_parity(*case)
    _rglru_parity(SERVE_BATCH, SERVE_PROMPT, get_config(SERVE_ARCH).d_rnn, None, None, True, decay=RGLRU_NEAR_ONE)
    for B, H, Kv, Sq, Sk, D, kw, broadcast, views in FLASH_SMALL_CASES:
        _flash_parity(B, H, Kv, Sq, Sk, D, kw, None, torch.bfloat16, broadcast, views, want_route="wgmma")
    flash_row = _flash_timing()
    flash_row["head_dims_160_192"] = [_flash_wide_timing(*shape) for shape in FLASH_WIDE_TIMING]
    flash_row["head_dims_16_32"] = [_flash_small_timing(D) for D in (16, 32)]
    rglru_row = _rglru_timing()
    return {"matmul_update": main, "flash_attention": flash_row, "rglru_scan": rglru_row}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _close(got, want, tol) -> tuple:
    """``|got - want| <= tol + tol |want|`` everywhere (the reference's
    atol = rtol tests), and the largest absolute error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= tol + tol * want.abs()).all()), float(err.max())


def _flash_fp32(q, k, v, *, causal, window, softcap, scale) -> tuple:
    """Attention on the same inputs in fp32 throughout (logits, weights w
    and values): its output, and ``sqrt(sum_j w_j^2 v_j^2)`` for every
    output element, the size of the rounding error that a weighted sum of
    bf16 terms may carry.  One query head at a time."""
    B, H, Sq, D = q.shape
    Sk, G = k.shape[2], H // k.shape[1]
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    terms = torch.empty_like(out)
    for h in range(H):
        logits = torch.einsum("bqd,bkd->bqk", q[:, h].float(), k[:, h // G].float()) * scale
        if softcap > 0:
            logits = softcap * torch.tanh(logits / softcap)
        w = torch.softmax(torch.where(mask, logits, -2e38), dim=-1)
        vf = v[:, h // G].float()
        out[:, h] = w @ vf
        terms[:, h] = ((w * w) @ (vf * vf)).sqrt()
    return out, terms


def _check_serve_flash(got, q, k, v, kw, what: str, fault: Optional[str] = None, fp32: bool = False) -> dict:
    """The kernel's output on the model's attention inputs against its plain
    version: ``|got - want| <= atol + rtol (|want| + terms)`` with
    SERVE_FLASH_TOL.  The ``terms`` part covers rows that sum few keys
    whose values cancel (bf16 weights err relative to the terms, not to
    their sum); rows over many keys are held near atol.  The check's own
    power: a plain version that drops one 64-key tile must fail it — with
    a window, the window one tile short of ``min(window, Sk)``; without
    (a global layer), the first tile of keys left out (a window short by
    one tile would drop only the last rows' oldest keys, under atol at
    Sk in the thousands).  ``fault`` names the planted fault instead
    (``"first_key_tile_dropped"`` or ``"window_one_tile_short"``).  With
    ``fp32`` the plain version (and its fault) runs on float32 copies of
    the inputs: the kernel takes the logits in fp32, the plain version at
    bf16 rounds them to bf16 first, which at large logits (trained
    weights) moves the output more than the tolerance.  Also
    reports, by query-row band, the kernel's and the plain version's
    largest error against attention in fp32 throughout."""
    atol, rtol = SERVE_FLASH_TOL
    kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale")}
    w = min(kw["window"] or k.shape[2], k.shape[2])  # window 0: every key
    exact, terms = _flash_fp32(q, k, v, **kw)
    got = got.float()
    plain = flash_attention_ref(q, k, v, **kw).float()
    operands = (q.float(), k.float(), v.float()) if fp32 else (q, k, v)
    want = flash_attention_ref(*operands, **kw).float() if fp32 else plain
    q, k, v = operands

    def within(out) -> tuple:
        err = (out.float() - want).abs()
        return bool((err <= atol + rtol * (want.abs() + terms)).all()), float(err.max())

    ok, max_err = within(got)
    bands = {}
    Sq = q.shape[2]
    for lo, hi in ((0, 64), (64, w), (w, Sq)):
        if lo < hi <= Sq:
            bands[f"rows {lo}-{hi}"] = {
                "kernel": float((got[:, :, lo:hi] - exact[:, :, lo:hi]).abs().max()),
                "plain": float((plain[:, :, lo:hi] - exact[:, :, lo:hi]).abs().max()),
            }
    if not ok:
        raise SystemExit(f"chip_smoke: flash_attention disagrees with its plain version {what}: {bands}")
    fault_name = fault or ("window_one_tile_short" if kw["window"] else "first_key_tile_dropped")
    if fault_name == "window_one_tile_short":
        fault = flash_attention_ref(q, k, v, **dict(kw, window=w - 64))
    else:
        fault = flash_attention_ref(q, k[:, :, 64:], v[:, :, 64:], **kw)
    passed, fault_err = within(fault)
    del fault
    if passed:
        raise SystemExit(f"chip_smoke: the flash check {what} cannot tell a plain version with its {fault_name}")
    return {
        "max_abs_err": max_err, "tol": f"atol {atol} + rtol {rtol} (|want| + sqrt(sum w^2 v^2))",
        f"{fault_name}_max_abs_err": fault_err, "max_abs_err_vs_fp32": bands,
        **({"against": "the plain version on float32 copies"} if fp32 else {}),
    }


def _flash_operands(B, H, Kv, Sq, Sk, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    def rand(shape, scale):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(dtype)
    return rand((B, H, Sq, D), 0.3), rand((B, Kv, Sk, D), 0.3), rand((B, Kv, Sk, D), 1.0)


def _flash_parity(B, H, Kv, Sq, Sk, D, kwargs, blocks, dtype, broadcast=False, views=False, want_route=None) -> float:
    """The kernel against its plain version, launched twice on the same
    inputs (bit-identical results), on the route the wrapper picks, which
    must be ``want_route`` when one is given.  ``broadcast`` expands one KV
    head to ``Kv`` with a zero head stride; ``views`` passes the model's
    transposed ``(B, S, H, D)`` views."""
    q, k, v = _flash_operands(B, H, 1 if broadcast else Kv, Sq, Sk, D, dtype, seed=Sq + D)
    if broadcast:
        k, v = k.expand(B, Kv, Sk, D), v.expand(B, Kv, Sk, D)
    if views:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    want = flash_attention_ref(q, k, v, **kwargs)
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, impl="cuda", bq=blocks, bk=blocks, **kwargs)
    again = flash_attention(q, k, v, impl="cuda", bq=blocks, bk=blocks, **kwargs)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    route = flash_attention_route(D, dtype, *launch_operands(q, k, v, got)[2:])
    ok, max_err = _close(got, want, FLASH_TOL[dtype])
    emit({
        "phase": "kernels", "kernel": "flash_attention", "case": [B, H, Kv, Sq, Sk, D], "kwargs": kwargs,
        "blocks": blocks, "dtype": _dtype_name(dtype), "kv_broadcast_over_heads": broadcast,
        "k_strides": list(k.stride()), "route": route, "launches_by_route": routes,
        "max_abs_err": max_err, "tol": f"atol = rtol = {FLASH_TOL[dtype]}", "ok": ok,
        "repeat_bit_identical": torch.equal(got, again),
    })
    if not ok:
        raise SystemExit(f"chip_smoke: flash_attention disagrees with its plain version at {(B, H, Kv, Sq, Sk, D, kwargs)}")
    if not torch.equal(got, again):
        raise SystemExit(f"chip_smoke: two flash_attention launches on the same inputs differ at {(B, H, Kv, Sq, Sk, D)}")
    expected = want_route or route
    if routes != {r: 2 * (r == expected) for r in routes} or route != expected:
        raise SystemExit(f"chip_smoke: flash_attention at {(B, H, Kv, Sq, Sk, D)} launched {routes}, not twice on {expected!r}")
    return max_err


def _flash_small_timing(D: int) -> dict:
    """flash_attention at head_dim ``D`` (16 or 32) at FLASH_SMALL_TIMING's
    shape, causal, the default scale, on the ``"wgmma"`` route, as
    ``_flash_timing_at``."""
    B, H, Kv, S = FLASH_SMALL_TIMING
    kw = dict(causal=True, window=0, softcap=0.0, scale=D ** -0.5)
    row = _flash_timing_at(B, H, Kv, S, D, kw, "wgmma", f"at head_dim {D} where the card sets the time",
                           seed=S + D)
    emit({"phase": "kernels", "kernel": "flash_attention", "timing": row})
    return row


def _rglru_operands(B, S, D, with_h0, seed, decay=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    log_a = -decay * torch.nn.functional.softplus(torch.randn((B, S, D), generator=g, device="cuda"))
    b = 0.1 * torch.randn((B, S, D), generator=g, device="cuda")
    h0 = torch.randn((B, D), generator=g, device="cuda") if with_h0 else None
    return log_a, b, h0


def _rglru_parity(B, S, D, bs, bd, with_h0, decay=1.0) -> float:
    """The kernel against its plain version, launched twice on the same
    inputs (bit-identical results); ``decay`` scales log_a."""
    log_a, b, h0 = _rglru_operands(B, S, D, with_h0, seed=S + D, decay=decay)
    want = rglru_scan_ref(log_a, b, h0)
    before = rglru_scan_cuda.launches
    got = rglru_scan(log_a, b, h0, impl="cuda", bs=bs, bd=bd)
    again = rglru_scan(log_a, b, h0, impl="cuda", bs=bs, bd=bd)
    torch.cuda.synchronize()
    launched = rglru_scan_cuda.launches - before
    ok, max_err = _close(got, want, 1e-5)
    emit({
        "phase": "kernels", "kernel": "rglru_scan", "case": [B, S, D], "blocks": [bs, bd], "h0": with_h0,
        "log_a_scale": decay, "dtype": "float32", "launches": launched, "max_abs_err": max_err, "tol": "atol = rtol = 1e-5",
        "ok": ok, "repeat_bit_identical": torch.equal(got, again),
    })
    if not ok:
        raise SystemExit(f"chip_smoke: rglru_scan disagrees with its plain version at {(B, S, D, with_h0)}")
    if not torch.equal(got, again):
        raise SystemExit(f"chip_smoke: two rglru_scan launches on the same inputs differ at {(B, S, D)}")
    if launched != 2:
        raise SystemExit(f"chip_smoke: rglru_scan at {(B, S, D)} launched {launched} times, not twice")
    return max_err


def _flash_refuses_rows_without_keys() -> None:
    """Causal attention with Sq > Sk raises ``ValueError`` on the card
    before any launch."""
    q, k, v = _flash_operands(1, 2, 1, 128, 64, 64, torch.bfloat16, seed=3)
    before = flash_attention_cuda.launches
    try:
        flash_attention(q, k, v, causal=True, bq=None, bk=None)
    except ValueError as exc:
        emit({"phase": "kernels", "kernel": "flash_attention", "causal_sq_gt_sk_raises": str(exc)})
    else:
        raise SystemExit("chip_smoke: causal flash_attention with Sq > Sk did not raise ValueError")
    if flash_attention_cuda.launches != before:
        raise SystemExit("chip_smoke: the refused flash_attention call launched the kernel")


def _bound_ms(ops_count: float, op_dtype, nbytes: float) -> tuple:
    t_ops = ops_count / PEAK_FLOPS[op_dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _routes_timed(wrapper, route, fn, reps) -> float:
    """``cuda_ms`` of ``fn``, failing unless every launch it made went
    through ``route``."""
    before = dict(wrapper.launches_by_route)
    ms = cuda_ms(fn, reps)
    routes = {r: n - before[r] for r, n in wrapper.launches_by_route.items()}
    if any(n for r, n in routes.items() if r != route) or not routes[route]:
        raise SystemExit(f"chip_smoke: timing the {route!r} route launched {routes}")
    return ms


def _flash_timing() -> dict:
    """flash_attention at the serve path's shape: B=4, H=10, Kv=1,
    Sq=Sk=4096, D=256, bf16, causal, window 2048, on the ``"wgmma"`` route."""
    cfg = get_config(SERVE_ARCH)
    kw = dict(causal=True, window=cfg.window, softcap=0.0, scale=cfg.query_scale)
    row = _flash_timing_at(SERVE_BATCH, cfg.num_heads, cfg.num_kv_heads, SERVE_PROMPT, cfg.head_dim, kw,
                           "wgmma", "at the serve shape", seed=7)
    emit({"phase": "kernels", "kernel": "flash_attention", "timing": row})
    return row


def _flash_wide_timing(arch: str, B: int, S: int) -> dict:
    """flash_attention at one decoder's prefill shape with head_dim 160 or
    192 (random operands, causal, the config's scale), on the ``"wgmma"``
    route, as ``_flash_timing_at``."""
    cfg = get_config(arch)
    D = cfg.nope_head_dim + cfg.rope_head_dim if cfg.mla else cfg.head_dim
    H, Kv = cfg.num_heads, cfg.num_heads if cfg.mla else cfg.num_kv_heads  # MLA: K/V decompressed per head
    kw = dict(causal=True, window=0, softcap=0.0, scale=cfg.query_scale or D ** -0.5)
    row = _flash_timing_at(B, H, Kv, S, D, kw, "wgmma", f"at {arch}'s prefill shape", seed=S + D)
    row["arch"] = arch
    emit({"phase": "kernels", "kernel": "flash_attention", "timing": row})
    return row


def _visible_mask(S: int, window: int, Sk: Optional[int] = None, causal: bool = True):
    """The ``(S, Sk)`` (query, key) pairs attention computes, query rows
    right-aligned to the keys (``Sk`` defaults to ``S``)."""
    Sk = S if Sk is None else Sk
    qpos, kpos = torch.arange(Sk - S, Sk, device="cuda"), torch.arange(Sk, device="cuda")
    mask = torch.ones((S, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _flash_bound(B, H, Kv, S, D, window, Sk: Optional[int] = None, causal: bool = True) -> tuple:
    """(bound ms, bound_by, visible pairs a head) of attention at this shape
    in bf16 (causal self-attention unless ``Sk``/``causal`` say otherwise):
    q, k, v read once, o written once; 4 D operations a visible (query,
    key) pair."""
    Sk = S if Sk is None else Sk
    pairs = int(_visible_mask(S, window, Sk, causal).sum())
    nbytes = 2 * (2 * B * H * S * D + 2 * B * Kv * Sk * D)
    return (*_bound_ms(4.0 * D * pairs * B * H, torch.bfloat16, nbytes), pairs)


def _flash_timing_at(B, H, Kv, S, D, kw, route, what, seed) -> dict:
    """flash_attention on random bf16 operands at one causal self-attention
    shape: checked against its plain version (``_check_serve_flash``), two
    launches bit-identical, then timed on ``route`` beside the plain
    version and ``scaled_dot_product_attention`` with the same bool mask
    (which takes no softcap: with ``softcap`` set, the library call
    computes attention without it)."""
    q, k, v = _flash_operands(B, H, Kv, S, S, D, torch.bfloat16, seed=seed)
    got = flash_attention(q, k, v, impl="cuda", bq=None, bk=None, **kw)
    again = flash_attention(q, k, v, impl="cuda", bq=None, bk=None, **kw)
    check = _check_serve_flash(got, q, k, v, kw, what)
    if not torch.equal(got, again):
        raise SystemExit(f"chip_smoke: two flash_attention launches {what} differ")
    del got, again
    ms = _routes_timed(flash_attention_cuda, route, lambda: flash_attention_cuda(q, k, v, bq=None, bk=None, **kw), 20)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), 5)
    mask = _visible_mask(S, kw["window"])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=kw["scale"], enable_gqa=True), 10)  # yardstick only
    del mask
    bound_ms, bound_by, pairs = _flash_bound(B, H, Kv, S, D, kw["window"])
    return {
        "shape": [B, H, Kv, S, S, D], "dtype": "bfloat16", "window": kw["window"], "softcap": kw["softcap"],
        "visible_pairs_per_head": pairs, **check, "repeat_bit_identical": True, "route": route, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "scaled_dot_product_attention(bool mask, enable_gqa=True)"
                   + (", no softcap" if kw["softcap"] > 0 else ""),
        "bound_ms": bound_ms, "bound_by": bound_by, "tflops": 4.0 * D * pairs * B * H / (ms * 1e-3) / 1e12,
    }


def _rglru_timing() -> dict:
    """rglru_scan at the serve path's shape: B=4, S=4096, D=2560, fp32, h0.
    The check's own power: the plain version
    with the carry reset to zero at the chunk boundary in mid-sequence (a
    kernel that loses one carry) must fail it."""
    cfg = get_config(SERVE_ARCH)
    B, S, D = SERVE_BATCH, SERVE_PROMPT, cfg.d_rnn
    log_a, b, h0 = _rglru_operands(B, S, D, True, seed=8)
    got = rglru_scan(log_a, b, h0, impl="cuda", bs=None, bd=None)
    again = rglru_scan(log_a, b, h0, impl="cuda", bs=None, bd=None)
    want = rglru_scan_ref(log_a, b, h0)
    torch.cuda.synchronize()
    ok, max_err = _close(got, want, 1e-5)
    if not ok:
        raise SystemExit("chip_smoke: rglru_scan disagrees with its plain version at the serve shape")
    if not torch.equal(got, again):
        raise SystemExit("chip_smoke: two rglru_scan launches at the serve shape differ")
    t = chunk_steps() * (S // chunk_steps() // 2)  # a chunk boundary in mid-sequence
    fault = torch.cat([want[:, :t], rglru_scan_ref(log_a[:, t:], b[:, t:], None)], dim=1)
    fault_passes, fault_err = _close(got, fault, 1e-5)
    if fault_passes:
        raise SystemExit("chip_smoke: the rglru_scan check cannot tell a carry lost at a chunk boundary")
    del got, again, fault
    ms = cuda_ms(lambda: rglru_scan_cuda(log_a, b, h0, bs=None, bd=None), 20)
    plain_ms = cuda_ms(lambda: rglru_scan_ref(log_a, b, h0), 3)
    nbytes = 4 * (3 * B * S * D + B * D)  # log_a, b read once, h written once, h0 read once
    bound_ms, bound_by = _bound_ms(3.0 * B * S * D, torch.float32, nbytes)  # exp, multiply, add
    row = {
        "shape": [B, S, D], "dtype": "float32", "h0": True, "max_abs_err": max_err,
        "repeat_bit_identical": True, "carry_lost_at_step": t, "carry_lost_max_abs_err": fault_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "library": "none: no single PyTorch call computes a linear recurrence",
        "bound_ms": bound_ms, "bound_by": bound_by, "gbps": nbytes / (ms * 1e-3) / 1e9,
    }
    emit({"phase": "kernels", "kernel": "rglru_scan", "timing": row})
    return row


# ---------------------------------------------------------------------------


def _random_bank(rng, p, monotone, k=8):
    """A random padded bank of piecewise speed estimates, 1..k knots a row."""
    counts = rng.integers(1, k + 1, p)
    xs = np.sort(rng.uniform(1.0, 1e4, (p, k)), axis=1)
    if monotone:  # ordered knot times: time is nondecreasing
        ss = xs / np.sort(rng.uniform(0.1, 50.0, (p, k)), axis=1)
    else:
        ss = rng.uniform(0.5, 500.0, (p, k))
    last = np.take_along_axis(xs, (counts - 1)[:, None], 1), np.take_along_axis(ss, (counts - 1)[:, None], 1)
    pad = np.arange(k)[None, :] >= counts[:, None]
    return ModelBank(xs=np.where(pad, last[0], xs), ss=np.where(pad, last[1], ss), counts=counts.astype(np.int64))


def _bank_case(rng, p, n, completion, min_units, monotone) -> dict:
    bank = _random_bank(rng, p, monotone)
    if monotone and not bank.is_monotone():
        raise SystemExit("chip_smoke: the threshold case needs a monotone bank")
    t0 = time.perf_counter()
    d_host, t_host = _partition_units_bank(bank, n, [n] * p, min_units=min_units, completion=completion)
    host_ms = (time.perf_counter() - t0) * 1e3
    tb = TorchModelBank.from_bank(bank, device="cuda")
    dev_ms = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_dev, t_dev = tb.partition_units(n, min_units=min_units, completion=completion, with_t=True)
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) * 1e3)
    drift = int(np.abs(np.asarray(d_dev) - np.asarray(d_host)).max())
    row = {
        "p": p, "n": n, "min_units": min_units, "completion": completion,
        "device_ms_cold": dev_ms[0], "device_ms": dev_ms[1], "host_numpy_ms": host_ms,
        "max_unit_drift": drift, "t_star_equal": float(t_dev) == t_host,
        "sum": int(np.asarray(d_dev).sum()),
    }
    if drift or not row["t_star_equal"] or row["sum"] != n:
        emit({"phase": "bank", "failed": row})
        raise SystemExit("chip_smoke: the device bank broke its bit-identity contract")
    return row


def phase_bank() -> None:
    rng = np.random.default_rng(2024)
    for size in (7, 128, 8193, 100_000):
        a = rng.uniform(0.0, 1e6, size) * rng.uniform(0.0, 1.0, size) ** 8
        if float(np_order_sum(torch.from_numpy(a).cuda())) != float(np.sum(a)):
            raise SystemExit(f"chip_smoke: np_order_sum on the card differs from numpy at n={size}")
    rows = {
        "p100000": _bank_case(rng, 100_000, 10_000_000, "threshold", 1, monotone=True),
        "p10000": _bank_case(rng, 10_000, 1_000_000, "greedy", 1, monotone=False),
        "p10000_takeback": _bank_case(rng, 10_000, 45_000, "threshold", 4, monotone=True),
    }
    # fold_in: one observation per row on the card == add_point on the host
    p = 10_000
    bank = _random_bank(rng, p, monotone=False)
    models = bank.to_models()
    tb = TorchModelBank.from_bank(bank, device="cuda")
    x = np.round(rng.uniform(1.0, 1e4, p))
    s = rng.uniform(0.5, 500.0, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb = tb.fold_in(x, s)
    torch.cuda.synchronize()
    fold_ms = (time.perf_counter() - t0) * 1e3
    for m, xi, si in zip(models, x, s):
        m.add_point(float(xi), float(si))
    host = tb.to_bank()
    if any(host.row(i).as_points() != PiecewiseLinearFPM(list(m.xs), list(m.ss)).as_points()
           for i, m in enumerate(models)):
        raise SystemExit("chip_smoke: fold_in on the card differs from add_point")
    rows["fold_in_p10000_ms"] = fold_ms
    rows["numpy_sum_block"] = numpy_sum_block()  # None: numpy sums a row in one block
    emit({"phase": "bank", "contract": "bit-identical allocations and t* to the host numpy bank, float64", **rows})


def phase_hcl_golden() -> None:
    golden = json.loads((ROOT / "tests" / "golden" / "dfpa_hcl.json").read_text())
    n = golden["n"]
    _, tfns = make_hcl_time_fns(n)
    rows = [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]
    sched = Scheduler(backend="torch", device="cuda")
    t0 = time.perf_counter()
    res = sched.autotune(
        SimulatedExecutor(time_fns=rows), n, golden["eps"], min_units=golden["min_units"]
    )
    history = res.diagnostics["history"]
    checks = {
        "iterations": res.iterations == golden["iterations"],
        "converged": res.converged == golden["converged"],
        "final_d": res.allocations == golden["final_d"],
        "points_per_proc": [m.num_points for m in res.diagnostics["models"]] == golden["points_per_proc"],
        "rounds_d": [d for d, _ in history] == [r["d"] for r in golden["rounds"]],
        "rounds_times": len(history) == len(golden["rounds"]) and all(
            np.allclose(t, r["times"], rtol=1e-12, atol=0.0) for (_, t), r in zip(history, golden["rounds"])
        ),
    }
    emit({
        "phase": "hcl_golden", "bank_device": str(sched.store.device_bank(snapshot=False).device),
        "contract": "bit-identical", "iterations": res.iterations,
        "wall_s": time.perf_counter() - t0, "checks": checks,
    })
    if not all(checks.values()):
        raise SystemExit("chip_smoke: the HCL golden trace differs on the card")


def phase_dfpa() -> tuple:
    """The main path: Scheduler.autotune over CallableExecutor, each
    processor running matmul_update on its row panel r_i times a round."""
    out, _ = _dfpa_loop("dfpa")
    return out["launches"], out["launches_by_route"]


def _dfpa_operands():
    """The DFPA panels' operands: a 16384^2 bf16 A and B, and C."""
    g = torch.Generator(device="cuda").manual_seed(0)
    n = DFPA_N
    a = torch.randn((n, n), generator=g, device="cuda", dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=g, device="cuda", dtype=torch.bfloat16)
    c = torch.zeros((n, n), device="cuda", dtype=torch.bfloat16)
    return a, b, c


def _reset_matmul_counts() -> None:
    matmul_update_cuda.launches = 0
    matmul_update_cuda.launches_by_route = dict.fromkeys(matmul_update_cuda.launches_by_route, 0)


def _dfpa_loop(phase: str, groups=None) -> tuple:
    """The DFPA loop balancing the matmul_update panels.  Without
    ``groups`` it is ``Scheduler.autotune``; with ``groups`` it is the
    loop a grouped session runs, ``Scheduler.observe`` after every round,
    whose repartitions go through the two-level partitioner (autotune's
    rounds repartition flat, as the reference's do).  Fails unless it
    converges, launches the kernel as often as the rounds account for,
    all on ``"wgmma"``, the final distribution re-measures within 2*eps,
    and, with ``groups``, every round after the first came from the
    two-level partitioner.  Returns the phase's JSON line and the
    scheduler."""
    n = DFPA_N
    a, b, c = _dfpa_operands()

    def processor(r):
        def run(units):
            rows = units * DFPA_UNIT_ROWS
            for _ in range(r):
                matmul_update(c[:rows], a[:rows], b, **DFPA_BLOCKS)
        return run

    fns = [processor(r) for r in DFPA_REPEATS]
    executor = CallableExecutor(fns, device="cuda")
    store = SpeedStore.empty(len(fns), backend="torch", device="cuda")
    # the scheduling overhead between rounds, on the host clock with the
    # card drained after each call: every fold_in and partition (flat, or
    # the two-level one with groups)
    overhead_ms = {"fold_in": [], "partition_units": []}

    def timed(name, method):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = method(*args, **kwargs)
            torch.cuda.synchronize()
            overhead_ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    for name in overhead_ms:
        setattr(store, name, timed(name, getattr(store, name)))
    _reset_matmul_counts()
    t0 = time.perf_counter()
    if groups is None:
        sched = Scheduler(store, backend="torch", device="cuda")
        res = sched.autotune(executor, DFPA_UNITS, DFPA_EPS, min_units=1)
        history, converged, allocations = res.diagnostics["history"], res.converged, res.allocations
        iterations, hier_calls = res.iterations, None
    else:
        sched = Scheduler(
            store, policy=Policy.HIER, groups=groups, n_units=DFPA_UNITS, eps=DFPA_EPS,
            min_units=1, backend="torch", device="cuda",
        )
        hier_calls = 0
        hier_partition = timed("partition_units", sched._hier_partition)

        def counted(*args, **kwargs):
            nonlocal hier_calls
            hier_calls += 1
            return hier_partition(*args, **kwargs)

        sched._hier_partition = counted
        history = []
        for _ in range(DFPA_MAX_OBSERVE_ROUNDS):
            times = executor.run(sched.d)
            history.append((list(sched.d), list(times)))
            if not sched.observe(times):
                break
        allocations, iterations = list(sched.d), len(history)
        converged = imbalance(history[-1][1]) <= DFPA_EPS
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = matmul_update_cuda.launches
    routes = dict(matmul_update_cuda.launches_by_route)

    expected = sum(r for r in DFPA_REPEATS) + sum(
        r for d, _ in history for di, r in zip(d, DFPA_REPEATS) if di > 0
    )
    remeasured = [executor.run(allocations) for _ in range(5)]
    remeasured_imb = [imbalance(t) for t in remeasured]
    median_imb = float(np.median(remeasured_imb))
    out = {
        "phase": phase, "groups": groups, "N": n, "units": DFPA_UNITS, "unit_rows": DFPA_UNIT_ROWS,
        "blocks": DFPA_BLOCKS, "dtype": "bfloat16", "repeats": DFPA_REPEATS, "eps": DFPA_EPS,
        "bank_device": str(sched.store.device_bank(snapshot=False).device), "iterations": iterations,
        "converged": converged, "final_imbalance": imbalance(history[-1][1]),
        "allocations": allocations, "hier_partition_calls": hier_calls,
        "rounds": [{"d": d, "imbalance": imbalance(t), "times_ms": [v * 1e3 for v in t]} for d, t in history],
        "launches": launches, "launches_by_route": routes, "expected_launches": expected, "wall_s": wall_s,
        "round_ms_sum": sum(max(t) for _, t in history) * 1e3,
        "fold_in_ms": overhead_ms["fold_in"], "partition_units_ms": overhead_ms["partition_units"],
        "overhead_ms_sum": sum(overhead_ms["fold_in"]) + sum(overhead_ms["partition_units"]),
        "final_d_remeasured_ms": [[v * 1e3 for v in t] for t in remeasured],
        "final_d_remeasured_imbalance": remeasured_imb,
        "final_d_remeasured_imbalance_median": median_imb,
    }
    emit(out)
    if not converged:
        raise SystemExit(f"chip_smoke: DFPA ({phase}) did not converge on the card")
    if groups is not None and hier_calls != len(history) - 1:
        raise SystemExit(
            f"chip_smoke: {phase}: {hier_calls} two-level partitions for {len(history)} rounds; "
            "every round after the first must come from the hierarchy"
        )
    if launches != expected:
        raise SystemExit(f"chip_smoke: {phase}: {launches} kernel launches, the rounds account for {expected}")
    if routes != {"tile": 0, "wgmma": launches}:
        raise SystemExit(f"chip_smoke: {phase}: the DFPA panels launched {routes}, not every one on 'wgmma'")
    if median_imb > 2 * DFPA_EPS:
        raise SystemExit(f"chip_smoke: {phase}: the final distribution re-measures at imbalance {median_imb}")
    return out, sched


# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class _Capture:
    """Records the inputs of the last ``ops.flash_attention`` and
    ``ops.rglru_scan`` call (the model calls them through ``ops``) while
    active, and passes every call on unchanged.  ``flash_by_window`` keeps
    the last flash call of each window (0: a global layer's),
    ``flash_by_shape`` the last of each ``(causal, Sq, Sk)``, and
    ``flash_calls`` the flash calls whose ordinals (from 0) are in
    ``keep``."""

    def __init__(self, keep=()):
        self.seen = {}
        self.flash_by_window = {}
        self.flash_by_shape = {}
        self.flash_calls = {}
        self._keep, self._calls = set(keep), 0
        self._orig = (ops.flash_attention, ops.rglru_scan)

    def __enter__(self):
        fa, rg = self._orig

        def flash(q, k, v, **kw):
            self.seen["flash_attention"] = (q.detach().clone(), k.detach().clone(), v.detach().clone(), kw)
            self.flash_by_window[kw.get("window", 0)] = self.seen["flash_attention"]
            self.flash_by_shape[(kw.get("causal", True), q.shape[2], k.shape[2])] = self.seen["flash_attention"]
            if self._calls in self._keep:
                self.flash_calls[self._calls] = self.seen["flash_attention"]
            self._calls += 1
            return fa(q, k, v, **kw)

        def scan(log_a, b, h0=None, **kw):
            self.seen["rglru_scan"] = (log_a.detach().clone(), b.detach().clone(),
                                       None if h0 is None else h0.detach().clone(), kw)
            return rg(log_a, b, h0, **kw)

        ops.flash_attention, ops.rglru_scan = flash, scan
        return self

    def __exit__(self, *exc):
        ops.flash_attention, ops.rglru_scan = self._orig
        return False


def _cuda_timed(fn) -> tuple:
    """(result, ms): one call of ``fn`` timed with CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def _timed_generate(eng, prompt, new) -> tuple:
    """(tokens, ms): one ``generate`` timed with CUDA events."""
    return _cuda_timed(lambda: eng.generate(prompt, new))


def _serve_full(out: dict) -> dict:
    cfg = get_config(SERVE_ARCH)
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_lm(cfg, g, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServeEngine(cfg, model, batch=SERVE_BATCH, seq_budget=SERVE_PROMPT + SERVE_NEW, device="cuda")
    gp = torch.Generator(device="cuda").manual_seed(1)
    seq = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1), generator=gp, device="cuda")
    prompt = seq[:, :SERVE_PROMPT]

    # the main path: one generate, the kernels' counts read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = rglru_scan_cuda.launches = matmul_update_cuda.launches = 0
    flash_attention_cuda.launches_by_route = dict.fromkeys(flash_attention_cuda.launches_by_route, 0)
    tokens, ms = _timed_generate(eng, prompt, SERVE_NEW)
    launches = {
        "flash_attention": flash_attention_cuda.launches, "rglru_scan": rglru_scan_cuda.launches,
        "matmul_update": matmul_update_cuda.launches,
    }
    out["launches"] = launches
    out["launches_by_route"] = {"flash_attention": dict(flash_attention_cuda.launches_by_route)}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    # two more generates, then three of one token (prefill and its argmax):
    # a decode step's time is the difference over the other new tokens
    gen_ms = [ms]
    for _ in range(2):
        again, ms = _timed_generate(eng, prompt, SERVE_NEW)
        gen_ms.append(ms)
        if not torch.equal(again, tokens):
            raise SystemExit("chip_smoke: two generate calls gave different tokens")
    prefill_ms = []
    for _ in range(3):
        first, ms = _timed_generate(eng, prompt, 1)
        prefill_ms.append(ms)
        if not torch.equal(first[:, 0], tokens[:, 0]):
            raise SystemExit("chip_smoke: generate of one token differs from the first of 32")
    out["generate_ms_runs"] = gen_ms
    out["prefill_ms_runs"] = prefill_ms
    out["prefill_ms"] = float(np.median(prefill_ms))
    out["decode_ms_per_token"] = (float(np.median(gen_ms)) - out["prefill_ms"]) / (SERVE_NEW - 1)
    out["tok_per_s"] = SERVE_BATCH * SERVE_NEW / (float(np.median(gen_ms)) / 1e3)
    out["prefill_tok_per_s"] = SERVE_BATCH * SERVE_PROMPT / (out["prefill_ms"] / 1e3)
    out["decode_tok_per_s"] = SERVE_BATCH / (out["decode_ms_per_token"] / 1e3)
    out["tokens_identical"] = True
    out["sample"] = tokens[0, :8].tolist()
    if launches["flash_attention"] != SERVE_LAUNCHES["flash_attention"] or launches["rglru_scan"] != SERVE_LAUNCHES["rglru_scan"]:
        raise SystemExit(f"chip_smoke: one generate launched {launches}, expected {SERVE_LAUNCHES}")
    if out["launches_by_route"]["flash_attention"]["wgmma"] != SERVE_LAUNCHES["flash_attention"]:
        raise SystemExit(f"chip_smoke: one generate's flash launches went {out['launches_by_route']}, not all 'wgmma'")

    with torch.inference_mode():
        # prefill(4096) + decode_step against the full forward over 4097 tokens
        hid, _, _ = apply_lm(model, cfg, seq, torch.arange(SERVE_PROMPT + 1, device="cuda"))
        full = lm_logits(model, cfg, hid[:, -1])
        del hid
        caches = init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, cfg.dtype, "cuda")
        with _Capture() as cap:
            _, caches = prefill(model, cfg, prompt, caches)
        step, _ = decode_step(model, cfg, seq[:, SERVE_PROMPT:], SERVE_PROMPT, caches)
        del caches
        out["decode_vs_full_rel"] = _rel(step, full)
        if not out["decode_vs_full_rel"] < 0.05:
            raise SystemExit(f"chip_smoke: prefill + decode differs from the full forward (rel {out['decode_vs_full_rel']})")

        # the kernels' inputs from that prefill (the last local and the last
        # rec layer), kernel against plain version on the card
        q, k, v, kw = cap.seen["flash_attention"]
        check = _check_serve_flash(flash_attention(q, k, v, impl="cuda", **kw), q, k, v, kw, "on the prefill's own inputs")
        out["captured_flash"] = {"shape": list(q.shape), "dtype": _dtype_name(q.dtype), **check}
        log_a, b, h0, kw = cap.seen["rglru_scan"]
        ok2, err2 = _close(rglru_scan(log_a, b, h0, impl="cuda", **kw), rglru_scan_ref(log_a, b, h0), 1e-5)
        out["captured_rglru"] = {"shape": list(log_a.shape), "h0": h0 is not None, "max_abs_err": err2, "ok": ok2}
        if not ok2:
            raise SystemExit("chip_smoke: rglru_scan disagrees with its plain version on the prefill's own inputs")
    return out


def _serve_smoke(out: dict, arch: str = SERVE_ARCH) -> dict:
    """The smoke-width model in float32: the card (kernels) gives the CPU's
    tokens (plain versions), logits within rel 1e-4, and each kernel the
    architecture serves with launched at least once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    cpu_model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = LanguageModel.from_state_dict(cfg, {n: t.to("cuda") for n, t in cpu_model.state_dict().items()})
    prompt = torch.randint(0, cfg.vocab_size, (SMOKE_BATCH, SMOKE_PROMPT), generator=torch.Generator().manual_seed(1))
    budget = SMOKE_PROMPT + SMOKE_NEW
    want = ServeEngine(cfg, cpu_model, batch=SMOKE_BATCH, seq_budget=budget, device="cpu").generate(prompt, SMOKE_NEW)
    wrappers = {"flash_attention": flash_attention_cuda, "rglru_scan": rglru_scan_cuda}
    kernels = kernels_for(cfg)
    before = [wrappers[name].launches for name in kernels]
    got = ServeEngine(cfg, gpu_model, batch=SMOKE_BATCH, seq_budget=budget, device="cuda").generate(prompt, SMOKE_NEW)
    launched = {name: wrappers[name].launches - b for name, b in zip(kernels, before)}
    with torch.inference_mode():
        rels = []
        for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
            toks = prompt.to(dev)
            hid, _, _ = apply_lm(model, cfg, toks, torch.arange(SMOKE_PROMPT, device=dev))
            rels.append(lm_logits(model, cfg, hid).cpu())
    rel = _rel(rels[1], rels[0])
    out["smoke"] = {
        "arch": cfg.name, "tokens_equal": bool(torch.equal(got.cpu(), want)), "logits_rel": rel,
        "launches": launched, "tokens": got[0].tolist(),
    }
    if not out["smoke"]["tokens_equal"] or not rel < 1e-4 or any(n < 1 for n in launched.values()):
        raise SystemExit(f"chip_smoke: the smoke model on the card differs from the CPU: {out['smoke']}")
    return out["smoke"]


def phase_serve() -> dict:
    out = {"phase": "serve", "arch": SERVE_ARCH, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW}
    try:
        _serve_full(out)
        _serve_smoke(out)
    finally:
        emit(out)
    return out


# ---------------------------------------------------------------------------


def phase_paper() -> None:
    """The paper's six tables, each at the smallest size it lists, with
    every bank on the card, against the numpy backend on the host, CSV for
    CSV."""
    for name, fn in paper_tables.TABLES.items():
        sizes = [min(paper_tables.SIZES[name])]
        t0 = time.perf_counter()
        host = fn(backend="numpy", device="cpu", sizes=sizes)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(backend="torch", device="cuda", sizes=sizes)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        emit({
            "phase": "paper", "table": name, "sizes": sizes, "csv_equal": card == host,
            "rows": card.count("\n") - 1, "card_wall_s": card_s, "host_numpy_wall_s": host_s,
            "csv_seconds": "simulated seconds of the paper's clusters, not times of the card",
        })
        if card != host:
            print(card, host, sep="\n", flush=True)
            raise SystemExit(f"chip_smoke: {name} on the card differs from the numpy backend's")


def _same_grid_partition(got, want) -> bool:
    return (
        got.col_widths == want.col_widths and got.row_heights == want.row_heights
        and got.times == want.times and got.iterations == want.iterations
        and got.imbalance == want.imbalance and got.converged == want.converged
        and all(got.diagnostics[k] == want.diagnostics[k] for k in ("total_rounds", "bench_cost", "times"))
    )


def _grid_parity() -> None:
    """(a) partition_grid on the HCL 4x4 grid at M = N = 512, bank on the
    card against numpy on the host, for the three policies.  FFMPA runs
    with ``analytic_tol``: its analytic models are sample-and-banked, so
    its column partitions run on the device bank (without it they stay on
    the scalar host path on either backend)."""
    for policy, ctor, kw in (
        ("GRID2D", {}, dict(eps=0.1)),
        ("CPM", {}, {}),
        ("FFMPA", dict(analytic_tol=FFMPA_ANALYTIC_TOL), dict(eps=0.1, max_outer=50)),
    ):
        walls = {}
        parts = {}
        for backend, device in (("numpy", "cpu"), ("torch", "cuda")):
            sched = Scheduler(grid=paper_tables.hcl_grid(4, 4), policy=getattr(Policy, policy),
                              backend=backend, device=device, **ctor)
            t0 = time.perf_counter()
            parts[backend] = sched.partition_grid(512, 512, **kw)
            walls[backend] = time.perf_counter() - t0
        same = _same_grid_partition(parts["torch"], parts["numpy"])
        emit({
            "phase": "grid", "part": "a", "policy": policy, **ctor, "M": 512, "N": 512, "bit_identical": same,
            "outer_iterations": parts["torch"].iterations, "converged": parts["torch"].converged,
            "total_rounds": parts["torch"].diagnostics["total_rounds"],
            "card_wall_s": walls["torch"], "host_numpy_wall_s": walls["numpy"],
        })
        if not same:
            raise SystemExit(f"chip_smoke: partition_grid ({policy}) on the card differs from numpy")


def _grid_repartition(smi: str) -> None:
    """(b) repartition_grid of q columns of p rows of random monotone
    estimates: one stacked [q, p, k] device bank against numpy."""
    rng = np.random.default_rng(16)
    q, p, k = REPART_Q, REPART_P, REPART_KNOTS
    M = 100 * p
    widths = [int(w) for w in rng.integers(64, 256, q)]
    fpms = [[None] * q for _ in range(p)]
    fpm_width = [[None] * q for _ in range(p)]
    for i in range(p):
        for j in range(q):
            xs = np.sort(rng.uniform(1.0, 4.0 * M / p, k))
            ss = xs / np.sort(rng.uniform(0.1, 50.0, k))  # ordered knot times: monotone
            fpms[i][j] = PiecewiseLinearFPM.from_points(list(zip(xs.tolist(), ss.tolist())))
            fpm_width[i][j] = int(rng.integers(widths[j] // 2, 2 * widths[j]))
    t0 = time.perf_counter()
    want = Scheduler(policy=Policy.GRID2D, backend="numpy").repartition_grid(fpms, fpm_width, widths, M)
    host_ms = (time.perf_counter() - t0) * 1e3
    sched = Scheduler(policy=Policy.GRID2D, backend="torch", device="cuda")
    card_ms, got = [], None
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sched.repartition_grid(fpms, fpm_width, widths, M)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
    diverged = sum(a != b for a, b in zip(got, want))
    emit({
        "phase": "grid", "part": "b", "q": q, "p": p, "knots": k, "M": M,
        "divergent_columns": diverged, "card_ms_cold_warm": card_ms, "host_numpy_ms": host_ms,
        "card": smi,
    })
    if diverged or any(sum(r) != M for r in got):
        raise SystemExit("chip_smoke: repartition_grid on the card differs from numpy")


def _grid_application() -> tuple:
    """(c) partition_grid (GRID2D) balancing matmul_update blocks on the
    card, each speed-function evaluation ``app.warmup`` untimed runs and
    then the median of ``app.samples`` timings.  After the counts are read,
    the kernel is held against its plain version at the blocks' shapes: the
    even first round's, and the final partition's largest and smallest."""
    app = MatmulGrid()
    app.run(0, 0, 1, 1)  # first use of the kernel, before the counts
    torch.cuda.synchronize()
    app.reset_counts()
    sched = Scheduler(grid=app.grid(), policy=Policy.GRID2D, backend="torch", device="cuda")
    tel = Telemetry()  # counts the fleet rounds the columns' inner loops ran
    _reset_matmul_counts()
    t0 = time.perf_counter()
    with use(tel):
        part = sched.partition_grid(GRID_UNITS, GRID_UNITS, eps=GRID_EPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = matmul_update_cuda.launches
    routes = dict(matmul_update_cuda.launches_by_route)
    evals, expected, eval_s = app.evals, app.expected, app.eval_s
    c_finite = bool(torch.isfinite(app.c).all())

    blocks = [(GRID_UNITS // len(app.repeats), GRID_UNITS // len(app.repeats[0]))]
    final = [(r, w) for w, col in zip(part.col_widths, part.row_heights) for r in col]
    blocks += [max(final, key=lambda b: b[0] * b[1]), min(final, key=lambda b: b[0] * b[1])]
    parity = []
    for r, w in blocks:
        M, N = r * app.unit, w * app.unit
        on_wgmma = matmul_update_cuda.launches_by_route["wgmma"]
        parity.append([M, N, app.K, _check_parity(M, N, app.K, app.blocks, torch.bfloat16, seed=3, phase="grid")])
        if matmul_update_cuda.launches_by_route["wgmma"] - on_wgmma != 2:
            raise SystemExit(f"chip_smoke: the grid block {(M, N, app.K)} was not checked on the 'wgmma' route")
    remeasured = [app.measure(part) for _ in range(5)]
    remeasured_imb = [imbalance(t) for t in remeasured]
    median_imb = float(np.median(remeasured_imb))
    cpm = Scheduler(grid=app.grid(), policy=Policy.CPM, backend="torch", device="cuda").partition_grid(
        GRID_UNITS, GRID_UNITS
    )
    makespan = {
        name: float(np.median([max(app.measure(pt)) for _ in range(5)])) * 1e3
        for name, pt in (("grid2d", part), ("cpm", cpm))
    }
    out = {
        "phase": "grid", "part": "c", "repeats": app.repeats, "unit": app.unit, "M_units": GRID_UNITS,
        "N_units": GRID_UNITS, "K": app.K, "blocks": app.blocks, "dtype": "bfloat16", "eps": GRID_EPS,
        "converged": part.converged, "final_imbalance": part.imbalance, "outer_iterations": part.iterations,
        "rounds": part.diagnostics["total_rounds"], "fleet_rounds": len(tel.spans("fleet.round")),
        "fleet_round_jobs_measured": [e.attrs["measured"] for e in tel.spans("fleet.round")],
        "col_widths": part.col_widths,
        "row_heights": part.row_heights, "wall_s": wall_s,
        "speed_fn_evaluations": evals, "samples_per_evaluation": app.samples,
        "untimed_runs_per_evaluation": app.warmup, "speed_fn_s": eval_s,
        "scheduling_s": wall_s - eval_s,
        "launches": launches, "launches_by_route": routes, "expected_launches": expected,
        "c_finite": c_finite, "block_parity_max_abs_err": parity,
        "final_remeasured_imbalance": remeasured_imb, "final_remeasured_imbalance_median": median_imb,
        "cpm_col_widths": cpm.col_widths, "cpm_row_heights": cpm.row_heights,
        "makespan_ms_median5": makespan,
    }
    emit(out)
    if not part.converged:
        raise SystemExit("chip_smoke: the 2-D grid partitioner did not converge on the card")
    if not c_finite:
        raise SystemExit("chip_smoke: the grid's blocks left a non-finite value in C")
    if launches != expected:
        raise SystemExit(f"chip_smoke: {launches} kernel launches, the speed functions account for {expected}")
    if routes != {"tile": 0, "wgmma": launches}:
        raise SystemExit(f"chip_smoke: the grid's blocks launched {routes}, not every one on 'wgmma'")
    if median_imb > 2 * GRID_EPS:
        raise SystemExit(f"chip_smoke: the final grid partition re-measures at imbalance {median_imb}")
    return launches, routes


def phase_grid(smi: str) -> tuple:
    _grid_parity()
    _grid_repartition(smi)
    return _grid_application()


# ---------------------------------------------------------------------------


def _front_fixture(p: int, seed: int):
    """Heterogeneous plateau/knee speed models and affine energy laws with
    per-processor (a, b) spread, efficiency uncorrelated with speed: the
    reference's front-sweep fixture (``benchmarks/energy_pareto.py``)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1e-6, 3e-6, p)
    knee = rng.uniform(2e3, 2e4, p)
    ea = rng.uniform(1.0, 50.0, p)
    eb = rng.uniform(0.05, 2.0, p)
    n = 100 * p
    speed, energy = [], []
    for i in range(p):
        xs = np.geomspace(16.0, 8.0 * knee[i], 6)
        ts = xs * base[i] * (
            1.0 + np.where(xs > knee[i], 3.0 * (xs - knee[i]) / knee[i], 0.0)
        )
        speed.append(PiecewiseLinearFPM.from_points(list(zip(xs, xs / ts))))
        exs = np.geomspace(1.0, 4.0 * n, 7)
        energy.append(energy_model(list(zip(exs, ea[i] + eb[i] * exs))))
    return speed, energy, n


def _walls(fn, sync: bool) -> tuple:
    """``fn()`` twice (cold, then warm): its two results' last and the two
    wall times in ms, the card drained around each call when ``sync``."""
    ms, out = [], None
    for _ in range(2):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def phase_energy(smi: str) -> None:
    """The time/energy front at p = 8 and 1024 (n = 100 p, 33 points) with
    the banks on the card (the interior thresholds as one stacked
    ``[T, p, k]`` partition), against the numpy backend on the host."""
    for i, p in enumerate(ENERGY_PS):
        speed, energy, n = _front_fixture(p, 100 + i)
        stores = {
            backend: SpeedStore.from_models(
                [PiecewiseLinearFPM.from_points(m.as_points()) for m in speed],
                backend=backend, device=device,
            ).attach_energy([PiecewiseLinearFPM.from_points(m.as_points()) for m in energy])
            for backend, device in (("numpy", "cpu"), ("torch", "cuda"))
        }
        want, host_ms = _walls(lambda: stores["numpy"].pareto_front(n, num_points=ENERGY_POINTS), False)
        got, card_ms = _walls(lambda: stores["torch"].pareto_front(n, num_points=ENERGY_POINTS), True)
        card = stores["torch"]
        same = {
            name: bool(np.array_equal(getattr(got, name), getattr(want, name)))
            for name in ("times", "energies", "allocations")
        }
        checks = {
            **{f"{name}_bit_identical": ok for name, ok in same.items()},
            "strictly_monotone": bool(np.all(np.diff(got.times) > 0) and np.all(np.diff(got.energies) < 0)),
            "interior_points": len(got) > 2,
            "first_is_time_optimal": list(got.allocations[0]) == card.partition_units(n),
            "last_is_energy_optimal": list(got.allocations[-1]) == card.partition_units(n, objective="energy"),
        }
        cap = float(got.energies[len(got) // 2])  # a budget between the endpoints
        picked = {
            backend: Scheduler(st, backend=backend, device=device).partition(
                n, objective="pareto", energy_cap=cap
            )
            for (backend, st), device in zip(stores.items(), ("cpu", "cuda"))
        }
        checks["scheduler_energy_cap_equal"] = (
            picked["torch"].allocations == picked["numpy"].allocations
            and picked["torch"].t_star == picked["numpy"].t_star
        )
        emit({
            "phase": "energy", "p": p, "n": n, "seed": 100 + i, "num_points": ENERGY_POINTS,
            "front_points": len(got), "contract": "bit-identical to the numpy backend, float64",
            "checks": checks, "energy_cap": cap, "picked_makespan": picked["torch"].t_star,
            "card_ms_cold_warm": card_ms, "host_numpy_ms_cold_warm": host_ms, "card": smi,
        })
        if not all(checks.values()):
            raise SystemExit(f"chip_smoke: the time/energy front at p={p} failed {checks}")


def _makespan(bank, d) -> float:
    d = np.asarray(d, dtype=np.float64)
    return float(np.max(np.where(d > 0, bank.time(np.maximum(d, 1.0)), 0.0)))


def _hier_bank(smi: str) -> None:
    """(a) the two-level partitioner at p = 10^4 in groups of 1000: the
    card's hierarchy against the host's, beside the flat device
    partition."""
    rng = np.random.default_rng(HIER_SEED)
    p = HIER_P
    bank = _random_bank(rng, p, monotone=True, k=HIER_KNOTS)
    groups = (np.arange(p) // HIER_GROUP).tolist()
    n = 20 * p
    host_h = Hierarchy.from_bank(bank, groups, backend="numpy")
    card_h = Hierarchy.from_bank(bank, groups, backend="torch", device="cuda")
    (want, t_want), host_ms = _walls(lambda: host_h.partition_units(n, with_t=True), False)
    (got, t_got), card_ms = _walls(lambda: card_h.partition_units(n, with_t=True), True)
    tb = TorchModelBank.from_bank(bank, device="cuda")
    flat, flat_ms = _walls(lambda: [int(v) for v in tb.partition_units(n)], True)
    one = Hierarchy.from_bank(bank, [0] * p, backend="torch", device="cuda")
    single, single_ms = _walls(lambda: one.partition_units(n), True)
    (gbank_card,), (gbank_host,) = card_h._agg_cache.values(), host_h._agg_cache.values()
    ratio = _makespan(bank, got) / _makespan(bank, flat)
    checks = {
        "allocations_bit_identical": got == want,
        "t_outer_bit_identical": t_got == t_want,
        "aggregate_bank_identical": all(
            np.array_equal(getattr(gbank_card, f), getattr(gbank_host, f)) for f in ("xs", "ss", "counts")
        ),
        "makespan_within_1.05_of_flat": ratio <= 1.05,
        "single_group_equals_flat": single == flat,
        "sum": sum(got) == n,
    }
    emit({
        "phase": "hier", "part": "a", "p": p, "knots": HIER_KNOTS, "group_size": HIER_GROUP, "g": card_h.g,
        "n": n, "contract": "bit-identical to the numpy backend, float64", "checks": checks,
        "makespan_ratio_to_flat": ratio, "aggregate_knots": int(gbank_card.xs.shape[1]),
        "card_hier_ms_cold_warm": card_ms, "host_hier_ms_cold_warm": host_ms,
        "card_flat_ms_cold_warm": flat_ms, "card_single_group_ms_cold_warm": single_ms, "card": smi,
    })
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the hierarchy at p={p} failed {checks}")


def phase_hier(smi: str) -> tuple:
    _hier_bank(smi)
    out, _ = _dfpa_loop("hier", groups=HIER_DFPA_GROUPS)
    return out["launches"], out["launches_by_route"]


# ---------------------------------------------------------------------------


def _sink_cost(tel, store, reps: int = 5) -> dict:
    """What a recording sink costs: the host seconds to record this run's
    events into a fresh sink (per DFPA round), and ``partition_units`` on the
    converged store with the sink on and off, in turns (medians, ms)."""
    replay = Telemetry()
    t0 = time.perf_counter()
    for e in tel.events:
        if e.kind == "span":
            replay.span_at(e.name, e.t0, e.t1, **e.attrs)
        elif e.kind == "event":
            replay.event(e.name, **e.attrs)
        else:
            getattr(replay, e.kind)(e.name, e.value, **e.attrs)
    record_s = time.perf_counter() - t0
    ms = {"on": [], "off": []}
    for _ in range(reps):
        for state, sink in (("on", Telemetry()), ("off", None)):
            with use(sink):
                torch.cuda.synchronize()
                t = time.perf_counter()
                store.partition_units(DFPA_UNITS, None, min_units=1)
                ms[state].append((time.perf_counter() - t) * 1e3)
    return {"record_events_s": record_s, "events": len(tel.events),
            "partition_ms_median": {k: float(np.median(v)) for k, v in ms.items()},
            "partition_ms": ms}


def phase_obs() -> tuple:
    """The ``dfpa`` phase's loop once more with a ``Telemetry`` sink
    installed: its Chrome trace (``build/obs_trace.json``) must be valid
    JSON with one ``scheduler.autotune`` span, one ``speedstore.partition``
    span (``backend="torch"``) per call of the store's ``partition_units``
    and none of ``scheduler.partition`` (autotune repartitions through the
    store, as the reference's does), ``speedstore.fold_in`` must count the
    rounds, and the loop keeps the ``dfpa`` phase's gates."""
    tel = Telemetry()
    with use(tel):
        out, sched = _dfpa_loop("obs")
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    path = ARTIFACTS / "obs_trace.json"
    export_chrome_trace(tel, str(path))
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    count = {name: sum(e["name"] == name for e in spans)
             for name in ("scheduler.autotune", "scheduler.partition", "speedstore.partition")}
    snap = MetricsSnapshot.from_payload(tel.to_payload())
    rounds, calls = len(out["rounds"]), len(out["partition_units_ms"])
    checks = {
        "trace_is_json_with_events": bool(trace["traceEvents"]),
        "one_autotune_span": count["scheduler.autotune"] == 1,
        "no_scheduler_partition_span": count["scheduler.partition"] == 0,
        "one_partition_span_per_call": count["speedstore.partition"] == calls,
        "partition_spans_on_torch": all(
            e["args"]["backend"] == "torch" for e in spans if e["name"] == "speedstore.partition"),
        "no_bisection_steps_gauge": "speedstore.bisection_steps" not in tel.gauges,
        "fold_in_counts_rounds": tel.counters.get("speedstore.fold_in") == rounds == snap.fold_ins,
        "autotune_span_iterations": next(
            e["args"]["iterations"] for e in spans if e["name"] == "scheduler.autotune") == rounds,
    }
    emit({"phase": "obs", "trace": str(path.relative_to(ROOT)), "span_counts": count, "rounds": rounds,
          "partition_units_calls": calls, "counters": tel.counters, "gauges": tel.gauges,
          "span_wall_ms": {k: v * 1e3 for k, v in snap.span_totals.items()},
          "sink_cost": _sink_cost(tel, sched.store), "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the obs trace failed {checks}")
    return out["launches"], out["launches_by_route"]


def phase_straggler() -> tuple:
    """The serving loop's order on the DFPA panels, with a ``FlightRecorder``
    installed: each round runs the distribution, then
    ``Scheduler.straggler_actions`` (REPROFILE applied by the scheduler),
    then ``observe``.  (1) The eight processors converge; (2) processor
    ``STRAGGLER_PROC`` runs its panel 2, 4, 8, ... times more each round
    (capped at ``STRAGGLER_CAP``) until QUARANTINE lands on it, and
    ``leave`` drops it (its function leaves the executor); (3) the seven
    survivors converge.  Fails unless REPROFILE lands on the slowed
    processor before QUARANTINE, a ``scheduler.reprofile`` event names it,
    no other processor is quarantined, the survivors converge within eps
    and their final distribution re-measures at median imbalance <= 2*eps,
    the launches equal what the rounds account for, all ``"wgmma"``, and the
    dumped recorder's ``straggler.verdict`` events name the slowed
    processor."""
    a, b, c = _dfpa_operands()
    mult = [1] * len(DFPA_REPEATS)

    def processor(i):
        def run(units):
            rows = units * DFPA_UNIT_ROWS
            for _ in range(DFPA_REPEATS[i] * mult[i]):
                matmul_update(c[:rows], a[:rows], b, **DFPA_BLOCKS)
        return run

    alive = list(range(len(DFPA_REPEATS)))  # original index of each live processor
    executor = CallableExecutor([processor(i) for i in alive], device="cuda")
    sched = Scheduler(
        SpeedStore.empty(len(alive), backend="torch", device="cuda"), n_units=DFPA_UNITS,
        eps=DFPA_EPS, min_units=1, backend="torch", device="cuda",
    )
    rec = FlightRecorder(capacity=8192, snapshot_capacity=64)
    rounds, expected = [], 0
    _reset_matmul_counts()
    t0 = time.perf_counter()

    def one_round(stage):
        nonlocal expected
        d = list(sched.d)
        expected += sum(
            DFPA_REPEATS[alive[i]] * mult[alive[i]] * ((i not in executor.warmed) + 1)
            for i, di in enumerate(d) if di > 0
        )
        times = executor.run(d)
        acts = [act.value for act in sched.straggler_actions(times)]
        rec.snapshot(stage, {"d": d, "alive": list(alive)})
        rounds.append({"stage": stage, "slowdown": mult[STRAGGLER_PROC], "alive": list(alive), "d": d,
                       "times_ms": [v * 1e3 for v in times], "imbalance": imbalance(times),
                       "actions": {alive[i]: act for i, act in enumerate(acts) if act != "none"},
                       "strikes": {alive[g]: s for g, s in sched.detector.strikes.items() if s}})
        return times, acts

    def converge(stage):
        for _ in range(DFPA_MAX_OBSERVE_ROUNDS):
            times, acts = one_round(stage)
            if "quarantine" in acts:
                return False
            sched.observe(times)
            if imbalance(times) <= DFPA_EPS:
                return True
        return False

    with use(rec):
        converged = converge("healthy")
        quarantined = None
        if converged:
            for _ in range(STRAGGLER_MAX_SLOW_ROUNDS):
                mult[STRAGGLER_PROC] = min(2 * mult[STRAGGLER_PROC], STRAGGLER_CAP)
                times, acts = one_round("slowed")
                gone = [i for i, act in enumerate(acts) if act == "quarantine"]
                if gone:
                    quarantined = [alive[i] for i in gone]
                    sched.leave(gone)
                    alive = [p for i, p in enumerate(alive) if i not in gone]
                    executor = CallableExecutor([processor(p) for p in alive], device="cuda")
                    break
                sched.observe(times)
        survivors_converged = quarantined == [STRAGGLER_PROC] and converge("survivors")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = matmul_update_cuda.launches
    routes = dict(matmul_update_cuda.launches_by_route)

    remeasured = [executor.run(sched.d) for _ in range(5)] if survivors_converged else []
    median_imb = float(np.median([imbalance(t) for t in remeasured])) if remeasured else None
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    path = ARTIFACTS / "straggler.flightrec.json"
    rec.dump(str(path), reason="quarantine", context={"processor": STRAGGLER_PROC, "quarantined": quarantined})
    dump = json.loads(path.read_text())
    verdicts = [e["attrs"] for e in dump["events"] if e["name"] == "straggler.verdict"]
    reprofiled = [e["attrs"]["group"] for e in dump["events"] if e["name"] == "scheduler.reprofile"]
    slowed = [r for r in rounds if r["stage"] == "slowed"]
    verdict_rounds = {
        act: next((k for k, r in enumerate(slowed, 1) if r["actions"].get(STRAGGLER_PROC) == act), None)
        for act in ("reprofile", "quarantine")
    }
    checks = {
        "healthy_loop_converged": converged,
        "quarantined_only_the_slowed_processor": quarantined == [STRAGGLER_PROC] and not any(
            act == "quarantine" for r in rounds for p, act in r["actions"].items() if p != STRAGGLER_PROC),
        "reprofile_before_quarantine": None not in verdict_rounds.values()
        and verdict_rounds["reprofile"] < verdict_rounds["quarantine"],
        "reprofile_event_names_it": STRAGGLER_PROC in reprofiled,
        "survivors_converged": bool(survivors_converged),
        "survivors_remeasure_within_2eps": median_imb is not None and median_imb <= 2 * DFPA_EPS,
        "launches_accounted": launches == expected,
        "all_wgmma": routes == {"tile": 0, "wgmma": launches},
        "recorder_verdicts_name_it": bool(verdicts) and all(
            v["group"] == STRAGGLER_PROC for v in verdicts),
    }
    emit({"phase": "straggler", "processor": STRAGGLER_PROC, "cap": STRAGGLER_CAP, "repeats": DFPA_REPEATS,
          "eps": DFPA_EPS, "verdict_rounds_after_onset": verdict_rounds, "quarantined": quarantined,
          "rounds": rounds, "wall_s": wall_s, "launches": launches, "launches_by_route": routes,
          "expected_launches": expected, "final_d": sched.d, "final_alive": alive,
          "final_d_remeasured_imbalance_median": median_imb,
          "flight_recorder": str(path.relative_to(ROOT)), "recorder_events": len(dump["events"]),
          "recorder_verdicts": verdicts, "reprofile_events": reprofiled, "checks": checks})
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: the straggler phase failed {checks}")
    return launches, routes


# ---------------------------------------------------------------------------


def fleet_knee_case(q: int, p: int, seed: int):
    """``parity_gate``'s and ``hier_parity_gate``'s tenants
    (``benchmarks/fleet_scale.py``): per-(job, processor) knee time
    functions as one ``[q, p]`` array function and as scalar ones, and
    ``n_j = 20 p + 13 j``."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1e-5, 9e-5, (q, p))
    knee = rng.uniform(50.0, 500.0, (q, p))

    def batch_fn(X):
        return X * base * (1.0 + np.where(X > knee, 3.0 * (X - knee) / knee, 0.0))

    def scalar_fns(j):
        return [
            (lambda b, k: lambda x: float(x * b * (1.0 + (3.0 * (x - k) / k if x > k else 0.0))))(
                base[j, i], knee[j, i])
            for i in range(p)
        ]

    return batch_fn, scalar_fns, [20 * p + 13 * j for j in range(q)]


def fleet_make_tenants(q: int, p: int, seed: int = 0):
    """``make_tenants`` of ``benchmarks/fleet_scale.py``: per-(job,
    processor) plateau/knee ground truth and 6-point warm models sampled
    from it."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1e-6, 3e-6, (q, p))
    knee = rng.uniform(2e3, 2e4, (q, p))

    def time_fn(X):  # X[q, p] -> T[q, p]
        return X * base * (1.0 + np.where(X > knee, 3.0 * (X - knee) / knee, 0.0))

    warm = []
    for j in range(q):
        models = []
        for i in range(p):
            xs = np.geomspace(16.0, 8.0 * knee[j, i], 6)
            ts = xs * base[j, i] * (
                1.0 + np.where(xs > knee[j, i], 3.0 * (xs - knee[j, i]) / knee[j, i], 0.0)
            )
            models.append(PiecewiseLinearFPM.from_points(list(zip(xs, xs / ts))))
        warm.append(models)
    return time_fn, warm


class PredispatchProbe:
    """Wraps a fleet's pre-dispatch (``_predispatch_next``): on the card each
    pre-dispatched partition is queued under ``torch.cuda.set_sync_debug_mode
    ("error")``, so a device-to-host read inside it raises, and CUDA events
    around it give its solve's device time beside the host time the call
    took.  ``fetch_ms`` collects the host time of the rounds that fetched
    one."""

    def __init__(self, fleet, device):
        self.calls = []  # (host_ms, (start, end) events or None)
        self.cuda = torch.device(device).type == "cuda"
        real = fleet._predispatch_next

        def wrapped(*args, **kw):
            before = fleet.predispatches
            events = None
            if self.cuda:
                events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                torch.cuda.set_sync_debug_mode("error")
                events[0].record()
            t0 = time.perf_counter()
            try:
                real(*args, **kw)
            finally:
                host_ms = (time.perf_counter() - t0) * 1e3
                if self.cuda:
                    events[1].record()
                    torch.cuda.set_sync_debug_mode("default")
            if fleet.predispatches > before:
                self.calls.append((host_ms, events))

        fleet._predispatch_next = wrapped

    def rows(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        return {
            "host_ms": [h for h, _ in self.calls],
            "device_ms": [e[0].elapsed_time(e[1]) if e else None for _, e in self.calls],
        }


def _fleet_knee_run(p, ns, batch_fn, *, backend, device, groups=None, probe=False, **kw):
    names = [f"t{j}" for j in range(len(ns))]
    fleet = FleetScheduler(p, backend=backend, device=device, groups=groups, **kw)
    if probe:
        fleet.probe = PredispatchProbe(fleet, device)
    for nm, n in zip(names, ns):
        fleet.admit(JobSpec(name=nm, n=n, eps=FLEET_EPS, min_units=1, max_iter=FLEET_MAX_ITER))
    res = fleet.run(BatchedSimulatedExecutor2D(time_fn_batch_2d=batch_fn, p=p, q=len(ns), job_names=names))
    return fleet, [res[nm] for nm in names]


def _same_job(a, b) -> bool:
    return (a.allocations == b.allocations and a.times == b.times
            and a.diagnostics["history"] == b.diagnostics["history"])


def fleet_parity_gate(device="cuda") -> dict:
    """parity_gate: the torch fleet (float64, bank on ``device``) against
    eight independent numpy ``Scheduler.autotune`` loops and the numpy
    fleet — allocations, times, histories, bench costs and folded models —
    and its device solves against the reference's count."""
    q, p, seed = FLEET_PARITY["q"], FLEET_PARITY["p"], FLEET_PARITY["seed"]
    batch_fn, scalar_fns, ns = fleet_knee_case(q, p, seed)
    indep = [
        Scheduler(SpeedStore.empty(p, backend="numpy"), backend="numpy").autotune(
            SimulatedExecutor(time_fns=scalar_fns(j)), ns[j], FLEET_EPS, max_iter=FLEET_MAX_ITER, min_units=1)
        for j in range(q)
    ]
    host, host_res = _fleet_knee_run(p, ns, batch_fn, backend="numpy", device="cpu")
    card, card_res = _fleet_knee_run(p, ns, batch_fn, backend="torch", device=device)
    names = [f"t{j}" for j in range(q)]
    return {
        "rounds": card.rounds, "device_dispatches": card.device_dispatches,
        "iterations": [r.iterations for r in card_res],
        "checks": {
            "equals_independent_autotune": all(map(_same_job, card_res, indep)),
            "equals_numpy_fleet": all(map(_same_job, card_res, host_res)) and all(
                card.bench_cost(nm) == host.bench_cost(nm)
                and [m.as_points() for m in card.models(nm)] == [m.as_points() for m in host.models(nm)]
                for nm in names),
            "dispatches_as_reference": card.device_dispatches == FLEET_PARITY_DISPATCHES,
        },
    }


def fleet_hier_gate(device="cuda") -> dict:
    """hier_parity_gate on the torch fleet: one group equals the flat
    fleet, four groups of 25 come within 1.05x its makespan with every
    allocation summing to n, and the four-group fleet equals the numpy
    one."""
    q, p, seed = FLEET_HIER["q"], FLEET_HIER["p"], FLEET_HIER["seed"]
    batch_fn, _, ns = fleet_knee_case(q, p, seed)
    four = [i % 4 for i in range(p)]
    _, flat = _fleet_knee_run(p, ns, batch_fn, backend="torch", device=device)
    _, one = _fleet_knee_run(p, ns, batch_fn, backend="torch", device=device, groups=[0] * p)
    card, grouped = _fleet_knee_run(p, ns, batch_fn, backend="torch", device=device, groups=four)
    _, grouped_host = _fleet_knee_run(p, ns, batch_fn, backend="numpy", device="cpu", groups=four)
    return {
        "makespan_ratio_to_flat": [g.makespan / f.makespan for g, f in zip(grouped, flat)],
        "device_dispatches": card.device_dispatches, "rounds": card.rounds,
        "checks": {
            "one_group_equals_flat": all(o.allocations == f.allocations for o, f in zip(one, flat)),
            "four_groups_within_1.05x": all(
                g.makespan <= f.makespan * 1.05 + 1e-12 for g, f in zip(grouped, flat)),
            "four_groups_sum_to_n": all(sum(g.allocations) == n for g, n in zip(grouped, ns)),
            "four_groups_equal_numpy": all(map(_same_job, grouped, grouped_host)),
        },
    }


def fleet_bucket_gate(device="cuda") -> dict:
    """bucket_gate on the torch fleet: with ``lane_buckets`` the q = 3 stack
    is padded to 4 lanes and serves allocations bit-identical to an
    unbucketed fleet, before and after an admit within the bucket, with
    the reference's restack count."""
    p, seed = FLEET_BUCKET["p"], FLEET_BUCKET["seed"]
    _, warm = fleet_make_tenants(4, p, seed=seed)
    ns = [100 * p + 7 * j for j in range(4)]
    names = [f"t{j}" for j in range(4)]

    def spec(j):
        return JobSpec(name=names[j], n=ns[j], eps=1e-12, min_units=1)

    def mk(buckets):
        fl = FleetScheduler(p, backend="torch", device=device, reserve_knots=16, lane_buckets=buckets)
        for j in range(3):
            fl.admit(spec(j), models=warm[j])
        return fl

    plain, bucketed = mk(False), mk(True)
    before = plain.rebalance() == bucketed.rebalance()
    padded = int(bucketed._stacked.counts.shape[0])
    obs = {names[0]: [0.1 * (i + 1) for i in range(p)]}
    bucketed.observe(obs)
    bucketed.rebalance()
    bucketed.admit(spec(3), models=warm[3])
    ds = bucketed.rebalance()
    bucketed.observe({names[3]: [0.1 * (i + 1) for i in range(p)]})
    plain.observe(obs)
    plain.admit(spec(3), models=warm[3])
    after = plain.rebalance() == ds
    return {
        "restacks": [plain.restacks, bucketed.restacks], "padded_lanes": padded,
        "checks": {
            "bucketed_equals_plain": before,
            "padded_to_4": padded == 4,
            "admit_sums_to_n": sum(ds[names[3]]) == ns[3],
            "equals_plain_after_admit": after,
            "restacks_as_reference": plain.restacks == bucketed.restacks == FLEET_BUCKET_RESTACKS,
        },
    }


def sync_debug_catches_a_read() -> bool:
    """Whether a device-to-host read raises under sync debug mode "error"
    on this card (the guard the pre-dispatch probe relies on)."""
    x = torch.ones(4, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        float(x.sum())
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return False


def fleet_pipeline_gate(device="cuda") -> dict:
    """parity_gate's case with ``pipeline=True`` at depth 0 and depth 1
    (float64, carry on ``device``): both bit-identical to the sync fleet —
    allocations, times, histories, bench costs, folded models — with the
    reference's counts, every pre-dispatched partition queued without a
    device-to-host read (sync debug mode ``"error"`` on the card)."""
    q, p, seed = FLEET_PARITY["q"], FLEET_PARITY["p"], FLEET_PARITY["seed"]
    batch_fn, _, ns = fleet_knee_case(q, p, seed)
    names = [f"t{j}" for j in range(q)]
    sync, sync_res = _fleet_knee_run(p, ns, batch_fn, backend="torch", device=device)
    out, checks = {}, {}
    if torch.device(device).type == "cuda":
        checks["sync_debug_mode_catches_a_read"] = sync_debug_catches_a_read()
    for depth, pins in ((0, FLEET_PIPELINE_DEPTH0), (1, FLEET_PIPELINE_DEPTH1)):
        fleet, res = _fleet_knee_run(p, ns, batch_fn, backend="torch", device=device, probe=True,
                                     pipeline=True, pipeline_depth=depth)
        counts = {k: fleet.stats()[k] for k in pins}
        out[f"depth{depth}"] = {**counts, "deferred": fleet.probe.rows()}
        checks[f"depth{depth}_equals_sync"] = all(map(_same_job, res, sync_res)) and all(
            fleet.bench_cost(nm) == sync.bench_cost(nm)
            and [m.as_points() for m in fleet.models(nm)] == [m.as_points() for m in sync.models(nm)]
            for nm in names)
        checks[f"depth{depth}_counts_as_reference"] = counts == pins
        checks[f"depth{depth}_every_predispatch_probed"] = len(fleet.probe.calls) == counts["predispatches"]
    return {**out, "checks": checks}


def _serving_cycle(noise: float, **kw) -> dict:
    """One q = 16 x p = 1000 serving session (make_tenants' warm banks,
    n = 100 p + 7 j, ``reserve_knots=16`` as a serving deployment fixes its
    carry's shape): epochs of ``rebalance()`` then ``observe()`` of the
    allocations' times (times 1 + noise * N(0, 1), seeded), the first
    ``FLEET_SERVE_WARMUP`` untimed (a pre-dispatched shape runs eagerly
    once and is captured as a CUDA graph the next time).  The epochs run
    back to back with no synchronization, so a timed epoch's wall includes
    waiting for the solve its rebalance needs; beside it, each timed
    rebalance's and observe's host milliseconds and the rebalance's
    CUDA-event milliseconds; every pre-dispatched partition's host and
    device milliseconds (under sync debug mode "error"); the carry
    generation each pre-dispatch read against the newest."""
    q, p = FLEET_SCALE_Q, FLEET_SCALE_P
    time_fn, warm = fleet_make_tenants(q, p, seed=0)
    ns = [100 * p + 7 * j for j in range(q)]
    names = [f"t{j}" for j in range(q)]
    fl = FleetScheduler(p, backend="torch", device="cuda", reserve_knots=16, **kw)
    for j in range(q):
        fl.admit(JobSpec(name=names[j], n=ns[j], eps=1e-12, min_units=1), models=warm[j])
    probe = PredispatchProbe(fl, "cuda")
    lags = []
    real = fl._stacked_partition

    def lag(jobs, carry, defer=False):
        if defer:
            lags.append(fl._stacked.generation - carry.generation)
        return real(jobs, carry, defer)

    fl._stacked_partition = lag
    rng = np.random.default_rng(1)
    starts, rebalance_host, observe_host, rebalance_events, allocations = [], [], [], [], []
    torch.cuda.synchronize()
    for e in range(FLEET_SERVE_WARMUP + FLEET_SERVE_EPOCHS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        ds = fl.rebalance()
        end.record()
        t1 = time.perf_counter()
        X = np.asarray([ds[nm] for nm in names], dtype=np.float64)
        T = time_fn(X) * (1.0 + noise * rng.standard_normal(X.shape))
        fl.observe({nm: T[j] for j, nm in enumerate(names)})
        t2 = time.perf_counter()
        allocations.append([ds[nm] for nm in names])
        starts.append(t0)
        if e >= FLEET_SERVE_WARMUP:
            rebalance_host.append((t1 - t0) * 1e3)
            observe_host.append((t2 - t1) * 1e3)
            rebalance_events.append((start, end))
    starts.append(time.perf_counter())  # the last epoch ends here, its solve still queued
    torch.cuda.synchronize()
    epochs = [(b - a) * 1e3 for a, b in zip(starts[FLEET_SERVE_WARMUP:-1], starts[FLEET_SERVE_WARMUP + 1:])]
    return {
        "epoch_ms": epochs, "epoch_ms_median": float(np.median(epochs)),
        "rebalance_host_ms": rebalance_host, "observe_host_ms": observe_host,
        "rebalance_device_ms": [a.elapsed_time(b) for a, b in rebalance_events],
        "predispatch": probe.rows(), "predispatch_lag": lags,
        "counts": {k: fl.stats()[k] for k in ("device_dispatches", "predispatches", "stale_reads",
                                              "speculative_misses")},
        "monotone_lanes_after": int(fl._stacked.monotone_lanes().sum()),
        "sums_to_n": all(sum(d) == n for ds in allocations for d, n in zip(ds, ns)),
        "allocations": allocations,
    }


def _fleet_pipeline_serving(eager: bool = False) -> dict:
    """(d) the serving cycle at q = 16 x p = 1000, sync beside depth 1 under
    exact times and under 2 % noise, and depth 0 under exact times.  Gates:
    every allocation sums to n, no pre-dispatch read a carry more than one
    generation old, depth 0 equals sync epoch by epoch.  ``eager`` adds
    depth 1 with the deferred program run eagerly, not replayed as a CUDA
    graph, and gates that it equals the replayed run
    (``tools/fleet_pipeline_probe.py``)."""
    out, checks = {}, {}
    for label, noise in (("exact", 0.0), ("noise_2pct", 0.02)):
        runs = {"sync": _serving_cycle(noise), "depth1": _serving_cycle(noise, pipeline=True, pipeline_depth=1)}
        if noise == 0.0:
            runs["depth0"] = _serving_cycle(noise, pipeline=True, pipeline_depth=0)
            checks["depth0_equals_sync"] = runs["depth0"]["allocations"] == runs["sync"]["allocations"]
        if eager:
            mbt.GRAPH_DEFERRED = False
            try:
                runs["depth1_eager"] = _serving_cycle(noise, pipeline=True, pipeline_depth=1)
            finally:
                mbt.GRAPH_DEFERRED = True
            checks[f"{label}_eager_equals_graph"] = runs["depth1_eager"]["allocations"] == runs["depth1"]["allocations"]
        checks[f"{label}_sums_to_n"] = all(r["sums_to_n"] for r in runs.values())
        checks[f"{label}_staleness_at_most_1"] = all(0 <= g <= 1 for r in runs.values() for g in r["predispatch_lag"])
        checks[f"{label}_depth1_predispatched"] = runs["depth1"]["counts"]["predispatches"] > 0
        for r in runs.values():
            r.pop("allocations")
        out[label] = runs
    return {"q": FLEET_SCALE_Q, "p": FLEET_SCALE_P, "epochs_untimed": FLEET_SERVE_WARMUP,
            "epochs_timed": FLEET_SERVE_EPOCHS, **out, "checks": checks}


def _fleet_scale() -> dict:
    """(b) make_tenants(q=16, p=1000), warm 6-point banks, n = 100 p + 7 j:
    stacked measurement rounds of the torch fleet (CUDA events and host
    walls) and of the numpy fleet, one untimed round first, under exact
    times and under 2 % noise.  Exact times keep every lane's bank
    monotone (the threshold completion); noisy observations turn them
    non-monotone, and the completion takes the greedy per-unit loop.  Under
    exact times 16 sequential torch sessions (a partition and a fold-in
    each per round) run the same rounds beside them.  Gate: the torch
    fleet's allocations equal the numpy fleet's after every round."""
    q, p, rounds = FLEET_SCALE_Q, FLEET_SCALE_P, FLEET_SCALE_ROUNDS
    time_fn, warm = fleet_make_tenants(q, p, seed=0)
    ns = [100 * p + 7 * j for j in range(q)]
    names = [f"t{j}" for j in range(q)]

    def drive(noise):
        fleets = {}
        for backend in ("torch", "numpy"):
            fl = FleetScheduler(p, backend=backend, device="cuda" if backend == "torch" else "cpu")
            for j in range(q):
                fl.admit(JobSpec(name=names[j], n=ns[j], eps=1e-12, min_units=1, max_iter=10**9,
                                 probe_budget=10**9), models=warm[j])
            fleets[backend] = fl, BatchedSimulatedExecutor2D(
                time_fn_batch_2d=time_fn, p=p, q=q, job_names=names, noise=noise, rng=np.random.default_rng(1))
        (card, card_ex), (host, host_ex) = fleets["torch"], fleets["numpy"]
        ms = {"torch_fleet_events": [], "torch_fleet_host": [], "numpy_fleet_host": []}
        same = []
        for r in range(rounds + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            card.step(card_ex)
            end.record()
            end.synchronize()
            t1 = time.perf_counter()
            host.step(host_ex)
            t2 = time.perf_counter()
            same.append(all(card.distribution(nm) == host.distribution(nm) for nm in names))
            if r:
                ms["torch_fleet_events"].append(start.elapsed_time(end))
                ms["torch_fleet_host"].append((t1 - t0) * 1e3)
                ms["numpy_fleet_host"].append((t2 - t1) * 1e3)
        return {
            "round_ms": ms, "round_ms_median": {k: float(np.median(v)) for k, v in ms.items()},
            "dispatches_per_round": card.device_dispatches / card.rounds,
            "monotone_lanes_after": int(card._stacked.monotone_lanes().sum()),
            "equal_every_round": all(same), "all_measuring": len(card.active_jobs) == q,
        }

    exact = drive(0.0)
    stores = [SpeedStore.from_models([PiecewiseLinearFPM.from_points(m.as_points()) for m in warm[j]],
                                     backend="torch", device="cuda") for j in range(q)]
    seq_ms = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j, store in enumerate(stores):
            X = np.zeros((q, p))
            X[j] = x = np.asarray(store.partition_units(ns[j], min_units=1), dtype=np.float64)
            t = time_fn(X)[j]
            ok = x > 0
            store.fold_in(x, np.where(ok, x / np.where(ok, t, 1.0), 1.0), ok)
        torch.cuda.synchronize()
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    exact["round_ms"]["sequential_torch_host"] = seq_ms
    exact["round_ms_median"]["sequential_torch_host"] = float(np.median(seq_ms))
    noisy = drive(0.02)
    return {
        "q": q, "p": p, "n": ns, "rounds_timed": rounds, "exact": exact, "noise_2pct": noisy,
        "dispatches_per_round_sequential": 2 * q,
        "checks": {
            "torch_equals_numpy_every_round": exact["equal_every_round"] and noisy["equal_every_round"],
            "all_jobs_measuring": exact["all_measuring"] and noisy["all_measuring"],
        },
    }


def _fleet_tenants(**kw) -> tuple:
    """(c) three tenants on the DFPA phase's eight processors and panels,
    each with its own repeats, measured through a BatchedSimulatedExecutor2D
    whose time function times every nonzero (tenant, processor) panel with
    CUDA events after one untimed warm-up per (tenant, processor).  Gates:
    all converge, launches as the rounds and warm-ups account for, all
    ``"wgmma"``, each tenant's final distribution re-measures at median
    imbalance <= 2*eps.  ``kw`` go to the fleet (part (d) runs it again at
    ``pipeline_depth=0``, its pre-dispatches probed)."""
    a, b, c = _dfpa_operands()
    repeats = FLEET_TENANT_REPEATS
    names = [f"tenant{j}" for j in range(len(repeats))]
    p = len(DFPA_REPEATS)
    warmed = set()

    def panel(j, i, units):
        rows = units * DFPA_UNIT_ROWS
        for _ in range(repeats[j][i]):
            matmul_update(c[:rows], a[:rows], b, **DFPA_BLOCKS)

    def seconds(j, i, units):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        panel(j, i, units)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def time_fn(X):
        T = np.zeros_like(X)
        busy = [(int(j), int(i)) for j, i in zip(*np.nonzero(X > 0))]
        cold = [ji for ji in busy if ji not in warmed]
        for j, i in cold:
            panel(j, i, int(X[j, i]))
            warmed.add((j, i))
        if cold:
            torch.cuda.synchronize()
        for j, i in busy:
            T[j, i] = seconds(j, i, int(X[j, i]))
        return T

    fleet = FleetScheduler(p, backend="torch", device="cuda", **kw)
    probe = PredispatchProbe(fleet, "cuda") if kw.get("pipeline") else None
    for nm in names:
        fleet.admit(JobSpec(name=nm, n=DFPA_UNITS, eps=DFPA_EPS, min_units=1))
    executor = BatchedSimulatedExecutor2D(time_fn_batch_2d=time_fn, p=p, q=len(names), job_names=names)
    _reset_matmul_counts()
    t0 = time.perf_counter()
    res = fleet.run(executor)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = matmul_update_cuda.launches
    routes = dict(matmul_update_cuda.launches_by_route)
    expected = sum(repeats[j][i] for j, i in warmed) + sum(
        r for j, nm in enumerate(names) for d, _ in res[nm].diagnostics["history"]
        for di, r in zip(d, repeats[j]) if di > 0
    )
    remeasured = {
        nm: [imbalance([seconds(j, i, di) if di > 0 else 0.0 for i, di in enumerate(res[nm].allocations)])
             for _ in range(5)]
        for j, nm in enumerate(names)
    }
    median_imb = {nm: float(np.median(v)) for nm, v in remeasured.items()}
    out = {
        "repeats": repeats, "eps": DFPA_EPS, "fleet_rounds": fleet.rounds,
        "device_dispatches": fleet.device_dispatches, "wall_s": wall_s,
        "fleet_kwargs": kw, "predispatches": fleet.predispatches,
        **({"predispatch": probe.rows()} if probe else {}),
        "tenants": {nm: {"iterations": res[nm].iterations, "converged": res[nm].converged,
                         "allocations": res[nm].allocations, "imbalance": res[nm].imbalance,
                         "rounds": [{"d": d, "times_ms": [v * 1e3 for v in t]}
                                    for d, t in res[nm].diagnostics["history"]]}
                    for nm in names},
        "launches": launches, "launches_by_route": routes, "expected_launches": expected,
        "final_remeasured_imbalance": remeasured, "final_remeasured_imbalance_median": median_imb,
        "checks": {
            "all_converged": all(res[nm].converged for nm in names),
            "launches_accounted": launches == expected,
            "all_wgmma": routes == {"tile": 0, "wgmma": launches},
            "remeasure_within_2eps": all(v <= 2 * DFPA_EPS for v in median_imb.values()),
        },
    }
    return out, launches, routes


def phase_fleet() -> tuple:
    """The multi-tenant fleet (``repro_torch.fleet``) on the card: (a) the
    reference's parity, hierarchy and lane-bucket gates in float64, (b)
    q = 16 x p = 1000 measurement rounds beside the numpy fleet and 16
    sequential sessions, (c) three tenants balancing ``matmul_update``
    panels through one fleet, (d) the pipelined rounds: parity at depth 0
    and 1, the q = 16 x p = 1000 serving cycle, and (c) again at depth 0."""
    rows = {}
    for name, gate in (("parity_gate", fleet_parity_gate), ("hier_parity_gate", fleet_hier_gate),
                       ("bucket_gate", fleet_bucket_gate)):
        t0 = time.perf_counter()
        rows[name] = gate("cuda")
        emit({"phase": "fleet", "part": "a", "gate": name, "seconds": time.perf_counter() - t0, **rows[name]})
    t0 = time.perf_counter()
    rows["scale"] = _fleet_scale()
    emit({"phase": "fleet", "part": "b", "seconds": time.perf_counter() - t0, **rows["scale"]})
    rows["tenants"], launches, routes = _fleet_tenants()
    emit({"phase": "fleet", "part": "c", **rows["tenants"]})
    t0 = time.perf_counter()
    rows["pipeline_gate"] = fleet_pipeline_gate("cuda")
    emit({"phase": "fleet", "part": "d", "gate": "pipeline_parity_gate", "seconds": time.perf_counter() - t0,
          **rows["pipeline_gate"]})
    t0 = time.perf_counter()
    rows["pipeline_serving"] = _fleet_pipeline_serving()
    emit({"phase": "fleet", "part": "d", "seconds": time.perf_counter() - t0, **rows["pipeline_serving"]})
    t0 = time.perf_counter()
    rows["tenants_depth0"], launches0, routes0 = _fleet_tenants(pipeline=True, pipeline_depth=0)
    rows["tenants_depth0"]["checks"]["predispatched"] = rows["tenants_depth0"]["predispatches"] > 0
    emit({"phase": "fleet", "part": "d", "tenants": "pipeline_depth=0", "seconds": time.perf_counter() - t0,
          **rows["tenants_depth0"]})
    failed = {name: {k: v for k, v in row["checks"].items() if not v}
              for name, row in rows.items() if not all(row["checks"].values())}
    if failed:
        raise SystemExit(f"chip_smoke: the fleet phase failed {failed}")
    return launches + launches0, {r: routes[r] + routes0[r] for r in routes}


# ---------------------------------------------------------------------------
# the serving dispatch
# ---------------------------------------------------------------------------


def _tenants_replica_run(i, x):
    """tests/test_fleet_pipeline.py's threading case: x3 past 30 chunks."""
    base = [4e-4, 2e-4, 8e-4, 3e-4]
    t = x * base[i]
    if x > 30:
        t += (x - 30) * base[i] * 3.0
    return t


def _partition_rows(res: dict) -> dict:
    return {nm: (r.allocations, r.iterations, r.diagnostics["history"]) for nm, r in res.items()}


def _dispatch_straggler(backend: str, device) -> tuple:
    """tests/test_serve_trace.py's straggler case on a ``backend`` fleet:
    three healthy epochs, then replica 2 decays x0.5 an epoch until
    REPROFILE; replica 2 leaves (a fresh 3-replica session, the detector
    remapped) and the replica now at index 2 decays the same way.  Returns
    the epochs' (distributions, actions) and, for each decay, the epochs to
    REPROFILE, the detector's patience and the other replicas struck."""
    tenants = {"t": 400}
    speeds = [8.0, 8.0, 4.0, 4.0]
    fkw = dict(backend=backend, reserve_knots=16, quantize=0.05, min_units=1, max_iter=12)
    disp = ReplicaDispatcher(lambda i, x: x / speeds[i], 4, eps=0.08, device=device)
    record, reactions = [], []

    def epoch(speeds_now):
        ds = disp.fleet.rebalance(dict(tenants))
        times = {nm: [d / s if d > 0 else 0.0 for d, s in zip(dv, speeds_now)] for nm, dv in ds.items()}
        acts = [a.value for a in disp.fleet.straggler_actions(times)]
        disp.fleet.observe(times)
        record.append((ds, acts))
        return acts

    def decay(base):
        others = set()
        for k in range(10):
            now = list(base)
            now[2] = base[2] * 0.5 ** (k + 1)
            acts = epoch(now)
            others |= {i for i, a in enumerate(acts) if a != "none" and i != 2}
            if acts[2] == StragglerAction.REPROFILE.value:
                return {"epochs": k + 1, "patience": disp.fleet.detector.patience, "others": sorted(others)}
        return {"epochs": None, "patience": disp.fleet.detector.patience, "others": sorted(others)}

    record.append(_partition_rows(disp.balance_fleet(tenants, **fkw)))
    healthy = all(epoch(speeds) == ["none"] * 4 for _ in range(3))
    reactions.append(decay(speeds))
    old, survivors = disp.fleet, [0, 1, 3]
    speeds3 = [speeds[i] for i in survivors]
    disp.num_replicas, disp.replica_run = 3, (lambda i, x: x / speeds3[i])
    record.append(_partition_rows(disp.balance_fleet(tenants, **fkw)))
    fresh = disp.fleet is not old
    disp.fleet.detector = old.detector.remap(survivors)
    reactions.append(decay(speeds3))
    return record, reactions, healthy and fresh


def dispatch_parity_gate(device="cuda") -> dict:
    """Part (a): ``ReplicaDispatcher`` on host-simulated replicas, its bank
    on ``device`` beside the numpy backend on the host, float64.
    ``balance`` on the reference demo (4 replicas, 64 chunks) and
    ``balance_fleet`` on the two tenants of tests/test_fleet_pipeline.py in
    sync and at pipeline depth 0 and 1: allocations, iterations, histories
    and logs bit-identical; a repeated ``balance_fleet`` keeps the session,
    restacks nothing and captures no new CUDA graph; and the straggler case
    of tests/test_serve_trace.py: REPROFILE on the decayed replica within
    the detector's patience and on no other, before and after a resize."""
    checks, out = {}, {"device": str(device)}
    run = demo_replica_run(4, DISPATCH_DEMO_CHUNKS)
    card = ReplicaDispatcher(run, 4, eps=DISPATCH_DEMO_EPS, device=device)
    host = ReplicaDispatcher(run, 4, eps=DISPATCH_DEMO_EPS, device=device)
    host.scheduler = Scheduler(policy=Policy.DFPA, eps=DISPATCH_DEMO_EPS, backend="numpy", device="cpu")
    got, want = card.balance(DISPATCH_DEMO_CHUNKS), host.balance(DISPATCH_DEMO_CHUNKS)
    out["balance"] = {"allocations": got.allocations, "iterations": got.iterations, "converged": got.converged}
    checks["balance_bank_on_device"] = card.scheduler.backend == "torch" and card.scheduler._device.type == torch.device(device).type
    checks["balance_bit_identical"] = (
        _partition_rows({"": got}) == _partition_rows({"": want}) and card.logs == host.logs
    )
    modes = {"sync": {}, "depth0": dict(pipeline=True, pipeline_depth=0), "depth1": dict(pipeline=True, pipeline_depth=1)}
    for mode, kw in modes.items():
        card = ReplicaDispatcher(_tenants_replica_run, 4, eps=DISPATCH_TENANTS_EPS, device=device)
        host = ReplicaDispatcher(_tenants_replica_run, 4, eps=DISPATCH_TENANTS_EPS, device=device)
        fkw = dict(min_units=1, reserve_knots=16, **kw)
        got = card.balance_fleet(DISPATCH_TENANTS, backend="torch", **fkw)
        want = host.balance_fleet(DISPATCH_TENANTS, backend="numpy", **fkw)
        fleet0, restacks0, keys0 = card.fleet, card.fleet.stats()["restacks"], set(mbt._graphs)
        warm = card.balance_fleet(DISPATCH_TENANTS, backend="torch", **fkw)
        warm_want = host.balance_fleet(DISPATCH_TENANTS, backend="numpy", **fkw)
        new_keys = set(mbt._graphs) - keys0
        out[mode] = {
            "allocations": {nm: r.allocations for nm, r in got.items()},
            "iterations": {nm: r.iterations for nm, r in got.items()},
            "restacks": restacks0, "warm_restacks": card.fleet.stats()["restacks"] - restacks0,
            "graphs": len(mbt._graphs), "warm_new_graphs": len(new_keys),
            "device_dispatches": card.fleet.stats()["device_dispatches"],
        }
        checks[f"{mode}_bit_identical"] = (
            _partition_rows(got) == _partition_rows(want) and _partition_rows(warm) == _partition_rows(warm_want)
            and card.logs == host.logs
        )
        checks[f"{mode}_warm_same_session"] = card.fleet is fleet0
        checks[f"{mode}_warm_no_restack"] = card.fleet.stats()["restacks"] == restacks0
        checks[f"{mode}_warm_no_new_graph"] = not new_keys
    rec, reactions, ok = _dispatch_straggler("torch", device)
    rec_host, reactions_host, _ = _dispatch_straggler("numpy", device)
    out["straggler"] = reactions
    checks["straggler_bit_identical"] = rec == rec_host and reactions == reactions_host
    checks["straggler_healthy_epochs_and_fresh_session"] = ok
    checks["straggler_reprofile_right_replica"] = all(
        r["epochs"] is not None and r["epochs"] <= r["patience"] and not r["others"] for r in reactions
    )
    return {**out, "checks": checks}


class PrefillReplicas:
    """Real replicas sharing the card: replica ``i`` serves ``x`` chunks
    (requests of ``prompt`` tokens, each served to its first token) as one
    batch, ``ServeEngine(batch=x, seq_budget=prompt + 1).generate(tokens,
    1)`` (prefill only), ``repeats[i]`` times — the emulated heterogeneity.
    ``new > 1`` serves each request to ``new`` tokens instead (prefill and
    ``new - 1`` decode steps).  A call's time is the median of ``samples``
    CUDA-event timings; every call is kept in ``calls`` and every
    ``generate`` (one prefill each) counted in ``prefills``."""

    def __init__(self, cfg, model, repeats, prompt: int, chunks: int, *, samples: int = DISPATCH_SAMPLES,
                 seed: int = 2, new: int = 1):
        g = torch.Generator(device="cuda").manual_seed(seed)
        self.tokens = torch.randint(0, cfg.vocab_size, (chunks, prompt), generator=g, device="cuda")
        self.cfg, self.model, self.repeats, self.prompt, self.samples = cfg, model, list(repeats), prompt, samples
        self.new = new
        self.prefills = 0
        self.calls = []

    def time_ms(self, x: int, repeats: int, samples: int) -> list:
        eng = ServeEngine(self.cfg, self.model, batch=x, seq_budget=self.prompt + self.new, device="cuda")
        toks = self.tokens[:x]
        ms = []
        for _ in range(samples):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                eng.generate(toks, self.new)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        self.prefills += samples * repeats
        return ms

    def __call__(self, i: int, x: int) -> float:
        ms = self.time_ms(x, self.repeats[i], self.samples)
        self.calls.append((i, x, ms))
        return float(np.median(ms)) / 1e3


class TenantDispatcher(ReplicaDispatcher):
    """``ReplicaDispatcher`` whose tenants are served by replicas of their
    own shape: ``run_jobs`` serves each tenant's cells, in its order, with
    ``runners[tenant](i, x)`` and keeps the base class's time-sliced
    accounting and log."""

    def __init__(self, runners: dict, num_replicas: int, **kw):
        super().__init__(None, num_replicas, **kw)
        self.runners = runners

    def run_jobs(self, names, D):
        cells = iter([(str(nm), i, int(x)) for nm, row in zip(names, D) for i, x in enumerate(row) if x > 0])

        def replica_run(i, x):
            nm, i0, x0 = next(cells)
            if (i0, x0) != (i, x):
                raise RuntimeError(f"run_jobs served ({i}, {x}) where ({i0}, {x0}) of {nm} was next")
            return self.runners[nm](i, x)

        self.replica_run = replica_run
        return super().run_jobs(names, D)


def _reset_serve_counts() -> None:
    flash_attention_cuda.launches = rglru_scan_cuda.launches = 0
    flash_attention_cuda.launches_by_route = dict.fromkeys(flash_attention_cuda.launches_by_route, 0)


def _serve_counts() -> dict:
    return {"flash_attention": flash_attention_cuda.launches, "rglru_scan": rglru_scan_cuda.launches,
            "flash_attention_by_route": dict(flash_attention_cuda.launches_by_route)}


def _launch_checks(counts: dict, prefills: int) -> dict:
    return {
        "flash_launches_8_per_prefill": counts["flash_attention"] == SERVE_LAUNCHES["flash_attention"] * prefills,
        "rglru_launches_18_per_prefill": counts["rglru_scan"] == SERVE_LAUNCHES["rglru_scan"] * prefills,
        "flash_all_wgmma": counts["flash_attention_by_route"].get("wgmma") == counts["flash_attention"],
    }


def dispatch_dfpa(cfg, model, n: int = DISPATCH_N, samples: int = DISPATCH_SAMPLES, new: int = 1) -> dict:
    """Part (b): ``ReplicaDispatcher.balance`` over four real replicas
    (``PrefillReplicas``, r = [1, 2, 3, 4]), n = 192 chunks of 128 tokens,
    eps 0.1, the bank on the card.  Checks: converged; the final
    distribution measured 5 more times at median imbalance <= 2*eps;
    flash 8 and the scan 18 launches per prefill run, flash all
    ``"wgmma"``.  ``n``, ``samples`` and ``new`` (tokens a request is
    served to) let ``tools/dispatch_probe.py`` run other configurations."""
    run = PrefillReplicas(cfg, model, DISPATCH_REPEATS, DISPATCH_PROMPT, n, samples=samples, new=new)
    disp = ReplicaDispatcher(run, len(DISPATCH_REPEATS), eps=DISPATCH_EPS, device="cuda")
    torch.cuda.synchronize()
    _reset_serve_counts()
    t0 = time.perf_counter()
    res = disp.balance(n, min_units=1)
    wall_s = time.perf_counter() - t0
    d = res.allocations
    remeasured = [[run(i, x) for i, x in enumerate(d)] for _ in range(DISPATCH_REMEASURE)]
    counts = _serve_counts()
    imbs = [imbalance(t) for t in remeasured]
    median_imb = float(np.median(imbs))
    history = res.diagnostics["history"]
    return {
        "replicas": len(DISPATCH_REPEATS), "repeats": DISPATCH_REPEATS, "n": n, "prompt": DISPATCH_PROMPT,
        "samples": samples, "new_tokens": new, "eps": DISPATCH_EPS, "converged": res.converged,
        "iterations": res.iterations, "allocations": d, "final_imbalance": res.imbalance, "wall_s": wall_s,
        "rounds": [{"d": list(h[0]), "times_ms": [v * 1e3 for v in h[1]], "imbalance": imbalance(h[1])}
                   for h in history],
        "scheduler_host_s": wall_s - disp.exec_host_s, "serve_host_s": disp.exec_host_s,
        "remeasured_ms": [[v * 1e3 for v in t] for t in remeasured], "remeasured_imbalance": imbs,
        "remeasured_imbalance_median": median_imb, "prefills": run.prefills, "launches": counts,
        "calls": [{"i": i, "x": x, "ms": ms} for i, x, ms in run.calls],
        "served": {DISPATCH_PROMPT: sorted({x for _, x, _ in run.calls})},
        "checks": {"converged": bool(res.converged), "remeasure_within_2eps": median_imb <= 2 * DISPATCH_EPS,
                   **_launch_checks(counts, run.prefills)},
    }


def dispatch_cycle(cfg, model) -> dict:
    """Part (c): two tenants through ``balance_fleet`` on the same four
    real replicas (``chat``: 192 chunks of 128 tokens, ``summarize``: 48
    chunks of 512), then ``DISPATCH_EPOCHS`` steady epochs: ``rebalance``,
    every tenant served time-sliced (``run_jobs``), ``straggler_actions``
    before ``observe``, sync.  Checks: every allocation sums to its n; no
    straggler action in a steady epoch; each ``FleetRoundLog``'s wall cost
    is its busiest replica's sum across tenants."""
    runners = {nm: PrefillReplicas(cfg, model, DISPATCH_REPEATS, prompt, n, seed=3 + k)
               for k, (nm, (n, prompt)) in enumerate(DISPATCH_CYCLE.items())}
    loads = {nm: n for nm, (n, _) in DISPATCH_CYCLE.items()}
    disp = TenantDispatcher(runners, len(DISPATCH_REPEATS), eps=DISPATCH_EPS, device="cuda")
    torch.cuda.synchronize()
    _reset_serve_counts()
    t0 = time.perf_counter()
    res = disp.balance_fleet(loads, min_units=1)
    balance_s = time.perf_counter() - t0
    rounds = len(disp.logs)
    fleet = disp.fleet
    epochs, sums_ok = [], all(sum(r.allocations) == loads[nm] for nm, r in res.items())
    for _ in range(DISPATCH_EPOCHS):
        t1 = time.perf_counter()
        ds = fleet.rebalance(dict(loads))
        names = list(ds)
        T = disp.run_jobs(names, [ds[nm] for nm in names])
        times = {nm: [float(v) for v in T[k]] for k, nm in enumerate(names)}
        acts = [a.value for a in fleet.straggler_actions(times)]
        fleet.observe(times)
        sums_ok &= all(sum(ds[nm]) == loads[nm] for nm in names)
        epochs.append({"d": ds, "times_ms": {nm: [v * 1e3 for v in t] for nm, t in times.items()},
                       "actions": acts, "wall_cost_ms": disp.logs[-1].wall_cost * 1e3,
                       "host_s": time.perf_counter() - t1})
    counts = _serve_counts()
    prefills = sum(r.prefills for r in runners.values())
    walls_ok = all(
        log.wall_cost == float(np.max(np.sum(np.asarray(log.times, dtype=np.float64), axis=0)))
        and log.proc_busy == [float(v) for v in np.sum(np.asarray(log.times, dtype=np.float64), axis=0)]
        for log in disp.logs
    )
    return {
        "tenants": {nm: {"chunks": n, "prompt": prompt} for nm, (n, prompt) in DISPATCH_CYCLE.items()},
        "repeats": DISPATCH_REPEATS, "eps": DISPATCH_EPS, "balance_s": balance_s, "rounds": rounds,
        "converged": {nm: r.converged for nm, r in res.items()},
        "iterations": {nm: r.iterations for nm, r in res.items()},
        "allocations": {nm: r.allocations for nm, r in res.items()},
        "round_wall_cost_ms": [log.wall_cost * 1e3 for log in disp.logs[:rounds]],
        "epochs": epochs, "prefills": prefills, "launches": counts,
        "served": {r.prompt: sorted({x for _, x, _ in r.calls}) for r in runners.values()},
        "checks": {
            "allocations_sum_to_n": bool(sums_ok),
            "no_straggler_action": all(a == "none" for e in epochs for a in e["actions"]),
            "wall_cost_is_busiest_replica_sum": bool(walls_ok),
            **_launch_checks(counts, prefills),
        },
    }


def dispatch_kernel_parity(cfg) -> list:
    """Before parts (b) and (c): each kernel against its plain version at
    ``DISPATCH_KERNEL_SHAPES`` — ``_flash_parity`` with the model's heads,
    head_dim, window and scale, on the ``"wgmma"`` route, and
    ``_rglru_parity`` at d_rnn with an initial state and the model's
    near-1 decays.  Raises on a disagreement."""
    kw = dict(causal=True, window=cfg.window, scale=cfg.query_scale)
    rows = []
    for B, S in DISPATCH_KERNEL_SHAPES:
        before = flash_attention_cuda.launches_by_route["wgmma"]
        flash_err = _flash_parity(B, cfg.num_heads, cfg.num_kv_heads, S, S, cfg.head_dim, kw, None, torch.bfloat16)
        if flash_attention_cuda.launches_by_route["wgmma"] - before != 2:
            raise SystemExit(f"chip_smoke: flash_attention at batch {B}, prompt {S} left the 'wgmma' route")
        scan_err = _rglru_parity(B, S, cfg.d_rnn, None, None, True, decay=RGLRU_NEAR_ONE)
        rows.append({"batch": B, "prompt": S, "flash_max_abs_err": flash_err, "rglru_max_abs_err": scan_err})
    return rows


def dispatch_captured_parity(cfg, model, served: dict) -> list:
    """After parts (b) and (c), their counts read: for each prompt length,
    one prefill at the smallest and the largest batch the parts served,
    with the inputs of its last local and last recurrent layer captured,
    and each kernel held against its plain version on them
    (``_check_serve_flash``, on ``"wgmma"``; the scan at atol = rtol =
    1e-5).  Raises on a disagreement."""
    rows = []
    for prompt, xs in sorted(served.items()):
        for x in sorted({min(xs), max(xs)}):
            g = torch.Generator(device="cuda").manual_seed(prompt + x)
            toks = torch.randint(0, cfg.vocab_size, (x, prompt), generator=g, device="cuda")
            eng = ServeEngine(cfg, model, batch=x, seq_budget=prompt + 1, device="cuda")
            with _Capture() as cap:
                eng.generate(toks, 1)
            what = f"on a dispatch prefill's own inputs (batch {x}, prompt {prompt})"
            q, k, v, kw = cap.seen["flash_attention"]
            before = flash_attention_cuda.launches_by_route["wgmma"]
            check = _check_serve_flash(flash_attention(q, k, v, impl="cuda", **kw), q, k, v, kw, what)
            if flash_attention_cuda.launches_by_route["wgmma"] - before != 1:
                raise SystemExit(f"chip_smoke: flash_attention {what} left the 'wgmma' route")
            log_a, b, h0, kw = cap.seen["rglru_scan"]
            ok, err = _close(rglru_scan(log_a, b, h0, impl="cuda", **kw), rglru_scan_ref(log_a, b, h0), 1e-5)
            if not ok:
                raise SystemExit(f"chip_smoke: rglru_scan disagrees with its plain version {what}")
            rows.append({"batch": x, "prompt": prompt, "flash": check,
                         "rglru": {"shape": list(log_a.shape), "h0": h0 is not None, "max_abs_err": err}})
    return rows


def dispatch_model():
    """recurrentgemma-2b at full width as the ``serve`` phase builds it
    (seed 0), shared by every replica."""
    cfg = get_config(SERVE_ARCH)
    return cfg, init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")


def phase_dispatch() -> dict:
    """(a) ``dispatch_parity_gate`` on the card; the kernels at the phase's
    shapes (``dispatch_kernel_parity``); (b) ``dispatch_dfpa`` and (c)
    ``dispatch_cycle`` over four full-width replicas; the kernels on the
    inputs of prefills at the smallest and largest batches (b) and (c)
    served (``dispatch_captured_parity``).  Returns (b) and (c)'s flash /
    scan launches, by route."""
    t0 = time.perf_counter()
    row = dispatch_parity_gate("cuda")
    emit({"phase": "dispatch", "part": "a", "seconds": time.perf_counter() - t0, **row})
    failed = [f"a.{k}" for k, ok in row["checks"].items() if not ok]
    cfg, model = dispatch_model()
    t0 = time.perf_counter()
    emit({"phase": "dispatch", "part": "kernels", "rows": dispatch_kernel_parity(cfg),
          "seconds": time.perf_counter() - t0})
    total = {"flash_attention": 0, "rglru_scan": 0,
             "flash_attention_by_route": dict.fromkeys(flash_attention_cuda.launches_by_route, 0)}
    served = {}
    for part, fn in (("b", dispatch_dfpa), ("c", dispatch_cycle)):
        t0 = time.perf_counter()
        row = fn(cfg, model)
        emit({"phase": "dispatch", "part": part, "seconds": time.perf_counter() - t0, **row})
        failed += [f"{part}.{k}" for k, ok in row["checks"].items() if not ok]
        counts = row["launches"]
        total["flash_attention"] += counts["flash_attention"]
        total["rglru_scan"] += counts["rglru_scan"]
        for r, v in counts["flash_attention_by_route"].items():
            total["flash_attention_by_route"][r] += v
        for prompt, xs in row["served"].items():
            served.setdefault(prompt, set()).update(xs)
    t0 = time.perf_counter()
    emit({"phase": "dispatch", "part": "captured", "rows": dispatch_captured_parity(cfg, model, served),
          "seconds": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: the dispatch phase failed {failed}")
    return total

# ---------------------------------------------------------------------------


def _captured_flash(q, k, v, kw, route, what) -> dict:
    """The kernel on one prefill layer's own attention inputs: against its
    plain version (``_check_serve_flash``), on ``route``, timed beside the
    plain version, with its bound; and, where the library call computes
    the same function (no softcap, no window, and no causal mask over
    ``Sq != Sk``, which it aligns to the first key), beside
    ``scaled_dot_product_attention`` on the same operands."""
    before = dict(flash_attention_cuda.launches_by_route)
    check = _check_serve_flash(flash_attention(q, k, v, impl="cuda", **kw), q, k, v, kw, what)
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    if routes != {r: int(r == route) for r in routes}:
        raise SystemExit(f"chip_smoke: flash_attention {what} went {routes}, not {route!r}")
    ms = _routes_timed(flash_attention_cuda, route, lambda: flash_attention_cuda(q, k, v, **kw), 10)
    plain_kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale")}
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **plain_kw), 3)
    B, H, S, D = q.shape
    Sk = k.shape[2]
    library_ms = None
    if not kw["softcap"] and not kw["window"] and (S == Sk or not kw["causal"]):
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=kw["causal"], scale=kw["scale"], enable_gqa=True),
                             10)  # yardstick only
    bound_ms, bound_by, pairs = _flash_bound(B, H, k.shape[1], S, D, kw["window"], Sk, kw["causal"])
    return {"shape": [B, H, k.shape[1], S, Sk, D], "causal": kw["causal"], "window": kw["window"],
            "softcap": kw["softcap"], "route": route, **check, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": "scaled_dot_product_attention(is_causal, enable_gqa=True)" if library_ms is not None else None,
            "visible_pairs_per_head": pairs}


def _routes_of(fn) -> tuple:
    """Run ``fn``; return its result and the expert choices ``(B, S, k)``
    of every MoE layer it ran, in call order."""
    seen, orig = [], lm_module.apply_moe

    def recording(p, c, x):
        seen.append(moe_top_k(router_probs(p, x), c.top_k)[1])
        return orig(p, c, x)

    lm_module.apply_moe = recording
    try:
        return fn(), seen
    finally:
        lm_module.apply_moe = orig


def _decode_vs_full(model, cfg, seq) -> dict:
    """Prefill of ``seq[:, :-1]`` + one decode step against the full
    forward over ``seq``: the last position's logits (rel), and for MoE the
    share of (token, choice) pairs whose expert is the same in both, with
    the last token's flips by layer."""
    B, S = seq.shape

    def full():
        hid, _, aux = apply_lm(model, cfg, seq, torch.arange(S, device="cuda"))
        return lm_logits(model, cfg, hid[:, -1]), float(aux)

    def cached():
        caches = init_cache(cfg, B, S, cfg.dtype, "cuda")
        _, caches = prefill(model, cfg, seq[:, :-1], caches)
        return decode_step(model, cfg, seq[:, -1:], S - 1, caches)[0]

    (want, aux), full_routes = _routes_of(full)
    got, cached_routes = _routes_of(cached)
    row = {"rel": _rel(got, want), "rel_by_sequence": [_rel(got[b], want[b]) for b in range(B)],
           "finite": bool(torch.isfinite(want).all() and torch.isfinite(got).all()), "aux_loss_full": aux,
           "capacity_factor": cfg.capacity_factor if cfg.is_moe else None}
    if full_routes:
        n = len(full_routes)
        whole = [torch.cat([p, d], dim=1) for p, d in zip(cached_routes[:n], cached_routes[n:])]
        # a pair flips when its expert is not among the other computation's choices
        flips = [~(f[..., :, None] == w[..., None, :]).any(-1) for f, w in zip(full_routes, whole)]
        pairs = sum(f.numel() for f in flips)
        row.update({
            "pairs": pairs, "pairs_flipped": sum(int(f.sum()) for f in flips),
            "prompt_pairs_flipped": sum(int(f[:, :-1].sum()) for f in flips),
            "last_token_pairs_flipped_by_layer": [int(f[:, -1].sum()) for f in flips],
        })
        row["routing_agreement"] = 1.0 - row["pairs_flipped"] / pairs
    return row


def decoder_full(out: dict, arch: str, layers, batch: int, prompt_len: int, new: int, route: str) -> dict:
    """One decoder at full width (``layers`` cut, or the published depth)
    served by ``ServeEngine.generate`` on the card, random weights (seed
    0).  Gates: one ``generate`` launches ``flash_attention`` once per
    attention layer, all on ``route``; three ``generate`` calls give
    identical tokens; prefill + one decode step agree with the full forward
    over ``prompt_len + 1`` tokens (rel 0.05; MoE at capacity factor
    ``DECODER_CHECK_CAPACITY``); the kernel agrees with its plain version
    on the prefill's own inputs of the last local and the last global
    layer.  For MoE, prefill + decode must route at least
    ``ROUTING_AGREEMENT`` of the (token, choice) pairs as the full forward
    does in bfloat16 (near ties flip there: the decode step's plain
    attention rounds apart from the kernel's), and the logits are held in
    float32, where no pair flips.  Times from CUDA events: prefill is a ``generate`` of one token,
    a decode step the rest of one of ``new`` tokens over ``new - 1``.  The
    model must be freed at the end (the card's allocated bytes back within
    256 MiB of where they started).  Fills ``out`` as it goes (the caller prints it, also after a failed
    gate)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    out.update({"arch": arch, "layers": cfg.num_layers, "published_layers": get_config(arch).num_layers,
                "batch": batch, "prompt": prompt_len, "new_tokens": new})
    out["allocated_before_bytes"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServeEngine(cfg, model, batch=batch, seq_budget=prompt_len + new, device="cuda")
    gp = torch.Generator(device="cuda").manual_seed(1)
    seq = torch.randint(0, cfg.vocab_size, (batch, prompt_len + 1), generator=gp, device="cuda")
    prompt = seq[:, :prompt_len]
    attn_layers = sum(k in ("attn", "local") for k in cfg.layer_kinds())

    # the main path: one generate, the counts set to 0 just before it and read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_serve_counts()
    tokens, ms = _timed_generate(eng, prompt, new)
    counts = _serve_counts()
    out["launches"] = counts
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if counts["flash_attention"] != attn_layers or counts["flash_attention_by_route"][route] != attn_layers:
        raise SystemExit(f"chip_smoke: one {arch} generate launched {counts}, expected {attn_layers} flash on {route!r}")
    if counts["rglru_scan"]:
        raise SystemExit(f"chip_smoke: {arch} launched rglru_scan {counts['rglru_scan']} times")
    gen_ms = [ms]
    for _ in range(2):
        again, ms = _timed_generate(eng, prompt, new)
        gen_ms.append(ms)
        if not torch.equal(again, tokens):
            raise SystemExit(f"chip_smoke: two {arch} generate calls gave different tokens")
    prefill_ms = []
    for _ in range(3):
        first, ms = _timed_generate(eng, prompt, 1)
        prefill_ms.append(ms)
        if not torch.equal(first[:, 0], tokens[:, 0]):
            raise SystemExit(f"chip_smoke: {arch} generate of one token differs from the first of {new}")
    out["generate_ms_runs"], out["prefill_ms_runs"] = gen_ms, prefill_ms
    out["prefill_ms"] = float(np.median(prefill_ms))
    out["decode_ms_per_token"] = (float(np.median(gen_ms)) - out["prefill_ms"]) / (new - 1)
    out["tok_per_s"] = batch * new / (float(np.median(gen_ms)) / 1e3)
    out["prefill_tok_per_s"] = batch * prompt_len / (out["prefill_ms"] / 1e3)
    out["decode_tok_per_s"] = batch / (out["decode_ms_per_token"] / 1e3)
    out["tokens_identical"] = True
    out["sample"] = tokens[0, :8].tolist()

    with torch.inference_mode():
        ccfg = cfg.replace(capacity_factor=DECODER_CHECK_CAPACITY) if cfg.is_moe else cfg
        dtypes = (cfg.dtype, torch.float32) if cfg.is_moe else (cfg.dtype,)
        out["decode_vs_full"] = {_dtype_name(d): _decode_vs_full(model, ccfg.replace(dtype=d), seq) for d in dtypes}
        for name, row in out["decode_vs_full"].items():
            if not row["finite"]:
                raise SystemExit(f"chip_smoke: {arch} full forward in {name} is not finite")
        main = out["decode_vs_full"][_dtype_name(cfg.dtype)]
        if cfg.is_moe:
            # bf16 router near ties flip between the two computations (the
            # decode step's plain attention rounds apart from the kernel's):
            # hold the routing to ROUTING_AGREEMENT there and the logits in
            # float32, where nothing flips
            gated = out["decode_vs_full"]["float32"]
            if not main["routing_agreement"] >= ROUTING_AGREEMENT:
                raise SystemExit(f"chip_smoke: {arch} prefill + decode routes {main['routing_agreement']} of pairs "
                                 f"as the full forward does, below {ROUTING_AGREEMENT}")
        else:
            gated = main
        if not gated["rel"] < 0.05:
            raise SystemExit(f"chip_smoke: {arch} prefill + decode differs from the full forward ({out['decode_vs_full']})")

        # the kernel on the inputs of the main path's prefill (the last
        # local and the last global layer)
        with _Capture() as cap:
            prefill(model, cfg, prompt, eng.new_cache())
        out["captured_flash"] = {}
        for window, (q, k, v, kw) in sorted(cap.flash_by_window.items()):
            kind = "local" if window else "global"
            out["captured_flash"][kind] = _captured_flash(
                q, k, v, kw, route, f"on the {arch} prefill's own inputs ({kind} layer)")
        del cap, q, k, v
    model_ref = weakref.ref(model)
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_after_free_bytes"] = torch.cuda.memory_allocated()
    if model_ref() is not None or out["allocated_after_free_bytes"] > out["allocated_before_bytes"] + 2**28:
        held_by = [type(r).__name__ for r in gc.get_referrers(model_ref())] if model_ref() is not None else []
        raise SystemExit(f"chip_smoke: {arch}'s model outlived its part: {out['allocated_after_free_bytes']} bytes "
                         f"allocated after it, {out['allocated_before_bytes']} before; held by {held_by}")
    return out


def phase_decoders() -> tuple:
    """(a) gemma2-2b and (b) granite-moe-1b-a400m at their published width
    and depth, (c) gemma2-27b, granite-20b, stablelm-12b and
    deepseek-v2-236b at full width and reduced depth (``DECODERS``), each
    through ``decoder_full`` and freed before the next; the kernel at
    gemma2-2b's prefill shape (random operands) timed beside the plain
    version, SDPA and its bound; (d) all six at smoke widths in float32,
    the card's tokens equal to the CPU's.  Returns (the launches of the
    timed ``generate`` calls of (a)-(c): flash by route, and the scan; the
    timing row)."""
    # the dispatch phase's replicas keep its model through reference
    # cycles until a collection: free it before the first part measures
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"flash_attention": dict.fromkeys(flash_attention_cuda.launches_by_route, 0), "rglru_scan": 0}
    for arch, layers, batch, prompt_len, new, route in DECODERS:
        t0 = time.perf_counter()
        row = {"phase": "decoders", "part": "full"}
        try:
            decoder_full(row, arch, layers, batch, prompt_len, new, route)
        finally:
            row["seconds"] = time.perf_counter() - t0
            emit(row)
        for r, n in row["launches"]["flash_attention_by_route"].items():
            launches["flash_attention"][r] += n
        launches["rglru_scan"] += row["launches"]["rglru_scan"]
    cfg = get_config("gemma2-2b")
    kw = dict(causal=True, window=cfg.window, softcap=cfg.attn_softcap, scale=cfg.query_scale)
    timing = _flash_timing_at(DECODERS[0][2], cfg.num_heads, cfg.num_kv_heads, DECODERS[0][3], cfg.head_dim, kw,
                              "wgmma", "at gemma2-2b's prefill shape", seed=11)
    emit({"phase": "decoders", "part": "flash_timing", "kernel": "flash_attention", "timing": timing})
    for arch, *_ in DECODERS:
        emit({"phase": "decoders", "part": "smoke", **_serve_smoke({}, arch)})
    return launches, timing

# ---------------------------------------------------------------------------


def _free(out: dict, before: int, what: str) -> None:
    """Collect garbage, empty the cache and fail if more than 256 MiB stayed
    allocated after ``what`` (the next part measures its own peak)."""
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_after_free_bytes"] = torch.cuda.memory_allocated()
    if out["allocated_after_free_bytes"] > before + 2**28:
        raise SystemExit(f"chip_smoke: {what} outlived its part: {out['allocated_after_free_bytes']} bytes "
                         f"allocated after it, {before} before")


def _train_single_part(out: dict, cfg, batch: int, seq: int, steps: int, lr: float) -> list:
    """``train_single`` on the card with the counts set to 0 just before it
    and read just after; the step ms (host clock between two
    synchronisations), tokens/s and peak memory.  Returns the losses."""
    out.update({"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model, "batch": batch, "seq": seq,
                "steps": steps, "remat": cfg.remat, "xent_chunk": cfg.xent_chunk})
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    _reset_serve_counts()
    state, losses = train_single(cfg, steps=steps, batch=batch, seq=seq, lr=lr, device="cuda",
                                 history=hist, log_every=steps)
    torch.cuda.synchronize()
    out["launches"] = _serve_counts()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["params"] = sum(t.numel() for _, t in tree_leaves(state.params))
    out["state_bytes"] = sum(t.numel() * t.element_size() for _, t in tree_leaves((state.params, state.opt.mu, state.opt.nu)))
    out["losses"] = losses
    out["grad_norms"] = [h["grad_norm"] for h in hist]
    out["step_ms_runs"] = [h["ms"] for h in hist]
    out["step_ms"] = float(np.median(out["step_ms_runs"][1:]))  # the first step carries first-use costs
    out["tokens_per_s"] = batch * seq / (out["step_ms"] / 1e3)
    del state
    _free(out, before, f"{cfg.name}'s training state")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"chip_smoke: {cfg.name} training gave a loss that is not finite: {losses}")
    return losses


def _layer_launches(cfg, kinds, per_step: int, steps: int) -> int:
    return sum(k in kinds for k in cfg.layer_kinds()) * per_step * steps


def train_gemma(out: dict) -> None:
    """(a) gemma2-2b as published, ``remat="full"``, ``xent_chunk`` 512:
    the loss falls, and every step launches flash 26 x 2 times (the forward
    and the remat recompute), all on ``"wgmma"``."""
    t = TRAIN_SINGLE
    cfg = get_config(t["arch"])
    losses = _train_single_part(out, cfg, t["batch"], t["seq"], t["steps"], t["lr"])
    want = _layer_launches(cfg, ("attn", "local"), 2, t["steps"])
    counts = out["launches"]
    if counts["flash_attention"] != want or counts["flash_attention_by_route"]["wgmma"] != want or counts["rglru_scan"]:
        raise SystemExit(f"chip_smoke: gemma2-2b training launched {counts}, expected {want} flash, all 'wgmma'")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: gemma2-2b's loss did not fall over {t['steps']} steps: {losses}")


def train_rec(out: dict) -> None:
    """(c) recurrentgemma-2b at full width, cut to its prefix and one
    pattern unit: the scan runs 3 times a recurrent layer a step (forward,
    remat recompute, the backward's reversed recurrence), flash twice a
    local layer."""
    t = TRAIN_REC
    full = get_config(t["arch"])
    cfg = full.replace(num_layers=len(full.prefix) + len(full.pattern))
    out["published_layers"] = full.num_layers
    _train_single_part(out, cfg, t["batch"], t["seq"], t["steps"], t["lr"])
    want = {"flash_attention": _layer_launches(cfg, ("attn", "local"), 2, t["steps"]),
            "rglru_scan": _layer_launches(cfg, ("rec",), 3, t["steps"])}
    counts = out["launches"]
    if {k: counts[k] for k in want} != want or counts["flash_attention_by_route"]["wgmma"] != want["flash_attention"]:
        raise SystemExit(f"chip_smoke: recurrentgemma-2b training launched {counts}, expected {want}")


def train_groups(out: dict) -> None:
    """(b) granite-moe-1b-a400m as published through ``train_hetero``:
    four groups emulating 1.0 / 1.4 / 2.0 / 3.1x slowdowns share the card;
    DFPA rebalances at least once, ends with ``d[3] < d[0]`` over 16
    units, and the loss falls; flash 24 x 2 launches a unit."""
    t = TRAIN_HETERO
    cfg = get_config(t["arch"])
    out.update({"arch": cfg.name, "layers": cfg.num_layers, **{k: t[k] for k in ("groups", "hetero", "units",
                "micro_batch", "seq", "steps", "eps")}})
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    _reset_serve_counts()
    t0 = time.perf_counter()
    state, ctrl = train_hetero(cfg, steps=t["steps"], groups=t["groups"], hetero=t["hetero"], n_units=t["units"],
                               micro_batch=t["micro_batch"], seq=t["seq"], lr=t["lr"], eps=t["eps"],
                               device="cuda", history=hist)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = counts = _serve_counts()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["history"] = hist
    out["final_d"], out["rebalances"] = list(ctrl.d), ctrl.rebalances
    out["unit_ms_by_group"] = [[1e3 * tm / h / d if d else None for tm, h, d in zip(r["times"], t["hetero"], r["d"])]
                               for r in hist]
    del state, ctrl
    _free(out, before, "granite-moe's training states")
    losses = [r["loss"] for r in hist]
    want = _layer_launches(cfg, ("attn", "local"), 2, t["steps"] * t["units"])
    if counts["flash_attention"] != want or counts["flash_attention_by_route"]["wgmma"] != want:
        raise SystemExit(f"chip_smoke: the four groups launched {counts}, expected {want} flash, all 'wgmma'")
    if not (out["rebalances"] >= 1 and out["final_d"][3] < out["final_d"][0] and sum(out["final_d"]) == t["units"]
            and all(sum(r["d"]) == t["units"] for r in hist)):
        raise SystemExit(f"chip_smoke: DFPA did not move units toward the fast groups: {hist}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"chip_smoke: the four groups' loss did not fall: {losses}")


def _grad_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def train_flash_grads(q, k, v, kw, what: str) -> dict:
    """(d) ``FlashAttention`` on a training step's own inputs.  Its forward
    (the kernel, on ``"wgmma"``) against ``flash_attention_ref`` on float32
    copies (``_check_serve_flash(..., fp32=True)``: the kernel and the
    backward take the logits in fp32; the planted fault drops the first
    key tile where the window covers every key, else cuts the window one
    tile short), and bit-identical to ``flash_attention_cuda`` with the
    model's own arguments (``bq``/``bk`` included).  Its gradients against
    autograd through ``flash_attention_ref`` on the float32 copies; a
    backward whose causal mask is dropped must fail the same check.  Times
    the Function's forward + backward beside the plain version's (at the
    inputs' dtype)."""
    plain_kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale")}
    g = torch.Generator(device="cuda").manual_seed(21)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))

    def forward():
        return FlashAttention.apply(q, k, v, kw["causal"], kw["window"], kw["softcap"], kw["scale"],
                                    kw["bq"], kw["bk"], True)

    def fn():
        return torch.autograd.grad(forward(), (q, k, v), dout)

    def plain():
        return torch.autograd.grad(flash_attention_ref(q, k, v, **plain_kw), (q, k, v), dout)

    before = dict(flash_attention_cuda.launches_by_route)
    out = forward()
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    if routes != {r: int(r == "wgmma") for r in routes}:
        raise SystemExit(f"chip_smoke: the Function's forward {what} went {routes}, not 'wgmma'")
    Sk = k.shape[2]
    fault = "first_key_tile_dropped" if not kw["window"] or kw["window"] >= Sk else "window_one_tile_short"
    forward_check = _check_serve_flash(out.detach(), q.detach(), k.detach(), v.detach(), kw, what,
                                       fault=fault, fp32=True)
    same = torch.equal(out, flash_attention_cuda(q.detach(), k.detach(), v.detach(), **kw))
    if not same:
        raise SystemExit(f"chip_smoke: the Function's forward {what} differs from flash_attention_cuda's")
    del out
    got = fn()
    want = torch.autograd.grad(flash_attention_ref(q32, k32, v32, **plain_kw), (q32, k32, v32), dout.float())
    bad = attention_backward(q.detach(), k.detach(), v.detach(), dout, **{**plain_kw, "causal": not kw["causal"]})
    tol = TRAIN_GRAD_TOL["flash_attention"]
    row = {"what": what, "shape": list(q.shape), "kv": list(k.shape), "window": kw["window"], "softcap": kw["softcap"],
           "forward": {**forward_check, "bit_identical_to_flash_attention_cuda": same},
           "rel": {n: _grad_rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)},
           "rel_to_the_bf16_plain_version": {n: _grad_rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, plain())},
           "planted_rel": {n: _grad_rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), bad, want)}, "tol": tol}
    del want
    row["ms"], row["plain_ms"] = cuda_ms(fn, 3), cuda_ms(plain, 3)
    if not max(row["rel"].values()) <= tol:
        raise SystemExit(f"chip_smoke: flash_attention's gradient {what} differs from its plain version's: {row}")
    if max(row["planted_rel"].values()) <= tol:
        raise SystemExit(f"chip_smoke: the flash gradient check passed a backward without its causal mask: {row}")
    return row


def train_scan_grads(log_a, b, what: str) -> dict:
    """(d) ``RGLRUScan`` (the kernel forward and the kernel on the reversed
    recurrence) against autograd through ``rglru_scan_ref`` on a training
    step's own inputs, with a random ``h0`` so that ``dh0`` is checked; a
    reversed recurrence that does not shift the decays by one step must
    fail the same check."""
    g = torch.Generator(device="cuda").manual_seed(22)
    h0 = torch.randn(log_a.shape[0], log_a.shape[2], generator=g, device="cuda")
    dh = torch.randn(log_a.shape, generator=g, device="cuda")
    la, bb, h0 = (t.detach().requires_grad_(True) for t in (log_a, b, h0))

    def fn():
        return torch.autograd.grad(RGLRUScan.apply(la, bb, h0, None, None, True), (la, bb, h0), dh)

    def plain():
        return torch.autograd.grad(rglru_scan_ref(la, bb, h0), (la, bb, h0), dh)

    got, want = fn(), plain()
    g_bad = rglru_scan_cuda(la.detach().flip(1).contiguous(), dh.flip(1).contiguous(), None, bs=None, bd=None).flip(1)
    tol = TRAIN_GRAD_TOL["rglru_scan"]
    row = {"what": what, "shape": list(la.shape),
           "rel": {n: _grad_rel(a, w) for n, a, w in zip(("dlog_a", "db", "dh0"), got, want)},
           "planted_rel_db": _grad_rel(g_bad, want[1]), "tol": tol}
    row["ms"], row["plain_ms"] = cuda_ms(fn, 3), cuda_ms(plain, 1)
    if not max(row["rel"].values()) <= tol:
        raise SystemExit(f"chip_smoke: rglru_scan's gradient {what} differs from its plain version's: {row}")
    if row["planted_rel_db"] <= tol:
        raise SystemExit(f"chip_smoke: the scan gradient check passed an unshifted reversed recurrence: {row}")
    return row


def train_checkpoint_resume(out: dict) -> None:
    """Checkpoints on the card at smoke width (float32): save after one
    step, restore bit for bit, and the resumed step's loss is the
    uninterrupted step's (its parameters within 1e-6 in L2: the backward's
    index and scatter adds run in any order on the card)."""
    cfg = get_smoke_config(TRAIN_SINGLE["arch"]).replace(dtype=torch.float32)
    data = SyntheticLMData(cfg, batch=2, seq=32)
    step = make_train_step(cfg, warmup_cosine(3e-3, 1, 3))
    state, _ = step(init_train_state(cfg, 0, device="cuda"), data.batch_at(0))
    path = ARTIFACTS / "train_ckpt"
    save_checkpoint(str(path), 1, {"train": state}, extra={"data": {"next_index": 1, "seed": 0}})
    restored, man = load_checkpoint(str(path), {"train": init_train_state(cfg, 1, device="cuda")})
    restored = restored["train"]
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(restored), tree_leaves(state)))
    nxt = data.batch_at(man["extra"]["data"]["next_index"])
    (a, am), (b, bm) = step(state, nxt), step(restored, nxt)
    with torch.no_grad():
        dist = max(float((x - y).norm() / y.norm().clamp_min(1e-30))
                   for (_, x), (_, y) in zip(tree_leaves(b.params), tree_leaves(a.params)))
    out["checkpoint"] = {"restored_bit_identical": same, "resumed_loss": float(bm["loss"]), "loss": float(am["loss"]),
                         "resumed_params_l2_rel": dist}
    if not (same and torch.equal(am["loss"], bm["loss"]) and dist <= 1e-6):
        raise SystemExit(f"chip_smoke: a restored checkpoint does not resume the run: {out['checkpoint']}")


def phase_train() -> dict:
    """(a) gemma2-2b trains at full width, (b) granite-moe's four groups
    balanced by DFPA, (c) recurrentgemma-2b's scan under training, (d) the
    kernels' gradients on inputs captured from (a) and (c), and the
    checkpoint check.  Returns the launches of (a)-(c) by kernel and route."""
    gc.collect()
    torch.cuda.empty_cache()
    rows = {}
    for part, fn in (("gemma2-2b", train_gemma), ("recurrentgemma-2b", train_rec)):
        row = {"phase": "train", "part": part}
        t0 = time.perf_counter()
        try:
            with _Capture() as cap:  # the kernels' inputs for (d)
                fn(row)
            rows[part] = (row, cap.flash_by_window, cap.seen.get("rglru_scan"))
        finally:
            row["seconds"] = time.perf_counter() - t0
            emit(row)
    row = {"phase": "train", "part": "groups"}
    t0 = time.perf_counter()
    try:
        train_groups(row)
    finally:
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    rows["groups"] = (row, None, None)
    grads = {"phase": "train", "part": "gradients", "flash_attention": {}, "rglru_scan": None}
    t0 = time.perf_counter()
    try:
        for window, (q, k, v, kw) in sorted(rows["gemma2-2b"][1].items()):
            kind = "local" if window else "global"
            grads["flash_attention"][kind] = train_flash_grads(q, k, v, kw, f"on gemma2-2b's training inputs ({kind} layer)")
        log_a, b, _, _ = rows["recurrentgemma-2b"][2]
        grads["rglru_scan"] = train_scan_grads(log_a, b, "on recurrentgemma-2b's training inputs")
        train_checkpoint_resume(grads)
    finally:
        grads["seconds"] = time.perf_counter() - t0
        emit(grads)
    launches = {"flash_attention": dict.fromkeys(flash_attention_cuda.launches_by_route, 0), "rglru_scan": 0}
    for row, _, _ in rows.values():
        for r, n in row["launches"]["flash_attention_by_route"].items():
            launches["flash_attention"][r] += n
        launches["rglru_scan"] += row["launches"]["rglru_scan"]
    return launches


# ---------------------------------------------------------------------------


def _flash_launched(counts: dict, want: int, what: str) -> None:
    if counts["flash_attention"] != want or counts["flash_attention_by_route"]["wgmma"] != want or counts["rglru_scan"]:
        raise SystemExit(f"chip_smoke: {what} launched {counts}, expected {want} flash, all 'wgmma', and no scan")


def _serving_times(out: dict, gen_ms: list, prefill_ms: list, batch: int, prompt: int, new: int) -> None:
    out["generate_ms_runs"], out["prefill_ms_runs"] = gen_ms, prefill_ms
    out["prefill_ms"] = float(np.median(prefill_ms))
    out["decode_ms_per_token"] = (float(np.median(gen_ms)) - out["prefill_ms"]) / (new - 1)
    out["prefill_tok_per_s"] = batch * prompt / (out["prefill_ms"] / 1e3)
    out["decode_tok_per_s"] = batch / (out["decode_ms_per_token"] / 1e3)


def _serve_family(out: dict, model, run, new: int, prompt: int, flash: int, what: str) -> torch.Tensor:
    """The serving gates of a family: ``run(n)`` gives ``(B, n)`` greedy
    tokens.  A warm-up run of 2; with the counts set to 0, one run of
    ``new`` (CUDA events) that launches flash ``flash`` times, all
    ``"wgmma"``, and no scan; a second run with the same tokens; two runs
    of 1 whose token is the first.  Records the parameters, the peak memory
    of the counted run and ``_serving_times``; returns its tokens."""
    out["params"] = sum(p.numel() for p in model.parameters())
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    run(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_serve_counts()
    tokens, ms = _cuda_timed(lambda: run(new))
    out["launches"] = _serve_counts()
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    _flash_launched(out["launches"], flash, f"one {what} run of {new} tokens")
    again, ms2 = _cuda_timed(lambda: run(new))
    if not torch.equal(again, tokens):
        raise SystemExit(f"chip_smoke: two {what} runs gave different tokens")
    prefill_ms = []
    for _ in range(2):
        first, pms = _cuda_timed(lambda: run(1))
        prefill_ms.append(pms)
        if not torch.equal(first[:, 0], tokens[:, 0]):
            raise SystemExit(f"chip_smoke: {what}'s first token differs between runs of 1 and {new}")
    _serving_times(out, [ms, ms2], prefill_ms, tokens.shape[0], prompt, new)
    out["tokens_identical"], out["sample"] = True, tokens[0, :8].tolist()
    return tokens


def _greedy(prefill_fn, step_fn, pos: int, new: int) -> torch.Tensor:
    """``prefill_fn()`` gives ``(logits, caches)`` and the first token, then
    ``new - 1`` greedy ``step_fn(token, position, caches)`` from position
    ``pos``; returns ``(B, new)`` tokens."""
    with torch.inference_mode():
        logits, caches = prefill_fn()
        toks = [torch.argmax(logits, -1)[:, None]]
        for i in range(new - 1):
            logits, caches = step_fn(toks[-1], pos + i, caches)
            toks.append(torch.argmax(logits, -1)[:, None])
        return torch.cat(toks, dim=1)


def _seamless_greedy(model, cfg, frames, prompt, new: int) -> torch.Tensor:
    """``encdec_prefill`` then greedy ``encdec_decode_step`` s on
    ``frames``' device, as the reference's tests drive it."""
    B, P = prompt.shape
    return _greedy(lambda: encdec_prefill(model, cfg, frames, prompt,
                                          init_encdec_cache(cfg, B, P + new, frames.shape[1], cfg.dtype, frames.device)),
                   lambda tok, pos, caches: encdec_decode_step(model, cfg, tok, pos, caches), P, new)


def family_xlstm(out: dict) -> None:
    """(a) xlstm-350m as published (24 layers, d 1024) served by
    ``ServeEngine``: batch 4, a 1,024-token prompt (four mLSTM chunks), 16
    greedy tokens through ``_serve_family``, which launch no kernel (the
    xLSTM blocks have none).  A prefill of the first 768 prompt tokens and
    256 teacher-forced decode steps agree with the full forward over the
    prompt (rel 0.05 at the last position; a prefill of 1,023 tokens is
    refused, as the reference refuses it: 256 does not divide it).  Decode
    ms a token is timed over those 256 steps (CUDA events); the difference
    of two ``generate`` lengths is kept beside it."""
    t = FAMILY_XLSTM
    cfg = get_config(t["arch"])
    B, S, new, S0 = t["batch"], t["prompt"], t["new"], t["check_prefill"]
    out.update({"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model, "batch": B, "prompt": S,
                "new_tokens": new})
    before = torch.cuda.memory_allocated()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServeEngine(cfg, model, batch=B, seq_budget=S + new, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
    _serve_family(out, model, lambda n: eng.generate(prompt, n), new, S, 0, cfg.name)
    with torch.inference_mode():
        hid, _, _ = apply_lm(model, cfg, prompt, torch.arange(S, device="cuda"))
        full = lm_logits(model, cfg, hid[:, S0:])
        del hid
        caches = init_cache(cfg, B, S, cfg.dtype, "cuda")
        _, caches = prefill(model, cfg, prompt[:, :S0], caches)

        def steps():
            nonlocal caches
            got = []
            for i in range(S0, S):
                step, caches = decode_step(model, cfg, prompt[:, i:i + 1], i, caches)
                got.append(step)
            return got

        got, ms = _cuda_timed(steps)
        # the host-bound prefill varies by hundreds of ms between calls, more
        # than 15 decode steps take: time decode directly, over these steps
        out["decode_ms_per_token_from_generate"] = out["decode_ms_per_token"]
        out["decode_ms_per_token"] = ms / (S - S0)
        out["decode_tok_per_s"] = B / (out["decode_ms_per_token"] / 1e3)
        rels = [_rel(step, full[:, i]) for i, step in enumerate(got)]
        del full, caches, got
    out["decode_vs_full"] = {"prefill": S0, "decode_steps": S - S0, "rel_last": rels[-1], "rel_max": max(rels)}
    if not rels[-1] < 0.05:
        raise SystemExit(f"chip_smoke: xlstm-350m prefill + decode differs from the full forward: {out['decode_vs_full']}")
    del model, eng
    _free(out, before, "xlstm-350m's model")


def family_seamless(out: dict) -> dict:
    """(b) seamless-m4t-medium as published (12 encoder + 12 decoder
    layers, d 1024, vocab 256,206): frames of 2 x 1,024, a decoder prompt
    of 128 and 16 greedy tokens through ``_serve_family``: flash 36 times a
    run (12 encoder, 12 decoder self-attention, 12 cross-attention).
    Prefill + one decode step agree with the full decoder (rel 0.05); the
    kernel agrees with its plain version on the prefill's own encoder,
    decoder and cross inputs, and on random operands with ``Sq != Sk``
    both ways.  Returns the captured cross-attention inputs, named, for
    (d)'s gradient checks."""
    t = FAMILY_SEAMLESS
    cfg = get_config(t["arch"])
    B, F, P, new = t["batch"], t["frames"], t["prompt"], t["new"]
    out.update({"arch": cfg.name, "encoder_layers": cfg.encoder_layers, "decoder_layers": cfg.num_layers,
                "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": B, "frames": F, "prompt": P,
                "new_tokens": new})
    before = torch.cuda.memory_allocated()
    model = init_encdec(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    frames = stub_frame_embeddings(cfg, B, F, seed=2, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
    _serve_family(out, model, lambda n: _seamless_greedy(model, cfg, frames, prompt, n), new, P,
                  cfg.encoder_layers + 2 * cfg.num_layers, cfg.name)
    with torch.inference_mode():
        xkv = _cross_kv_all(model, cfg, encode(model, cfg, frames))
        hid, _ = apply_decoder(model, cfg, prompt, torch.arange(P, device="cuda"), xkv)
        full = _dec_logits(model, cfg, hid[:, -1])
        del xkv, hid
        caches = init_encdec_cache(cfg, B, P, F, cfg.dtype, "cuda")
        _, caches = encdec_prefill(model, cfg, frames, prompt[:, :-1], caches)
        got, _ = encdec_decode_step(model, cfg, prompt[:, -1:], P - 1, caches)
        out["decode_vs_full_rel"] = _rel(got, full)
        del caches, got, full
        if not out["decode_vs_full_rel"] < 0.05:
            raise SystemExit(f"chip_smoke: seamless prefill + decode differs from the full decoder ({out['decode_vs_full_rel']})")
        with _Capture() as cap:
            encdec_prefill(model, cfg, frames, prompt, init_encdec_cache(cfg, B, P, F, cfg.dtype, "cuda"))
        out["captured_flash"] = {}
        for name, key in (("encoder", (False, F, F)), ("decoder", (True, P, P)), ("cross", (False, P, F))):
            q, k, v, kw = cap.flash_by_shape[key]
            out["captured_flash"][name] = _captured_flash(q, k, v, kw, "wgmma",
                                                          f"on seamless's prefill inputs ({name} attention)")
        cross = cap.flash_by_shape[(False, P, F)]
        del cap, q, k, v
    out["random_operands"] = []
    for Bq, H, Kv, Sq, Sk, D in FAMILY_RANDOM_CROSS:
        q, k, v = _flash_operands(Bq, H, Kv, Sq, Sk, D, torch.bfloat16, seed=Sq + Sk)
        kw = dict(causal=False, window=0, softcap=0.0, scale=1.0 / D ** 0.5, bq=None, bk=None)
        out["random_operands"].append(_captured_flash(q, k, v, kw, "wgmma", f"at Sq {Sq}, Sk {Sk} (non-causal)"))
    del model, frames, q, k, v
    _free(out, before, "seamless-m4t-medium's model")
    return {f"prefill's cross-attention (B {B}, Sq {P}, Sk {F})": cross}


def family_pixtral(out: dict) -> None:
    """(c) pixtral-12b at full width cut to 4 layers: 256 prefix embeddings
    (the vision stub's) + 1,024 text tokens, batch 2, 8 new tokens through
    ``prefill(prefix_embeds=)`` and ``decode_step`` in ``_serve_family``:
    flash once a layer (head_dim 128, 32 query heads over 8 KV heads).
    Prefill + one decode step agree with the full forward over prefix +
    text (rel 0.05); the kernel agrees with its plain version on the
    prefill's own inputs."""
    t = FAMILY_PIXTRAL
    full_cfg = get_config(t["arch"])
    cfg = full_cfg.replace(num_layers=t["layers"])
    B, S, new, P = t["batch"], t["text"], t["new"], cfg.num_prefix_embeddings
    out.update({"arch": cfg.name, "layers": cfg.num_layers, "published_layers": full_cfg.num_layers,
                "d_model": cfg.d_model, "batch": B, "prefix": P, "text": S, "new_tokens": new})
    before = torch.cuda.memory_allocated()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    pe = stub_patch_embeddings(cfg, B, seed=2, device="cuda")
    text = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")

    def run(n: int):
        return _greedy(lambda: prefill(model, cfg, text[:, :S], init_cache(cfg, B, P + S + n, cfg.dtype, "cuda"),
                                       prefix_embeds=pe),
                       lambda tok, pos, caches: decode_step(model, cfg, tok, pos, caches), P + S, n)

    _serve_family(out, model, run, new, P + S, cfg.num_layers, cfg.name)
    with torch.inference_mode():
        hid, _, _ = apply_lm(model, cfg, text, torch.arange(P + S + 1, device="cuda"), prefix_embeds=pe)
        full = lm_logits(model, cfg, hid[:, -1])
        del hid
        caches = init_cache(cfg, B, P + S + 1, cfg.dtype, "cuda")
        _, caches = prefill(model, cfg, text[:, :S], caches, prefix_embeds=pe)
        got, _ = decode_step(model, cfg, text[:, S:], P + S, caches)
        out["decode_vs_full_rel"] = _rel(got, full)
        del caches, got, full
        if not out["decode_vs_full_rel"] < 0.05:
            raise SystemExit(f"chip_smoke: pixtral prefill + decode differs from the full forward ({out['decode_vs_full_rel']})")
        with _Capture() as cap:
            prefill(model, cfg, text[:, :S], init_cache(cfg, B, P + S, cfg.dtype, "cuda"), prefix_embeds=pe)
        q, k, v, kw = cap.flash_by_shape[(True, P + S, P + S)]
        out["captured_flash"] = _captured_flash(q, k, v, kw, "wgmma", "on pixtral's prefill inputs (prefix + text)")
        del cap, q, k, v
    del model, pe
    _free(out, before, "pixtral-12b's model")


def family_train(out: dict, t: dict) -> dict:
    """(d) ``train_single`` at the published size: the loss finite and
    falling; flash twice an attention call a step (the forward and the
    remat recompute; the encoder-decoder's encoder, decoder and cross
    attention), none for xLSTM.  For the encoder-decoder, returns the
    inputs of the first step's first encoder, decoder and cross-attention
    calls, named, for the gradient checks: ``encdec_loss`` runs the
    encoder's E layers, then each decoder layer's self- and then
    cross-attention, so these are flash calls 0, E and E + 1."""
    cfg = get_config(t["arch"])
    E = cfg.encoder_layers if cfg.is_encdec else 0
    with _Capture(keep=(0, E, E + 1) if cfg.is_encdec else ()) as cap:
        losses = _train_single_part(out, cfg, t["batch"], t["seq"], t["steps"], t["lr"])
    per_call = 2 if cfg.remat == "full" else 1  # the forward, and the recompute of a remat layer
    want = (E + 2 * cfg.num_layers) * per_call * t["steps"] if cfg.is_encdec else 0
    _flash_launched(out["launches"], want, f"{cfg.name} training")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: {cfg.name}'s loss did not fall over {t['steps']} steps: {losses}")
    if not cfg.is_encdec:
        return {}
    calls = {"encoder": cap.flash_calls[0], "decoder": cap.flash_calls[E], "cross": cap.flash_calls[E + 1]}
    causal = {name: kw["causal"] for name, (_, _, _, kw) in calls.items()}
    if causal != {"encoder": False, "decoder": True, "cross": False}:
        raise SystemExit(f"chip_smoke: {cfg.name} training's flash calls 0, {E} and {E + 1} are not an encoder, "
                         f"a decoder and a cross-attention call: causal {causal}")
    return {f"training {name} attention (B {q.shape[0]}, Sq {q.shape[2]}, Sk {k.shape[2]})": (q, k, v, kw)
            for name, (q, k, v, kw) in calls.items()}


def _encdec_smoke(arch: str) -> dict:
    """The encoder-decoder's smoke model in float32: the card's greedy
    tokens (kernels) equal the CPU's (plain versions), decoder logits within
    rel 1e-4, and flash launched."""
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    cpu_model = init_encdec(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu_model = EncoderDecoder.from_state_dict(cfg, {n: t.to("cuda") for n, t in cpu_model.state_dict().items()})
    frames = torch.from_numpy((0.02 * np.random.default_rng(2).standard_normal((SMOKE_BATCH, 10, cfg.d_model)))
                              .astype(np.float32))
    prompt = torch.randint(0, cfg.vocab_size, (SMOKE_BATCH, SMOKE_PROMPT), generator=torch.Generator().manual_seed(1))
    out = {}
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        before = flash_attention_cuda.launches
        f, p = frames.to(dev), prompt.to(dev)
        toks = _seamless_greedy(model, cfg, f, p, SMOKE_NEW)
        with torch.inference_mode():
            xkv = _cross_kv_all(model, cfg, encode(model, cfg, f))
            hid, _ = apply_decoder(model, cfg, p, torch.arange(SMOKE_PROMPT, device=dev), xkv)
        out[dev] = (toks.cpu(), _dec_logits(model, cfg, hid).cpu(), flash_attention_cuda.launches - before)
    rel = _rel(out["cuda"][1], out["cpu"][1])
    row = {"arch": cfg.name, "tokens_equal": bool(torch.equal(out["cuda"][0], out["cpu"][0])), "logits_rel": rel,
           "launches": {"flash_attention": out["cuda"][2]}, "tokens": out["cuda"][0][0].tolist()}
    if not row["tokens_equal"] or not rel < 1e-4 or out["cuda"][2] < 1:
        raise SystemExit(f"chip_smoke: the encoder-decoder smoke model on the card differs from the CPU: {row}")
    return row


def phase_families() -> dict:
    """(a) xlstm-350m, (b) seamless-m4t-medium and (c) pixtral-12b (4
    layers) served at full width, (d) xlstm-350m and seamless-m4t-medium
    trained as published, and ``FlashAttention``'s gradients on the inputs
    captured from seamless's training (its encoder, decoder and cross
    attention) and from (b)'s prefill (cross-attention, ``Sq != Sk``), (e)
    the three smoke models in float32 against the CPU; each model freed
    before the next.  Returns the launches of the counted runs of (a)-(d):
    flash by route, and the scan."""
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"flash_attention": dict.fromkeys(flash_attention_cuda.launches_by_route, 0), "rglru_scan": 0}
    parts = [("xlstm-350m", family_xlstm), ("seamless-m4t-medium", family_seamless), ("pixtral-12b", family_pixtral)]
    parts += [(f"train {t['arch']}", lambda row, t=t: family_train(row, t)) for t in FAMILY_TRAIN]
    captured = {}
    for name, fn in parts:
        row = {"phase": "families", "part": name}
        t0 = time.perf_counter()
        try:
            captured.update(fn(row) or {})
        finally:
            row["seconds"] = time.perf_counter() - t0
            emit(row)
        for r, n in row["launches"]["flash_attention_by_route"].items():
            launches["flash_attention"][r] += n
        launches["rglru_scan"] += row["launches"]["rglru_scan"]
    row = {"phase": "families", "part": "flash gradients", "flash_attention": {}}
    t0 = time.perf_counter()
    try:
        for what, (q, k, v, kw) in captured.items():
            # clones: normal tensors (the prefill's capture ran under inference_mode)
            row["flash_attention"][what] = train_flash_grads(q.clone(), k.clone(), v.clone(), kw,
                                                             f"on seamless's {what} inputs")
    finally:
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    t0 = time.perf_counter()
    smoke = [_serve_smoke({}, "xlstm-350m"), _serve_smoke({}, "pixtral-12b"), _encdec_smoke("seamless-m4t-medium")]
    emit({"phase": "families", "part": "smoke", "smoke": smoke, "seconds": time.perf_counter() - t0})
    return launches


def _random_args(spec_args, cfg, shape, seed: int):
    """The step's arguments on the card (``dryrun.materialize``), filled
    with random values from ``seed``: floats normal(0, 0.02), AdamW's
    second moment its absolute value; positions (decode's ``pos`` and the
    caches' ``pos``) uniform below the cell's sequence length, the other
    integers (token ids, labels) below the vocabulary."""
    args = dryrun.materialize(spec_args, "cuda")
    positions = {id(args[2])} if shape.kind == "decode" else set()
    nu = {id(t) for _, t in tree_leaves(args[0].opt.nu)} if shape.kind == "train" else set()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for path, t in tree_leaves(args):
            if t.device.type != "cuda":
                continue
            if t.is_floating_point():
                t.normal_(0.0, 0.02, generator=gen)
                if id(t) in nu:
                    t.abs_()
            elif id(t) in positions or path[-1] == "pos":
                t.random_(0, shape.seq_len, generator=gen)
            else:
                t.random_(0, cfg.vocab_size, generator=gen)
    return args


def _dryrun_real(arch: str, shape_name: str, rec: dict) -> dict:
    """The 1-unit variant of one cell run for real: arguments made from
    random weights after a baseline of allocated bytes, the peak reset,
    one step timed with CUDA events; the peak above the baseline against
    the trace's resident bytes, the wall against its ``compute_s``, the
    launches against its kernel calls."""
    shape = next(s for s in dryrun.SHAPES if s.name == shape_name)
    cfg = dryrun.reduced_units(get_config(arch), 1).replace(scan_layers=False, unroll_scans=True)
    fn, spec_args = dryrun.build_step(cfg, shape, dryrun.make_production_mesh())
    u1 = rec["cost_model"]["u1"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = _random_args(spec_args, cfg, shape, seed=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (dict(flash_attention_cuda.launches_by_route), rglru_scan_cuda.launches)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = dryrun.run_step(fn, args, shape)
    stop.record()
    torch.cuda.synchronize()
    wall_s = start.elapsed_time(stop) * 1e-3
    peak = torch.cuda.max_memory_allocated() - base
    flash = {r: n - before[0][r] for r, n in flash_attention_cuda.launches_by_route.items()}
    scan = rglru_scan_cuda.launches - before[1]
    result = out[1]["loss"] if shape.kind == "train" else out[0]  # the loss, or the logits
    finite = bool(torch.isfinite(result.float()).all())
    if shape.kind == "train":  # and the updated parameters
        finite = finite and all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(out[0].params))
    del out, result, args
    gc.collect()
    torch.cuda.empty_cache()
    compute_s = dryrun.compute_seconds(u1["flops"])
    memory_s = u1["bytes"] / HW.HBM_BW
    row = {
        "arch": arch, "shape": shape_name, "units": 1, "predicted_resident_bytes": u1["resident_bytes"],
        "measured_peak_bytes": int(peak), "memory_rel": peak / u1["resident_bytes"] - 1.0,
        "wall_s": wall_s, "compute_s": compute_s, "memory_s": memory_s, "memory_s_over_wall": memory_s / wall_s,
        "compute_s_over_wall": compute_s / wall_s, "trace_kernel_calls": u1["kernel_calls"],
        "launches": {"flash_attention_by_route": flash, "rglru_scan": scan}, "outputs_finite": finite,
    }
    calls = u1["kernel_calls"]
    checks = {
        "memory": abs(row["memory_rel"]) <= DRYRUN_MEM_TOL,
        "bound": wall_s >= compute_s,
        "launches": sum(flash.values()) == calls.get("flash_attention", 0) and scan == calls.get("rglru_scan", 0),
        "finite": finite,
    }
    row["checks"] = checks
    if not all(checks.values()):
        emit({"phase": "dryrun", "part": "b", **row})
        raise SystemExit(f"chip_smoke: the dry run's {arch} {shape_name} (1 unit) disagrees with the card: {checks}")
    return row


def phase_dryrun() -> dict:
    """(a) ``HW.HBM_BYTES`` against the card, every architecture at
    ``DRYRUN_SHAPE`` and the cells of ``DRYRUN_REAL`` traced; (b) those
    cells' 1-unit variants run for real (``_dryrun_real``).  Returns the
    launches of (b): flash by route, and the scan."""
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "dryrun", "part": "a", "total_memory": total, "HW.HBM_BYTES": HW.HBM_BYTES})
    if total != HW.HBM_BYTES:
        raise SystemExit(f"chip_smoke: the card has {total} bytes, launch.mesh.HW.HBM_BYTES pins {HW.HBM_BYTES}")
    cells = [(a, DRYRUN_SHAPE) for a in dryrun.ARCH_IDS] + [c for c in DRYRUN_REAL if c[1] != DRYRUN_SHAPE]
    recs = {}
    t0 = time.perf_counter()
    for arch, shape in cells:
        rec = dryrun.run_cell(arch, shape)
        recs[(arch, shape)] = rec
        row = {"phase": "dryrun", "part": "a", "arch": arch, "shape": shape, "status": rec["status"]}
        if rec["status"] == "ok":
            row.update(resident_gib=rec["mem"]["resident_bytes"] / 2**30, fits_hbm=rec["fits_hbm"],
                       compute_s=rec["terms"]["compute_s"], memory_s=rec["terms"]["memory_s"],
                       dominant=rec["dominant"], trace_s=rec["trace_s"], kernel_calls=rec["kernel_calls"],
                       u1_resident_gib=rec["cost_model"]["u1"]["resident_bytes"] / 2**30)
        else:
            row["detail"] = rec.get("reason") or rec.get("error")
        emit(row)
        if rec["status"] not in ("ok", "skipped"):
            raise SystemExit(f"chip_smoke: dry-run cell {arch} {shape} ended {rec['status']}: {rec.get('traceback')}")
    emit({"phase": "dryrun", "part": "a", "cells": len(cells), "seconds": time.perf_counter() - t0})
    launches = {"flash_attention": dict.fromkeys(flash_attention_cuda.launches_by_route, 0), "rglru_scan": 0}
    for arch, shape in DRYRUN_REAL:
        rec = recs[(arch, shape)]
        if rec["status"] != "ok" or rec["cost_model"]["u1"]["resident_bytes"] > HW.HBM_BYTES:
            raise SystemExit(f"chip_smoke: {arch} {shape} does not fit the card at one unit in the dry run")
        t1 = time.perf_counter()
        row = _dryrun_real(arch, shape, rec)
        emit({"phase": "dryrun", "part": "b", **row, "seconds": time.perf_counter() - t1})
        for r, n in row["launches"]["flash_attention_by_route"].items():
            launches["flash_attention"][r] += n
        launches["rglru_scan"] += row["launches"]["rglru_scan"]
    return launches


def _load_example(name: str):
    """``examples_torch/<name>.py`` as a module, loaded by path (the
    directory is no package); its ``main`` is not run."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_flash(q, k, v, kw, what: str) -> dict:
    """The kernel on one flash call captured from a model twin: against its
    plain version at the ``kernels`` phase's bf16 tolerance, on the
    ``"wgmma"`` route, timed beside the plain version and, where it computes
    the same function, ``scaled_dot_product_attention``, with its bound."""
    kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale", "bq", "bk")}
    plain_kw = {n: kw[n] for n in ("causal", "window", "softcap", "scale")}
    B, H, S, D = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, impl="cuda", **kw)
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    if routes != {r: int(r == "wgmma") for r in routes}:
        raise SystemExit(f"chip_smoke: flash_attention {what} went {routes}, not 'wgmma'")
    tol = FLASH_TOL[q.dtype]
    ok, err = _close(got, flash_attention_ref(q, k, v, **plain_kw), tol)
    if not ok:
        raise SystemExit(f"chip_smoke: flash_attention {what} disagrees with its plain version: {err}")
    ms = _routes_timed(flash_attention_cuda, "wgmma", lambda: flash_attention_cuda(q, k, v, **kw), 20)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **plain_kw), 10)
    library_ms = None
    if not kw["softcap"] and not kw["window"] and (S == Sk or not kw["causal"]):
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=kw["causal"], scale=kw["scale"], enable_gqa=True),
                             20)  # yardstick only
    bound_ms, bound_by, pairs = _flash_bound(B, H, Kv, S, D, kw["window"], Sk, kw["causal"])
    return {"shape": [B, H, Kv, S, Sk, D], "dtype": _dtype_name(q.dtype), "causal": kw["causal"],
            "window": kw["window"], "k_strides": list(k.stride()), "route": "wgmma", "max_abs_err": err,
            "tol": f"atol = rtol = {tol}", "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention(is_causal, enable_gqa=True)" if library_ms is not None else None,
            "bound_ms": bound_ms, "bound_by": bound_by, "visible_pairs_per_head": pairs}


def phase_examples() -> dict:
    """The ten ``examples_torch`` twins on the card, each through its
    ``main(device="cuda")`` (stdout to ``build/examples/<name>.txt``):
    (a) each twin's claims; (b) the flash launches of the two model twins
    by route, all on ``"wgmma"``, and the kernel held against
    its plain version on each one's first captured flash call; (c) each
    twin's seconds and ``fleet_pipeline``'s Part 2 ms per epoch.  Returns
    the twins' flash launches by route."""
    out_dir = ARTIFACTS / "examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = dict.fromkeys(flash_attention_cuda.launches_by_route, 0)
    for name in EXAMPLES:
        mod = _load_example(name)
        before = dict(flash_attention_cuda.launches_by_route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Capture(keep=(0,)) as cap, open(out_dir / f"{name}.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            got = mod.main(device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
        if not all(got["claims"].values()):
            raise SystemExit(f"chip_smoke: the {name} twin's claims fail on the card: {got['claims']}")
        counters = {k: got[k] for k in EXAMPLE_COUNTERS.get(name, {})}
        if counters != EXAMPLE_COUNTERS.get(name, {}):
            raise SystemExit(f"chip_smoke: the {name} twin counts {counters} on the card, "
                             f"the reference's script {EXAMPLE_COUNTERS[name]}")
        row = {"phase": "examples", "example": name, "seconds": seconds, "claims": got["claims"],
               "counters": counters, "flash_launches_by_route": routes}
        if name == "fleet_pipeline_walkthrough":
            row.update(sync_ms_per_epoch=got["sync_ms"], pipelined_ms_per_epoch=got["pipelined_ms"],
                       pipelined_speedup=got["sync_ms"] / got["pipelined_ms"])
        if name in EXAMPLE_MODELS:
            if not routes["wgmma"] or any(n for r, n in routes.items() if r != "wgmma"):
                raise SystemExit(f"chip_smoke: the {name} twin launched flash {routes}, not all on 'wgmma'")
            q, k, v, kw = cap.flash_calls[0]
            row["flash_first_call"] = _example_flash(q, k, v, kw, f"on the {name} twin's first call")
            del cap, q, k, v
        elif any(routes.values()):
            raise SystemExit(f"chip_smoke: the {name} twin launched flash {routes}; it runs no model")
        for r, n in routes.items():
            launches[r] += n
        emit(row)
        del got, mod
        gc.collect()
        torch.cuda.empty_cache()
    return {"flash_attention": launches}


def main() -> int:
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": seconds[name]})
        return result

    smi = run("device", phase_device)
    run("build", phase_build)
    timings = run("kernels", phase_kernels)
    run("bank", phase_bank)
    run("hcl_golden", phase_hcl_golden)
    dfpa_launches, dfpa_routes = run("dfpa", phase_dfpa)
    serve = run("serve", phase_serve)
    run("paper", phase_paper)
    grid_launches, grid_routes = run("grid", phase_grid, smi)
    run("energy", phase_energy, smi)
    hier_launches, hier_routes = run("hier", phase_hier, smi)
    obs_launches, obs_routes = run("obs", phase_obs)
    straggler_launches, straggler_routes = run("straggler", phase_straggler)
    fleet_launches, fleet_routes = run("fleet", phase_fleet)
    dispatch = run("dispatch", phase_dispatch)
    decoders, decoder_timing = run("decoders", phase_decoders)
    train = run("train", phase_train)
    families = run("families", phase_families)
    dryrun_launches = run("dryrun", phase_dryrun)
    examples = run("examples", phase_examples)
    by_phase = {"dfpa": dfpa_launches, "grid": grid_launches, "hier": hier_launches, "obs": obs_launches,
                "straggler": straggler_launches, "fleet": fleet_launches}
    by_phase_routes = [dfpa_routes, grid_routes, hier_routes, obs_routes, straggler_routes, fleet_routes]
    serve_by_phase = {k: {"serve": serve["launches"][k], "dispatch": dispatch[k]} for k in SERVE_LAUNCHES}
    model_phases = {"decoders": decoders, "train": train, "families": families, "dryrun": dryrun_launches}
    for name, counted in {**model_phases, "examples": examples}.items():
        serve_by_phase["flash_attention"][name] = sum(counted["flash_attention"].values())
    for name, counted in model_phases.items():  # the twins run no scan
        serve_by_phase["rglru_scan"][name] = counted["rglru_scan"]
    launches = {"matmul_update": sum(by_phase.values()), **{k: sum(v.values()) for k, v in serve_by_phase.items()}}
    flash_routes = {r: v + dispatch["flash_attention_by_route"][r]
                    + sum(c["flash_attention"][r] for c in (decoders, train, families, dryrun_launches, examples))
                    for r, v in serve["launches_by_route"]["flash_attention"].items()}
    routes = {
        "matmul_update": {r: sum(rs[r] for rs in by_phase_routes) for r in dfpa_routes},
        "flash_attention": flash_routes,
    }
    sources = {
        "matmul_update": "src/repro/kernels/matmul_update.py:49",
        "flash_attention": "src/repro/kernels/flash_attention.py:93",
        "rglru_scan": "src/repro/kernels/rglru.py:48",
    }
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": sources[name], "launches": launches[name], "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], "dtype": row["dtype"],
        **({"launches_by_route": routes[name], "kernel_route": row["route"]} if name in routes else {}),
        "launches_by_phase": by_phase if name == "matmul_update" else serve_by_phase[name],
        **({"decoders_timing": decoder_timing, "head_dims_160_192": row["head_dims_160_192"],
            "head_dims_16_32": row["head_dims_16_32"]} if name == "flash_attention" else {}),
    } for name, row in timings.items()], "phase_seconds": seconds})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
