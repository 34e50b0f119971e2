"""PyTorch/CUDA port of the self-adaptable partitioning system.

The JAX package ``repro`` stays the reference; this package has the same
layout and names and imports nothing of it.  It carries, so far:

* the paper's DFPA loop: ``core`` (FPMs, host and device banks, the
  partitioners, ``SpeedStore``, ``Scheduler.autotune``, executors, the HCL
  simulator), with the 2-D grid partitioner, energy, the two-level
  hierarchy, straggler handling (``Scheduler.straggler_actions`` over
  ``runtime.straggler``) and elastic membership (``Scheduler.resize`` /
  ``join`` / ``leave``);
* ``obs``: telemetry (spans, counters, gauges, events), the Chrome-trace
  export, the flight recorder and ``python -m repro_torch.obs.report``;
* the model stack's serving path for recurrentgemma-2b: ``configs``,
  ``nn`` (parameter specs), ``models`` (layers, local attention, the RG-LRU
  block, the decoder), ``runtime.ServeEngine`` and ``launch.serve``;
* ``kernels``: ``matmul_update``, ``flash_attention`` and ``rglru_scan`` as
  CUDA kernels for Hopper beside their plain PyTorch versions.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from . import core, kernels

__all__ = ["core", "kernels"]
