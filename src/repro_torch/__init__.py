"""PyTorch/CUDA port of the self-adaptable partitioning system.

The JAX package ``repro`` stays the reference; this package has the same
layout and names and imports nothing of it.  It carries, so far:

* the paper's DFPA loop: ``core`` (FPMs, host and device banks, the
  partitioners, ``SpeedStore``, ``Scheduler.autotune``, executors, the HCL
  simulator);
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
