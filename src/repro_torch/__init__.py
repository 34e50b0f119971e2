"""PyTorch/CUDA port of the self-adaptable partitioning system.

The JAX package ``repro`` stays the reference; this package has the same
layout and names and imports nothing of it.  This slice carries the
paper's DFPA loop: ``core`` (FPMs, host and device banks, the partitioners,
``SpeedStore``, ``Scheduler.autotune``, executors, the HCL simulator) and
``kernels`` (``matmul_update``, the paper's panel update, as a CUDA kernel
for Hopper beside its plain PyTorch version).  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from . import core, kernels

__all__ = ["core", "kernels"]
