"""Kernels of the port, each a hand-written CUDA kernel for Hopper beside its
plain PyTorch version (``ref.py``):

  * ``matmul_update`` — the paper's computational kernel, the blocked
    ``C += A·B`` panel update whose speed DFPA estimates
    (``csrc/matmul_update.cu``).

The reference's other two Pallas kernels, ``flash_attention`` and
``rglru_scan``, belong to the LLM-stack slice of the port.
"""

from .ops import matmul_update

__all__ = ["matmul_update"]
