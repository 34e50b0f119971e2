"""Kernels of the port, each a hand-written CUDA kernel for Hopper beside its
plain PyTorch version (``ref.py``), reached through ``ops.py``:

  * ``matmul_update`` — the paper's computational kernel, the blocked
    ``C += A·B`` panel update whose speed DFPA estimates
    (``csrc/matmul_update.cu``);
  * ``flash_attention`` — online-softmax attention with GQA, softcap,
    causal and sliding-window masks, the model stack's prefill attention
    (``csrc/flash_attention.cu``);
  * ``rglru_scan`` — the RG-LRU linear recurrence with an initial state,
    the model stack's prefill scan (``csrc/rglru_scan.cu``).
"""

from .ops import flash_attention, matmul_update, rglru_scan

__all__ = ["flash_attention", "matmul_update", "rglru_scan"]
