"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each is the function its kernel computes, written with ordinary tensor ops.
The CPU tests hold it against the reference package, ``chip_smoke.py``
holds the kernel against it on the card, and a kernel wrapper runs it for
tensors that lie on the CPU.  It is never what a CUDA tensor gets from a
wrapper.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_update_ref"]


def matmul_update_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C + A @ B`` with fp32 accumulation, cast back to ``C``'s dtype (a
    new tensor; ``c`` is not modified)."""
    acc = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return (c.to(torch.float32) + acc).to(c.dtype)
