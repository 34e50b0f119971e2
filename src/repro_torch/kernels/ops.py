"""Public kernel entry points: the hand-written kernel for CUDA tensors, the
plain version for CPU tensors.

``impl="auto"`` chooses by the tensor's device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor runs the kernel or raises — nothing falls
back from the card to the plain version.  ``impl="cuda"`` insists on the
kernel, ``impl="ref"`` on the plain version, which takes CPU tensors only.
"""

from __future__ import annotations

from . import ref
from .matmul_update import check_blocks, matmul_update_cuda

__all__ = ["matmul_update"]


def matmul_update(c, a, b, *, impl: str = "auto", bm: int = 256, bn: int = 256, bk: int = 512):
    """``c += a @ b`` in place (fp32 accumulation, cast back to ``c``'s
    dtype); returns ``c``.  The reference's block rule applies on every
    path: blocks are clipped to the shape and a shape they do not divide
    raises ``ValueError``."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" or (impl == "auto" and c.device.type == "cuda"):
        return matmul_update_cuda(c, a, b, bm=bm, bn=bn, bk=bk)
    if c.device.type != "cpu":
        raise ValueError(f"matmul_update impl={impl!r} takes CPU tensors, not {c.device}")
    M, K = a.shape
    check_blocks(M, b.shape[1], K, bm, bn, bk)
    return c.copy_(ref.matmul_update_ref(c, a, b))
