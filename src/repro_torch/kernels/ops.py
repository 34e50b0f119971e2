"""Public kernel entry points: the hand-written kernel for CUDA tensors, the
plain version for CPU tensors.

``impl="auto"`` chooses by the tensor's device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor runs the kernel or raises — nothing falls
back from the card to the plain version.  A ``meta`` tensor (the dry run's
trace, ``launch.dryrun``) takes the kernel's path too: the kernel's custom
operator has a meta implementation, so a trace sees the kernel the card
would launch, and nothing runs.  ``impl="cuda"`` insists on the
kernel, ``impl="ref"`` on the plain version, which takes CPU tensors only.
The reference's block rule applies on every path where blocks are given.

Gradients: on a CUDA tensor ``flash_attention`` and ``rglru_scan`` go
through their ``autograd.Function`` (``flash_attention.FlashAttention``,
``rglru.RGLRUScan``), whose forward is the kernel with its counts and
routes and whose backward is plain torch (and, for the scan, the kernel
again on the reversed recurrence); it never calls ``ref``.  On a CPU tensor
autograd runs through the plain version.  ``matmul_update`` writes ``c``
in place and has no gradient (DFPA's measured kernel, not the model's).
"""

from __future__ import annotations

from typing import Optional

from . import ref
from . import flash_attention as _fa
from . import rglru as _rg
from .matmul_update import check_blocks, matmul_update_cuda

__all__ = ["matmul_update", "flash_attention", "rglru_scan"]


def _use_kernel(name: str, impl: str, t) -> bool:
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "cuda" or (impl == "auto" and t.device.type in ("cuda", "meta")):
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name} impl={impl!r} takes CPU tensors, not {t.device}")
    return False


def matmul_update(c, a, b, *, impl: str = "auto", bm: int = 256, bn: int = 256, bk: int = 512):
    """``c += a @ b`` in place (fp32 accumulation, cast back to ``c``'s
    dtype); returns ``c``."""
    if _use_kernel("matmul_update", impl, c):
        return matmul_update_cuda(c, a, b, bm=bm, bn=bn, bk=bk)
    M, K = a.shape
    check_blocks(M, b.shape[1], K, bm, bn, bk)
    return c.copy_(ref.matmul_update_ref(c, a, b))


def flash_attention(
    q, k, v, *, impl: str = "auto", causal: bool = True, window: int = 0,
    softcap: float = 0.0, scale: Optional[float] = None,
    bq: Optional[int] = 256, bk: Optional[int] = 256,
):
    """Attention ``q (B,H,Sq,D)`` over ``k``/``v (B,Kv,Sk,D)``; returns a new
    tensor of ``q``'s shape (see ``kernels/flash_attention.py``).  Raises
    ``ValueError`` for ``causal`` with ``Sq > Sk`` before any dispatch."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    _fa.check_causal(q.shape[-2], k.shape[-2], causal)
    if _use_kernel("flash_attention", impl, q):
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap, scale, bq, bk, True)
    _fa.check_operands(q, k, v)
    _fa.check_blocks(q.shape[2], k.shape[2], bq, bk)
    return ref.flash_attention_ref(q, k, v, **kw)


def rglru_scan(log_a, b, h0=None, *, impl: str = "auto", bs: Optional[int] = 256, bd: Optional[int] = 512):
    """``h_t = exp(log_a_t) * h_{t-1} + b_t`` along axis 1 from ``h0``
    (zeros when None); returns a new ``(B, S, D)`` float32 tensor."""
    if _use_kernel("rglru_scan", impl, log_a):
        return _rg.RGLRUScan.apply(log_a, b, h0, bs, bd, True)
    _, S, D = _rg.check_operands(log_a, b, h0)
    _rg.check_blocks(S, D, bs, bd)
    return ref.rglru_scan_ref(log_a, b, h0)
