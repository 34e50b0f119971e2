"""The paper's computational kernel on Hopper: blocked ``C += A @ B``.

Wraps ``csrc/matmul_update.cu`` (built and loaded by ``repro_torch._build``)
and replaces the reference's ``matmul_update_pallas``
(``src/repro/kernels/matmul_update.py:49``).  The wrapper keeps the
reference's block rule — blocks default to 256x256x512, are clipped to the
shape, and a shape they do not divide raises ``ValueError`` — although the
CUDA kernel tiles the shape its own way and masks ragged edges.  ``C`` is
updated in place (the Pallas kernel aliases ``C`` in->out).

``matmul_update_cuda.launches`` counts the kernel's launches; the wrapper
increments it where it launches the kernel and nowhere else, and a caller
may set it to 0 to count one stretch of work.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

__all__ = ["check_blocks", "matmul_update_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_blocks(
    M: int, N: int, K: int, bm: int = 256, bn: int = 256, bk: int = 512
) -> Tuple[int, int, int]:
    """The reference's block rule: blocks clipped to the shape; a shape they
    do not divide raises ``ValueError``."""
    if min(M, N, K) < 1:
        raise ValueError(f"empty shape ({M},{N},{K})")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"shape ({M},{N},{K}) not divisible by blocks ({bm},{bn},{bk})")
    return bm, bn, bk


def _check_operands(c, a, b) -> Tuple[int, int, int]:
    tensors = (c, a, b)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("matmul_update_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("c, a and b must lie on one device")
    if len({t.dtype for t in tensors}) != 1 or c.dtype not in _DTYPES:
        raise TypeError(
            f"c, a, b must share one dtype of float32/bfloat16, got "
            f"{c.dtype}, {a.dtype}, {b.dtype}"
        )
    if any(t.dim() != 2 for t in tensors):
        raise ValueError("c, a and b must be 2-D")
    M, K = a.shape
    K2, N = b.shape
    if K != K2 or tuple(c.shape) != (M, N):
        raise ValueError(f"shapes c{tuple(c.shape)} a{tuple(a.shape)} b{tuple(b.shape)} do not match")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("c, a and b must be contiguous")
    if max(M, N, K) >= 2**31:
        raise ValueError("dimensions must fit in int32")
    return M, N, K


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_update")
    fn = lib.matmul_update
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def matmul_update_cuda(c, a, b, *, bm: int = 256, bn: int = 256, bk: int = 512):
    """``c += a @ b`` in place on the card, launched on the current stream
    without synchronising; returns ``c``.  Raises on anything the kernel
    does not take, and when the launch is refused."""
    M, N, K = _check_operands(c, a, b)
    check_blocks(M, N, K, bm, bn, bk)
    fn = _lib().matmul_update
    with torch.cuda.device(c.device):
        err = fn(
            c.data_ptr(), a.data_ptr(), b.data_ptr(), M, N, K, _DTYPES[c.dtype],
            torch.cuda.current_stream(c.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"matmul_update launch failed with CUDA error {err}")
    matmul_update_cuda.launches += 1
    return c


matmul_update_cuda.launches = 0
