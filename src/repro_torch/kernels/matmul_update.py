"""The paper's computational kernel on Hopper: blocked ``C += A @ B``.

Wraps ``csrc/matmul_update.cu`` (built and loaded by ``repro_torch._build``)
and replaces the reference's ``matmul_update_pallas``
(``src/repro/kernels/matmul_update.py:49``).  The wrapper keeps the
reference's block rule — blocks default to 256x256x512, are clipped to the
shape, and a shape they do not divide raises ``ValueError`` — although the
CUDA kernels tile the shape their own way and mask ragged edges.  ``C`` is
updated in place (the Pallas kernel aliases ``C`` in->out).

Two routes, chosen by shape and alignment in :func:`matmul_update_route`:
``"wgmma"`` (bf16 with N and K multiples of 8 and every operand 16-byte
aligned: TMA loads into an mbarrier ring feeding ``wgmma``, 64x128 output
tiles) and ``"tile"`` (everything else: a plain FMA tile kernel with the
same contract).

``matmul_update_cuda.launches`` counts the kernel's launches and
``matmul_update_cuda.launches_by_route`` the same launches by route; the
wrapper increments both where it launches the kernel and nowhere else, and
a caller may reset them to count one stretch of work.

The launch is the custom operator ``repro_torch::matmul_update`` (it
mutates ``c``), so that a trace on fake tensors (``launch.dryrun``) sees
it: its fake implementation does nothing, and its FLOP formula counts
``2 M N K``.  The route is chosen, the library loaded and the counts
bumped inside the real implementation only, which alone has data
pointers.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build

__all__ = ["check_blocks", "matmul_update_cuda", "matmul_update_route", "wgmma_smem_bytes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"tile": 0, "wgmma": 1}


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


def matmul_update_route(M: int, N: int, K: int, dtype, ptrs: Sequence[int]) -> str:
    """``"wgmma"`` for bf16 with N and K multiples of 8 and every pointer
    in ``ptrs`` (C, A, B) 16-byte aligned, which TMA and ``wgmma`` need;
    ``"tile"`` for everything else (float32 among it)."""
    if dtype == torch.bfloat16 and N % 8 == 0 and K % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "tile"


def wgmma_smem_bytes() -> int:
    """Dynamic shared memory the ``"wgmma"`` kernel asks for (from the
    built library; the card's machine only)."""
    return _lib().matmul_update_wgmma_smem()


def _check_operands(c, a, b) -> Tuple[int, int, int]:
    tensors = (c, a, b)
    if any(t.device.type not in ("cuda", "meta") for t in tensors):
        raise ValueError("matmul_update_cuda needs CUDA tensors (or meta tensors, which trace it without running it)")
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


_SIGNATURES = {  # the C entries' (argtypes, restype), set once when the library loads
    "matmul_update": (
        [ctypes.c_void_p] * 3  # c, a, b
        + [ctypes.c_int] * 5  # M, N, K, dtype, route
        + [ctypes.c_void_p],  # stream
        ctypes.c_int,
    ),
    "matmul_update_wgmma_smem": ([], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("matmul_update", _SIGNATURES)


def matmul_update_cuda(c, a, b, *, bm: int = 256, bn: int = 256, bk: int = 512):
    """``c += a @ b`` in place on the card, launched on the current stream
    without synchronising; returns ``c``.  Raises on anything the kernel
    does not take, and when the launch is refused."""
    M, N, K = _check_operands(c, a, b)
    check_blocks(M, N, K, bm, bn, bk)
    with torch.no_grad():
        _matmul_update_op(c, a, b)
    return c


matmul_update_cuda.launches = 0
matmul_update_cuda.launches_by_route = dict.fromkeys(_ROUTES, 0)


@torch.library.custom_op("repro_torch::matmul_update", mutates_args=("c",))
def _matmul_update_op(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    M, K = a.shape
    N = b.shape[1]
    route = matmul_update_route(M, N, K, c.dtype, (c.data_ptr(), a.data_ptr(), b.data_ptr()))
    fn = _lib().matmul_update
    with torch.cuda.device(c.device):
        err = fn(
            c.data_ptr(), a.data_ptr(), b.data_ptr(), M, N, K, _DTYPES[c.dtype], _ROUTES[route],
            torch.cuda.current_stream(c.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"matmul_update launch ({route} route) failed with CUDA error {err}")
    matmul_update_cuda.launches += 1
    matmul_update_cuda.launches_by_route[route] += 1


@_matmul_update_op.register_fake
def _(c, a, b) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.matmul_update)
def _matmul_update_flops(c_shape, a_shape, b_shape, *args, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]
