"""Flash attention on Hopper: one pass of online-softmax attention.

Wraps ``csrc/flash_attention.cu`` (built and loaded by ``repro_torch._build``)
and replaces the reference's ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:93``).  It computes what
``ref.flash_attention_ref`` computes: GQA/MQA, the default scale ``1/sqrt(D)``,
optional tanh softcap, causal and sliding-window masks with queries
right-aligned to the keys, fp32 running max, sum and accumulator, the
weights cast to ``v``'s dtype before the second product.  Causal attention
with ``Sq > Sk`` is refused with ``ValueError`` on every device by
``ops.flash_attention`` (:func:`check_causal`, before it dispatches): its
first query rows see no key, and the reference gives them no single answer
(its plain version averages every value, its Pallas kernel the values of
the tiles it visits).  The model never asks for such a row.

Layouts: ``q (B, H, Sq, D)``, ``k``/``v (B, Kv, Sk, D)``, float32 or
bfloat16, any strides with the last dim contiguous (the model passes
transposed views of its ``(B, S, H, D)`` tensors without copying).  The
output has ``q``'s shape, dtype and memory layout.

Blocks: ``bq``/``bk`` keep the reference's rule for callers that pass them
— clipped to the shape, and a shape they do not divide raises
``ValueError``.  ``None`` skips the rule: the kernel tiles its own way and
masks ragged edges, so any length runs (the model's call).

Routes, chosen from the operands by :func:`flash_attention_route` before
the launch: ``"wgmma"`` (bf16, head_dim 64, 128 or 256, every pointer
16-byte aligned and every ``(b, h, s)`` stride a positive multiple of 8
elements: TMA loads into an mbarrier ring feeding ``wgmma``, 128 query
rows a block), ``"mma"`` (other aligned bf16 head dims of 16 or 32:
``mma.sync``, 64 rows a block) and ``"rows"`` (everything else, float32
among it: one warp per query row).  No route falls back to another at
run time.

``flash_attention_cuda.launches`` counts the kernel's launches and
``flash_attention_cuda.launches_by_route`` the same launches by route; the
wrapper increments both where it launches the kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from .. import _build

__all__ = ["ROUTES", "check_blocks", "check_causal", "flash_attention_cuda", "flash_attention_route", "wgmma_smem_bytes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("rows", "mma", "wgmma")  # in the C entry's numbering


def check_blocks(Sq: int, Sk: int, bq: Optional[int] = 256, bk: Optional[int] = 256) -> None:
    """The reference's block rule (when blocks are given): clipped to the
    shape; a shape they do not divide raises ``ValueError``."""
    if bq is None and bk is None:
        return
    bq = min(bq if bq is not None else Sq, Sq)
    bk = min(bk if bk is not None else Sk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq ({Sq},{Sk}) not divisible by blocks ({bq},{bk})")


def check_causal(Sq: int, Sk: int, causal: bool) -> None:
    """Refuse causal attention with more queries than keys (rows that see
    no key), on every device."""
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq {Sq} > Sk {Sk}: the first {Sq - Sk} query rows see no key")


def check_operands(q, k, v):
    """Shapes ``(B, H, Sq, D)``, ``(B, Kv, Sk, D)`` x2 with ``H % Kv == 0``;
    returns ``(B, H, Kv, Sq, Sk, D)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, H, Sq, D), (B, Kv, Sk, D)")
    B, H, Sq, D = q.shape
    Bk, Kv, Sk, Dk = k.shape
    if Bk != B or Dk != D or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} do not match")
    if Kv < 1 or H % Kv:
        raise ValueError(f"{H} query heads do not divide over {Kv} KV heads")
    return B, H, Kv, Sq, Sk, D


def flash_attention_route(D: int, dtype, ptrs: Sequence[int], strides: Sequence[int]) -> str:
    """The route for head_dim ``D``, ``dtype``, the pointers of q, k, v and
    the output, and their ``(b, h, s)`` element strides (q's, k's, v's,
    then the output's): the first of ``"wgmma"``, ``"mma"``, ``"rows"``
    that they allow.  TMA needs 16-byte aligned addresses and strides, and
    a positive stride for q, k and v."""
    aligned = dtype == torch.bfloat16 and all(p % 16 == 0 for p in ptrs) and all(s % 8 == 0 for s in strides)
    if aligned and D in (64, 128, 256) and all(s > 0 for s in strides[:9]):
        return "wgmma"
    if aligned and D in (16, 32, 64, 128, 256):
        return "mma"
    return "rows"


def wgmma_smem_bytes(D: int) -> int:
    """Dynamic shared memory the ``"wgmma"`` kernel asks for at head_dim
    ``D`` (from the built library; the card's machine only)."""
    return _lib().flash_attention_wgmma_smem(D)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 4  # q, k, v, out
        + [ctypes.c_longlong] * 12  # (b, h, s) strides of q, k, v, out
        + [ctypes.c_int] * 6  # B, H, Kv, Sq, Sk, D
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]  # scale, softcap, causal, window
        + [ctypes.c_int, ctypes.c_int]  # dtype, route
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_wgmma_smem.argtypes = [ctypes.c_int]
    lib.flash_attention_wgmma_smem.restype = ctypes.c_int
    return lib


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    bq: Optional[int] = 256,
    bk: Optional[int] = 256,
) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` on the card, launched on the
    current stream without synchronising, on :func:`flash_attention_route`'s
    route; returns a new tensor.  Raises on anything the kernel does not
    take, and when the launch is refused.  Causal rows without keys are
    refused by ``ops.flash_attention``, which calls this after
    :func:`check_causal`."""
    tensors = (q, k, v)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k and v must lie on one device")
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Kv, Sq, Sk, D = check_operands(q, k, v)
    check_blocks(Sq, Sk, bq, bk)
    if min(B, Sq, Sk, D) < 1:
        raise ValueError(f"empty shape q{tuple(q.shape)} k{tuple(k.shape)}")
    if D > 256:
        raise ValueError(f"head_dim {D} > 256")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("q, k and v need a contiguous last dim")
    if max(Sq, Sk) >= 2**31 or B * H > 65535:
        raise ValueError("Sq and Sk must fit in int32, and B * H in 65535 (the grid's y)")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)  # q's layout: dense views keep their strides, others become contiguous
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    route = flash_attention_route(D, q.dtype, ptrs, strides)
    fn = _lib().flash_attention
    with torch.cuda.device(q.device):
        err = fn(
            *ptrs, *strides,
            B, H, Kv, Sq, Sk, D, float(scale), float(softcap), int(bool(causal)), int(window),
            _DTYPES[q.dtype], ROUTES.index(route), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch ({route} route) failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[route] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
