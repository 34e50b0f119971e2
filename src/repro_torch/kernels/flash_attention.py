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
the launch: ``"wgmma"`` (bf16, head_dim 16, 32, 64, 128, 160, 192 or 256,
every pointer 16-byte aligned and every ``(b, h, s)`` stride a positive
multiple of 8 elements: TMA loads into an mbarrier ring feeding ``wgmma``,
128 query rows a block; 160 is stablelm-12b's head_dim, 192 deepseek-v2's
MLA scores, 16 and 32 the smoke models' and the reference's MQA case) and
``"rows"`` (everything else, float32 among it: one warp per query row).
K and V broadcast over heads (a zero head stride) are passed as their
one-head view (:func:`launch_operands`); K/V broadcast over the batch or
the sequence, or only one of them over heads, keep a zero stride, which
TMA cannot walk, and take ``"rows"``.  No route falls back to another at
run time.

``flash_attention_cuda.launches`` counts the kernel's launches and
``flash_attention_cuda.launches_by_route`` the same launches by route; the
wrapper increments both where it launches the kernel and nowhere else.

The launch is the custom operator ``repro_torch::flash_attention``, so
that a trace on fake tensors (``launch.dryrun``) sees it: its fake
implementation returns an empty tensor of ``q``'s shape, dtype and layout,
and its FLOP formula counts ``4 D`` operations for every visible (query,
key) pair of every head (:func:`visible_pairs`).  The route is chosen, the
library loaded and the counts bumped inside the real implementation only,
which alone has data pointers.

Gradients: :class:`FlashAttention` is the ``autograd.Function`` that
``ops.flash_attention`` applies to CUDA tensors.  Its forward is the kernel
(no log-sum-exp is kept); its backward recomputes the attention weights in
plain torch from the saved ``q``, ``k`` and ``v``, one block of query rows
at a time, with the logits in fp32 as the kernel takes them, and
differentiates that (:func:`attention_backward`) — the reference's
training schedule
(``_sdpa_chunked``, which its training differentiates; the Pallas kernel
has no backward).  No backward kernel runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build

__all__ = [
    "ROUTES", "WGMMA_HEAD_DIMS", "FlashAttention", "attention_backward", "attention_rows", "check_blocks",
    "check_causal", "check_register_split", "flash_attention_cuda", "flash_attention_route", "launch_operands",
    "visible_pairs", "wgmma_registers", "wgmma_smem_bytes",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -2.0e38
BACKWARD_LOGITS = 2**27  # logits a block of query rows may hold in the backward
ROUTES = ("rows", "wgmma")  # in the C entry's numbering
WGMMA_HEAD_DIMS = (16, 32, 64, 128, 160, 192, 256)  # the "wgmma" kernel's instantiations


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
    then the output's, as :func:`launch_operands` gives them): ``"wgmma"``
    where they allow it, else ``"rows"``.  TMA needs 16-byte aligned
    addresses and strides, and a positive stride for q, k and v."""
    aligned = dtype == torch.bfloat16 and all(p % 16 == 0 for p in ptrs) and all(s % 8 == 0 for s in strides)
    if aligned and D in WGMMA_HEAD_DIMS and all(s > 0 for s in strides[:9]):
        return "wgmma"
    return "rows"


def launch_operands(q, k, v, out) -> tuple:
    """What the C entry is given for these operands: ``(k, v, ptrs,
    strides)``.  K and V whose head stride is 0 (one KV head broadcast
    over ``Kv``) become their ``[:, :1]`` views, with ``Kv`` then 1: the
    same function, since every query head reads the same K/V.  ``ptrs``
    are the data pointers of q, k, v and ``out``; ``strides`` their
    ``(b, h, s)`` element strides, where a dim of size 1 (never indexed
    past 0) is given the stride it would have if contiguous over the dims
    after it.  A zero stride left after that (K/V broadcast over the batch
    or the sequence, or only one of K and V over heads) is one TMA cannot
    walk, and :func:`flash_attention_route` sends it to ``"rows"``."""
    if k.shape[1] > 1 and k.stride(1) == 0 and v.stride(1) == 0:
        k, v = k[:, :1], v[:, :1]
    strides = []
    for t in (q, k, v, out):
        st = [0, 0, 0]
        inner = t.stride(3) * t.shape[3]
        for d in (2, 1, 0):
            st[d] = t.stride(d) if t.shape[d] > 1 else inner
            inner = st[d] * t.shape[d]
        strides += st
    return k, v, [t.data_ptr() for t in (q, k, v, out)], strides


def wgmma_smem_bytes(D: int) -> int:
    """Dynamic shared memory the ``"wgmma"`` kernel asks for at head_dim
    ``D`` (from the built library; the card's machine only)."""
    return _lib().flash_attention_wgmma_smem(D)


_SIGNATURES = {  # the C entries' (argtypes, restype), set once when the library loads
    "flash_attention": (
        [ctypes.c_void_p] * 4  # q, k, v, out
        + [ctypes.c_longlong] * 12  # (b, h, s) strides of q, k, v, out
        + [ctypes.c_int] * 6  # B, H, Kv, Sq, Sk, D
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]  # scale, softcap, causal, window
        + [ctypes.c_int, ctypes.c_int]  # dtype, route
        + [ctypes.c_void_p],  # stream
        ctypes.c_int,
    ),
    "flash_attention_wgmma_smem": ([ctypes.c_int], ctypes.c_int),
    "flash_attention_wgmma_registers": ([ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
}


def wgmma_registers(D: int, lib: Optional[ctypes.CDLL] = None) -> tuple:
    """``(given, needed)`` for the ``"wgmma"`` kernel at head_dim ``D`` in
    ``lib`` (default the package's): the registers a thread got from
    ``ptxas`` (the fewer of its softcap and plain instantiations) and the
    fewest its ``setmaxnreg`` split holds with (the card's machine only)."""
    need = ctypes.c_int()
    given = (lib or _lib()).flash_attention_wgmma_registers(D, ctypes.byref(need))
    if given < 0:
        raise RuntimeError(f"flash_attention: cudaFuncGetAttributes failed with CUDA error {-given}")
    return given, need.value


def check_register_split(lib: ctypes.CDLL) -> None:
    """Refuse a library in which a ``"wgmma"`` kernel got fewer registers
    than its ``setmaxnreg`` split hands out: its consumer warpgroups would
    wait for them forever, and every launch would hang."""
    for D in WGMMA_HEAD_DIMS:
        given, need = wgmma_registers(D, lib)
        if given < need:
            raise RuntimeError(
                f"flash_attention: the \"wgmma\" kernel at head_dim {D} got {given} registers a thread, and its "
                f"setmaxnreg split needs {need}: refusing the library"
            )


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES, check=check_register_split)


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
    if any(t.device.type not in ("cuda", "meta") for t in tensors):
        raise ValueError("flash_attention_cuda needs CUDA tensors (or meta tensors, which trace it without running it)")
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
    with torch.no_grad():
        return _flash_attention_op(q, k, v, float(scale), float(softcap), bool(causal), int(window))


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, softcap: float, causal: bool, window: int
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    out = torch.empty_like(q)  # q's layout: dense views keep their strides, others become contiguous
    k, v, ptrs, strides = launch_operands(q, k, v, out)
    Kv, Sk = k.shape[1], k.shape[2]
    route = flash_attention_route(D, q.dtype, ptrs, strides)
    fn = _lib().flash_attention
    with torch.cuda.device(q.device):
        err = fn(
            *ptrs, *strides,
            B, H, Kv, Sq, Sk, D, scale, softcap, int(causal), window,
            _DTYPES[q.dtype], ROUTES.index(route), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch ({route} route) failed with CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[route] += 1
    return out


@_flash_attention_op.register_fake
def _(q, k, v, scale, softcap, causal, window):
    return torch.empty_like(q)


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs one head of attention computes, query rows
    right-aligned to the keys: key ``j`` is visible to the query at
    position ``p`` when ``j <= p`` (causal) and ``j > p - window``
    (``window > 0``)."""
    qpos = np.arange(Sk - Sq, Sk, dtype=np.int64)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1, dtype=np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, scale, softcap, causal, window, *args, **kwargs) -> int:
    B, H, Sq, D = q_shape
    return 4 * D * B * H * visible_pairs(Sq, k_shape[2], causal, window)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def attention_rows(q, k, v, q_pos, k_pos, *, causal: bool, window: int, softcap: float, scale: float):
    """Plain softmax attention of query rows at positions ``q_pos`` over
    keys at ``k_pos``: GQA by repeating K/V; logits, softcap, masks and
    softmax in float32 (float64 for float64 inputs), the weights cast to
    ``v``'s dtype.  The same function as the kernel's, which accumulates
    the logits in fp32 (``ref.flash_attention_ref``, as the reference's
    plain attention, rounds bf16 logits to bf16 first)."""
    G = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(G, dim=1) if G > 1 else k
    vr = v.repeat_interleave(G, dim=1) if G > 1 else v
    acc = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kr.to(acc)) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr)


def attention_backward(q, k, v, dout, *, causal: bool, window: int, softcap: float, scale: float) -> tuple:
    """``(dq, dk, dv)`` of attention at ``dout``: each block of query rows
    recomputed by :func:`attention_rows` and differentiated there, so at
    most ``BACKWARD_LOGITS`` logits are live."""
    B, H, Sq, _ = q.shape
    Sk = k.shape[2]
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    k_pos = torch.arange(Sk, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.promote_types(k.dtype, torch.float32), device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.promote_types(v.dtype, torch.float32), device=v.device)
    L = max(1, min(Sq, BACKWARD_LOGITS // max(B * H * Sk, 1)))
    for i0 in range(0, Sq, L):
        i1 = min(Sq, i0 + L)
        q_pos = torch.arange(i0, i1, device=q.device) + (Sk - Sq)  # rows right-aligned to the keys
        with torch.enable_grad():
            qi = q[:, :, i0:i1].detach().requires_grad_(True)
            ki, vi = k.detach().requires_grad_(True), v.detach().requires_grad_(True)
            out = attention_rows(qi, ki, vi, q_pos, k_pos, **kw)
            gq, gk, gv = torch.autograd.grad(out, (qi, ki, vi), dout[:, :, i0:i1])
        dq[:, :, i0:i1] = gq
        dk += gk
        dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is the kernel when ``kernel``
    (``ops.flash_attention`` on CUDA tensors; it raises on others); the
    backward is :func:`attention_backward`.  ``kernel=False`` exists for
    the CPU gradcheck only (no caller of the model passes it): the forward
    is then :func:`attention_rows` on host tensors, so the backward can be
    checked without the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, bq, bk, kernel):
        kw = dict(causal=bool(causal), window=int(window), softcap=float(softcap),
                  scale=float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])))
        if kernel:
            out = flash_attention_cuda(q, k, v, bq=bq, bk=bk, **kw)
        else:
            check_causal(q.shape[-2], k.shape[-2], causal)
            check_operands(q, k, v)
            check_blocks(q.shape[2], k.shape[2], bq, bk)
            Sq, Sk = q.shape[2], k.shape[2]
            out = attention_rows(q, k, v, torch.arange(Sk - Sq, Sk, device=q.device),
                                 torch.arange(Sk, device=q.device), **kw)
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None
