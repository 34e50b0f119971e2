"""The RG-LRU linear recurrence on Hopper.

Wraps ``csrc/rglru_scan.cu`` (built and loaded by ``repro_torch._build``)
and replaces the reference's ``rglru_scan_pallas``
(``src/repro/kernels/rglru.py:48``): ``h_t = exp(log_a_t) * h_{t-1} + b_t``
along the sequence, ``(B, S, D)`` float32.  Unlike the Pallas kernel, which
fixes ``h_0 = 0``, it takes the optional initial state ``h0 (B, D)`` that
the model's cache carries (``ref.rglru_scan_ref`` takes it too).

Blocks: ``bs``/``bd`` keep the reference's rule for callers that pass them
— clipped to the shape, and a shape they do not divide raises
``ValueError``; ``None`` skips it (the model's call, any length).

The kernel: blocks own 64-step chunks of 128 channels and pass the state
between chunks in order, reading the inputs once; it needs scratch, which
the wrapper allocates.

``rglru_scan_cuda.launches`` counts the kernel's launches; the wrapper
increments it where it launches the kernel and nowhere else.

The launch is the custom operator ``repro_torch::rglru_scan``, so that a
trace on fake tensors (``launch.dryrun``) sees it: its fake implementation
returns an empty ``(B, S, D)`` float32 tensor (not the few kilobytes of
scratch), and it has no FLOP formula, being bound by its bytes.  The
library is loaded and the count bumped inside the real implementation
only.

Gradients: :class:`RGLRUScan` is the ``autograd.Function`` that
``ops.rglru_scan`` applies to CUDA tensors.  Its forward is the kernel.
Its backward is the same linear recurrence run in reverse,
``g_t = dh_t + a_{t+1} g_{t+1}`` (``a = exp(log_a)``), which it runs
through the same kernel on flipped inputs with the decays shifted by one
step (:func:`reverse_scan`); then ``db_t = g_t``,
``dlog_a_t = g_t a_t h_{t-1}`` and ``dh0 = a_0 g_0`` are elementwise torch.
So a backward launches the kernel once more.  (The reference
differentiates its ``associative_scan``; the Pallas kernel has no
backward.)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import ref

__all__ = ["RGLRUScan", "check_blocks", "chunk_steps", "reverse_scan", "rglru_scan_cuda"]


def check_blocks(S: int, D: int, bs: Optional[int] = 256, bd: Optional[int] = 512) -> None:
    """The reference's block rule (when blocks are given): clipped to the
    shape; a shape they do not divide raises ``ValueError``."""
    if bs is None and bd is None:
        return
    bs = min(bs if bs is not None else S, S)
    bd = min(bd if bd is not None else D, D)
    if S % bs or D % bd:
        raise ValueError(f"(S={S}, D={D}) not divisible by blocks ({bs},{bd})")


def check_operands(log_a, b, h0):
    """``log_a``/``b (B, S, D)`` and ``h0 (B, D)`` or None; returns
    ``(B, S, D)``."""
    if log_a.dim() != 3 or tuple(b.shape) != tuple(log_a.shape):
        raise ValueError(f"log_a{tuple(log_a.shape)} and b{tuple(b.shape)} must share one (B, S, D) shape")
    B, S, D = log_a.shape
    if h0 is not None and tuple(h0.shape) != (B, D):
        raise ValueError(f"h0{tuple(h0.shape)} must be (B, D) = {(B, D)}")
    return B, S, D


def chunk_steps() -> int:
    """Steps of one chunk (from the built library; the card's machine
    only)."""
    return _lib().rglru_scan_chunk_steps()


_SIGNATURES = {  # the C entries' (argtypes, restype), set once when the library loads
    "rglru_scan": (
        [ctypes.c_void_p] * 6  # log_a, b, h0, out, flags, state
        + [ctypes.c_longlong] * 2  # flags and state lengths
        + [ctypes.c_int] * 3  # B, S, D
        + [ctypes.c_void_p],  # stream
        ctypes.c_int,
    ),
    "rglru_scan_chunk_steps": ([], ctypes.c_int),
    "rglru_scan_tile_channels": ([], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("rglru_scan", _SIGNATURES)


def rglru_scan_cuda(
    log_a: torch.Tensor,
    b: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    bs: Optional[int] = 256,
    bd: Optional[int] = 512,
) -> torch.Tensor:
    """The recurrence on the card, launched on the current stream without
    synchronising; returns a new ``(B, S, D)`` float32 tensor.  Raises on
    anything the kernel does not take, and when the launch is refused."""
    tensors = (log_a, b) + ((h0,) if h0 is not None else ())
    if any(t.device.type not in ("cuda", "meta") for t in tensors):
        raise ValueError("rglru_scan_cuda needs CUDA tensors (or meta tensors, which trace it without running it)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("log_a, b and h0 must lie on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("log_a, b and h0 must be float32")
    B, S, D = check_operands(log_a, b, h0)
    check_blocks(S, D, bs, bd)
    if min(B, S, D) < 1:
        raise ValueError(f"empty shape {(B, S, D)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("log_a, b and h0 must be contiguous")
    if B * S * D >= 2**62 or max(B * D, S) >= 2**31:
        raise ValueError("dimensions too large")
    with torch.no_grad():
        return _rglru_scan_op(log_a, b, h0)


rglru_scan_cuda.launches = 0


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan_op(log_a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    B, S, D = log_a.shape
    lib = _lib()
    out = torch.empty_like(log_a)
    blocks = B * -(-D // lib.rglru_scan_tile_channels()) * -(-S // lib.rglru_scan_chunk_steps())
    flags = torch.zeros(1 + blocks, dtype=torch.int32, device=log_a.device)  # ticket, then one flag a block
    state = torch.empty(blocks * lib.rglru_scan_tile_channels(), dtype=torch.float32, device=log_a.device)
    with torch.cuda.device(log_a.device):
        err = lib.rglru_scan(
            log_a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None, out.data_ptr(),
            flags.data_ptr(), state.data_ptr(), flags.numel(), state.numel(),
            B, S, D, torch.cuda.current_stream(log_a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed with CUDA error {err}")
    rglru_scan_cuda.launches += 1
    return out


@_rglru_scan_op.register_fake
def _(log_a, b, h0):
    return torch.empty_like(log_a)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def reverse_scan(log_a: torch.Tensor, x: torch.Tensor, kernel: bool) -> torch.Tensor:
    """``g_t = x_t + exp(log_a_{t+1}) g_{t+1}`` from ``g_{S-1} = x_{S-1}``:
    the forward recurrence on the flipped sequence with the decays shifted
    by one step — the kernel when ``kernel``, else ``ref.rglru_scan_ref``
    (host tensors: the CPU gradcheck's path only)."""
    shifted = torch.cat([log_a[:, 1:], torch.zeros_like(log_a[:, :1])], dim=1)
    la, xr = shifted.flip(1).contiguous(), x.flip(1).contiguous()
    if kernel:
        g = rglru_scan_cuda(la, xr, None, bs=None, bd=None)
    else:
        g = ref.rglru_scan_ref(la, xr)
    return g.flip(1)


class RGLRUScan(torch.autograd.Function):
    """The recurrence with a gradient: with ``kernel`` (``ops.rglru_scan``
    on CUDA tensors; it raises on others) the forward and the backward's
    reversed recurrence are the kernel; the rest of the backward is
    elementwise torch.  ``kernel=False`` exists for the CPU gradcheck only
    (no caller of the model passes it): the recurrence is then
    ``ref.rglru_scan_ref`` on host tensors, so the backward's formulas can
    be checked without the card."""

    @staticmethod
    def forward(ctx, log_a, b, h0, bs, bd, kernel):
        if kernel:
            h = rglru_scan_cuda(log_a, b, h0, bs=bs, bd=bd)
        else:
            _, S, D = check_operands(log_a, b, h0)
            check_blocks(S, D, bs, bd)
            h = ref.rglru_scan_ref(log_a, b, h0)
        ctx.save_for_backward(log_a, h, h0)
        ctx.kernel = kernel
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh):
        log_a, h, h0 = ctx.saved_tensors
        g = reverse_scan(log_a, dh.to(h.dtype), ctx.kernel)
        a = torch.exp(log_a)
        first = h0 if h0 is not None else torch.zeros_like(h[:, 0])
        h_prev = torch.cat([first[:, None], h[:, :-1]], dim=1)
        dlog_a = g * a * h_prev if ctx.needs_input_grad[0] else None
        dh0 = a[:, 0] * g[:, 0] if h0 is not None and ctx.needs_input_grad[2] else None
        return dlog_a, g, dh0, None, None, None
