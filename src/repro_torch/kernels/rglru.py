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

Routes: ``"chunked"`` (the default: blocks own 64-step chunks of 128
channels and pass the state between chunks in order, reading the inputs
once; it needs scratch, which the wrapper allocates) and ``"serial"`` (one
thread walks all of S for one channel: the first port's kernel, kept so a
run can time both).  ``route=`` names one; nothing falls back from one to
the other.

``rglru_scan_cuda.launches`` counts the kernel's launches and
``rglru_scan_cuda.launches_by_route`` the same launches by route; the
wrapper increments both where it launches the kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["ROUTES", "check_blocks", "chunk_steps", "rglru_scan_cuda"]

ROUTES = ("chunked", "serial")


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
    """Steps of one chunk of the ``"chunked"`` route (from the built
    library; the card's machine only)."""
    return _lib().rglru_scan_chunk_steps()


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # log_a, b, h0, out, flags, state
        + [ctypes.c_longlong] * 2  # flags and state lengths
        + [ctypes.c_int] * 4  # B, S, D, route
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    for name in ("rglru_scan_chunk_steps", "rglru_scan_tile_channels"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def rglru_scan_cuda(
    log_a: torch.Tensor,
    b: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    bs: Optional[int] = 256,
    bd: Optional[int] = 512,
    route: str = "chunked",
) -> torch.Tensor:
    """The recurrence on the card, launched on the current stream without
    synchronising; returns a new ``(B, S, D)`` float32 tensor.  Raises on
    anything the kernel does not take, and when the launch is refused."""
    if route not in ROUTES:
        raise ValueError(f"unknown rglru_scan route {route!r}; routes are {ROUTES}")
    tensors = (log_a, b) + ((h0,) if h0 is not None else ())
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("rglru_scan_cuda needs CUDA tensors")
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
    lib = _lib()
    out = torch.empty_like(log_a)
    flags = state = None
    if route == "chunked":
        blocks = B * -(-D // lib.rglru_scan_tile_channels()) * -(-S // lib.rglru_scan_chunk_steps())
        flags = torch.zeros(1 + blocks, dtype=torch.int32, device=log_a.device)  # ticket, then one flag a block
        state = torch.empty(blocks * lib.rglru_scan_tile_channels(), dtype=torch.float32, device=log_a.device)
    with torch.cuda.device(log_a.device):
        err = lib.rglru_scan(
            log_a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None, out.data_ptr(),
            flags.data_ptr() if flags is not None else None, state.data_ptr() if state is not None else None,
            flags.numel() if flags is not None else 0, state.numel() if state is not None else 0,
            B, S, D, ROUTES.index(route), torch.cuda.current_stream(log_a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rglru_scan launch ({route} route) failed with CUDA error {err}")
    rglru_scan_cuda.launches += 1
    rglru_scan_cuda.launches_by_route[route] += 1
    return out


rglru_scan_cuda.launches = 0
rglru_scan_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
