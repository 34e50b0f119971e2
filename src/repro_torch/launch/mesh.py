"""The mesh of one card, and the card's constants.

The port's copy of the reference's ``launch/mesh.py``.  The reference
builds a 16x16 ``("data", "model")`` mesh of TPU v5e chips (2x16x16 with a
leading ``"pod"`` axis for two pods); the port runs on one NVIDIA H100, so
its production mesh is ``(1, 1)`` over ``("data", "model")``: every logical
axis maps to a mesh axis of size 1, and every sharding is the whole tensor
on the card.  The sharding rules (``repro_torch.sharding``) read only a
mesh's ``axis_names`` and ``devices.shape``, so they run unchanged on any
:class:`Mesh` descriptor, a larger one included.

Defined as functions, so that importing this module touches no device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HW", "Mesh", "make_mesh", "make_production_mesh"]


class HW:
    """NVIDIA H100 SXM (80 GB HBM3) constants used by the roofline terms.

    The published dense peaks (bf16 tensor cores, fp32 without TF32) and
    memory rate; ``HBM_BYTES`` is what ``torch.cuda.get_device_properties(0)
    .total_memory`` gives on the card (``chip_smoke.py`` checks the pin).
    One card has no collectives, so there is no interconnect term."""

    PEAK_FLOPS_BF16 = 989e12
    PEAK_FLOPS_FP32 = 67e12
    HBM_BW = 3.35e12  # bytes/s
    HBM_BYTES = 85_017_493_504

    @classmethod
    def peak_flops(cls, dtype) -> float:
        """The peak for operands of ``dtype``: the tensor cores' for 16-bit
        floats, the fp32 peak for everything else."""
        return cls.PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16) else cls.PEAK_FLOPS_FP32


@dataclass(frozen=True)
class Mesh:
    """A mesh descriptor: ``axis_names``, a ``devices`` array of the mesh's
    shape (device indices), and the torch device the mesh lives on."""

    axis_names: Tuple[str, ...]
    devices: Any  # np.ndarray of device indices, shape = the mesh shape
    device: torch.device

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda") -> Mesh:
    """A mesh of ``prod(shape)`` devices of ``device``'s type; raises when
    fewer are present (``"cpu"`` and ``"meta"`` count one)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    dev = torch.device(device)
    if dev.type == "cuda":
        present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    elif dev.type in ("cpu", "meta"):
        present = 1
    else:
        raise ValueError(f"no mesh over {dev.type} devices")
    n = int(np.prod(shape))
    if n > present:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} {dev.type} devices; {present} present")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    first = dev.index or 0
    return Mesh(axes, np.arange(first, first + n).reshape(shape), dev)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The one-card mesh ``(1, 1)`` over ``("data", "model")``.
    ``multi_pod=True`` (the reference's 2x16x16 mesh over two pods) has no
    counterpart on one card."""
    if multi_pod:
        raise NotImplementedError(
            "multi_pod=True is the reference's 2x16x16 mesh of 512 TPU chips over two pods; the port "
            "runs on one card, where the pod axis, the 16x16 slice and its collectives are dropped"
        )
    return make_mesh((1, 1), ("data", "model"), device=device)
