"""The plain reference for rows of ``C = A B`` as the emulated processors
leave them: plain PyTorch in float32 with TF32 off.

A processor that runs its panel ``r`` times zeroes its rows and adds the
product ``r`` times, each sum rounded to bf16 (``matmul_update``'s contract:
``C += A B`` accumulated in float32, stored in C's dtype).  ``Product``
works out the float32 product of a fixed pool of rows once, then any
sample of them for any ``r``.  ``precision="fp8"`` is the control: A and B
rounded to float8 e4m3 (a scale per tensor) before the product.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

BLOCK_ROWS = 64


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor, back in
    float32."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(torch.float8_e4m3fn).max
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Product:
    """``A[pool] @ B`` in float32 (TF32 off), computed in blocks of rows."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, pool: Sequence[int], precision: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.pool = np.asarray(pool)
        bf = b.to(torch.float32)
        if precision == "fp8":
            bf = _fp8(bf)
        idx = torch.as_tensor(self.pool, device=a.device)
        blocks = []
        for lo in range(0, len(idx), BLOCK_ROWS):
            af = a.index_select(0, idx[lo:lo + BLOCK_ROWS]).to(torch.float32)
            if precision == "fp8":
                af = _fp8(af)
            blocks.append(af @ bf)
        self.p = torch.cat(blocks)
        del bf

    def rows(self, rows: Sequence[int], repeats: Sequence[int]) -> torch.Tensor:
        """The rows as a processor with ``repeats[j]`` leaves row ``rows[j]``:
        zero, then ``r`` times ``c = bf16(c + p)``."""
        p = self.p[torch.as_tensor(np.searchsorted(self.pool, rows), device=self.p.device)]
        reps = torch.as_tensor(list(repeats), device=p.device)[:, None]
        c = torch.zeros_like(p)
        for j in range(int(reps.max())):
            c = torch.where(reps > j, (c + p).to(torch.bfloat16).to(torch.float32), c)
        return c

    def error(self, rows: Sequence[int], repeats: Sequence[int], got: torch.Tensor) -> float:
        """``|got - want| / |want|`` (root mean squares) over the sampled rows."""
        want = self.rows(rows, repeats)
        diff = got.to(torch.float32) - want
        return float(diff.square().mean().sqrt() / want.square().mean().sqrt().clamp_min(1e-30))
