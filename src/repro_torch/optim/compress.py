"""Gradient compression for the inter-group all-reduce.

The port's copy of the reference's ``optim/compress.py``.  Groups in the
DFPA training runtime synchronize gradients over the slow cross-group
fabric once per global step; compression cuts those bytes:

  * ``compress_bf16`` — 2x: cast fp32 grads to bf16 for the wire;
  * ``compress_int8_ef`` — 4x: per-tensor absmax int8 quantization with
    ERROR FEEDBACK: the quantization residual is carried into the next
    step's gradient, making the compression unbiased over time.

Trees are nested dicts and tuples of tensors (``nn.params.tree_map``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..nn.params import tree_map, tree_map_n

__all__ = ["compress_bf16", "compress_int8_ef", "decompress_int8"]


def compress_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def compress_int8_ef(grads, error: Any) -> Tuple[Any, Any, Any]:
    """Returns (q_int8_tree, scales_tree, new_error_tree).

    ``error`` is the carried residual tree (zeros at step 0).
    """

    def one(g, e):
        gf = g.to(torch.float32) + e
        scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        new_e = gf - q.to(torch.float32) * scale
        return q, scale, new_e

    return tree_map_n(one, 3, grads, error)


def decompress_int8(q_tree, scales_tree):
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scales_tree)
