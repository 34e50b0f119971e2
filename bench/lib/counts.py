"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
that each measured piece of work needs, computed from its shapes.

Peaks are NVIDIA's published dense rates for one H100 SXM (80 GB HBM3) at
its full 700 W: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.
A card set below 700 W runs slower; the run prints its power limit.  Bytes
count each input read once and each output written once.
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card needs: operations over the peak, or bytes over
    the memory rate, whichever is larger."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


# -- the paper's kernel: C += A @ B on a panel of rows --------------------------


def matmul_update_flops(rows: int, n: int, k: int) -> float:
    return 2.0 * rows * n * k


def matmul_update_bytes(rows: int, n: int, k: int) -> float:
    """A's panel and B read once, the panel of C read once and written once."""
    return BF16_BYTES * (rows * k + k * n + 2 * rows * n)


def matmul_update_bound_s(rows: int, n: int, k: int) -> float:
    return bound_s(matmul_update_flops(rows, n, k), matmul_update_bytes(rows, n, k))


# -- causal self-attention ----------------------------------------------------


def causal_pairs(s: int) -> int:
    """(query, key) pairs that causal attention over ``s`` positions computes."""
    return s * (s + 1) // 2


def attention_flops(batch: int, heads: int, s: int, head_dim: int) -> float:
    """Q K^T and P V: 2 multiply-adds of ``head_dim`` a visible pair."""
    return 4.0 * head_dim * causal_pairs(s) * batch * heads


def attention_bytes(batch: int, heads: int, kv_heads: int, s: int, head_dim: int) -> float:
    """q and o of every head, k and v of every key/value head, in bf16."""
    return BF16_BYTES * (2 * batch * heads * s * head_dim + 2 * batch * kv_heads * s * head_dim)


def attention_bound_s(batch: int, heads: int, kv_heads: int, s: int, head_dim: int) -> float:
    return bound_s(attention_flops(batch, heads, s, head_dim), attention_bytes(batch, heads, kv_heads, s, head_dim))


# -- a dense decoder's prefill --------------------------------------------------


def dense_layer_linear_flops(tokens: int, d: int, heads: int, kv_heads: int, head_dim: int, d_ff: int) -> float:
    """The projections (q, k, v, o) and a gated MLP (gate, up, down) of one
    layer over ``tokens`` positions."""
    proj = d * head_dim * (2 * heads + 2 * kv_heads)
    mlp = 3 * d * d_ff
    return 2.0 * tokens * (proj + mlp)


def dense_prefill_flops(batch: int, s: int, *, layers: int, d: int, heads: int, kv_heads: int, head_dim: int,
                        d_ff: int, vocab: int) -> float:
    """One prefill of ``batch`` prompts of ``s`` tokens: every layer's linear
    work and causal attention, and the head on the last position only."""
    per_layer = dense_layer_linear_flops(batch * s, d, heads, kv_heads, head_dim, d_ff)
    per_layer += attention_flops(batch, heads, s, head_dim)
    return layers * per_layer + 2.0 * batch * d * vocab
