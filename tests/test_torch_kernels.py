"""The port's ``matmul_update`` held against the reference's Pallas kernel.

On the CPU the port's plain version (``kernels/ref.py``, which the wrapper
runs for CPU tensors) meets the reference's ``matmul_update_pallas`` in
interpret mode on the reference's ``MATMUL_SHAPES`` x dtypes and a ragged
case whose blocks clip to the shape, at the reference's tolerances
(``atol * sqrt(K)`` with atol 2e-4 in float32 and 5e-2 in bfloat16,
``rtol 2e-2``).  Inputs are made from a seed with numpy and rounded to
bfloat16 the same way on both sides.

``flash_attention_ref`` meets ``flash_attention_pallas`` (interpret mode,
64-row blocks) on the reference's ``FLASH_CASES`` x ``FLASH_DTYPES``
(2e-5 float32, 2e-2 bfloat16) and ``rglru_scan_ref`` meets
``rglru_scan_pallas`` on ``RGLRU_CASES`` at 1e-5; the ``h0`` cases, which
the Pallas kernel cannot take, meet the reference's own ``rglru_scan_ref``
and the reference model's ``_rglru_scan``, and so does ``_log_depth_scan`` here: a
third plain version of the recurrence, the log-depth form of the
reference model's associative scan.

Which route ``matmul_update`` takes on the card (``"wgmma"`` or ``"tile"``)
depends on shape, dtype and pointer alignment alone, so it is tested here:
the DFPA panels and the reference's aligned bf16 cases go ``"wgmma"``,
and so does every panel the DFPA loop can give a processor; float32, N or
K not a multiple of 8 and a misaligned operand go ``"tile"``.
``ops.flash_attention`` refuses causal attention with ``Sq > Sk`` (rows
that see no key) before any dispatch.  The route ``flash_attention`` takes
is decided the same way: aligned bf16 at head_dim 16, 32, 64, 128, 160,
192 or 256 goes ``"wgmma"`` — the model's transposed views at the serving
shape and K/V broadcast over heads (passed as their one-head view, which
the plain version holds to the broadcast operands) among it — and
float32, a misaligned operand, another head_dim (48, 96) or K/V broadcast
over the batch or the sequence ``"rows"``.  At the
decoders' head dims, stablelm-12b's 160 and deepseek-v2's MLA scores at
192 (``v`` zero-padded from 128), ``flash_attention_ref`` meets
``flash_attention_pallas`` in both dtypes too.  The chunked scan's arithmetic (the carry
into each 64-step chunk from the chunk's product and local end state, every
step inside a chunk sequential) is written out here and meets the
reference at its tolerance over a 4096-step sequence; a carry reset at one
chunk boundary fails that check.

The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py`` (which imports no JAX, so it runs on
the machine with the card) and by ``chip_smoke.py``.
"""

import ctypes
import ctypes.util
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.matmul_update import matmul_update_pallas
from repro.kernels.rglru import rglru_scan_pallas
from repro.models.recurrent import _rglru_scan as jax_model_scan

from repro_torch import _build
from repro_torch.kernels import flash_attention, matmul_update, rglru_scan
from repro_torch.kernels.flash_attention import (
    check_register_split, flash_attention_cuda, flash_attention_route, launch_operands,
)
from repro_torch.kernels.matmul_update import matmul_update_cuda, matmul_update_route
from repro_torch.kernels.ref import flash_attention_ref, matmul_update_ref, rglru_scan_ref
from repro_torch.kernels.rglru import rglru_scan_cuda

MATMUL_DTYPES = [("float32", 2e-4), ("bfloat16", 5e-2)]
MATMUL_SHAPES = [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 128, 256, 128),
    (512, 256, 1024, 256, 256, 512),
    (128, 1024, 256, 64, 512, 256),
    (100, 96, 40, 256, 256, 512),  # ragged: the default blocks clip to the shape
]
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(M, N, K, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((M, N), dtype=np.float32),
        rng.standard_normal((M, K), dtype=np.float32),
        rng.standard_normal((K, N), dtype=np.float32),
    )


@pytest.mark.parametrize("dtype,atol", MATMUL_DTYPES)
@pytest.mark.parametrize("M,N,K,bm,bn,bk", MATMUL_SHAPES)
def test_plain_matches_reference_kernel(M, N, K, bm, bn, bk, dtype, atol):
    c, a, b = _inputs(M, N, K)
    want = matmul_update_pallas(
        *(jnp.asarray(v, _JNP[dtype]) for v in (c, a, b)),
        bm=bm, bn=bn, bk=bk, interpret=True,
    )
    ct, at, bt = (torch.from_numpy(v).to(_TORCH[dtype]) for v in (c, a, b))
    plain = matmul_update_ref(ct, at, bt)
    assert torch.equal(ct, torch.from_numpy(c).to(_TORCH[dtype]))  # pure
    got = matmul_update(ct, at, bt, bm=bm, bn=bn, bk=bk)  # CPU tensor: plain version, in place
    assert got is ct and torch.equal(got, plain)
    np.testing.assert_allclose(
        plain.to(torch.float32).numpy(), np.asarray(want, np.float32),
        atol=atol * np.sqrt(K), rtol=2e-2,
    )


def test_indivisible_shape_raises_like_reference():
    a, b, c = np.zeros((100, 128), np.float32), np.zeros((128, 128), np.float32), np.zeros((100, 128), np.float32)
    with pytest.raises(ValueError, match="not divisible") as want:
        matmul_update_pallas(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), bm=64, bn=64, bk=64, interpret=True)
    with pytest.raises(ValueError, match="not divisible") as got:
        matmul_update(torch.from_numpy(c), torch.from_numpy(a), torch.from_numpy(b), bm=64, bn=64, bk=64)
    assert str(got.value) == str(want.value)


def test_cpu_tensors_never_reach_the_kernel():
    c, a, b = (torch.from_numpy(v) for v in _inputs(64, 64, 64))
    before = matmul_update_cuda.launches
    matmul_update(c, a, b)
    matmul_update(c, a, b, impl="ref")
    with pytest.raises(ValueError, match="CUDA tensors"):
        matmul_update(c, a, b, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        matmul_update(c, a, b, impl="pallas")
    assert matmul_update_cuda.launches == before


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_plain_version_takes_cpu_tensors_only(impl):
    # A tensor off the CPU never reaches the plain version.  A "meta" tensor
    # (the dry run's trace) takes the kernel's path under "auto": its custom
    # operator's meta implementation, no launch; "ref" refuses it.  The
    # card's case is in test_torch_kernels_cuda.py.
    c = torch.zeros(64, 64, device="meta")
    before = matmul_update_cuda.launches
    if impl == "auto":
        assert matmul_update(c, c, c, impl=impl) is c
    else:
        with pytest.raises(ValueError, match="takes CPU tensors"):
            matmul_update(c, c, c, impl=impl)
    assert matmul_update_cuda.launches == before


# The route each shape takes on the card, decided by shape, dtype and pointer
# alignment alone (CPU tensors stand in for the card's: torch aligns both).

DFPA_PANELS = [(rows, 16384, 16384) for rows in (32, 992, 2048)]


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


@pytest.mark.parametrize("M,N,K", DFPA_PANELS + [s[:3] for s in MATMUL_SHAPES])
def test_aligned_bf16_takes_the_wgmma_route(M, N, K):
    c, a, b = (torch.zeros(8, 8, dtype=torch.bfloat16) for _ in range(3))
    assert matmul_update_route(M, N, K, torch.bfloat16, _ptrs(c, a, b)) == "wgmma"


@pytest.mark.parametrize("M,N,K,dtype,offset,why", [
    (2048, 16384, 16384, torch.float32, 0, "float32"),
    (72, 90, 36, torch.bfloat16, 0, "N, K not multiples of 8"),
    (64, 96, 36, torch.bfloat16, 0, "K not a multiple of 8"),
    (64, 90, 64, torch.bfloat16, 0, "N not a multiple of 8"),
    (32, 16384, 16384, torch.bfloat16, 1, "A not 16-byte aligned"),
])
def test_what_tma_cannot_take_goes_to_the_tile_route(M, N, K, dtype, offset, why):
    base = torch.zeros(64, dtype=dtype)
    a = base[offset:]  # one element in: 2 or 4 bytes off the allocation's alignment
    ptrs = (base.data_ptr(), a.data_ptr(), base.data_ptr())
    assert (ptrs[1] % 16 == 0) == (offset == 0)
    assert matmul_update_route(M, N, K, dtype, ptrs) == "tile", why


def test_every_dfpa_panel_takes_the_wgmma_route():
    # M = 32 * units rows of a 16384-wide bf16 panel, for every allocation
    # the DFPA loop over 512 units can give one processor.
    c, a, b = (torch.zeros(8, 8, dtype=torch.bfloat16) for _ in range(3))
    for units in range(1, 513):
        assert matmul_update_route(32 * units, 16384, 16384, torch.bfloat16, _ptrs(c, a, b)) == "wgmma", units


def test_cpu_launch_counts_stay_put_on_every_route():
    before = (matmul_update_cuda.launches, dict(matmul_update_cuda.launches_by_route))
    assert set(before[1]) == {"wgmma", "tile"}
    for dtype in (torch.float32, torch.bfloat16):
        c, a, b = (torch.from_numpy(v).to(dtype) for v in _inputs(64, 64, 64))
        matmul_update(c, a, b)
    assert (matmul_update_cuda.launches, matmul_update_cuda.launches_by_route) == before


# ---------------------------------------------------------------------------
# flash attention and the RG-LRU scan (the model stack's kernels)
# ---------------------------------------------------------------------------

FLASH_DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, dict(causal=True)),
    (2, 4, 2, 128, 128, 64, dict(causal=True)),  # GQA
    (2, 4, 1, 128, 128, 32, dict(causal=True)),  # MQA
    (1, 2, 2, 128, 128, 64, dict(causal=True, window=32)),  # sliding window
    (1, 2, 2, 128, 128, 64, dict(causal=True, softcap=30.0)),  # gemma softcap
    (1, 2, 2, 128, 128, 64, dict(causal=False)),  # encoder
    (1, 2, 2, 64, 256, 64, dict(causal=True)),  # right-aligned queries
]
RGLRU_CASES = [
    (1, 128, 128, 64, 128),
    (2, 256, 512, 128, 256),
    (3, 512, 256, 256, 128),
]


def _flash_inputs(B, H, Kv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (
        0.3 * rng.standard_normal((B, H, Sq, D), dtype=np.float32),
        0.3 * rng.standard_normal((B, Kv, Sk, D), dtype=np.float32),
        rng.standard_normal((B, Kv, Sk, D), dtype=np.float32),
    )


def _rglru_inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    log_a = -np.logaddexp(rng.standard_normal((B, S, D), dtype=np.float32), 0.0).astype(np.float32)
    return log_a, 0.1 * rng.standard_normal((B, S, D), dtype=np.float32), rng.standard_normal((B, D), dtype=np.float32)


@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("B,H,Kv,Sq,Sk,D,kwargs", FLASH_CASES)
def test_plain_flash_attention_matches_reference_kernel(B, H, Kv, Sq, Sk, D, kwargs, dtype, tol):
    q, k, v = _flash_inputs(B, H, Kv, Sq, Sk, D)
    want = flash_attention_pallas(
        *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)), bq=64, bk=64, interpret=True, **kwargs
    )
    qt, kt, vt = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    got = flash_attention(qt, kt, vt, bq=64, bk=64, **kwargs)  # CPU tensors: the plain version
    assert got.dtype == _TORCH[dtype] and torch.equal(got, flash_attention_ref(qt, kt, vt, **kwargs))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


# the decoders' head dims on the "wgmma" route: stablelm-12b's 160 (four
# query heads a KV head) and deepseek-v2's MLA scores at 192 (H = Kv, v
# zero-padded from 128 to 192, scale 1/sqrt(192))
DECODER_HEAD_DIM_CASES = [
    (8, 2, 160, 160, dict(causal=True)),
    (4, 4, 192, 128, dict(causal=True, scale=192 ** -0.5)),
]


@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("H,Kv,D,v_dim,kwargs", DECODER_HEAD_DIM_CASES)
def test_plain_flash_attention_matches_reference_kernel_at_decoder_head_dims(H, Kv, D, v_dim, kwargs, dtype, tol):
    q, k, v = _flash_inputs(1, H, Kv, 128, 128, D, seed=D)
    v[..., v_dim:] = 0.0
    want = flash_attention_pallas(
        *(jnp.asarray(x, _JNP[dtype]) for x in (q, k, v)), bq=64, bk=64, interpret=True, **kwargs
    )
    qt, kt, vt = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    got = flash_attention(qt, kt, vt, bq=64, bk=64, **kwargs)  # CPU tensors: the plain version
    assert got.dtype == _TORCH[dtype] and torch.equal(got, flash_attention_ref(qt, kt, vt, **kwargs))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)
    assert not got[..., v_dim:].any()  # zero value columns give zero output columns


@pytest.mark.parametrize("B,S,D,bs,bd", RGLRU_CASES)
def test_plain_rglru_scan_matches_reference_kernel(B, S, D, bs, bd):
    log_a, b, _ = _rglru_inputs(B, S, D)
    want = rglru_scan_pallas(jnp.asarray(log_a), jnp.asarray(b), bs=bs, bd=bd, interpret=True)
    got = rglru_scan(torch.from_numpy(log_a), torch.from_numpy(b), bs=bs, bd=bd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _log_depth_scan(log_a, b, h0):
    """h_t = exp(log_a_t) * h_{t-1} + b_t along axis 1 (fp32), as a
    log-depth scan over (decay, input) pairs: after the step of stride
    ``k``, element ``t`` holds the combination of ``t-2k+1 .. t``."""
    la, bb = log_a, b
    S = la.shape[1]
    k = 1
    while k < S:
        bb = torch.cat([bb[:, :k], torch.exp(la[:, k:]) * bb[:, :-k] + bb[:, k:]], dim=1)
        la = torch.cat([la[:, :k], la[:, :-k] + la[:, k:]], dim=1)
        k *= 2
    return bb + torch.exp(la) * h0[:, None]


@pytest.mark.parametrize("B,S,D", [(2, 256, 128), (3, 77, 40)])
def test_rglru_scan_with_h0_matches_reference_and_model_scan(B, S, D):
    log_a, b, h0 = _rglru_inputs(B, S, D, seed=1)
    args = tuple(jnp.asarray(x) for x in (log_a, b, h0))
    want_ref = np.asarray(jax.jit(jref.rglru_scan_ref)(*args))
    want_model = np.asarray(jax.jit(jax_model_scan)(*args))
    la, bt, h0t = (torch.from_numpy(x) for x in (log_a, b, h0))
    for got in (rglru_scan(la, bt, h0t, bs=None, bd=None), rglru_scan_ref(la, bt, h0t), _log_depth_scan(la, bt, h0t)):
        np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_model, atol=1e-5, rtol=1e-5)


def test_model_kernel_block_rules_raise_like_reference():
    q = np.zeros((1, 1, 96, 16), np.float32)
    with pytest.raises(ValueError, match="not divisible") as want:
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), bq=64, bk=64, interpret=True)
    with pytest.raises(ValueError, match="not divisible") as got:
        flash_attention(*(torch.from_numpy(q),) * 3, bq=64, bk=64)
    assert str(got.value) == str(want.value)
    la = np.zeros((1, 96, 64), np.float32)
    with pytest.raises(ValueError, match="not divisible") as want:
        rglru_scan_pallas(jnp.asarray(la), jnp.asarray(la), bs=64, bd=64, interpret=True)
    with pytest.raises(ValueError, match="not divisible") as got:
        rglru_scan(torch.from_numpy(la), torch.from_numpy(la), bs=64, bd=64)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("impl", ["auto", "ref", "cuda"])
def test_flash_attention_refuses_causal_rows_without_keys(impl):
    # Causal with Sq > Sk leaves the first Sq - Sk query rows no key; the
    # reference has no single answer for them, so the port refuses the shape
    # before any dispatch, whatever the device or impl.
    q, kv = torch.zeros(1, 2, 96, 16), torch.zeros(1, 1, 64, 16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="Sq 96 > Sk 64"):
        flash_attention(q, kv, kv, impl=impl, causal=True, bq=None, bk=None)
    with pytest.raises(ValueError, match="Sq 96 > Sk 64"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"), impl=impl, causal=True)
    assert flash_attention_cuda.launches == before
    if impl != "cuda":  # not causal, or Sq <= Sk: served as before
        assert flash_attention(q, kv, kv, impl=impl, causal=False, bq=None, bk=None).shape == q.shape
        assert flash_attention(kv, q[:, :1], q[:, :1], impl=impl, causal=True, bq=None, bk=None).shape == kv.shape


def test_model_kernels_dispatch_cpu_tensors_to_plain_versions():
    q = torch.full((1, 2, 8, 4), 0.1)
    la = torch.full((1, 8, 4), -1.0)
    before = (flash_attention_cuda.launches, rglru_scan_cuda.launches)
    assert flash_attention(q, q, q, causal=True).shape == (1, 2, 8, 4)
    assert torch.equal(flash_attention(q, q, q, impl="ref"), flash_attention_ref(q, q, q))
    assert torch.equal(rglru_scan(la, torch.ones_like(la), impl="ref"), rglru_scan_ref(la, torch.ones_like(la)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_scan(la, la, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        rglru_scan(la, la, impl="pallas")
    meta = torch.zeros(1, 2, 8, 4, device="meta")
    traced = flash_attention(meta, meta, meta)  # the kernel's meta implementation: no plain version, no launch
    assert traced.device.type == "meta" and traced.shape == meta.shape
    with pytest.raises(ValueError, match="takes CPU tensors"):
        flash_attention(meta, meta, meta, impl="ref")
    with pytest.raises(ValueError, match="takes CPU tensors"):
        rglru_scan(meta[0], meta[0], impl="ref")
    assert (flash_attention_cuda.launches, rglru_scan_cuda.launches) == before


# ---------------------------------------------------------------------------
# routes of the model stack's kernels, and the chunked scan's arithmetic
# ---------------------------------------------------------------------------


def _flash_route(q, k, v, out=None):
    # as the custom op does: K/V broadcast over heads become their one-head
    # view, then the route is chosen from the pointers and strides
    out = q if out is None else out
    _, _, ptrs, strides = launch_operands(q, k, v, out)
    return flash_attention_route(q.shape[-1], q.dtype, ptrs, strides)


def test_serving_shape_takes_the_wgmma_route():
    # the model's call: transposed (B, S, H, D) views, row stride H * D
    q = torch.zeros(4, 64, 10, 256, dtype=torch.bfloat16).transpose(1, 2)
    kv = torch.zeros(4, 64, 1, 256, dtype=torch.bfloat16).transpose(1, 2)
    assert q.stride() == (64 * 10 * 256, 256, 10 * 256, 1)
    assert _flash_route(q, kv, kv, torch.empty_like(q)) == "wgmma"


@pytest.mark.parametrize("D,dtype,offset,route", [
    (64, torch.bfloat16, 0, "wgmma"),
    (128, torch.bfloat16, 0, "wgmma"),
    (256, torch.bfloat16, 0, "wgmma"),
    (160, torch.bfloat16, 0, "wgmma"),  # stablelm-12b
    (192, torch.bfloat16, 0, "wgmma"),  # deepseek-v2's MLA scores
    (32, torch.bfloat16, 0, "wgmma"),  # the reference's MQA case
    (16, torch.bfloat16, 0, "wgmma"),  # the smoke models
    (48, torch.bfloat16, 0, "rows"),
    (96, torch.bfloat16, 0, "rows"),
    (256, torch.float32, 0, "rows"),
    (160, torch.float32, 0, "rows"),
    (256, torch.bfloat16, 1, "rows"),  # q one element off its allocation's 16-byte alignment
    (192, torch.bfloat16, 1, "rows"),
])
def test_flash_attention_route_by_operands(D, dtype, offset, route):
    base = torch.zeros(2 * 8 * D + offset, dtype=dtype)
    q = base[offset:].view(1, 2, 8, D)
    kv = torch.zeros(1, 1, 8, D, dtype=dtype)
    assert _flash_route(q, kv, kv, torch.zeros_like(q)) == route


def test_flash_attention_route_needs_tma_strides():
    q = torch.zeros(1, 2, 8, 256, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 8, 256, dtype=torch.bfloat16)
    broadcast = kv.expand(1, 2, 8, 256)  # a zero head stride: passed as the one-head view
    assert broadcast.stride(1) == 0
    assert _flash_route(q, broadcast, broadcast, q) == "wgmma"
    odd = torch.zeros(1, 8, 2, 257, dtype=torch.bfloat16)[..., :256].transpose(1, 2)  # row stride 514: not 16-byte
    assert _flash_route(odd, kv, kv, q) == "rows"


@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=True, window=7, softcap=20.0), dict(causal=False)])
def test_broadcast_kv_heads_view_computes_the_same_attention(kwargs):
    # K and V broadcast over their heads (a zero head stride) reach the
    # kernel as their [:, :1] views with Kv = 1: the plain version gives the
    # same output on both, and the reference's on the broadcast operands
    rng = np.random.default_rng(5)
    q = torch.tensor(0.3 * rng.standard_normal((2, 8, 40, 64)), dtype=torch.float32)
    k1 = torch.tensor(0.3 * rng.standard_normal((2, 1, 40, 64)), dtype=torch.float32)
    v1 = torch.tensor(rng.standard_normal((2, 1, 40, 64)), dtype=torch.float32)
    k, v = k1.expand(2, 4, 40, 64), v1.expand(2, 4, 40, 64)
    assert k.stride(1) == v.stride(1) == 0
    kv, vv, ptrs, strides = launch_operands(q, k, v, torch.empty_like(q))
    assert kv.shape == vv.shape == (2, 1, 40, 64) and kv.data_ptr() == k.data_ptr()
    assert ptrs[1:3] == [k.data_ptr(), v.data_ptr()] and all(s > 0 for s in strides)
    got = flash_attention(q, kv, vv, impl="ref", bq=None, bk=None, **kwargs)
    assert torch.equal(got, flash_attention(q, k, v, impl="ref", bq=None, bk=None, **kwargs))
    want = jref.flash_attention_ref(*(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_broadcast_kv_heads_take_the_wgmma_route(D):
    q = torch.zeros(1, 8, 16, D, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 16, D, dtype=torch.bfloat16).expand(1, 4, 16, D)
    assert _flash_route(q, kv, kv, torch.empty_like(q)) == "wgmma"


@pytest.mark.parametrize("which", ["batch", "sequence", "k_heads_only", "v_heads_only"])
def test_flash_attention_route_leaves_other_zero_strides_to_rows(which):
    # zero strides the one-head view does not remove: K/V broadcast over
    # the batch or the sequence, or only one of K and V over heads
    q = torch.zeros(2, 4, 16, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 2, 16, 64, dtype=torch.bfloat16)
    one_head = kv[:, :1].expand(2, 2, 16, 64)
    k, v = {
        "batch": (kv[:1].expand(2, 2, 16, 64),) * 2,
        "sequence": (kv[:, :, :1].expand(2, 2, 16, 64),) * 2,
        "k_heads_only": (one_head, kv),
        "v_heads_only": (kv, one_head),
    }[which]
    assert 0 in k.stride()[:3] + v.stride()[:3]
    _, _, _, strides = launch_operands(q, k, v, torch.empty_like(q))
    assert 0 in strides
    assert _flash_route(q, k, v, torch.empty_like(q)) == "rows"


def test_launch_operands_give_size_one_dims_a_dense_stride():
    # a dim of size 1 is never indexed past 0: its stride, whatever the
    # tensor says (0 for a one-head view of a broadcast), is the dense one
    q = torch.zeros(1, 4, 1, 32, dtype=torch.bfloat16)  # B 1, one query row
    kv = torch.zeros(1, 1, 16, 32, dtype=torch.bfloat16).expand(1, 3, 16, 32)[:, :1]
    assert kv.stride(1) == 0
    _, _, _, strides = launch_operands(q, kv, kv, torch.empty_like(q))
    assert strides == [4 * 32, 32, 32] + [16 * 32, 16 * 32, 32] * 2 + [4 * 32, 32, 32]


class _RegisterReport:
    """Stands in for the built library's ``flash_attention_wgmma_registers``:
    ``given`` registers at head_dim ``D``, and the split's need (78 at two
    blocks an SM, 168 at one) written through the pointer."""

    def __init__(self, given):
        self.given = given

    def flash_attention_wgmma_registers(self, D, need):
        need._obj.value = 78 if D <= 32 else 168
        return self.given.get(D, 168 if D > 32 else 80)


def test_register_split_check_passes_what_ptxas_gives_on_the_card():
    # ptxas gives the kernel 80 registers at D 16 / 32 (two blocks an SM)
    # and 168 at the others: every split holds
    check_register_split(_RegisterReport({}))


@pytest.mark.parametrize("D, given, match", [
    (16, 72, "head_dim 16 got 72 registers a thread, and its setmaxnreg split needs 78"),
    (32, 64, "head_dim 32 got 64 registers"),
    (256, 160, "head_dim 256 got 160 registers a thread, and its setmaxnreg split needs 168"),
    (128, -98, "cudaFuncGetAttributes failed with CUDA error 98"),
])
def test_register_split_check_refuses_a_library_that_would_hang(D, given, match):
    # fewer registers than a split hands out: the consumers' setmaxnreg.inc
    # would wait forever, so the library is refused before any launch
    with pytest.raises(RuntimeError, match=match):
        check_register_split(_RegisterReport({D: given}))


def test_flash_library_loads_through_the_register_check(monkeypatch):
    fa_module = importlib.import_module("repro_torch.kernels.flash_attention")
    seen = {}

    def load(name, signatures, check=None):
        seen.update(name=name, entries=set(signatures), check=check)
        return "library"

    monkeypatch.setattr(_build, "load", load)
    assert fa_module._lib() == "library"
    assert seen == {
        "name": "flash_attention", "check": check_register_split,
        "entries": {"flash_attention", "flash_attention_wgmma_smem", "flash_attention_wgmma_registers"},
    }


def test_build_load_keeps_only_a_library_its_check_passed(monkeypatch):
    # a refused library is not kept: the next load checks anew
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.fail("no C library to stand in for a built one")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda names: {n: _build.Built(n, Path(libc), "", 0.0) for n in names})
    calls = []

    def refuse(lib):
        calls.append(lib)
        raise RuntimeError("refused")

    with pytest.raises(RuntimeError, match="refused"):
        _build.load("stand_in", {"strlen": ([ctypes.c_char_p], ctypes.c_size_t)}, check=refuse)
    assert "stand_in" not in _build._libs
    lib = _build.load("stand_in", {"strlen": ([ctypes.c_char_p], ctypes.c_size_t)}, check=calls.append)
    assert len(calls) == 2 and calls[1] is lib and _build._libs["stand_in"] is lib
    assert lib.strlen(b"hopper") == 6
    assert _build.load("stand_in", check=refuse) is lib  # a kept library is not checked again


def test_model_kernels_cpu_launch_counts_stay_put_on_every_route():
    before = (dict(flash_attention_cuda.launches_by_route), rglru_scan_cuda.launches)
    assert set(before[0]) == {"rows", "wgmma"}
    assert not hasattr(rglru_scan_cuda, "launches_by_route")  # the scan has one kernel
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.full((1, 2, 8, 64), 0.1, dtype=dtype)
        flash_attention(q, q[:, :1], q[:, :1], bq=None, bk=None)
    la = torch.full((1, 70, 8), -1.0)
    rglru_scan(la, la, bs=None, bd=None)
    # neither wrapper takes a caller's route any more: the operands choose
    with pytest.raises(TypeError, match="route"):
        rglru_scan_cuda(la, la, route="chunked")
    with pytest.raises(TypeError, match="route"):
        flash_attention_cuda(q, q, q, route="wgmma")
    assert (flash_attention_cuda.launches_by_route, rglru_scan_cuda.launches) == before


CHUNK = 64  # the scan kernel's steps a chunk (csrc/rglru_scan.cu)


def _chunked_scan(log_a, b, h0, reset_at=None):
    """The scan kernel's arithmetic in float32: per chunk the product
    A of its decays and its end state Bl from zero, each step rounded as
    the kernel rounds it; the carry into chunk c is A_{c-1} * carry + Bl_{c-1}
    (h0 into the first), and every step inside a chunk is the sequential
    recurrence from its carry.  ``reset_at`` zeroes the carry into that
    chunk (a planted fault)."""
    a = torch.exp(log_a)
    out = torch.empty_like(b)
    carry = h0.clone()
    for c, t0 in enumerate(range(0, b.shape[1], CHUNK)):
        if c == reset_at:
            carry = torch.zeros_like(carry)
        A, Bl, h = torch.ones_like(carry), torch.zeros_like(carry), carry
        for t in range(t0, min(t0 + CHUNK, b.shape[1])):
            A, Bl = A * a[:, t], a[:, t] * Bl + b[:, t]
            h = a[:, t] * h + b[:, t]
            out[:, t] = h
        carry = A * carry + Bl
    return out


@pytest.mark.parametrize("B,S,D,decay", [(2, 4096, 16, 1.0), (2, 4096, 16, 0.002), (3, 77, 40, 1.0), (1, 50, 8, 1.0)])
def test_chunked_scan_arithmetic_meets_reference(B, S, D, decay):
    # decay 0.002 keeps a near 1, so every carry reaches the far end of its chunk
    log_a, b, h0 = _rglru_inputs(B, S, D, seed=2)
    log_a = (decay * log_a).astype(np.float32)
    want = np.asarray(jax.jit(jref.rglru_scan_ref)(*(jnp.asarray(x) for x in (log_a, b, h0))))
    la, bt, h0t = (torch.from_numpy(x) for x in (log_a, b, h0))
    np.testing.assert_allclose(_chunked_scan(la, bt, h0t).numpy(), want, atol=1e-5, rtol=1e-5)
    chunks = -(-S // CHUNK)
    if chunks > 2:  # the check's power: one carry lost at a chunk boundary fails it
        fault = _chunked_scan(la, bt, h0t, reset_at=chunks // 2).numpy()
        assert not np.allclose(fault, want, atol=1e-5, rtol=1e-5)
