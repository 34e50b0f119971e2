"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases and tolerances are the reference's (``tests/test_kernels.py``):

* ``matmul_update``: ``MATMUL_SHAPES`` x float32/bfloat16 plus two ragged
  shapes (the default blocks clipped to the shape; and K, N not multiples
  of 8, the "tile" route) and two larger ones on the "wgmma" route,
  ``atol * sqrt(K)`` (2e-4 float32, 5e-2 bfloat16), ``rtol 2e-2``; the
  three DFPA panels on the "wgmma" route, two launches bit-identical, and
  at 2048 rows a plain version that drops the last 64-deep K slice must
  fail the same check;
* ``flash_attention``: ``FLASH_CASES`` x float32 (2e-5) / bfloat16 (2e-2),
  plus a window whose first key tile is fully masked for some rows, ragged
  lengths no block divides, a head_dim the tensor-core path does not take,
  and strided (transposed) operands; causal with ``Sq > Sk`` refused;
* ``flash_attention`` on the ``"wgmma"`` route at head_dim 256: ten query
  heads over one KV head, an odd group count, lengths no 128-row or 64-key
  tile divides, a window no tile divides, softcap, the model's transposed
  views; each launched twice (bit-identical) and counted by route; bf16
  head_dim 32 and head_dim 256 over broadcast K/V (a zero head stride,
  passed as the one-head view) on ``"wgmma"``, and the ``"rows"`` route
  (float32 at head_dim 256 and 160, bf16 head_dim 96), each reached
  through operands that select it;
* the ``"wgmma"`` kernel's ``setmaxnreg`` split at every head dim: the
  registers ptxas gave it are those the split hands out;
* ``flash_attention`` at head_dim 16 and 32 on the ``"wgmma"`` route: the
  reference's ``FLASH_CASES`` at each of the two, and the model twins'
  captured shapes (the smoke stablelm-12b served, the smoke granite-20b
  trained, MQA), from the model's views, in bfloat16 at 2e-2, two launches
  bit-identical;
* ``flash_attention`` at the decoders' head dims on the ``"wgmma"`` route:
  160 (stablelm-12b, four query heads a KV head) and 192 (deepseek-v2's
  MLA scores, H = Kv, ``v`` zero-padded from 128 to 192 and the output's
  first 128 features kept, as the model calls it), from the model's
  ``(B, S, H, D)`` views at a length no tile divides, with and without a
  window and softcap, two launches bit-identical and the padded output
  columns zero; the same head dims in float32 on ``"rows"``;
* ``rglru_scan``: ``RGLRU_CASES`` at 1e-5, plus an ``h0`` case and a
  ragged one; S not a multiple of the 64-step chunk and S below it, B·D
  not a multiple of the 128-channel tile, and S = 4096 at a narrow D with
  ``h0``, each launched twice (bit-identical); S = 4096 with decays near 1
  (log_a scaled by 0.002), where every chunk's carry reaches the far end
  of the chunk, and a carry lost at a mid-sequence chunk boundary fails
  the same check;
* the gradients of the two ``autograd.Function`` s (``FlashAttention``,
  ``RGLRUScan``) through ``ops`` on CUDA tensors against autograd through
  the plain versions: flash ``dq``/``dk``/``dv`` at ``GRAD_FLASH_CASES``
  against the plain version on float32 copies (the kernel and the
  backward take the logits in fp32), rel 1e-4 in float32 and 2e-2 in
  bfloat16 (of the largest magnitude),
  one kernel launch (the forward) a call; the scan's ``dlog_a``/``db``/
  ``dh0`` rel 1e-4, two launches a call (the forward and the reversed
  recurrence);
* ``flash_attention`` at the encoder-decoder's and the vision prefix's
  operands (``SLICE_CASES``): non-causal bf16 head_dim 64 with ``Sq !=
  Sk`` both ways and a key length no 64-key tile divides (seamless's
  cross-attention), and causal head_dim 128, 32 query heads over 8 KV
  heads, at 256 prefix + 1,024 text positions (pixtral), on ``"wgmma"``
  against the plain version on float32 copies at 2e-2; and
  ``FlashAttention``'s gradients at ``Sq != Sk`` (non-causal), rel 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, matmul_update, rglru_scan
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS, flash_attention_cuda, wgmma_registers
from repro_torch.kernels.matmul_update import matmul_update_cuda, matmul_update_route
from repro_torch.kernels.ref import flash_attention_ref, matmul_update_ref, rglru_scan_ref
from repro_torch.kernels.rglru import chunk_steps, rglru_scan_cuda

pytestmark = pytest.mark.cuda

MATMUL_DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)]
MATMUL_SHAPES = [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 128, 256, 128),
    (512, 256, 1024, 256, 256, 512),
    (128, 1024, 256, 64, 512, 256),
    (100, 96, 40, 256, 256, 512),
    (72, 90, 36, 256, 256, 512),
    (1024, 4096, 256, 1024, 4096, 256),  # "wgmma" route, 512 blocks
    (1000, 4000, 200, 1000, 4000, 200),  # "wgmma" route, ragged M, N and K
]
DFPA_PANELS = [(rows, 16384, 16384) for rows in (32, 992, 2048)]
FLASH_DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
FLASH_CASES = [  # (B, H, Kv, Sq, Sk, D, kwargs, blocks)
    (1, 2, 2, 128, 128, 64, dict(causal=True), 64),
    (2, 4, 2, 128, 128, 64, dict(causal=True), 64),  # GQA
    (2, 4, 1, 128, 128, 32, dict(causal=True), 64),  # MQA
    (1, 2, 2, 128, 128, 64, dict(causal=True, window=32), 64),  # sliding window
    (1, 2, 2, 128, 128, 64, dict(causal=True, softcap=30.0), 64),  # gemma softcap
    (1, 2, 2, 128, 128, 64, dict(causal=False), 64),  # encoder
    (1, 2, 2, 64, 256, 64, dict(causal=True), 64),  # right-aligned queries
    # beyond the reference's cases: the window's first key tile fully
    # masked for most rows of a query tile; ragged lengths; D=256 (the
    # model's); D=48 (the plain-row path in bf16); MQA over ten heads
    (1, 2, 1, 256, 256, 64, dict(causal=True, window=40), None),
    (2, 3, 1, 97, 161, 64, dict(causal=True, window=50), None),
    (1, 10, 1, 130, 130, 256, dict(causal=True, window=70, scale=0.0625), None),
    (1, 2, 1, 77, 77, 48, dict(causal=True, softcap=20.0), None),
]
# the "wgmma" route at the model's head_dim: (B, H, Kv, Sq, Sk, kwargs, views)
WGMMA_CASES = [
    (2, 10, 1, 256, 256, dict(causal=True), False),  # MQA over ten heads
    (2, 3, 1, 200, 200, dict(causal=True), False),  # an odd group count
    (1, 4, 2, 97, 161, dict(causal=True), False),  # lengths no tile divides, right-aligned, GQA
    (1, 10, 1, 333, 333, dict(causal=True, window=100, scale=0.0625), False),  # a window no tile divides
    (1, 2, 1, 190, 190, dict(causal=True, softcap=30.0), False),  # softcap
    (2, 10, 1, 300, 300, dict(causal=True, window=90), True),  # the model's (B, S, H, D) views
    (1, 2, 2, 130, 130, dict(causal=False), False),  # encoder
]
RGLRU_CASES = [  # (B, S, D, bs, bd)
    (1, 128, 128, 64, 128),
    (2, 256, 512, 128, 256),
    (3, 512, 256, 256, 128),
    (2, 77, 130, None, None),  # ragged, no block rule
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("dtype,atol", MATMUL_DTYPES)
@pytest.mark.parametrize("M,N,K,bm,bn,bk", MATMUL_SHAPES)
def test_kernel_matches_plain_on_card(card, M, N, K, bm, bn, bk, dtype, atol):
    rng = np.random.default_rng(0)
    c, a, b = (_randn(rng, shape).to(card, dtype) for shape in ((M, N), (M, K), (K, N)))
    want = matmul_update_ref(c, a, b)
    before = matmul_update_cuda.launches
    got = matmul_update(c, a, b, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert got is c and matmul_update_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol * np.sqrt(K), rtol=2e-2)


def _within(got, want, K):
    err = (got.float() - want.float()).abs()
    return bool((err <= 5e-2 * np.sqrt(K) + 2e-2 * want.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("M,N,K", DFPA_PANELS)
def test_dfpa_panels_take_wgmma_and_repeat_bit_identically(card, M, N, K):
    g = torch.Generator(device=card).manual_seed(M)
    c, a, b = (torch.randn(s, generator=g, device=card).to(torch.bfloat16) for s in ((M, N), (M, K), (K, N)))
    want = matmul_update_ref(c, a, b)
    fault = matmul_update_ref(c, a[:, : K - 64], b[: K - 64]) if M == 2048 else None
    again = c.clone()
    before = dict(matmul_update_cuda.launches_by_route)
    matmul_update(c, a, b, bm=32, bn=256, bk=512)
    matmul_update(again, a, b, bm=32, bn=256, bk=512)
    torch.cuda.synchronize()
    assert matmul_update_route(M, N, K, torch.bfloat16, (c.data_ptr(), a.data_ptr(), b.data_ptr())) == "wgmma"
    assert matmul_update_cuda.launches_by_route["wgmma"] == before["wgmma"] + 2
    assert matmul_update_cuda.launches_by_route["tile"] == before["tile"]
    assert torch.equal(c, again)
    assert _within(c, want, K)[0]
    if fault is not None:  # the check's power: a lost 64-deep pipeline stage fails it
        assert not _within(c, fault, K)[0]


def test_kernel_refuses_what_it_does_not_take(card):
    c = torch.zeros(64, 64, device=card)
    with pytest.raises(ValueError, match="takes CPU tensors"):
        matmul_update(c, c, c, impl="ref")
    with pytest.raises(TypeError):
        matmul_update(c, c.double(), c)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_update(c, c.t(), c)
    with pytest.raises(ValueError, match="not divisible"):
        matmul_update(torch.zeros(100, 64, device=card), torch.zeros(100, 64, device=card), c, bm=64)


@pytest.mark.parametrize("dtype,tol", FLASH_DTYPES)
@pytest.mark.parametrize("B,H,Kv,Sq,Sk,D,kwargs,blocks", FLASH_CASES)
def test_flash_attention_matches_plain_on_card(card, B, H, Kv, Sq, Sk, D, kwargs, blocks, dtype, tol):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, H, Sq, D), 0.3).to(card, dtype)
    k = _randn(rng, (B, Kv, Sk, D), 0.3).to(card, dtype)
    v = _randn(rng, (B, Kv, Sk, D)).to(card, dtype)
    want = flash_attention_ref(q, k, v, **kwargs)
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, bq=blocks, bk=blocks, **kwargs)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_reads_strided_operands(card):
    # the model's call: (B, S, H, D) tensors as transposed (B, H, S, D) views
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 100, 4, 64
    q = _randn(rng, (B, S, H, D), 0.3).to(card, torch.bfloat16)
    k = _randn(rng, (B, S, 1, D), 0.3).to(card, torch.bfloat16)
    v = _randn(rng, (B, S, 1, D)).to(card, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = flash_attention(qt, kt, vt, causal=True, window=30, bq=None, bk=None)
    want = flash_attention_ref(qt.contiguous(), kt.contiguous(), vt.contiguous(), causal=True, window=30)
    torch.cuda.synchronize()
    assert got.stride() == qt.stride()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,bs,bd", RGLRU_CASES)
def test_rglru_scan_matches_plain_on_card(card, B, S, D, bs, bd, with_h0):
    rng = np.random.default_rng(0)
    log_a = -torch.nn.functional.softplus(_randn(rng, (B, S, D))).to(card)
    b = (0.1 * _randn(rng, (B, S, D))).to(card)
    h0 = _randn(rng, (B, D)).to(card) if with_h0 else None
    want = rglru_scan_ref(log_a, b, h0)
    before = rglru_scan_cuda.launches
    got = rglru_scan(log_a, b, h0, bs=bs, bd=bd)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,kwargs,views", WGMMA_CASES)
def test_flash_attention_wgmma_route_at_head_dim_256(card, B, H, Kv, Sq, Sk, kwargs, views):
    rng = np.random.default_rng(2)
    D = 256
    q = _randn(rng, (B, Sq, H, D), 0.3).to(card, torch.bfloat16)
    k = _randn(rng, (B, Sk, Kv, D), 0.3).to(card, torch.bfloat16)
    v = _randn(rng, (B, Sk, Kv, D)).to(card, torch.bfloat16)
    q, k, v = (x.transpose(1, 2) if views else x.transpose(1, 2).contiguous() for x in (q, k, v))
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kwargs)
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, bq=None, bk=None, **kwargs)
    again = flash_attention(q, k, v, bq=None, bk=None, **kwargs)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    assert routes == {"rows": 0, "wgmma": 2}
    assert torch.equal(got, again)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


# head_dim 16 and 32 on "wgmma": the reference's cases at each, then the
# model twins' captured shapes (B, H, Kv, Sq, Sk, D, kwargs, blocks)
SMALL_HEAD_DIM_CASES = [(B, H, Kv, Sq, Sk, D, kw, blocks)
                        for D in (16, 32) for B, H, Kv, Sq, Sk, _, kw, blocks in FLASH_CASES[:7]] + [
    (2, 4, 2, 16, 16, 16, dict(causal=True), None),  # the smoke stablelm-12b served
    (2, 4, 1, 32, 32, 16, dict(causal=True), None),  # the smoke granite-20b trained, MQA
]


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,D,kwargs,blocks", SMALL_HEAD_DIM_CASES)
def test_flash_attention_wgmma_route_at_head_dims_16_and_32(card, B, H, Kv, Sq, Sk, D, kwargs, blocks):
    rng = np.random.default_rng(D)
    q = _randn(rng, (B, Sq, H, D), 0.3).to(card, torch.bfloat16)
    k = _randn(rng, (B, Sk, Kv, D), 0.3).to(card, torch.bfloat16)
    v = _randn(rng, (B, Sk, Kv, D)).to(card, torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))  # the model's views
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kwargs)
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, bq=blocks, bk=blocks, **kwargs)
    again = flash_attention(q, k, v, bq=blocks, bk=blocks, **kwargs)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    assert routes == {"rows": 0, "wgmma": 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("D", WGMMA_HEAD_DIMS)
def test_flash_attention_wgmma_register_split_holds_on_card(card, D):
    # ptxas gave each "wgmma" kernel the registers its setmaxnreg split
    # hands out (the library would not have loaded otherwise): 78 of the
    # 80 that two blocks an SM allow (D 16, 32), all 168 of one
    given, need = wgmma_registers(D)
    assert need == (78 if D <= 32 else 168) and given >= need


@pytest.mark.parametrize("D,dtype,broadcast,route", [
    (32, torch.bfloat16, False, "wgmma"),  # the reference's MQA head_dim
    (256, torch.bfloat16, True, "wgmma"),  # K/V broadcast over heads: passed as the one-head view
    (96, torch.bfloat16, False, "rows"),  # a head_dim the tensor-core route does not take
    (256, torch.float32, False, "rows"),
    (160, torch.float32, False, "rows"),
])
def test_flash_attention_named_routes_on_card(card, D, dtype, broadcast, route):
    # each route reached through operands that select it
    rng = np.random.default_rng(3)
    q = _randn(rng, (1, 10, 150, D), 0.3).to(card, dtype)
    kv = _randn(rng, (1, 1, 150, D), 0.3).to(card, dtype)
    if broadcast:
        kv = kv.expand(1, 2, 150, D)
        assert kv.stride(1) == 0
    kw = dict(causal=True, window=70)
    want = flash_attention_ref(q, kv.contiguous(), kv.contiguous(), **kw)
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, kv, kv, bq=None, bk=None, **kw)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()} == {
        r: int(r == route) for r in before
    }
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


DECODER_HEAD_DIM_CASES = [  # (H, Kv, D, v_dim, kwargs)
    (8, 2, 160, 160, dict(causal=True)),  # stablelm-12b: GQA 4, partial rotary's head_dim
    (8, 2, 160, 160, dict(causal=True, window=100, softcap=30.0)),
    (4, 4, 192, 128, dict(causal=True, scale=192 ** -0.5)),  # deepseek-v2 MLA: v padded to 192
    (4, 4, 192, 192, dict(causal=True, window=70, softcap=20.0)),
]


def _decoder_head_dim_operands(card, dtype, H, Kv, D, v_dim):
    """q, k, v as the model passes them: transposed views of ``(B, S, H, D)``
    tensors, S = 300 (no 128-row or 64-key tile divides it), ``v`` zero
    past ``v_dim``."""
    rng = np.random.default_rng(D + v_dim)
    B, S = 2, 300
    q = _randn(rng, (B, S, H, D), 0.3).to(card, dtype)
    k = _randn(rng, (B, S, Kv, D), 0.3).to(card, dtype)
    v = torch.nn.functional.pad(_randn(rng, (B, S, Kv, v_dim)), (0, D - v_dim)).to(card, dtype)
    return tuple(x.transpose(1, 2) for x in (q, k, v))


def _run_twice_by_route(q, k, v, kwargs):
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, bq=None, bk=None, **kwargs)
    again = flash_attention(q, k, v, bq=None, bk=None, **kwargs)
    torch.cuda.synchronize()
    return got, again, {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}


@pytest.mark.parametrize("H,Kv,D,v_dim,kwargs", DECODER_HEAD_DIM_CASES)
def test_flash_attention_wgmma_route_at_decoder_head_dims(card, H, Kv, D, v_dim, kwargs):
    q, k, v = _decoder_head_dim_operands(card, torch.bfloat16, H, Kv, D, v_dim)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kwargs)
    got, again, routes = _run_twice_by_route(q, k, v, kwargs)
    assert routes == {"rows": 0, "wgmma": 2}
    assert torch.equal(got, again)
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert not got[..., v_dim:].any()  # zero value columns give zero output columns


@pytest.mark.parametrize("H,Kv,D,v_dim,kwargs", DECODER_HEAD_DIM_CASES[::2])
def test_flash_attention_rows_route_at_decoder_head_dims(card, H, Kv, D, v_dim, kwargs):
    # float32 at the decoders' head dims stays on the catch-all route
    q, k, v = _decoder_head_dim_operands(card, torch.float32, H, Kv, D, v_dim)
    want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), **kwargs)
    got, again, routes = _run_twice_by_route(q, k, v, kwargs)
    assert routes == {"rows": 2, "wgmma": 0}
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert not got[..., v_dim:].any()


@pytest.mark.parametrize("B,S,D", [
    (2, 100, 256),  # S not a multiple of the chunk
    (3, 50, 200),  # S below one chunk
    (3, 130, 300),  # B * D not a multiple of the tile
    (2, 4096, 64),  # a long sequence at a narrow D
])
def test_rglru_scan_chunked_route_on_card(card, B, S, D):
    rng = np.random.default_rng(S + D)
    log_a = -torch.nn.functional.softplus(_randn(rng, (B, S, D))).to(card)
    b = (0.1 * _randn(rng, (B, S, D))).to(card)
    h0 = _randn(rng, (B, D)).to(card)
    want = rglru_scan_ref(log_a, b, h0)
    before = rglru_scan_cuda.launches
    got = rglru_scan(log_a, b, h0, bs=None, bd=None)
    again = rglru_scan(log_a, b, h0, bs=None, bd=None)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,D", [(2, 4096, 256), (1, 4096, 2560)])
def test_rglru_scan_carries_decays_near_one_on_card(card, B, S, D):
    # log_a scaled by 0.002 keeps a near 1: each chunk's carry reaches the far
    # end of the chunk, so the kernel's reassociated carry is what is checked
    rng = np.random.default_rng(S + D + 1)
    log_a = (-0.002 * torch.nn.functional.softplus(_randn(rng, (B, S, D)))).to(card)
    b = (0.1 * _randn(rng, (B, S, D))).to(card)
    h0 = _randn(rng, (B, D)).to(card)
    want = rglru_scan_ref(log_a, b, h0)
    before = rglru_scan_cuda.launches
    got = rglru_scan(log_a, b, h0, bs=None, bd=None)
    again = rglru_scan(log_a, b, h0, bs=None, bd=None)
    torch.cuda.synchronize()
    assert rglru_scan_cuda.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    t = chunk_steps() * (S // chunk_steps() // 2)  # the check's power: a carry lost mid-sequence fails it
    fault = torch.cat([want[:, :t], rglru_scan_ref(log_a[:, t:], b[:, t:], None)], dim=1)
    assert not torch.allclose(got, fault, atol=1e-5, rtol=1e-5)


def test_flash_attention_refuses_causal_rows_without_keys_on_card(card):
    q = torch.zeros(1, 2, 96, 64, device=card, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 64, 64, device=card, dtype=torch.bfloat16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="Sq 96 > Sk 64"):
        flash_attention(q, kv, kv, causal=True, bq=None, bk=None)
    assert flash_attention_cuda.launches == before


def test_model_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(1, 2, 64, 64, device=card, dtype=torch.bfloat16)
    la = torch.zeros(1, 64, 64, device=card)
    with pytest.raises(ValueError, match="takes CPU tensors"):
        flash_attention(q, q, q, impl="ref")
    with pytest.raises(ValueError, match="takes CPU tensors"):
        rglru_scan(la, la, impl="ref")
    before = (flash_attention_cuda.launches, rglru_scan_cuda.launches)
    with pytest.raises(TypeError):
        flash_attention(q, q.float(), q)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention(q, q, q, bq=48)
    with pytest.raises(TypeError):
        rglru_scan(la, la.double())
    with pytest.raises(ValueError, match="not divisible"):
        rglru_scan(la, la, bs=48)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(la.transpose(1, 2), la)
    assert (flash_attention_cuda.launches, rglru_scan_cuda.launches) == before


GRAD_FLASH_CASES = [  # (B, H, Kv, S, D, kwargs, dtype, tol)
    (2, 8, 4, 256, 256, dict(causal=True, softcap=50.0, window=100, scale=0.0625), torch.bfloat16, 2e-2),
    (2, 10, 1, 300, 256, dict(causal=True, window=90), torch.bfloat16, 2e-2),
    (1, 4, 2, 97, 64, dict(causal=True), torch.float32, 1e-4),
    (1, 2, 2, 130, 128, dict(causal=False), torch.bfloat16, 2e-2),
]


def _grad_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("B,H,Kv,S,D,kwargs,dtype,tol", GRAD_FLASH_CASES)
def test_flash_attention_gradients_on_card(card, B, H, Kv, S, D, kwargs, dtype, tol):
    rng = np.random.default_rng(7)
    # the model's (B, S, H, D) tensors, passed as transposed views
    q, k, v = (_randn(rng, (B, S, n, D)).to(card, dtype).transpose(1, 2).requires_grad_(True) for n in (H, Kv, Kv))
    dout = _randn(rng, (B, H, S, D)).to(card, dtype)
    before = flash_attention_cuda.launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, bq=None, bk=None, **kwargs), (q, k, v), dout)
    assert flash_attention_cuda.launches - before == 1  # the forward; the backward is plain torch
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_ref(q32, k32, v32, **kwargs), (q32, k32, v32), dout.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert _grad_rel(g, w) <= tol, name


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D", [(2, 300, 160), (4, 1024, 256)])
def test_rglru_scan_gradients_on_card(card, B, S, D, with_h0):
    rng = np.random.default_rng(8)
    la = (-_randn(rng, (B, S, D)).abs() * 0.05).to(card).requires_grad_(True)
    b = _randn(rng, (B, S, D)).to(card).requires_grad_(True)
    h0 = _randn(rng, (B, D)).to(card).requires_grad_(True) if with_h0 else None
    dh = _randn(rng, (B, S, D)).to(card)
    inputs = (la, b) + ((h0,) if with_h0 else ())
    before = rglru_scan_cuda.launches
    got = torch.autograd.grad(rglru_scan(la, b, h0, bs=None, bd=None), inputs, dh)
    assert rglru_scan_cuda.launches - before == 2  # the forward and the reversed recurrence
    want = torch.autograd.grad(rglru_scan_ref(la, b, h0), inputs, dh)
    for name, g, w in zip(("dlog_a", "db", "dh0"), got, want):
        assert _grad_rel(g, w) <= 1e-4, name


SLICE_CASES = [  # (B, H, Kv, Sq, Sk, D, kwargs): seamless's cross and encoder attention, pixtral's prefix + text
    (2, 16, 16, 130, 1000, 64, dict(causal=False)),
    (2, 16, 16, 1000, 130, 64, dict(causal=False)),
    (1, 32, 8, 1280, 1280, 128, dict(causal=True)),
]


@pytest.mark.parametrize("B,H,Kv,Sq,Sk,D,kwargs", SLICE_CASES)
def test_flash_attention_at_the_encdec_and_prefix_operands_on_card(card, B, H, Kv, Sq, Sk, D, kwargs):
    rng = np.random.default_rng(9)
    # the model's (B, S, H, D) tensors, passed as transposed views
    q = _randn(rng, (B, Sq, H, D), 0.3).to(card, torch.bfloat16).transpose(1, 2)
    k = _randn(rng, (B, Sk, Kv, D), 0.3).to(card, torch.bfloat16).transpose(1, 2)
    v = _randn(rng, (B, Sk, Kv, D)).to(card, torch.bfloat16).transpose(1, 2)
    before = dict(flash_attention_cuda.launches_by_route)
    got = flash_attention(q, k, v, bq=None, bk=None, **kwargs)
    again = flash_attention(q, k, v, bq=None, bk=None, **kwargs)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in flash_attention_cuda.launches_by_route.items()}
    assert routes == {"rows": 0, "wgmma": 2}
    assert torch.equal(got, again)
    want = flash_attention_ref(q.float(), k.float(), v.float(), **kwargs)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("Sq,Sk", [(130, 1000), (1000, 130)])
def test_flash_attention_gradients_at_unequal_lengths_on_card(card, Sq, Sk):
    rng = np.random.default_rng(10)
    B, H, D = 2, 4, 64
    q = _randn(rng, (B, Sq, H, D)).to(card, torch.bfloat16).transpose(1, 2).requires_grad_(True)
    k, v = (_randn(rng, (B, Sk, H, D)).to(card, torch.bfloat16).transpose(1, 2).requires_grad_(True) for _ in range(2))
    dout = _randn(rng, (B, H, Sq, D)).to(card, torch.bfloat16)
    before = flash_attention_cuda.launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False, bq=None, bk=None), (q, k, v), dout)
    assert flash_attention_cuda.launches - before == 1
    q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_ref(q32, k32, v32, causal=False), (q32, k32, v32), dout.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert _grad_rel(g, w) <= 2e-2, name
