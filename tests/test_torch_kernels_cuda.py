"""The CUDA ``matmul_update`` against its plain version, on the card.

Marked ``cuda``: each test skips where there is no CUDA device.  This file
imports no JAX and nothing of the reference, so it runs on the machine with
the card:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases: the reference's ``MATMUL_SHAPES`` x float32/bfloat16 plus two ragged
shapes (the default blocks clipped to the shape; and K, N not multiples of
8, the plain-tile path), at the reference's tolerances ``atol * sqrt(K)``
(2e-4 float32, 5e-2 bfloat16), ``rtol 2e-2``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import matmul_update
from repro_torch.kernels.matmul_update import matmul_update_cuda
from repro_torch.kernels.ref import matmul_update_ref

pytestmark = pytest.mark.cuda

MATMUL_DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)]
MATMUL_SHAPES = [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 384, 128, 256, 128),
    (512, 256, 1024, 256, 256, 512),
    (128, 1024, 256, 64, 512, 256),
    (100, 96, 40, 256, 256, 512),
    (72, 90, 36, 256, 256, 512),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", MATMUL_DTYPES)
@pytest.mark.parametrize("M,N,K,bm,bn,bk", MATMUL_SHAPES)
def test_kernel_matches_plain_on_card(card, M, N, K, bm, bn, bk, dtype, atol):
    rng = np.random.default_rng(0)
    c, a, b = (
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)
        for shape in ((M, N), (M, K), (K, N))
    )
    want = matmul_update_ref(c, a, b)
    before = matmul_update_cuda.launches
    got = matmul_update(c, a, b, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert got is c and matmul_update_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol * np.sqrt(K), rtol=2e-2)


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
