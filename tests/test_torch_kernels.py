"""The port's ``matmul_update`` held against the reference's Pallas kernel.

On the CPU the port's plain version (``kernels/ref.py``, which the wrapper
runs for CPU tensors) meets the reference's ``matmul_update_pallas`` in
interpret mode on the reference's ``MATMUL_SHAPES`` x dtypes and a ragged
case whose blocks clip to the shape, at the reference's tolerances
(``atol * sqrt(K)`` with atol 2e-4 in float32 and 5e-2 in bfloat16,
``rtol 2e-2``).  Inputs are made from a seed with numpy and rounded to
bfloat16 the same way on both sides.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` (which imports no JAX, so it runs on
the machine with the card) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_update import matmul_update_pallas

from repro_torch.kernels import matmul_update
from repro_torch.kernels.matmul_update import matmul_update_cuda
from repro_torch.kernels.ref import matmul_update_ref

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
    # A tensor off the CPU never reaches the plain version: "meta" stands in
    # here for any device without a kernel; the card's case is in
    # test_torch_kernels_cuda.py.
    c = torch.zeros(64, 64, device="meta")
    before = matmul_update_cuda.launches
    with pytest.raises(ValueError, match="takes CPU tensors"):
        matmul_update(c, c, c, impl=impl)
    assert matmul_update_cuda.launches == before
