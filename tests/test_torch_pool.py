"""Port parity: the 3x3/stride-2 max pool against the JAX Pallas kernel.

Max is exact, so the port's plain version must equal the JAX kernel (run
in interpret mode) bit for bit, in fp32 and bf16, including the zero ties
that post-ReLU activations are full of.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.ops.pallas_pool import max_pool_3x3s2 as jax_pool
from mcncrossmodalemotions_torch.ops import pool

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 11, 9, 4), (1, 33, 35, 8),
                                   (2, 69, 37, 8)])
def test_pool_matches_jax_bitwise(shape, dtype, relu):
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    if relu:
        x = np.maximum(x, 0.0)
    ref = np.asarray(jax_pool(jnp.asarray(x, jdt), interpret=True)
                     .astype(jnp.float32))
    got = pool.max_pool_3x3s2(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    assert got.shape == ref.shape == (shape[0], (shape[1] - 3) // 2 + 1,
                                      (shape[2] - 3) // 2 + 1, shape[3])
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_pool_cuda_wrapper_takes_plain_path_on_cpu():
    x = torch.relu(torch.from_numpy(
        np.random.RandomState(0).randn(2, 13, 10, 6).astype(np.float32)))
    before = pool.max_pool_3x3s2_cuda.launches
    got = pool.max_pool_3x3s2_cuda(x)
    assert pool.max_pool_3x3s2_cuda.launches == before
    assert torch.equal(got, pool.max_pool_3x3s2(x))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        pool.max_pool_3x3s2_cuda(x.to("meta"))
