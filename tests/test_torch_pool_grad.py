"""Port parity: the gradient of the 3x3/stride-2 max pool against JAX.

Two port paths, on the CPU: the K2 autograd Function
(``max_pool_3x3s2_train``, whose with-index forward and backward run
their plain versions for CPU tensors) and the plain backward (autograd of
``F.max_pool2d``). The JAX references: ``jax.vjp`` through the Pallas
kernel (interpret mode; its backward is XLA's SelectAndScatterAdd with the
``ge`` select) and through ``flax.linen.max_pool``. All inputs are finite:
for NaN the port keeps PyTorch's rule (a NaN wins), which XLA's ``ge``
does not share.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_tpu.ops.pallas_pool import max_pool_3x3s2 as pallas_pool
from mcncrossmodalemotions_tpu.ops.pallas_pool import reference_pool_grad
from mcncrossmodalemotions_torch.ops import pool

SHAPES = [(2, 13, 11, 5), (2, 12, 10, 5), (1, 14, 9, 3)]  # odd, even, mixed H/W
JAX_POOLS = {
    "pallas": lambda a: pallas_pool(a, True),
    "flax": lambda a: nn.max_pool(a, (3, 3), strides=(2, 2), padding="VALID"),
}


def _port_grad(path: str, x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    if path == "plain":
        return pool.max_pool_3x3s2_backward(x, dy)
    xg = x.detach().requires_grad_(True)
    (dx,) = torch.autograd.grad(pool.max_pool_3x3s2_train(xg), xg, dy)
    return dx


def _jax_grad(which: str, x: np.ndarray, dy: np.ndarray, dtype) -> np.ndarray:
    _, vjp = jax.vjp(JAX_POOLS[which], jnp.asarray(x, dtype))
    return np.asarray(vjp(jnp.asarray(dy, dtype))[0].astype(jnp.float32))


def _inputs(shape, relu: bool):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    if relu:
        x = np.maximum(x, 0.0)  # many zero ties, as after the student's ReLU
    ho, wo = (shape[1] - 3) // 2 + 1, (shape[2] - 3) // 2 + 1
    dy = rng.uniform(0.5, 1.5, (shape[0], ho, wo, shape[3])).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("path", ["kernel-function", "plain"])
@pytest.mark.parametrize("which", sorted(JAX_POOLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_matches_jax_fp32(shape, which, path):
    """Continuous input: fp32 within rtol 1e-6 (summation order only)."""
    x, dy = _inputs(shape, relu=False)
    dy = dy * np.where(np.random.RandomState(1).rand(*dy.shape) < 0.5, -1, 1)
    ref = _jax_grad(which, x, dy, jnp.float32)
    got = _port_grad(path, torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("path", ["kernel-function", "plain"])
@pytest.mark.parametrize("which", sorted(JAX_POOLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_winner_mask_identical_to_xla_under_ties(shape, which, path):
    """Post-ReLU input (zero ties), dy > 0 everywhere: the set of inputs
    that receive gradient is exactly XLA's one-winner set, and so are the
    summed values (rtol 1e-6)."""
    x, dy = _inputs(shape, relu=True)
    assert (x == 0).mean() > 0.3
    ref = _jax_grad(which, x, dy, jnp.float32)
    got = _port_grad(path, torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("path", ["kernel-function", "plain"])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_bf16_within_one_ulp(shape, path):
    """bf16: JAX sums overlapping windows in bf16, the port in fp32 and
    rounds once, so they may differ by one bf16 ulp (2**-7 relative)."""
    x, dy = _inputs(shape, relu=True)
    ref = _jax_grad("pallas", x, dy, jnp.bfloat16)
    got = _port_grad(path, torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(dy).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


@pytest.mark.parametrize("path", ["kernel-function", "plain"])
@pytest.mark.parametrize("shape", SHAPES)
def test_grad_matches_numpy_oracle_without_ties(shape, path):
    x, dy = _inputs(shape, relu=False)
    ref = reference_pool_grad(x.astype(np.float64), dy.astype(np.float64))
    got = _port_grad(path, torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_with_index_forward_matches_forward(dtype):
    """The with-index forward's output equals the index-free forward's, and
    its index names each window's first maximum in row-major order."""
    x, _ = _inputs((2, 13, 11, 5), relu=True)
    xt = torch.from_numpy(x).to(dtype)
    y, idx = pool.max_pool_3x3s2_idx_cuda(xt)  # CPU: the plain version
    assert idx.dtype == torch.uint8 and idx.shape == y.shape
    assert torch.equal(y, pool.max_pool_3x3s2(xt))
    win = np.lib.stride_tricks.sliding_window_view(
        xt.float().numpy(), (3, 3), axis=(1, 2))[:, ::2, ::2]  # [B,Ho,Wo,C,3,3]
    first = win.reshape(*win.shape[:4], 9).argmax(-1)  # numpy: first max
    np.testing.assert_array_equal(idx.numpy(), first)


def test_backward_wrapper_takes_plain_path_on_cpu():
    x, dy = _inputs((1, 9, 7, 4), relu=True)
    before = (pool.max_pool_3x3s2_idx_cuda.launches,
              pool.max_pool_3x3s2_bwd_cuda.launches)
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(pool.max_pool_3x3s2_train(xt), xt,
                                torch.from_numpy(dy))
    assert (pool.max_pool_3x3s2_idx_cuda.launches,
            pool.max_pool_3x3s2_bwd_cuda.launches) == before
    assert torch.equal(dx, pool.max_pool_3x3s2_backward(xt, torch.from_numpy(dy)))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent path
        pool.max_pool_3x3s2_bwd_cuda(torch.from_numpy(dy).to("meta"),
                                     torch.zeros(1, 4, 3, 4, dtype=torch.uint8),
                                     9, 7)
