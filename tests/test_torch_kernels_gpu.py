"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device (decided inside the
fixture, never at import). The file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: tests/conftest.py imports jax.)
"""

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.ops import pool, spectrogram_kernel
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC, spectrogram

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("frames,dtype", [(400, torch.float32),
                                          (150, torch.float32),
                                          (65, torch.int16),
                                          (1, torch.uint8)])
def test_spectrogram_kernel_matches_plain(cuda, frames, dtype):
    """Full tiles, a ragged last tile, one frame; all three feed formats."""
    gen = torch.Generator().manual_seed(frames)
    x = torch.randn(3, DEFAULT_SPEC.crop_samples(frames), generator=gen) * 0.2
    if dtype == torch.int16:
        x = (x * 32767).round().clamp(-32768, 32767).to(torch.int16)
    elif dtype == torch.uint8:
        x = ((x.clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8)
    x = x.to(cuda)
    before = spectrogram_kernel.spectrogram_cuda.launches
    got = spectrogram_kernel.spectrogram_cuda(x)
    torch.cuda.synchronize()
    assert spectrogram_kernel.spectrogram_cuda.launches == before + 1
    ref = spectrogram(x)
    assert got.shape == ref.shape == (3, 512, frames)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 11, 9, 4), (1, 33, 35, 8),
                                   (2, 69, 37, 96), (1, 3, 3, 1)])
def test_pool_kernel_bitwise_equal(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.relu(torch.randn(*shape, generator=gen)).to(dtype).to(cuda)
    x[0, 1, 1, 0] = float("nan")  # NaN wins its windows in both
    got = pool.max_pool_3x3s2_cuda(x)
    ref = pool.max_pool_3x3s2(x).contiguous()
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 11, 9, 4), (1, 33, 35, 8),
                                   (2, 69, 37, 96), (1, 3, 3, 1), (2, 4, 6, 3)])
def test_pool_with_index_matches_forward(cuda, shape, dtype):
    """Bitwise the index-free forward's output, and the plain version's
    index (finite post-ReLU input, zero ties)."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.relu(torch.randn(*shape, generator=gen)).to(dtype).to(cuda)
    y, idx = pool.max_pool_3x3s2_idx_cuda(x)
    ref_y, ref_idx = pool.max_pool_3x3s2_with_index(x.cpu())
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(pool.max_pool_3x3s2_cuda(x)))
    assert torch.equal(idx.cpu(), ref_idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 11, 9, 4), (1, 33, 35, 8),
                                   (2, 69, 37, 96), (1, 3, 3, 1), (2, 4, 6, 3)])
def test_pool_backward_kernel_matches_plain(cuda, shape, dtype):
    """dx through the K2 autograd Function (with-index forward + backward
    kernel) is bitwise autograd of F.max_pool2d: the same winners, fp32
    sums in the same window order, one rounding."""
    gen = torch.Generator().manual_seed(sum(shape) + 1)
    x = torch.relu(torch.randn(*shape, generator=gen)).to(dtype).to(cuda)
    xg = x.clone().requires_grad_(True)
    y = pool.max_pool_3x3s2_train(xg)
    dy = torch.randn(y.shape, generator=gen).to(dtype).to(cuda)
    before = pool.max_pool_3x3s2_bwd_cuda.launches
    (dx,) = torch.autograd.grad(y, xg, dy)
    torch.cuda.synchronize()
    assert pool.max_pool_3x3s2_bwd_cuda.launches == before + 1
    ref = pool.max_pool_3x3s2_backward(x, dy)
    assert dx.dtype == dtype and dx.shape == x.shape
    assert torch.equal(_bits(dx), _bits(ref.contiguous()))


def test_kernel_wrappers_refuse_what_they_cannot_take(cuda):
    x = torch.zeros(2, 9, 9, 4, device=cuda)
    with pytest.raises(ValueError):
        pool.max_pool_3x3s2_cuda(x.permute(0, 2, 1, 3))  # not contiguous
    with pytest.raises(TypeError):
        pool.max_pool_3x3s2_cuda(x.half())
    with pytest.raises(ValueError):
        pool.max_pool_3x3s2_cuda(x[:, :2])
    dy = torch.zeros(2, 4, 4, 4, device=cuda)
    idx = torch.zeros(2, 4, 4, 4, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # dy is not the pool output of 9x8
        pool.max_pool_3x3s2_bwd_cuda(dy, idx, 9, 8)
    with pytest.raises(ValueError):  # index of the wrong dtype
        pool.max_pool_3x3s2_bwd_cuda(dy, idx.long(), 9, 9)
    with pytest.raises(ValueError):  # index on the CPU
        pool.max_pool_3x3s2_bwd_cuda(dy, idx.cpu(), 9, 9)
    with pytest.raises(TypeError):
        pool.max_pool_3x3s2_bwd_cuda(dy.half(), idx, 9, 9)
    with pytest.raises(ValueError):
        spectrogram_kernel.spectrogram_cuda(torch.zeros(2, 399, device=cuda))
    with pytest.raises(TypeError):
        spectrogram_kernel.spectrogram_cuda(torch.zeros(2, 800, device=cuda,
                                                        dtype=torch.float64))
