"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device (decided inside the
fixture, never at import). The file imports no jax, so it also runs on a
machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest``: tests/conftest.py imports jax.)
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.ops import (
    epilogue,
    pool,
    probes,
    spectrogram_kernel,
)
from mcncrossmodalemotions_torch.ops.spectrogram import (
    DEFAULT_SPEC,
    SpecConfig,
    spectrogram,
)
from mcncrossmodalemotions_torch.tools import probe_mosaic, probe_mosaic2

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


@pytest.mark.parametrize("batch", [3, 42])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("frames", [1, 31, 32, 33, 400, 1100])
def test_spectrogram_kernel_at_tile_edges(cuda, frames, dtype, batch):
    """The FFT kernel's tile of 16 frames: one frame, two tiles but one,
    two tiles, one frame past them, the train crop and the longest bucket;
    both feeds the kernel reads as they are."""
    gen = torch.Generator().manual_seed(frames + batch)
    x = torch.randn(batch, DEFAULT_SPEC.crop_samples(frames), generator=gen) * 0.2
    if dtype == torch.int16:
        x = (x * 32767).round().clamp(-32768, 32767).to(torch.int16)
    x = x.to(cuda)
    got = spectrogram_kernel.spectrogram_cuda(x)
    ref = spectrogram(x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (batch, 512, frames)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("cfg", [SpecConfig(hop_ms=20.0),
                                 SpecConfig(window_ms=32.0)])
def test_spectrogram_kernel_with_a_longer_span(cuda, cfg):
    """A longer hop or window: the tile's span outgrows the loads the
    kernel issues in one go and takes its second loop."""
    gen = torch.Generator().manual_seed(cfg.hop_length + cfg.win_length)
    x = torch.randn(3, cfg.win_length + 39 * cfg.hop_length, generator=gen)
    got = spectrogram_kernel.spectrogram_cuda(x.to(cuda), cfg)
    ref = spectrogram(x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (3, 512, 40)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_spectrogram_int16_feed_is_read_without_a_float_copy(cuda):
    """The int16 rows go to the kernel as they are: the call allocates the
    output and nothing the size of a float32 copy of the waveform."""
    x = torch.randint(-8000, 8000, (42, DEFAULT_SPEC.crop_samples(1100)),
                      dtype=torch.int16, device=cuda)
    spectrogram_kernel.spectrogram_cuda(x)  # tables on the device, library built
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = spectrogram_kernel.spectrogram_cuda.launches
    out = spectrogram_kernel.spectrogram_cuda(x)
    torch.cuda.synchronize()
    assert spectrogram_kernel.spectrogram_cuda.launches == before + 1
    grown = torch.cuda.max_memory_allocated() - base
    assert out.numel() * 4 <= grown < out.numel() * 4 + x.numel() * 4


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


def _placed(t, offset, device):
    """A copy of t on the device, `offset` elements into a flat buffer."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _backward_matches_autograd(x, dy, offsets=(0, 0, 0)):
    """dx of the backward kernel from the with-index forward's idx, with
    dy, idx and dx placed `offsets` elements off their buffers' bases,
    bitwise autograd of F.max_pool2d on the card."""
    bsz, h, w, c = x.shape
    _, idx = pool.max_pool_3x3s2_idx_cuda(x)
    dy = _placed(dy, offsets[0], x.device)
    idx = _placed(idx, offsets[1], x.device)
    dx = _placed(torch.full(x.shape, 7.0, dtype=x.dtype), offsets[2], x.device)
    before = pool.max_pool_3x3s2_bwd_cuda.launches
    if offsets[2]:  # the wrapper allocates an aligned dx: call the library
        pool._run(f"max_pool_3x3s2_bwd_{pool._SUFFIX[x.dtype]}", dy,
                  (dy.data_ptr(), idx.data_ptr(), dx.data_ptr(), bsz, h, w, c))
    else:
        dx = pool.max_pool_3x3s2_bwd_cuda(dy, idx, h, w)
        assert pool.max_pool_3x3s2_bwd_cuda.launches == before + 1
    ref = pool.max_pool_3x3s2_backward(x, dy).contiguous()
    torch.cuda.synchronize()
    assert torch.equal(_bits(dx), _bits(ref))


@pytest.mark.parametrize("kind", ["relu", "ints"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 18, 20, 16), (2, 254, 198, 96)])
def test_pool_backward_at_even_sizes(cuda, shape, dtype, kind):
    """Even H and W at 16-byte vectors: the last input column lies in no
    window (the tail lane writes it), the last row in none either."""
    x = _pool_input(kind, shape, dtype, shape[1]).to(cuda)
    ho, wo = (shape[1] - 3) // 2 + 1, (shape[2] - 3) // 2 + 1
    gen = torch.Generator().manual_seed(shape[2])
    dy = torch.randn(shape[0], ho, wo, shape[3], generator=gen).to(dtype)
    _backward_matches_autograd(x, dy.to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [17, 18, 19, 20])
def test_pool_backward_at_strip_boundaries(cuda, h, dtype):
    """Strips of 4 output rows: ho = 8 ends on a whole strip, ho = 9 one
    row past it; each strip but the first seeds its carry from the row
    above it."""
    x = _pool_input("ints", (2, h, 22, 16), dtype, h).to(cuda)
    gen = torch.Generator().manual_seed(h + 1)
    dy = torch.randn(2, (h - 3) // 2 + 1, 10, 16, generator=gen).to(dtype)
    _backward_matches_autograd(x, dy.to(cuda))


@pytest.mark.parametrize("dtype,shape,offsets", [
    (torch.bfloat16, (2, 17, 19, 12), (0, 0, 0)),  # 24 bytes a pixel
    (torch.float32, (2, 17, 19, 6), (0, 0, 0)),    # 24 bytes a pixel
    (torch.bfloat16, (2, 9, 11, 8), (1, 0, 0)),    # dy 2 bytes off
    (torch.bfloat16, (2, 9, 11, 8), (0, 4, 0)),    # idx 4 bytes off its 8
    (torch.bfloat16, (2, 9, 11, 8), (0, 0, 4)),    # dx 8 bytes off
    (torch.float32, (2, 9, 11, 4), (2, 0, 0)),     # dy 8 bytes off
    (torch.float32, (2, 9, 11, 4), (0, 1, 0)),     # idx 1 byte off its 4
    (torch.float32, (2, 9, 11, 4), (0, 0, 1))])    # dx 4 bytes off
def test_pool_backward_narrow_paths(cuda, dtype, shape, offsets):
    """One element a lane: C x the element size not a multiple of 16
    bytes, or dy, idx or dx off its alignment (a view into a flat buffer)."""
    x = _pool_input("ints", shape, dtype, sum(shape)).to(cuda)
    gen = torch.Generator().manual_seed(sum(offsets))
    dy = torch.randn(shape[0], (shape[1] - 3) // 2 + 1,
                     (shape[2] - 3) // 2 + 1, shape[3], generator=gen).to(dtype)
    _backward_matches_autograd(x, dy.to(cuda), offsets)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_backward_special_values_in_dy(cuda, dtype):
    """NaN, +-inf and -0.0 in dy, routed to winners that one, two or four
    windows share (tie-heavy x): NaN and inf sums, inf - inf, and -0.0
    that a sum from +0 makes +0."""
    x = _pool_input("ints", (2, 21, 24, 16), dtype, 5).to(cuda)
    gen = torch.Generator().manual_seed(6)
    dy = torch.randn(2, 10, 11, 16, generator=gen)
    pick = torch.rand(dy.shape, generator=gen)
    dy[pick < 0.05] = float("nan")
    dy[(pick >= 0.05) & (pick < 0.12)] = float("inf")
    dy[(pick >= 0.12) & (pick < 0.19)] = -float("inf")
    dy[(pick >= 0.19) & (pick < 0.4)] = -0.0
    dy[..., 0] = -0.0  # a whole channel of -0.0
    _backward_matches_autograd(x, dy.to(dtype).to(cuda))


def _pool_matches_plain(x):
    """Both forwards against the plain version on the card: y bitwise (the
    index-free one too), idx exactly."""
    y, idx = pool.max_pool_3x3s2_idx_cuda(x)
    y_free = pool.max_pool_3x3s2_cuda(x)
    ref_y, ref_idx = pool.max_pool_3x3s2_with_index(x)
    torch.cuda.synchronize()
    assert y.shape == ref_y.shape and idx.dtype == torch.uint8
    assert torch.equal(_bits(y), _bits(ref_y.contiguous()))
    assert torch.equal(_bits(y_free), _bits(y))
    assert torch.equal(idx, ref_idx.contiguous())


def _pool_input(kind, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    if kind == "ints":  # ties everywhere
        return torch.randint(0, 3, shape, generator=gen).to(dtype)
    return torch.relu(torch.randn(*shape, generator=gen)).to(dtype)


@pytest.mark.parametrize("kind", ["relu", "ints"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 253, 197, 96), (2, 61, 47, 256)])
def test_pool_forward_at_the_train_shapes(cuda, shape, dtype, kind):
    """pool1 and pool2 of the train step at batch 2, 16-byte vectors."""
    _pool_matches_plain(_pool_input(kind, shape, dtype, shape[1]).to(cuda))


@pytest.mark.parametrize("dtype,shape,offset", [
    (torch.bfloat16, (2, 17, 19, 12), 0),  # 24 bytes a pixel: one element
    (torch.float32, (2, 17, 19, 6), 0),    # 24 bytes: one element
    (torch.bfloat16, (2, 9, 11, 8), 1),    # base 2 bytes off: one element
    (torch.bfloat16, (2, 9, 11, 8), 4),    # base 8 bytes off: one element
    (torch.float32, (2, 9, 11, 4), 1),     # base 4 bytes off
    (torch.float32, (2, 9, 11, 4), 2)])    # base 8 bytes off
def test_pool_forward_narrow_paths(cuda, dtype, shape, offset):
    """One element a lane: C x the element size not a multiple of 16
    bytes, or a base off 16-byte alignment (a view into a flat buffer)."""
    x = _pool_input("ints", shape, dtype, sum(shape) + offset)
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
    view = buf[offset:].view(shape)
    view.copy_(x.to(cuda))
    assert view.data_ptr() % 16 == offset * view.element_size() % 16
    _pool_matches_plain(view)


def test_pool_forward_on_a_sliced_odd_image(cuda):
    """x[1:] of a (3, 5, 5, 3) bf16 tensor: not 16-byte aligned, C=3."""
    x = _pool_input("ints", (3, 5, 5, 3), torch.bfloat16, 3).to(cuda)
    assert x[1:].data_ptr() % 16 != 0
    _pool_matches_plain(x[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [17, 18, 19, 20])
def test_pool_forward_at_strip_boundaries(cuda, h, dtype):
    """At these sizes a thread walks 4 output rows: ho = 8 ends on a whole
    strip, ho = 9 one row past it."""
    _pool_matches_plain(_pool_input("ints", (2, h, 21, 16), dtype, h).to(cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_forward_special_values_in_shared_rows_and_halo(cuda, dtype):
    """NaN, -0.0 and -inf in the rows two windows share (even rows) and
    the halo columns two lanes share (even columns)."""
    nan, inf = float("nan"), float("inf")
    x = _pool_input("ints", (2, 21, 23, 16), torch.float32, 7)
    x[:, 2::4, 4::4, 0] = nan                  # NaN in shared rows and halo
    x[:, 1, 1, 3] = x[:, 2, 2, 3] = nan        # two NaNs a window: the last wins
    gen = torch.Generator().manual_seed(8)
    zeros = torch.where(torch.rand(2, 21, 23, generator=gen) < 0.5, -0.0, 0.0)
    x[..., 1] = zeros                          # ties between signed zeros
    x[::2, ::2, ::2, 2] = -0.0
    x[:, :3, :3, 5] = -inf                     # an all -inf window: code 0
    x[:, 2::4, :, 5] = -inf                    # whole -inf shared rows
    x[:, :, 2::4, 6] = -inf                    # whole -inf halo columns
    x = x.to(dtype).to(cuda)
    # NaNs of three payloads in channel 7, set by their bits: the card's
    # F.max_pool2d returns the winning NaN's own bits, and so must K2
    payloads = ((0x7FC0, -1, 0x7F81) if dtype == torch.bfloat16
                else (0x7FC00000, -0x3FFFFF, 0x7F800001))
    for k, p in enumerate(payloads):
        _bits(x)[:, k::3, 2 * k::3, 7] = p
    _pool_matches_plain(x)


@pytest.mark.parametrize("kind", ["relu", "ints"])
def test_pool_backward_at_pool1_from_the_new_index(cuda, kind):
    """dx of the backward kernel fed the with-index forward's idx, at the
    train step's pool1 at batch 2, bitwise autograd of F.max_pool2d."""
    x = _pool_input(kind, (2, 253, 197, 96), torch.bfloat16, 11).to(cuda)
    xg = x.clone().requires_grad_(True)
    y = pool.max_pool_3x3s2_train(xg)
    gen = torch.Generator().manual_seed(12)
    dy = torch.randn(y.shape, generator=gen).to(torch.bfloat16).to(cuda)
    (dx,) = torch.autograd.grad(y, xg, dy)
    ref = pool.max_pool_3x3s2_backward(x, dy)
    torch.cuda.synchronize()
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
    with pytest.raises(ValueError):  # the kernel's FFT is 512 points
        spectrogram_kernel.spectrogram_cuda(torch.zeros(2, 1200, device=cuda),
                                            SpecConfig(nfft=1024))


@pytest.mark.parametrize("tool", [probe_mosaic, probe_mosaic2])
def test_probe_kernels_match_plain_at_the_probe_shapes(cuda, tool):
    """Each probe's kernel bitwise equal to its plain version on the card,
    and every probe of the tool RUNS with match=True."""
    for p in tool.make_probes(cuda):
        got, ref = p.run(), p.run(plain=True)
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype == torch.float32, p.name
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), p.name
    results = tool.main(cuda)
    assert results and all(ran and ok for ran, ok in results.values()), results


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [((3, 7, 5), 1), ((5, 33), 1),
                                        ((13, 9), 0), ((2, 3, 31), 2)])
def test_probe_gather_odd_shapes(cuda, shape, axis, dtype):
    """Odd n_in and inner, a gather along every position of the axis."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=gen).to(dtype).to(cuda)
    n_in = shape[axis]
    idx = np.random.RandomState(n_in).randint(0, n_in, 2 * n_in + 1)
    index = probes.index_map(idx, n_in, cuda)
    before = probes.probe_gather.launches
    got = probes.probe_gather(x, index, axis)
    torch.cuda.synchronize()
    assert probes.probe_gather.launches == before + 1
    ref = probes.gather(x, index, axis)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_probe_select_matmul_is_exact_fp32(cuda):
    """arange(4096) through a 0/1 selection matrix: fp32 FFMA is exact
    where TF32 would round every value above 2048."""
    x = torch.arange(16 * 256, dtype=torch.float32, device=cuda).view(16, 256)
    sel = np.zeros((128, 256), np.float32)
    sel[np.repeat(np.arange(128), 2), np.arange(256)] = 1.0
    got = probes.probe_select_matmul(x[:, :128], torch.from_numpy(sel).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  x[:, :128].cpu().numpy() @ sel)


@pytest.mark.parametrize("m,k,n", [(16, 128, 256), (5, 37, 70)])
def test_probe_select_matmul_random_against_float64(cuda, m, k, n):
    """General inputs, a row stride on a, ragged m, k and n. The kernel
    splits K across 8 warps and adds the partials, another order than one
    FFMA chain, so it is held to float64 within 1e-5 of |a| @ |b|, the
    scale of fp32's rounding bound (a chain of k/8 + 7 roundings)."""
    gen = torch.Generator().manual_seed(m * k * n)
    a = torch.randn(m, k + 3, generator=gen)[:, :k]
    b = torch.randn(k, n, generator=gen)
    before = probes.probe_select_matmul.launches
    got = probes.probe_select_matmul(a.to(cuda), b.to(cuda)).cpu().double()
    assert probes.probe_select_matmul.launches == before + 1
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert ((got - ref).abs() <= 1e-5 * scale).all()


@pytest.mark.parametrize("w,wh", [(197, 100), (196, 99), (9, 6)])
def test_probe_col_candidates_on_ties(cuda, w, wh):
    """Small-integer inputs, where both candidate branches fire."""
    gen = torch.Generator().manual_seed(w)
    x = torch.randint(0, 3, (4, w, 5), generator=gen).float().to(cuda)
    y = torch.randint(0, 3, (4, wh, 5), generator=gen).float().to(cuda)
    dy = torch.randn(4, wh, 5, generator=gen).to(cuda)
    got = probes.probe_col_candidates(x, y, dy)
    ref = probes.col_candidates(x, y, dy)
    torch.cuda.synchronize()
    assert (got != 0).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _offset_view(shape, dtype, offset, gen, cuda):
    """A contiguous randn tensor of ``shape`` on the card whose storage
    starts ``offset`` elements into its buffer (1: not 16-byte aligned)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, generator=gen).to(dtype).to(cuda)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,shape,axis,offset", [
    ("vector", (16, 100, 96), 1, 0),        # P4r's shape: inner 96
    ("misaligned", (16, 100, 96), 1, 1),    # the same, one element in
    ("lanes", (16, 256), 1, 0),             # inner == 1
    ("ragged", (4, 37, 13), 1, 0),          # inner 13: no vector width
    ("inner 12", (3, 20, 12), 1, 0),        # f32 vectors, bf16 elements
    ("outer past the grid", (70000, 5, 4), 1, 0)])
def test_probe_gather_paths(cuda, dtype, case, shape, axis, offset):
    """Each path of the gather bitwise equal to its plain version, one
    launch each, the launcher's path the one ``gather_route`` names."""
    gen = torch.Generator().manual_seed(sum(shape) + offset)
    x = _offset_view(shape, dtype, offset, gen, cuda)
    n_in = shape[axis]
    idx = np.random.RandomState(n_in).randint(0, n_in, n_in + 3)
    index = probes.index_map(idx, n_in, cuda)
    before = probes.probe_gather.launches
    got = probes.probe_gather(x, index, axis)
    torch.cuda.synchronize()
    assert probes.probe_gather.launches == before + 1
    ref = probes.gather(x, index, axis)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    inner = probes.gather_dims(shape, axis)[1]
    vec = 16 // x.element_size()
    want = vec if offset == 0 and inner % vec == 0 else 1
    assert probes.probe_gather.route == probes.Route(want, False)
    assert probes.library_route(probes.probe_gather) == probes.probe_gather.route


def test_probe_gather_rows_past_the_grid(cuda):
    """More output rows than 65535 blocks of 256 threads cover: the rows'
    grid stride."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1)).to(cuda)
    idx = np.random.RandomState(1).randint(0, 1000, 65535 * 256 + 3)
    index = probes.index_map(idx, 1000, cuda)
    before = probes.probe_gather.launches
    got = probes.probe_gather(x, index, 0)
    torch.cuda.synchronize()
    assert probes.probe_gather.launches == before + 1
    assert torch.equal(got, probes.gather(x, index, 0))
    assert probes.probe_gather.route == probes.Route(1, False)


@pytest.mark.parametrize("offset", [0, 1])
def test_probe_gather_64_bit_offsets(cuda, offset):
    """bf16 x of 3 x 2^30 elements and an f32 out of 2^31: the 64-bit
    path, in vectors and, one element in, one element a thread (about 26
    GB of the card's memory at the peak)."""
    buf = torch.empty(3 * 2 ** 30 + offset, dtype=torch.bfloat16, device=cuda)
    x = buf[offset:].view(3, 2 ** 30)
    x.copy_(torch.arange(2 ** 30, device=cuda, dtype=torch.float32)
            .remainder_(257).to(torch.bfloat16).expand(3, -1))
    x[1].neg_()
    x[2].mul_(0.5)
    index = probes.index_map([2, 0], 3, cuda)
    before = probes.probe_gather.launches
    got = probes.probe_gather(x, index, 0)
    torch.cuda.synchronize()
    assert probes.probe_gather.launches == before + 1
    assert probes.probe_gather.route == probes.Route(1 if offset else 8, True)
    assert probes.library_route(probes.probe_gather) == probes.probe_gather.route
    for j, src in enumerate((2, 0)):
        assert torch.equal(got[j].view(torch.int32),
                           x[src].float().view(torch.int32))
    del buf, x, got
    torch.cuda.empty_cache()


@pytest.mark.parametrize("c", [96, 5])
@pytest.mark.parametrize("w,wh", [(197, 100), (196, 100), (196, 99)])
@pytest.mark.parametrize("offset", [0, 1])
def test_probe_col_candidates_paths(cuda, c, w, wh, offset):
    """C = 96 (float4) and C = 5 (one channel a thread), odd W (a half pair
    at the end), even W, 2 (Wh - 1) == W exactly, and y one element into
    its buffer (one channel a thread): bitwise the plain version on
    small-integer ties, both branches firing, one launch."""
    gen = torch.Generator().manual_seed(w * c + offset)
    x = torch.randint(0, 3, (4, w, c), generator=gen).float().to(cuda)
    ybuf = torch.randint(0, 3, (4 * wh * c + offset,), generator=gen).float()
    y = ybuf.to(cuda)[offset:].view(4, wh, c)
    dy = torch.randn(4, wh, c, generator=gen).to(cuda)
    before = probes.probe_col_candidates.launches
    got = probes.probe_col_candidates(x, y, dy)
    torch.cuda.synchronize()
    assert probes.probe_col_candidates.launches == before + 1
    ref = probes.col_candidates(x, y, dy)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    for k2 in (0, 1):  # each branch adds a nonzero somewhere
        yc = torch.repeat_interleave(y[:, 1 - k2:], 2, dim=1)[:, :w]
        fired = x == yc
        if k2:
            fired[:, 1::2] = False
        assert fired.any()
    want = 4 if c % 4 == 0 and offset == 0 else 1
    assert probes.probe_col_candidates.route == probes.Route(want, False)
    assert (probes.library_route(probes.probe_col_candidates)
            == probes.probe_col_candidates.route)


def test_probe_col_candidates_64_bit_offsets(cuda):
    """x [2, 2^15, 2^15] (2^31 elements): the 64-bit float4 path, each
    image held bitwise to the plain version on its own."""
    t, w, c = 2, 2 ** 15, 2 ** 15
    wh = w // 2 + 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 3, (t, w, c), device=cuda, generator=gen).float()
    y = torch.randint(0, 3, (t, wh, c), device=cuda, generator=gen).float()
    dy = torch.randn(t, wh, c, device=cuda, generator=gen)
    before = probes.probe_col_candidates.launches
    got = probes.probe_col_candidates(x, y, dy)
    torch.cuda.synchronize()
    assert probes.probe_col_candidates.launches == before + 1
    assert probes.probe_col_candidates.route == probes.Route(4, True)
    assert (probes.library_route(probes.probe_col_candidates)
            == probes.probe_col_candidates.route)
    for k in range(t):
        ref = probes.col_candidates(x[k:k + 1], y[k:k + 1], dy[k:k + 1])
        assert torch.equal(got[k:k + 1].view(torch.int32), ref.view(torch.int32))
        del ref
    del x, y, dy, got
    torch.cuda.empty_cache()


def test_probe_wrappers_refuse_what_they_cannot_take(cuda):
    x = torch.zeros(4, 6, device=cuda)
    index = probes.index_map([0, 5], 6, cuda)
    with pytest.raises(ValueError):  # the index map is for another length
        probes.probe_gather(x, index, 0)
    with pytest.raises(ValueError):  # not contiguous
        probes.probe_gather(x.t().contiguous().t(), index, 1)
    with pytest.raises(TypeError):
        probes.probe_gather(x.half(), index, 1)
    with pytest.raises(ValueError):  # operands on different devices
        probes.probe_gather(x, probes.index_map([0, 5], 6, "cpu"), 1)
    with pytest.raises(TypeError):
        probes.probe_select_matmul(x.double(), x.t().double())
    with pytest.raises(ValueError):
        probes.probe_col_candidates(torch.zeros(2, 9, 3, device=cuda),
                                    torch.zeros(2, 5, 3, device=cuda),
                                    torch.zeros(2, 5, 3, device=cuda))


def test_extraction_runs_on_the_card_from_host_weights(cuda, tmp_path):
    """compute_audio_feats with CPU weights and no device runs on the card."""
    from mcncrossmodalemotions_torch.data import synthetic_track_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    imdb = synthetic_track_imdb(tmp_path, durations=(1.2,), tracks_per_class=1)
    state = student_state_dict_from_flax(
        random_student_variables(seed=0, fc6=64, fc7=32))
    before = spectrogram_kernel.spectrogram_cuda.launches
    logits = compute_audio_feats(imdb, build_student(tiny=True, with_frontend=False),
                                 state, batch_size=3, verbose=False)
    assert spectrogram_kernel.spectrogram_cuda.launches == before + 2
    assert len(logits) == 6 and all(np.isfinite(l).all() for l in logits)


@pytest.mark.parametrize("policy", ["drop_conv1", "save_pools", "dots"])
def test_remat_policy_launches_and_state(cuda, policy):
    """Three steps of the tiny student at int16 [4, 16384] with a remat
    policy against none, cuDNN deterministic for both: the state bitwise
    equal, and per step K1 once, K2's backward twice and its with-index
    forward twice plus once for each pool the policy recomputes."""
    from mcncrossmodalemotions_torch.train.state import (
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import build_student, student_loss_fn

    recomputed = {"drop_conv1": 0, "save_pools": 2, "dots": 2}[policy]
    gen = torch.Generator().manual_seed(0)
    batch = {"data": (torch.randn(4, 16384, generator=gen) * 3000).to(torch.int16),
             "logit_target": torch.randn(4, 8, generator=gen),
             "max_label": torch.tensor([1, 5, 2, 7], dtype=torch.int32),
             "pad_mask": torch.tensor([1.0, 1.0, 0.0, 1.0])}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    wrappers = (spectrogram_kernel.spectrogram_cuda,
                pool.max_pool_3x3s2_idx_cuda, pool.max_pool_3x3s2_bwd_cuda)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in (None, policy):
            model = build_student(tiny=True, dropout=0.5,
                                  generator=torch.Generator().manual_seed(1))
            state = TrainState.create(
                model.to(cuda), torch.Generator(device=cuda).manual_seed(2))
            step = make_train_step(student_loss_fn(), remat_policy=name,
                                   pass_pad_mask=True)
            before = [w.launches for w in wrappers]
            for lr in (1e-2, 5e-3, 2e-3):
                state, _ = step(state, batch, lr)
            torch.cuda.synchronize()
            runs[name] = (state, [w.launches - b
                                  for w, b in zip(wrappers, before)])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert runs[None][1] == [3, 6, 6]
    assert runs[policy][1] == [3, 3 * (2 + recomputed), 6]
    plain, remat = runs[None][0], runs[policy][0]
    for k, v in plain.model.state_dict().items():
        assert torch.equal(remat.model.state_dict()[k], v), k
    for k, v in plain.velocity.items():
        assert torch.equal(remat.velocity[k], v), k


# The teachers' epilogue kernels (ops/epilogue.py). Per stage of the
# full-width teachers: (h = w, the bottleneck's inner width, its output
# width); stage 0 is the stem conv's output.
EPILOGUE_STAGES = {0: (112, 64, None), 1: (56, 64, 256), 2: (28, 128, 512),
                   3: (14, 256, 1024), 4: (7, 512, 2048)}
EPILOGUE_KERNELS = ["affine_relu", "affine_squeeze", "tail", "tail_gate",
                    "tail_proj", "tail_gate_proj", "affine_relu_pool2x2"]
# VGG-VD-16's block-end conv outputs at 224x224, (h = w, c): what
# affine_relu_pool2x2 reads
VD16_BLOCK_ENDS = [(224, 64), (112, 128), (56, 256), (28, 512), (14, 512)]
TEACHER_GOLDEN = (Path(__file__).resolve().parent / "fixtures"
                  / "torch_teacher_golden.npz")
VGG16_GOLDEN = TEACHER_GOLDEN.with_name("torch_vgg16_golden.npz")
VGG_FACE_MEAN = (129.1863, 104.7624, 93.594)
TEACHER_FP32_RTOL = 2e-3  # chip_smoke's gates against the JAX golden
TEACHER_BF16_RTOL = 1e-2


def _epilogue_args(kernel, shape, dtype, device, seed, offset=0):
    """The kernel's inputs (y, s, t and the tail's residual, gate and
    projection affine) with y and the residual placed ``offset`` elements
    into a buffer."""
    gen = torch.Generator().manual_seed(seed)
    b, c = shape[0], shape[3]

    def act():
        buf = torch.empty(int(np.prod(shape)) + offset, dtype=dtype,
                          device=device)
        view = buf[offset:].view(shape)
        view.copy_(torch.randn(shape, generator=gen).to(dtype))
        return view

    def affine():
        s = (torch.randn(c, generator=gen) * 0.5 + 1.0).to(device)
        return s, torch.randn(c, generator=gen).to(device)

    y = act()
    s, t = affine()
    if kernel == "affine_relu_pool2x2":  # the affine before the max matters
        s[::2] *= -1.0
    kw = {}
    if kernel.startswith("tail"):
        kw["residual"] = act()
        if "gate" in kernel:
            kw["gate"] = torch.rand(b, c, generator=gen).to(dtype).to(device)
        if "proj" in kernel:
            kw["residual_affine"] = affine()
    return y, s, t, kw


def _epilogue_call(kernel, y, s, t, kw, plain=False):
    if kernel == "affine_relu":
        fn = epilogue.affine_relu_plain if plain else epilogue.affine_relu
        return fn(y, s, t)
    if kernel == "affine_squeeze":
        fn = epilogue.affine_squeeze_plain if plain else epilogue.affine_squeeze
        return fn(y, s, t)
    if kernel == "affine_relu_pool2x2":
        fn = (epilogue.affine_relu_pool2x2_plain if plain
              else epilogue.affine_relu_pool2x2)
        return fn(y, s, t)
    kw = dict(kw)
    r = kw.pop("residual")
    if plain:
        return epilogue.affine_gate_add_relu_plain(y, s, t, r, **kw)
    return epilogue.affine_gate_add_relu(y, s, t, r, **kw)


def _wrapper(kernel):
    return {"affine_relu": epilogue.affine_relu,
            "affine_squeeze": epilogue.affine_squeeze,
            "affine_relu_pool2x2": epilogue.affine_relu_pool2x2}.get(
                kernel, epilogue.affine_gate_add_relu)


def _epilogue_matches_plain(kernel, y, s, t, kw):
    """The kernel against its plain version: within one unit in the last
    place of the output type (a fused multiply-add against a multiply and
    an add, another summation order) and 1e-5 of the largest value."""
    wrapper = _wrapper(kernel)
    before = wrapper.launches
    got = _epilogue_call(kernel, y, s, t, kw)
    ref = _epilogue_call(kernel, y, s, t, kw, plain=True)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype == y.dtype
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 2.0 ** -22
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    bad = (got - ref).abs() > ulp * ref.abs() + 1e-5 * scale
    assert not bad.any().item(), (got[bad][:8], ref[bad][:8])
    assert torch.isfinite(got).all().item()


@pytest.mark.parametrize("batch", [128, 3])
@pytest.mark.parametrize("kernel,stage", [
    (k, stage) for stage in EPILOGUE_STAGES for k in EPILOGUE_KERNELS
    if stage or k == "affine_relu"])  # the stem's output: affine_relu alone
def test_epilogue_kernels_match_plain_at_the_teachers_shapes(
        cuda, kernel, stage, batch):
    """bf16 at each stage's full width: affine_relu at the inner width
    (and the stem's output), the squeeze and the tails at the output's."""
    hw, inner, out = EPILOGUE_STAGES[stage]
    c = inner if kernel == "affine_relu" else out
    y, s, t, kw = _epilogue_args(kernel, (batch, hw, hw, c), torch.bfloat16,
                                 cuda, seed=stage * 10 + batch)
    _epilogue_matches_plain(kernel, y, s, t, kw)


@pytest.mark.parametrize("hw,c", VD16_BLOCK_ENDS)
def test_pool_epilogue_matches_plain_at_the_vd16_block_ends(cuda, hw, c):
    """affine_relu_pool2x2 at batch 128 in bf16 at each of VGG-VD-16's
    five block ends, every other channel's scale negative."""
    y, s, t, kw = _epilogue_args("affine_relu_pool2x2", (128, hw, hw, c),
                                 torch.bfloat16, cuda, seed=hw + c)
    _epilogue_matches_plain("affine_relu_pool2x2", y, s, t, kw)


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (3, 15, 13, 64)),   # odd: the last row and column unread
    (torch.bfloat16, (2, 3, 2, 8)),      # one 16-byte vector a pixel
    (torch.float32, (3, 7, 9, 4)),
    (torch.bfloat16, (1, 2, 2, 1024))])  # one window, eight channel tiles
def test_pool_epilogue_at_odd_and_narrow_shapes(cuda, dtype, shape):
    y, s, t, kw = _epilogue_args("affine_relu_pool2x2", shape, dtype, cuda,
                                 seed=sum(shape))
    _epilogue_matches_plain("affine_relu_pool2x2", y, s, t, kw)


def test_pool_epilogue_keeps_a_nan_in_its_window(cuda):
    y, s, t, _ = _epilogue_args("affine_relu_pool2x2", (2, 4, 4, 16),
                                torch.bfloat16, cuda, seed=5)
    y[0, 1, 2, 3] = float("nan")
    got = epilogue.affine_relu_pool2x2(y, s, t)
    ref = epilogue.affine_relu_pool2x2_plain(y, s, t)
    assert torch.isnan(got[0, 0, 1, 3]).item()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))


def test_pool_epilogue_refuses_what_it_cannot_pool(cuda):
    y, s, t, _ = _epilogue_args("affine_relu_pool2x2", (2, 4, 4, 16),
                                torch.bfloat16, cuda, seed=6)
    before = epilogue.affine_relu_pool2x2.launches
    with pytest.raises(ValueError, match="H and W of 2 or more"):
        epilogue.affine_relu_pool2x2(y[:, :1], s, t)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        epilogue.affine_relu_pool2x2(y.permute(0, 2, 1, 3), s, t)
    with pytest.raises(ValueError, match="fp32"):
        epilogue.affine_relu_pool2x2(y, s[:8], t[:8])
    assert epilogue.affine_relu_pool2x2.launches == before


@pytest.mark.parametrize("kernel", EPILOGUE_KERNELS)
def test_epilogue_kernels_fp32(cuda, kernel):
    """The fp32 kernels (the teachers' fp32 forward), 4 elements a lane."""
    y, s, t, kw = _epilogue_args(kernel, (3, 14, 14, 1024), torch.float32,
                                 cuda, seed=7)
    _epilogue_matches_plain(kernel, y, s, t, kw)


@pytest.mark.parametrize("dtype,shape,offset", [
    (torch.bfloat16, (2, 5, 7, 12), 0),     # 24 bytes a pixel
    (torch.bfloat16, (2, 5, 7, 16), 1),     # base 2 bytes off
    (torch.float32, (2, 5, 7, 6), 0),       # 24 bytes a pixel
    (torch.float32, (2, 5, 7, 8), 2)])      # base 8 bytes off
@pytest.mark.parametrize("kernel", EPILOGUE_KERNELS)
def test_epilogue_kernels_refuse_narrow_or_misaligned(cuda, kernel, dtype,
                                                      shape, offset):
    """No narrower path: C x the element size not a multiple of 16 bytes,
    or y and the residual off 16-byte alignment, raise and launch
    nothing."""
    y, s, t, kw = _epilogue_args(kernel, shape, dtype, cuda, seed=sum(shape),
                                 offset=offset)
    wrapper = _wrapper(kernel)
    before = wrapper.launches
    with pytest.raises(ValueError, match="16-byte"):
        _epilogue_call(kernel, y, s, t, kw)
    assert wrapper.launches == before


def test_epilogue_in_place_is_the_same_as_apart(cuda):
    """``out=y`` (the teachers' use) writes what a new tensor gets."""
    for kernel in ("affine_relu", "tail_gate_proj"):
        y, s, t, kw = _epilogue_args(kernel, (4, 14, 14, 256), torch.bfloat16,
                                     cuda, seed=3)
        apart = _epilogue_call(kernel, y, s, t, kw)
        fn = _wrapper(kernel)
        args = (y, s, t) if kernel == "affine_relu" else (
            y, s, t, kw.pop("residual"))
        assert fn(*args, **kw, out=y) is y
        torch.cuda.synchronize()
        assert torch.equal(y, apart)


def test_epilogue_kernels_refuse_what_they_do_not_take(cuda):
    y, s, t, kw = _epilogue_args("tail_gate_proj", (2, 7, 7, 64),
                                 torch.bfloat16, cuda, seed=1)
    r = kw["residual"]
    nchw = y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        epilogue.affine_relu(nchw, s, t)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        epilogue.affine_squeeze(y[:, :, :, :32], s[:32], t[:32])
    with pytest.raises(TypeError, match="unsupported dtype"):
        epilogue.affine_relu(y.half(), s, t)
    with pytest.raises(ValueError, match="fp32"):
        epilogue.affine_relu(y, s[:32], t[:32])
    with pytest.raises(ValueError, match="fp32"):
        epilogue.affine_squeeze(y, s.cpu(), t.cpu())
    with pytest.raises(ValueError, match="fp32"):
        epilogue.affine_relu(y, s.to(torch.bfloat16), t)
    with pytest.raises(ValueError, match="gate"):
        epilogue.affine_gate_add_relu(y, s, t, r, gate=kw["gate"][:1])
    with pytest.raises(ValueError, match="contiguous"):
        epilogue.affine_gate_add_relu(y, s, t, r.float())
    with pytest.raises(ValueError, match="contiguous"):
        epilogue.affine_gate_add_relu(y, s, t, nchw)
    with pytest.raises(ValueError, match="fp32"):
        epilogue.affine_gate_add_relu(y, s, t, r, residual_affine=(s[:8], t))


def _full_teacher(use_se, dtype, cuda):
    from mcncrossmodalemotions_torch.models.resnet import ResNet

    model = ResNet(use_se=use_se, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(cuda).eval()


@pytest.mark.parametrize("use_se", [True, False], ids=["senet50", "resnet50"])
def test_teacher_eval_forward_launches_the_epilogues(cuda, use_se):
    """One full-width eval forward at batch 128 without autograd: 33
    affine_relu (the stem, two a bottleneck), 16 squeezes with SE and 16
    tails; the prepared weights built once over two calls; an eval call
    under autograd launches none."""
    model = _full_teacher(use_se, torch.bfloat16, cuda)
    x = torch.randn(128, 224, 224, 3, device=cuda) * 60
    wrappers = (epilogue.affine_relu, epilogue.affine_squeeze,
                epilogue.affine_gate_add_relu)
    for _ in range(2):
        before = [w.launches for w in wrappers]
        with torch.inference_mode():
            logits = model(x)
        torch.cuda.synchronize()
        assert [w.launches - b for w, b in zip(wrappers, before)] == \
            [33, 16 if use_se else 0, 16]
    assert logits.shape == (128, 8) and torch.isfinite(logits).all().item()
    assert model.prepared.builds == 1
    before = [w.launches for w in wrappers]
    model(x[:2]).sum().backward()
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("arch", ["senet50", "resnet50"])
def test_teacher_eval_forward_holds_the_golden(cuda, arch, dtype):
    """The fused forward on the golden's four frames against the JAX
    package's fp32 logits: fp32 (TF32 off) within 2e-3 x max|golden|, bf16
    within max(2 x JAX's own bf16 error, 1e-2 x max|golden|), chip_smoke's
    teacher gates."""
    from mcncrossmodalemotions_torch.models.resnet import ResNet
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.zoo.bridge import (
        random_teacher_variables,
        teacher_state_dict_from_flax,
    )

    gold = np.load(TEACHER_GOLDEN)
    frames = gold["frames_crop0625"][gold["logit_index"]][..., None]
    use_se = arch == "senet50"
    v = random_teacher_variables(seed=0, use_se=use_se)
    state = teacher_state_dict_from_flax(
        {"params": {"teacher": v["params"]},
         "batch_stats": {"teacher": v["batch_stats"]}})
    model = FaceTeacherPipeline(ResNet(use_se=use_se, dtype=dtype))
    model.load_state_dict(state)
    model = model.to(cuda).eval()
    before = epilogue.affine_gate_add_relu.launches
    with torch.no_grad():
        got = model(torch.from_numpy(frames).to(cuda)).cpu().numpy()
    assert epilogue.affine_gate_add_relu.launches == before + 16
    ref = gold[f"logits_{arch}_fp32"]
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    if dtype == torch.float32:
        gate = TEACHER_FP32_RTOL * scale
    else:
        jax_bf16 = float(np.abs(gold[f"logits_{arch}_bf16"] - ref).max())
        gate = max(2 * jax_bf16, TEACHER_BF16_RTOL * scale)
    print(f"{arch} {dtype}: max abs {err:.3e}, gate {gate:.3e}")
    assert err <= gate


def _vggface(arch, bn, dtype, cuda):
    """A full-width classic face network (VGG-VD-16 'vd', as
    ``vgg-vd-face-fer`` without BatchNorm or with the useBnorm retrofit;
    VGG-M 'm') with ``random_vggface_variables``' seeded weights."""
    from mcncrossmodalemotions_torch.models.vggface import VGGFace
    from mcncrossmodalemotions_torch.zoo.bridge import (
        random_vggface_variables,
        teacher_state_dict_from_flax,
    )

    model = VGGFace(arch, use_batchnorm=bn, dtype=dtype)
    model.load_state_dict(teacher_state_dict_from_flax(
        random_vggface_variables(seed=1, arch=arch, use_batchnorm=bn)))
    return model.to(cuda).eval()


@pytest.mark.parametrize("arch,bn", [("vd", False), ("vd", True), ("m", True)],
                         ids=["vgg16", "vgg16_bn", "vggm_bn"])
def test_vggface_fused_forward_matches_the_unfused_at_published_widths(
        cuda, arch, bn):
    """The classic face networks at full width on 8 frames: the fused eval
    forward in fp32 within 2e-3 x max|logit| of the unfused fp32 forward
    (autograd on, TF32 off), in bf16 within max(2 x the unfused bf16
    forward's own error, 1e-2 x max|logit|); the embeddings too."""
    x = torch.randn(8, 224, 224, 3, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2)) * 60
    out = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = _vggface(arch, bn, dtype, cuda)
        with torch.enable_grad():
            out[f"unfused {tag}"] = [v.detach().float() for v in
                                     model(x, return_embedding=True)]
        with torch.inference_mode():
            out[tag] = [v.float() for v in model(x, return_embedding=True)]
        assert model.prepared.builds == 1
        del model
    for i, what in enumerate(("logits", "embedding")):
        ref = out["unfused fp32"][i]
        scale = ref.abs().max().item()
        err = {k: (out[k][i] - ref).abs().max().item()
               for k in ("fp32", "bf16", "unfused bf16")}
        print(f"{arch} {what}: max |ref| {scale:.4f}, {err}")
        assert err["fp32"] <= TEACHER_FP32_RTOL * scale, what
        assert err["bf16"] <= max(2 * err["unfused bf16"],
                                  TEACHER_BF16_RTOL * scale), what


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("bn", [False, True], ids=["vgg16", "vgg16_bn"])
def test_vgg16_fused_forward_holds_the_jax_golden(cuda, bn, dtype):
    """Full-width VGG-VD-16 (BN-less as ``vgg-vd-face-fer``, and the
    useBnorm retrofit) in a ``FaceTeacherPipeline`` with the vgg_face mean,
    ``random_vggface_variables(seed=0)``' weights, the fused eval forward on
    the teacher golden's four frames against the JAX package's fp32 logits
    (``torch_vgg16_golden.npz``): fp32 (TF32 off) within 2e-3 x
    max|golden|, bf16 within max(2 x JAX's own bf16 error, 1e-2 x
    max|golden|), chip_smoke's teacher gates; 10 affine_relu and 5
    affine_relu_pool2x2 launched."""
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.models.vggface import VGGFace
    from mcncrossmodalemotions_torch.zoo.bridge import (
        random_vggface_variables,
        teacher_state_dict_from_flax,
    )

    gold = np.load(TEACHER_GOLDEN)
    frames = gold["frames_crop0625"][gold["logit_index"]][..., None]
    v = random_vggface_variables(seed=0, arch="vd", use_batchnorm=bn)
    model = FaceTeacherPipeline(VGGFace("vd", use_batchnorm=bn, dtype=dtype),
                                mean_rgb=VGG_FACE_MEAN, augment=False)
    model.load_state_dict(teacher_state_dict_from_flax(
        {k: {"teacher": tree} for k, tree in v.items()}), strict=True)
    model = model.to(cuda).eval()
    wrappers = (epilogue.affine_relu, epilogue.affine_relu_pool2x2)
    before = [w.launches for w in wrappers]
    with torch.no_grad():
        got = model(torch.from_numpy(frames).to(cuda)).cpu().numpy()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [10, 5]
    arch = "vgg16_bn" if bn else "vgg16"
    vgold = np.load(VGG16_GOLDEN)
    ref = vgold[f"logits_{arch}_fp32"]
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    if dtype == torch.float32:
        gate = TEACHER_FP32_RTOL * scale
    else:
        jax_bf16 = float(np.abs(vgold[f"logits_{arch}_bf16"] - ref).max())
        gate = max(2 * jax_bf16, TEACHER_BF16_RTOL * scale)
    print(f"{arch} {dtype}: max abs {err:.3e}, gate {gate:.3e}")
    assert err <= gate


def test_vgg16_eval_forward_launches_the_epilogues(cuda):
    """``build_teacher('vgg-vd-face-fer')`` in a ``FaceTeacherPipeline``,
    one eval forward at batch 128 without autograd: 10 affine_relu (8
    mid-block convs, fc6, fc7) and 5 affine_relu_pool2x2, no squeeze or
    tail; the prepared weights built once over two calls; an eval call
    under autograd launches none."""
    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.zoo import build_teacher

    model = FaceTeacherPipeline(build_teacher("vgg-vd-face-fer"),
                                mean_rgb=(129.1863, 104.7624, 93.594),
                                augment=False)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    frames = torch.randint(0, 256, (128, 224, 224, 1), dtype=torch.uint8,
                           device=cuda)
    wrappers = (epilogue.affine_relu, epilogue.affine_squeeze,
                epilogue.affine_gate_add_relu, epilogue.affine_relu_pool2x2)
    for _ in range(2):
        before = [w.launches for w in wrappers]
        with torch.inference_mode():
            logits = model(frames)
        torch.cuda.synchronize()
        assert [w.launches - b for w, b in zip(wrappers, before)] == \
            [10, 0, 0, 5]
    assert logits.shape == (128, 8) and torch.isfinite(logits).all().item()
    assert model.teacher.prepared.builds == 1
    before = [w.launches for w in wrappers]
    model(frames[:2]).sum().backward()
    assert [w.launches for w in wrappers] == before
