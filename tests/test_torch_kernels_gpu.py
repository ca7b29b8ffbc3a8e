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

from mcncrossmodalemotions_torch.ops import pool, probes, spectrogram_kernel
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
