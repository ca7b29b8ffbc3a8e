"""The port's ``ops/warp.py`` against the JAX package's.

- The host path (numpy), bit for bit for the same ``RandomState``:
  ``random_augmentation_thetas_np`` (defaults and explicit ranges),
  ``warp_images_np`` (uint8 and float inputs, identity, shrinking and
  enlarging warps, samples outside the image clamped to the border) and
  ``augment_batch_np`` (rounded half to even before the uint8 cast).
- The device path (torch, fp32) within 1e-5 x max(1, max|ref|) of the JAX
  functions on the same thetas: ``affine_grid``, ``bilinear_sample``,
  ``warp_images`` and ``resize_bilinear``; ``identity_theta`` and
  ``_compose`` exactly. The sampler is the JAX four-tap gather, not
  ``F.grid_sample``. The torch ``random_augmentation_thetas`` draws from a
  ``torch.Generator``: reproducible from its seed, the identity on about
  1 - apply_prob of the batch, and its applied affines are z @ r @ k with
  the zoom, angle and skew inside their ranges.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.ops import warp
from mcncrossmodalemotions_tpu.ops import warp as jwarp


def _thetas(batch: int, seed: int) -> np.ndarray:
    return jwarp.random_augmentation_thetas_np(np.random.RandomState(seed),
                                               batch)


@pytest.mark.parametrize("kw", [{}, dict(zoom_delta=0.3, max_rotate=1.0,
                                         max_skew=0.4, apply_prob=0.9)])
def test_random_thetas_np_equal(kw):
    got = warp.random_augmentation_thetas_np(np.random.RandomState(7), 33, **kw)
    ref = jwarp.random_augmentation_thetas_np(np.random.RandomState(7), 33, **kw)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("out", [(48, 48), (20, 31), (64, 64)])
def test_warp_images_np_equal(dtype, out):
    rng = np.random.RandomState(3)
    images = (rng.rand(6, 48, 40, 2) * 255).astype(dtype)
    theta = _thetas(6, 3)
    theta[0] = [[1, 0, 0], [0, 1, 0]]
    theta[1] = [[1.5, 0.2, 0.4], [-0.3, 1.4, -0.5]]  # reaches past the border
    got = warp.warp_images_np(images, theta, *out)
    ref = jwarp.warp_images_np(images, theta, *out)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_size", [None, 64])
def test_augment_batch_np_equal(out_size):
    images = np.random.RandomState(5).randint(0, 256, (9, 48, 48, 1)).astype(
        np.uint8)
    got = warp.augment_batch_np(images, np.random.RandomState(11), out_size)
    ref = jwarp.augment_batch_np(images, np.random.RandomState(11), out_size)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # half to even: a warped value of x.5 rounds to the even neighbour
    theta = np.tile(np.float32([[1, 0, 0], [0, 1, 0]]), (1, 1, 1))
    half = warp.warp_images_np(np.float32([[[[2.5]], [[3.5]]]]), theta, 2, 1)
    assert np.round(half).ravel().tolist() == [2.0, 4.0]


def _close(got: torch.Tensor, ref, what: str):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got.numpy() - ref).max())
    assert got.shape == ref.shape, what
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), (what, err)


@pytest.mark.parametrize("hw,out", [((48, 48), (48, 48)), ((48, 40), (64, 72)),
                                    ((31, 17), (9, 5))])
def test_device_warp_matches_jax(hw, out):
    rng = np.random.RandomState(1)
    images = (rng.rand(5, *hw, 3) * 255).astype(np.float32)
    theta = _thetas(5, 1)
    theta[2] = [[1.3, -0.4, 0.6], [0.2, 0.7, -0.9]]  # out of the image too
    tt = torch.from_numpy(theta)
    grid = warp.affine_grid(tt, *out)
    _close(grid, jwarp.affine_grid(jnp.asarray(theta), *out), "affine_grid")
    _close(warp.bilinear_sample(torch.from_numpy(images), grid),
           jwarp.bilinear_sample(jnp.asarray(images), jnp.asarray(grid.numpy())),
           "bilinear_sample")
    _close(warp.warp_images(torch.from_numpy(images), tt, *out),
           jwarp.warp_images(jnp.asarray(images), jnp.asarray(theta), *out),
           "warp_images")
    _close(warp.resize_bilinear(torch.from_numpy(images), *out),
           jwarp.resize_bilinear(jnp.asarray(images), *out), "resize_bilinear")


def test_identity_and_compose_equal():
    a, b = _thetas(4, 2), _thetas(4, 8)
    np.testing.assert_array_equal(warp.identity_theta(4).numpy(),
                                  np.asarray(jwarp.identity_theta(4)))
    got = warp._compose(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jwarp._compose(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_random_thetas_draw_from_the_generator():
    n = 4000
    draw = lambda s, **kw: warp.random_augmentation_thetas(  # noqa: E731
        torch.Generator().manual_seed(s), n, **kw)
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    eye = warp.identity_theta(n)
    is_eye = (a == eye).flatten(1).all(1)
    # identity with probability 1 - apply_prob = 0.5: 6 sigma of a binomial
    assert abs(float(is_eye.float().mean()) - 0.5) <= 6 * np.sqrt(0.25 / n)
    # an applied affine is zoom @ rot @ skew: its linear part's determinant
    # is zoom^2 (1 - skew_x skew_y), inside [0.96^2 (1 - 0.01), 1.04^2]
    det = torch.linalg.det(a[~is_eye][:, :, :2].double())
    assert float(det.min()) >= 0.96 ** 2 * 0.99 - 1e-6
    assert float(det.max()) <= 1.04 ** 2 * 1.01 + 1e-6
    assert torch.all(a[:, :, 2] == 0)  # no translation
    all_on = draw(2, apply_prob=1.0)
    assert not (all_on == eye).flatten(1).all(1).any()
