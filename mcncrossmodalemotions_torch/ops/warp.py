"""Batched affine grid + bilinear sampling (the augmentation engine), PyTorch.

Port of ``mcncrossmodalemotions_tpu/ops/warp.py``: the reference's
``vl_nnaffinegrid`` + ``vl_nnbilinearsampler`` (ferplus_baselines.m:194-213)
with the same semantics in two forms.

- The host (numpy) path, ``random_augmentation_thetas_np``,
  ``warp_images_np`` and ``augment_batch_np``: the port's own copy of the
  original's, bit for bit for the same ``np.random.RandomState``
  (``tests/test_torch_warp.py``). The FER+ batch loader
  (``data/ferplus.ferplus_batches``) augments 48x48 uint8 images with it on
  the host; the device receives uint8 and does only the resize and the
  elementwise preprocessing (``models/teacher_pipeline.py``).
- The device (torch) path, ``affine_grid``, ``bilinear_sample``,
  ``warp_images``, ``resize_bilinear`` and ``random_augmentation_thetas``:
  float32 tensors on any device. ``bilinear_sample`` is the JAX module's
  four-tap gather with the border clamped (the vl_nnbilinearsampler
  convention), not ``F.grid_sample``; the random affines draw from an
  explicit ``torch.Generator`` (the draws differ from ``jax.random``'s).
- ``resize_separable``: the align-corners separable bilinear resize the
  teacher pipeline applies when frames are not the network's input size,
  as two fp32 matmuls with interpolation matrices (the JAX function runs
  them at HIGHEST precision; here TF32 is off by PyTorch's default). The
  host resize of ``data/images.py`` and the C++ decoder share its
  convention.

Augmentation parameters mirror computeAugs (ferplus_baselines.m:232-268):
zoom 1 +/- 1/25, rotation +/- pi/18, skew +/- 0.1, composed, applied to a
random 50% of the batch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """theta [B, 2, 3] -> sampling grid [B, H, W, 2] in [-1, 1] coords:
    output pixel (i, j) samples input at ``theta @ [x_j, y_i, 1]``
    (vl_nnaffinegrid semantics)."""
    dev = theta.device
    ys = torch.linspace(-1.0, 1.0, height, device=dev)
    xs = torch.linspace(-1.0, 1.0, width, device=dev)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=-1)
    return torch.einsum("bij,hwj->bhwi", theta.float(), base)


def bilinear_sample(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NHWC ``images`` at ``grid`` [B, H', W', 2] ([-1, 1] x/y
    coords), border pixels clamped; differentiable in ``images`` and
    ``grid``."""
    b, h, w, c = images.shape
    images = images.float()
    x = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    x0i, x1i, y0i, y1i = (t.long() for t in (x0, x1, y0, y1))
    bidx = torch.arange(b, device=images.device)[:, None, None]
    v00 = images[bidx, y0i, x0i]
    v01 = images[bidx, y0i, x1i]
    v10 = images[bidx, y1i, x0i]
    v11 = images[bidx, y1i, x1i]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def identity_theta(batch: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device)
    return eye[None].repeat(batch, 1, 1)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two [B, 2, 3] affines: result = a after b."""
    last = torch.tensor([[[0.0, 0.0, 1.0]]], device=a.device).repeat(
        a.shape[0], 1, 1)
    return torch.matmul(torch.cat([a, last], 1), torch.cat([b, last], 1))[:, :2]


def random_augmentation_thetas(generator: torch.Generator, batch: int,
                               zoom_delta: float = 1.0 / 25.0,
                               max_rotate: float = math.pi / 18.0,
                               max_skew: float = 0.1,
                               apply_prob: float = 0.5) -> torch.Tensor:
    """Random zoom-rotate-skew affines (computeAugs) [B, 2, 3] on
    ``generator``'s device: each sample an independent composed
    transform, replaced by the identity with probability
    ``1 - apply_prob`` (ferplus_baselines.m:194-199)."""
    dev = generator.device

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator, device=dev) * 2 - 1) * bound

    zoom = 1.0 + uniform((batch,), zoom_delta)
    angle = uniform((batch,), max_rotate)
    skew = uniform((batch, 2), max_skew)
    zeros = torch.zeros(batch, device=dev)
    ones = torch.ones(batch, device=dev)
    zoom_t = torch.stack([torch.stack([zoom, zeros, zeros], -1),
                          torch.stack([zeros, zoom, zeros], -1)], 1)
    cos, sin = torch.cos(angle), torch.sin(angle)
    rot_t = torch.stack([torch.stack([cos, -sin, zeros], -1),
                         torch.stack([sin, cos, zeros], -1)], 1)
    skew_t = torch.stack([torch.stack([ones, skew[:, 0], zeros], -1),
                          torch.stack([skew[:, 1], ones, zeros], -1)], 1)
    theta = _compose(_compose(zoom_t, rot_t), skew_t)
    apply = torch.rand(batch, generator=generator, device=dev) < apply_prob
    return torch.where(apply[:, None, None], theta, identity_theta(batch, dev))


def warp_images(images: torch.Tensor, theta: torch.Tensor,
                out_height: int, out_width: int) -> torch.Tensor:
    """Affine-warp + resize in one sampling pass (the reference's combined
    augmentation/resize path)."""
    return bilinear_sample(images, affine_grid(theta, out_height, out_width))


def resize_bilinear(images: torch.Tensor, out_height: int,
                    out_width: int) -> torch.Tensor:
    """Plain bilinear resize via the identity warp."""
    return warp_images(images, identity_theta(images.shape[0], images.device),
                       out_height, out_width)


def _weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] align-corners interpolation matrix."""
    if n_in == 1:  # replication: all conventions agree
        return np.ones((1, n_out), np.float32)
    if n_out == 1:  # one output samples index 0, not the axis mean
        mat = np.zeros((n_in, 1), np.float32)
        mat[0, 0] = 1.0
        return mat
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(pos).astype(int), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = pos - lo
    mat = np.zeros((n_in, n_out), np.float32)
    mat[lo, np.arange(n_out)] += 1.0 - frac
    mat[hi, np.arange(n_out)] += frac
    return mat


def resize_weights(height: int, width: int, out_height: int, out_width: int,
                   device: torch.device | str = "cpu"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``resize_separable``'s interpolation matrices ([H, H'], [W, W']) on
    ``device``. Made on the host and copied: a caller that resizes at every
    step keeps them (a copy from pageable host memory to the card makes the
    host wait for the card there)."""
    return (torch.from_numpy(_weights(height, out_height)).to(device),
            torch.from_numpy(_weights(width, out_width)).to(device))


def resize_separable(images: torch.Tensor, out_height: int, out_width: int,
                     weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """[B, H, W, C] -> [B, H', W', C] float32, align-corners bilinear; the
    input itself when the size already matches. ``weights`` are
    ``resize_weights``' matrices for these sizes, made here when None."""
    b, h, w, c = images.shape
    if (h, w) == (out_height, out_width):
        return images
    wy, wx = weights or resize_weights(h, w, out_height, out_width,
                                       images.device)
    out = torch.einsum("bhwc,hH->bHwc", images.float(), wy)
    return torch.einsum("bHwc,wW->bHWc", out, wx)


# ---------------------------------------------------------------------------
# Host (numpy) implementations: the batch loaders' augmentation
# ---------------------------------------------------------------------------

def random_augmentation_thetas_np(rng: np.random.RandomState, batch: int,
                                  zoom_delta: float = 1.0 / 25.0,
                                  max_rotate: float = float(np.pi) / 18.0,
                                  max_skew: float = 0.1,
                                  apply_prob: float = 0.5) -> np.ndarray:
    """numpy twin of ``random_augmentation_thetas`` for host-side aug."""
    zoom = 1.0 + rng.uniform(-zoom_delta, zoom_delta, batch)
    angle = rng.uniform(-max_rotate, max_rotate, batch)
    skew = rng.uniform(-max_skew, max_skew, (batch, 2))
    thetas = np.zeros((batch, 2, 3))
    for i in range(batch):
        z = np.array([[zoom[i], 0, 0], [0, zoom[i], 0], [0, 0, 1]])
        c, s = np.cos(angle[i]), np.sin(angle[i])
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        k = np.array([[1, skew[i, 0], 0], [skew[i, 1], 1, 0], [0, 0, 1]])
        thetas[i] = (z @ r @ k)[:2]
    apply = rng.rand(batch) < apply_prob
    eye = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    thetas[~apply] = eye
    return thetas.astype(np.float32)


def warp_images_np(images, theta, out_height: int,
                   out_width: int) -> np.ndarray:
    """Host affine warp, the torch sampler's arithmetic in numpy.

    ``images``: [B, H, W, C] (any numeric dtype), read as float32; the
    result is float64, as the original's (its grid comes from float64
    ``np.linspace``).
    """
    images = np.asarray(images, np.float32)
    b, h, w, c = images.shape
    ys = np.linspace(-1.0, 1.0, out_height)
    xs = np.linspace(-1.0, 1.0, out_width)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    base = np.stack([gx, gy, np.ones_like(gx)], axis=-1)  # [H', W', 3]
    grid = np.einsum("bij,hwj->bhwi", np.asarray(theta, np.float32), base)
    x = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = np.clip(np.floor(x), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(y), 0, h - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = np.clip(x - x0, 0.0, 1.0)[..., None]
    wy = np.clip(y - y0, 0.0, 1.0)[..., None]
    bidx = np.arange(b)[:, None, None]
    v00 = images[bidx, y0, x0]
    v01 = images[bidx, y0, x1]
    v10 = images[bidx, y1, x0]
    v11 = images[bidx, y1, x1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def augment_batch_np(images, rng: np.random.RandomState,
                     out_size: Optional[int] = None,
                     **theta_kwargs) -> np.ndarray:
    """Host-side augmentation for a uint8 image batch.

    ``out_size=None`` warps at the native resolution (same size in/out:
    the device resizes later, two resamplings in all). ``out_size=S``
    composes warp AND resize into ONE bilinear sample to [B, S, S, C],
    the reference's single-resample composition (ferplus_baselines.m:
    194-213), at (S/48)^2 more host arithmetic and feed bytes. The warped
    values are rounded half to even (``np.round``) before the uint8 cast.
    """
    b, h, w, _ = images.shape
    oh = ow = out_size if out_size is not None else h
    theta = random_augmentation_thetas_np(rng, b, **theta_kwargs)
    warped = warp_images_np(images, theta, oh, ow)
    return np.clip(np.round(warped), 0, 255).astype(np.uint8)
