"""FER+ teacher training, worked out again: the batch loader's shuffle and
host augmentation, the pipeline's device draws, SE-ResNet-50 in train mode
and the fine-tuning SGD.

Batches (``getBatchFerPlus``, ferplus_baselines.m:181-268): per epoch a
numpy ``RandomState(seed + epoch)`` shuffles the training images, then,
batch by batch, draws the zoom (1 +/- 1/25), rotation (+/- pi/18) and
skew (+/- 0.1) of every image and whether it is applied (half of them),
warps each 48x48 image by that affine with clamped bilinear sampling
(``vl_nnbilinearsampler``) and rounds to uint8. On the card, per step, a
generator seeded ``seed + 1`` draws each row's fliplr (probability 0.5)
and then the dropout mask (keep 0.5) on the pooled embedding. Targets
are the 8 emotions' vote shares. SGD: v <- m v - lr s (g + wd p), p <- p
+ v, with s 1 for the head and 0.1 for the backbone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import senet50
from perfbench.reference.common import Ops


def _thetas(rng: np.random.RandomState, batch: int) -> np.ndarray:
    zoom = 1.0 + rng.uniform(-1.0 / 25.0, 1.0 / 25.0, batch)
    angle = rng.uniform(-float(np.pi) / 18.0, float(np.pi) / 18.0, batch)
    skew = rng.uniform(-0.1, 0.1, (batch, 2))
    thetas = np.zeros((batch, 2, 3))
    for i in range(batch):
        z = np.array([[zoom[i], 0, 0], [0, zoom[i], 0], [0, 0, 1]])
        c, s = np.cos(angle[i]), np.sin(angle[i])
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        k = np.array([[1, skew[i, 0], 0], [skew[i, 1], 1, 0], [0, 0, 1]])
        thetas[i] = (z @ r @ k)[:2]
    apply = rng.rand(batch) < 0.5
    thetas[~apply] = np.array([[1.0, 0, 0], [0, 1.0, 0]])
    return thetas.astype(np.float32)


def _warp(images: np.ndarray, theta: np.ndarray) -> np.ndarray:
    images = np.asarray(images, np.float32)
    b, h, w, _ = images.shape
    gy, gx = np.meshgrid(np.linspace(-1.0, 1.0, h), np.linspace(-1.0, 1.0, w),
                         indexing="ij")
    base = np.stack([gx, gy, np.ones_like(gx)], axis=-1)
    grid = np.einsum("bij,hwj->bhwi", np.asarray(theta, np.float32), base)
    x = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = np.clip(np.floor(x), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(y), 0, h - 1).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    wx = np.clip(x - x0, 0.0, 1.0)[..., None]
    wy = np.clip(y - y0, 0.0, 1.0)[..., None]
    bi = np.arange(b)[:, None, None]
    top = images[bi, y0, x0] * (1 - wx) + images[bi, y0, x1] * wx
    bot = images[bi, y1, x0] * (1 - wx) + images[bi, y1, x1] * wx
    return np.clip(np.round(top * (1 - wy) + bot * wy), 0, 255).astype(np.uint8)


def epoch_batches(data: np.ndarray, votes: np.ndarray, seed: int, epoch: int,
                  batch_size: int, count: int) -> List[dict]:
    """The first ``count`` augmented batches of ``epoch`` (numpy)."""
    rng = np.random.RandomState(seed + epoch)
    idx = rng.permutation(len(data))
    out = []
    for b in range(count):
        chunk = idx[b * batch_size:(b + 1) * batch_size]
        emo = votes[chunk, :8].astype(np.float32)
        out.append({"frames": _warp(data[chunk], _thetas(rng, len(chunk))),
                    "dist": emo / np.maximum(emo.sum(1, keepdims=True), 1e-8)})
    return out


def train_steps(cfg: dict, weights: Dict[str, torch.Tensor], batches: Sequence[dict],
                lr: float, generator_seed: int, device, precision: str = "fp32") -> dict:
    """``len(batches)`` steps from ``weights``: losses, the first step's
    logits, the first gradient's norm by leaf and the change's norm by
    leaf after the last step."""
    ops = Ops(precision)
    gen = torch.Generator(device=device).manual_seed(generator_seed)
    names = [n for n in weights if not n.endswith(("running_mean", "running_var"))]
    p0 = {n: weights[n].clone() for n in names}
    params = {n: weights[n].clone().requires_grad_(True) for n in names}
    stats = {n: weights[n] for n in weights if n not in params}
    vel = {n: torch.zeros_like(v) for n, v in params.items()}
    keep = 1.0 - cfg["dropout"]
    losses, grad_norms = [], {}
    for k, batch in enumerate(batches):
        x = torch.as_tensor(batch["frames"], device=device)
        b = x.shape[0]
        flip = torch.rand(b, generator=gen, device=device) < cfg["flip_prob"]
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        mask = torch.empty((b, cfg["stage_widths"][-1] * cfg["expansion"]),
                           dtype=torch.float32, device=device)
        mask = mask.bernoulli_(keep, generator=gen).bool()
        emb = senet50.forward(cfg, {**params, **stats}, x, True, ops, embedding=True)
        emb = torch.where(mask, emb / keep, torch.zeros((), device=device))
        logits = ops.linear(emb, params["prediction.weight"], params["prediction.bias"])
        dist = torch.as_tensor(batch["dist"], device=device)
        loss = -(dist * torch.log_softmax(logits, -1)).sum(-1).mean()
        if k == 0:
            logits1 = logits.detach().double().cpu().numpy()
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                if k == 0:
                    grad_norms[n] = float(g.double().norm())
                scale = 1.0 if "prediction" in n.split(".") else cfg["backbone_lr_scale"]
                vel[n].mul_(cfg["momentum"]).sub_(
                    lr * scale * (g + cfg["weight_decay"] * params[n]))
                params[n].add_(vel[n])
    with torch.no_grad():
        change = {n: float((params[n] - p0[n]).double().norm()) for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "logits1": logits1}
