"""Plain VGG-M student, its spectrogram frontend, its distillation step
and its whole-clip extraction, from ``configs/vggm-emovox-student.json``.

Frontend (VGGVox ``runSpec``): PCM16 / 32768, pre-emphasis, 25 ms
symmetric Hamming frames at a 10 ms hop, |512-point DFT| with all 512
bins, then per-bin normalisation over time (N - 1 std). Student: conv1-5
with BatchNorm and ReLU, 3x3/2 max pools after conv1 and conv2, a 5x3
pool of stride (3, 2), fc6 a 9x1 conv with BatchNorm and ReLU, the mean
over time, fc7 with ReLU, and the head. The step: hot cross-entropy at
temperature T against the crop's cached teacher logits (max over the
crop's logit frames), then MatConvNet SGD: v <- m v - lr (g + wd p),
p <- p + v.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.common import Leaf, Ops, batch_norm


def leaves(cfg: dict) -> List[Leaf]:
    """The student's parameters and running statistics, by the names the
    benchmark gives them."""
    out: List[Leaf] = []
    cin = 1
    bns = []
    for conv in cfg["convs"]:
        kh, kw = conv["kernel"]
        out.append((f"{conv['name']}.weight", (conv["out"], cin, kh, kw), "kernel",
                    cin * kh * kw))
        bns.append(conv["out"])
        cin = conv["out"]
    fh, fw = cfg["fc6"]["kernel"]
    out.append(("fc6.weight", (cfg["fc6"]["out"], cin, fh, fw), "kernel", cin * fh * fw))
    bns.append(cfg["fc6"]["out"])
    for i, c in enumerate(bns, 1):
        out += [(f"bn{i}.weight", (c,), "bn_scale", 0), (f"bn{i}.bias", (c,), "bn_shift", 0),
                (f"bn{i}.running_mean", (c,), "running_mean", 0),
                (f"bn{i}.running_var", (c,), "running_var", 0)]
    f6, f7 = cfg["fc6"]["out"], cfg["fc7"]
    out += [("fc7.weight", (f7, f6), "kernel", f6), ("fc7.bias", (f7,), "bias", 0),
            ("prediction.weight", (cfg["num_outputs"], f7), "kernel", f7),
            ("prediction.bias", (cfg["num_outputs"],), "bias", 0)]
    return out


def is_parameter(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def num_frames(cfg: dict, samples: int) -> int:
    s = cfg["spectrogram"]
    win = round(s["sample_rate"] * s["window_ms"] / 1000)
    hop = round(s["sample_rate"] * s["hop_ms"] / 1000)
    return 0 if samples < win else (samples - win) // hop + 1


def crop_samples(cfg: dict, frames: int) -> int:
    """Samples that make ``frames`` frames (400 frames: 64,384)."""
    s = cfg["spectrogram"]
    return int(round((s["hop_ms"] / 1000 * frames + (s["window_ms"] - 1) / 1000)
                     * s["sample_rate"]))


def spectrogram(cfg: dict, pcm: torch.Tensor) -> torch.Tensor:
    """[B, N] int16 -> [B, nfft, T] magnitudes, in float64."""
    s = cfg["spectrogram"]
    win = round(s["sample_rate"] * s["window_ms"] / 1000)
    hop = round(s["sample_rate"] * s["hop_ms"] / 1000)
    x = pcm.to(torch.float64) / 32768.0
    y = torch.cat([x[:, :1], x[:, 1:] - s["preemph"] * x[:, :-1]], dim=1)
    frames = y.unfold(1, win, hop)
    i = torch.arange(win, dtype=torch.float64, device=x.device)
    ham = 0.54 - 0.46 * torch.cos(2 * math.pi * i / (win - 1))
    half = torch.fft.rfft(frames * ham, n=s["nfft"]).abs()
    full = torch.cat([half, torch.flip(half[..., 1:s["nfft"] // 2], dims=(-1,))], -1)
    return full.transpose(1, 2)


def instance_norm(cfg: dict, spec: torch.Tensor) -> torch.Tensor:
    """Per bin over time: (s - mean) / sqrt(var_{N-1} + eps)."""
    mu = spec.mean(dim=-1, keepdim=True)
    var = spec.var(dim=-1, keepdim=True, unbiased=True)
    return (spec - mu) / torch.sqrt(var + cfg["spectrogram"]["instance_norm_eps"])


def forward(cfg: dict, p: Dict[str, torch.Tensor], spec: torch.Tensor,
            train: bool, ops: Ops) -> torch.Tensor:
    """[B, bins, T] normalised spectrogram (float32) -> [B, C] logits."""
    eps = cfg["batchnorm_eps"]
    x = spec[:, None]
    for i, conv in enumerate(cfg["convs"], 1):
        x = ops.conv(x, p[f"{conv['name']}.weight"], tuple(conv["stride"]),
                     tuple(conv["pad"]))
        x = F.relu(ops.store(batch_norm(x, p, f"bn{i}", train, eps)))
        if conv["name"] in cfg["pool_3x3s2_after"]:
            x = F.max_pool2d(x, 3, 2)
    x = F.max_pool2d(x, tuple(cfg["pool5"]["kernel"]), tuple(cfg["pool5"]["stride"]))
    x = ops.conv(x, p["fc6.weight"])
    x = F.relu(ops.store(batch_norm(x, p, f"bn{len(cfg['convs']) + 1}", train, eps)))
    x = ops.store(x.mean(dim=(2, 3)))
    x = F.relu(ops.store(ops.linear(x, p["fc7.weight"], p["fc7.bias"])))
    return ops.linear(x, p["prediction.weight"], p["prediction.bias"])


def hot_cross_entropy(logits: torch.Tensor, teacher: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """-mean_b sum_c softmax(teacher / T) log softmax(logits / T)."""
    target = torch.softmax(teacher / temperature, dim=-1)
    return -(target * torch.log_softmax(logits / temperature, dim=-1)).sum(-1).mean()


def distill_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                  batches: Sequence[dict], lrs: Sequence[float],
                  precision: str = "fp32") -> dict:
    """Run ``len(batches)`` steps from ``weights``; returns the losses, the
    first step's gradient norm by leaf and the change's norm by leaf
    after the last step. Each batch holds ``pcm`` [B, N] int16 and
    ``teacher`` [B, C] float32 on the device."""
    ops = Ops(precision)
    names = [n for n in weights if is_parameter(n)]
    p0 = {n: weights[n].clone() for n in names}
    params = {n: weights[n].clone().requires_grad_(True) for n in names}
    stats = {n: weights[n] for n in weights if not is_parameter(n)}
    vel = {n: torch.zeros_like(v) for n, v in params.items()}
    losses, grad_norms = [], {}
    for k, (batch, lr) in enumerate(zip(batches, lrs)):
        with torch.no_grad():
            spec = instance_norm(cfg, spectrogram(cfg, batch["pcm"])).float()
        logits = forward(cfg, {**params, **stats}, spec, True, ops)
        loss = hot_cross_entropy(logits, batch["teacher"], cfg["temperature"])
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                if k == 0:
                    grad_norms[n] = float(g.double().norm())
                vel[n].mul_(cfg["momentum"]).sub_(lr * (g + cfg["weight_decay"] * params[n]))
                params[n].add_(vel[n])
    with torch.no_grad():
        change = {n: float((params[n] - p0[n]).double().norm()) for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


@torch.no_grad()
def track_logits(cfg: dict, weights: Dict[str, torch.Tensor], pcm: np.ndarray,
                 buckets: Sequence[int], max_frames: int, device,
                 precision: str = "fp32") -> np.ndarray:
    """Whole-clip extraction of one track (``pcm`` int16, at most the
    clip cap): its valid frames (at most ``max_frames``), normalised over
    all of them, then the centre crop of the largest bucket width that
    fits (the smallest bucket at least) through the student in eval
    mode. Returns [C] logits (float64)."""
    t = min(max(num_frames(cfg, len(pcm)), 1), max_frames)
    fit = [b for b in buckets if b <= t]
    bucket = fit[-1] if fit else buckets[0]
    need = crop_samples(cfg, t)
    x = np.zeros(max(need, len(pcm)), np.int16)
    x[:len(pcm)] = pcm
    spec = spectrogram(cfg, torch.as_tensor(x[:need], device=device)[None])[..., :t]
    normed = instance_norm(cfg, spec)
    start = max((t - bucket) // 2, 0)
    crop = normed[..., start:start + bucket].float()
    if crop.shape[-1] < bucket:
        crop = F.pad(crop, (0, bucket - crop.shape[-1]))
    logits = forward(cfg, weights, crop, False, Ops(precision))
    return logits[0].double().cpu().numpy()
