"""VGG-M ("VGGVox"-style) speech student, PyTorch.

Port of ``mcncrossmodalemotions_tpu/models/vggm.py`` (``VGGMStudent``),
eval and train mode. Same parameters (through ``zoo/bridge.py``) and the
same function:

- input [B, 512, T, 1] (the JAX NHWC layout at the public function);
  inside, activations are NCHW-shaped tensors in ``channels_last`` memory,
  so pool1/pool2 hand the kernel a contiguous NHWC view without a copy;
- conv1 7x7/2, a plain conv by default; ``conv1_s2d=True`` runs it as
  ``SpaceToDepthConv1`` (the JAX module's form: a 4x4/1 conv over the
  input regrouped 2x2 into channels, the same parameter and function; the
  JAX default is True, the port's False, so its measured paths stay as
  they were measured: ``tools/ab_step_conv1.py`` times the step in each
  form);
- BatchNorm (eps 1e-5), then ReLU, after every conv; with
  ``use_batchnorm=False`` the convs carry biases instead;
- pool1 and pool2 are 3x3/2 VALID max pools through the K2 kernels
  (``ops/pool.py``): the index-free forward without grad, the with-index
  forward and its backward kernel under grad; pool5 is 5x3/(3,2), a plain
  ``F.max_pool2d``, as the JAX model left it to XLA;
- dropout after pool5 and after fc7 (train mode, ``dropout_rate > 0``);
- fc6 is a 9x1 conv collapsing frequency, then a masked temporal mean over
  the valid columns (``temporal_valid_frames``), fc7 + ReLU (the
  embedding, taken before dropout), and the head.

Compute runs in ``dtype`` (bf16 by default) with fp32 parameters; pool6
and the head run in fp32, as in the JAX module.

Rematerialisation (``remat_policy``, the train step's option): the forward
is a list of stages cut where the JAX module tags its blocks with
``checkpoint_name`` (``conv1_out``, ``relu1_out``, ``pool1_out``,
``relu2_out``, ``pool2_out``, ``pool5_out``, ``fc6_out``). A policy names
runs of stages that ``torch.utils.checkpoint`` (non-reentrant) recomputes
in the backward instead of keeping their activations (``REMAT_RUNS``);
``dots`` keeps the matmul outputs of its run (a selective-checkpoint
policy) and recomputes the convs. A recomputed run computes what the first
run did: dropout stays outside every run (its generator is not one
``checkpoint`` restores), and BatchNorm updates its running statistics on
the first run only. A recomputed pool1/pool2 launches K2's with-index
forward again.

Train-mode BatchNorm follows Flax's ``nn.BatchNorm(momentum=0.9)``, not
``nn.BatchNorm2d``'s: statistics in fp32 whatever the input dtype, the
variance in the biased fast form E[x^2] - E[x]^2 clipped at 0, over the
rows where ``pad_mask > 0`` only; the running update is
``0.9 * running + 0.1 * batch`` with that BIASED variance
(``nn.BatchNorm2d`` would use momentum 0.1 on the unbiased one).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from mcncrossmodalemotions_torch.ops import train_bn
from mcncrossmodalemotions_torch.ops.pool import (
    max_pool_3x3s2,
    max_pool_3x3s2_cuda,
    max_pool_3x3s2_train,
)
from mcncrossmodalemotions_torch.parallel.mesh import DataMesh, all_reduce_sum
from mcncrossmodalemotions_torch.utils import trace

BN_EPS = 1e-5  # flax.linen.BatchNorm default
BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch
# stddev of a unit normal truncated to [-2, 2]: lecun_normal divides by it
# so that the truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978

# The forward's stages, in order. The JAX module tags the outputs of conv1
# (conv1_out), relu1, pool1, relu2, pool2, pool5 (after conv3-conv5) and
# fc6; "dropout5"/"dropout7" run only in train mode with a dropout rate.
_STAGES = ("conv1", "relu1", "pool1", "conv2", "relu2", "pool2", "pool5",
          "dropout5", "fc6", "fc7", "dropout7", "prediction")
_RANDOM_STAGES = ("dropout5", "dropout7")
_DETERMINISTIC = tuple(s for s in _STAGES if s not in _RANDOM_STAGES)
# Per remat policy (JAX train/state.py resolve_remat_policy), the runs of
# stages recomputed in the backward; a run's input and output are kept.
# drop_conv1 drops conv1_out and relu1_out (relu1_out, the run's output,
# is freed all the same: pool1 keeps only its uint8 winners), and
# drop_through_pool1 pool1_out too; save_pools keeps only pool1_out,
# pool2_out, pool5_out and fc6_out; dots and nothing recompute everything
# (dots keeps the matmul outputs).
REMAT_RUNS = {
    "drop_conv1": (("conv1", "relu1"),),
    "drop_through_pool1": (("conv1", "relu1", "pool1", "conv2"),),
    "save_pools": (("conv1", "relu1", "pool1"), ("conv2", "relu2", "pool2"),
                   ("pool5",), ("fc6",), ("fc7", "prediction")),
    "dots": (_DETERMINISTIC,),
    "nothing": (_DETERMINISTIC,),
}
# jax's dots_with_no_batch_dims_saveable: matmuls without batch dims (fc7,
# the head); convolutions are not dots
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


Stage = Callable[[torch.Tensor, bool], torch.Tensor]


def _checkpointed(fns: Sequence[Stage], x: torch.Tensor,
                  save_matmuls: bool) -> torch.Tensor:
    """Run ``fns`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward recomputes them from ``x``. Each stage gets ``first``, True on
    the forward and False on the recompute, so side effects (BatchNorm's
    running statistics) happen once."""
    calls: List[None] = []

    def run(h):
        first = not calls
        calls.append(None)
        for fn in fns:
            h = fn(h, first)
        return h

    kw = {}
    if save_matmuls:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


def _run_stages(stages: Sequence[Tuple[str, Stage]], x: torch.Tensor,
               remat_policy: Optional[str]) -> torch.Tensor:
    """Run the named stages in order; under ``remat_policy`` each maximal
    stretch of one of its runs (``REMAT_RUNS``) is checkpointed."""
    run_of = {}
    if remat_policy is not None:
        for r, run in enumerate(REMAT_RUNS[remat_policy]):
            run_of.update(dict.fromkeys(run, r))
    i = 0
    while i < len(stages):
        r = run_of.get(stages[i][0])
        if r is None:
            x = stages[i][1](x, True)
            i += 1
            continue
        j = i
        while j < len(stages) and run_of.get(stages[j][0]) == r:
            j += 1
        x = _checkpointed([fn for _, fn in stages[i:j]], x,
                          save_matmuls=remat_policy == "dots")
        i = j
    return x


def _floor_out(size, kernel, stride):
    """VALID conv/pool output size; works on ints and integer tensors."""
    return (size - kernel) // stride + 1


def temporal_valid_frames(w):
    """Valid input spectrogram frames -> valid columns at the fc6 output.

    conv1 s2, mpool1 3/2, conv2 s2, mpool2 3/2, (conv3-5 SAME), mpool5 3/2
    in time: 400 frames -> 11, the reference's ``pool6=[1 11]``.
    """
    w = _floor_out(w, 7, 2)   # conv1
    w = _floor_out(w, 3, 2)   # mpool1
    w = _floor_out(w, 5, 2)   # conv2
    w = _floor_out(w, 3, 2)   # mpool2
    w = _floor_out(w, 3, 2)   # mpool5 (time stride 2)
    return w


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> None:
    """Flax's ``lecun_normal`` in place: a normal truncated at 2 std with
    variance 1 / fan_in, fan_in the product of all axes but the first (a
    conv's ``[O, I, kh, kw]``, a ``Linear``'s ``[out, in]``)."""
    fan_in = int(np.prod(weight.shape[1:]))
    std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     pad_mask: Optional[torch.Tensor] = None,
                     update: bool = True,
                     mesh: Optional[DataMesh] = None,
                     relu: bool = False,
                     use_kernels: bool = True) -> torch.Tensor:
    """Flax train-mode BatchNorm over NCHW ``x``: normalise with the batch
    statistics of the rows where ``pad_mask > 0`` (all rows without a
    mask) and, with ``update``, update ``bn``'s running statistics in
    place. The result is in ``x``'s dtype; statistics and affine run in
    fp32 (fp64 for an fp64 ``x``: Flax promotes to at least fp32).
    ``relu`` applies the ReLU that follows (the student's layers).

    With ``use_kernels``, a 4-D CUDA bf16 ``x`` in ``channels_last``
    memory with C a multiple of 8 and no ``mesh`` takes the hand-written
    kernels of ``ops/train_bn.py`` for both, forward and backward (they
    launch or raise); every other input, and every input without
    ``use_kernels``, runs ``_batch_norm_train`` below, then ``F.relu``.

    Under ``mesh`` ``x`` is this rank's shard of the batch: the masked
    sums of x and x^2 and the count are summed over the ranks (one
    differentiable all-reduce) before the mean and variance are formed, so
    every rank normalises with the GLOBAL batch's statistics and makes the
    same running update, as Flax under pjit does. A rank whose rows are
    all padding contributes zeros.

    While ``utils/trace`` records, the forward is the span ``vggm.bn`` and,
    under grad, its backward the span ``vggm.bn.backward`` on the thread
    that runs the backward: a hook on the result's gradient opens it and
    a hook on ``x``'s closes it (tensor hooks, so the graph and the
    gradients are those of a run that does not record)."""
    if not trace.recording():
        return _batch_norm_relu(x, bn, pad_mask, update, mesh, relu,
                                use_kernels)
    with trace.span("vggm.bn"):
        y = _batch_norm_relu(x, bn, pad_mask, update, mesh, relu, use_kernels)
    if torch.is_grad_enabled() and x.requires_grad:
        opened: list = []
        y.register_hook(
            lambda g: opened.append(trace.open_span("vggm.bn.backward")))
        x.register_hook(
            lambda g: trace.close_span(opened.pop() if opened else None))
    return y


def _batch_norm_relu(x: torch.Tensor, bn: nn.BatchNorm2d,
                     pad_mask: Optional[torch.Tensor], update: bool,
                     mesh: Optional[DataMesh], relu: bool,
                     use_kernels: bool) -> torch.Tensor:
    if use_kernels and train_bn.takes(x, mesh):
        return train_bn.batch_norm(x, bn, pad_mask, update, BN_MOMENTUM, relu)
    if x.is_cuda:
        train_bn.calls["plain"] += 1
    y = _batch_norm_train(x, bn, pad_mask, update, mesh)
    return F.relu(y, inplace=True) if relu else y


def _batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                      pad_mask: Optional[torch.Tensor], update: bool,
                      mesh: Optional[DataMesh]) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if pad_mask is None and mesh is None:
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = xf.square().mean(dim=(0, 2, 3))
    else:
        w = (torch.ones(x.shape[0], device=x.device) if pad_mask is None
             else (pad_mask > 0).float())[:, None]
        s1 = (xf.sum(dim=(2, 3)) * w).sum(dim=0)
        s2 = (xf.square().sum(dim=(2, 3)) * w).sum(dim=0)
        count = w.sum() * (x.shape[2] * x.shape[3])
        if mesh is not None:
            sums = all_reduce_sum(torch.cat([s1, s2, count[None].to(s1.dtype)]),
                                  mesh)
            c = x.shape[1]
            s1, s2, count = sums[:c], sums[c:2 * c], sums[2 * c]
        mean = s1 / count
        mean2 = s2 / count
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    if update:
        with torch.no_grad():  # running statistics: in place, no autograd
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                                  + (1.0 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                                 + (1.0 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] (even H and W) -> [B, 4C, H/2, W/2] in ``channels_last``
    memory: channel ``c * 4 + 2 * di + dj`` holds ``x[:, c, 2i + di, 2j +
    dj]`` (``F.pixel_unshuffle``'s order), in one copy."""
    b, c, h, w = x.shape
    z = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    z = z.permute(0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, 4 * c)
    return z.permute(0, 3, 1, 2)


def space_to_depth_weight(weight: torch.Tensor) -> torch.Tensor:
    """A 7x7 kernel ``[O, C, 7, 7]`` laid out for ``space_to_depth`` input:
    zero-padded to 8x8, then ``[O, 4C, 4, 4]`` with ``w2[o, c * 4 + 2 * di
    + dj, a, b] = w[o, c, 2a + di, 2b + dj]``. Differentiable: the gradient
    reaches the 7x7 kernel."""
    o, c = weight.shape[:2]
    w = F.pad(weight, (0, 1, 0, 1)).reshape(o, c, 4, 2, 4, 2)
    return w.permute(0, 1, 3, 5, 2, 4).reshape(o, 4 * c, 4, 4)


def space_to_depth_conv1(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv1 (7x7/2 VALID) of NCHW ``x`` as a 4x4/1 VALID conv of its
    ``space_to_depth`` regrouping with the re-laid ``weight``; odd H or W
    takes the plain 7x7/2 conv (the 2x2 grid does not tile)."""
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        return F.conv2d(x, weight, bias, 2)
    return F.conv2d(space_to_depth(x), space_to_depth_weight(weight), bias)


class SpaceToDepthConv1(nn.Conv2d):
    """conv1 in space-to-depth form: 7x7/2 on Cin channels == 4x4/1 on 4 Cin.

    Port of the JAX ``SpaceToDepthConv1``. The parameter is the plain
    conv1's (``weight [96, Cin, 7, 7]``, ``bias`` without BatchNorm), so
    ``state_dict`` keys and shapes, the bridge, the ``.mat`` and msgpack
    loaders and surgery see no difference; each call lays the kernel out
    again inside the graph (``space_to_depth_weight``) and the gradient
    reaches the canonical parameter through autograd. Odd H or W falls back
    to the plain conv."""

    def __init__(self, in_channels: int = 1, out_channels: int = 96,
                 bias: bool = False):
        super().__init__(in_channels, out_channels, 7, stride=2, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return space_to_depth_conv1(x, self.weight, self.bias)


def global_rows(rows: int, mesh: Optional[DataMesh]) -> Tuple[int, slice]:
    """(the global batch's rows, this rank's slice of them) for a shard of
    ``rows``; (rows, all of them) without a mesh. A random draw made at the
    global shape and cut to the slice leaves every rank's generator where
    one process's would be, and gives each rank the rows one process would
    draw for them."""
    if mesh is None:
        return rows, slice(None)
    total = rows * mesh.world_size
    return total, mesh.rows(total)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate); the draws come from ``generator`` (required), at the
    global batch's shape under ``mesh`` (``global_rows``)."""
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit torch.Generator")
    keep = 1.0 - rate
    total, rows = global_rows(x.shape[0], mesh)
    mask = torch.empty((total,) + tuple(x.shape[1:]), dtype=torch.float32,
                       device=x.device)
    mask = mask.bernoulli_(keep, generator=generator)[rows]
    return torch.where(mask.bool(), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class VGGMStudent(nn.Module):
    """VGG-M audio emotion student.

    Input: spectrogram [B, 512, T, 1] (freq-major, instance-normalised).
    Output: logits [B, num_outputs], plus the fc7 embedding with
    ``return_embedding``. Built with Flax's scratch init
    (``reset_parameters``). ``conv1_s2d`` makes conv1 a
    ``SpaceToDepthConv1`` (the same parameters and init draws).
    """

    def __init__(self, num_outputs: int = 8, fc6_features: int = 4096,
                 fc7_features: int = 1024, dropout_rate: float = 0.0,
                 use_batchnorm: bool = True, dtype: torch.dtype = torch.bfloat16,
                 head_init_scale: float = 1e-4,
                 generator: Optional[torch.Generator] = None,
                 conv1_s2d: bool = False):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.use_batchnorm = use_batchnorm
        self.head_init_scale = head_init_scale
        self.conv1_s2d = conv1_s2d
        bias = not use_batchnorm
        self.conv1 = (SpaceToDepthConv1(1, 96, bias=bias) if conv1_s2d
                      else nn.Conv2d(1, 96, 7, stride=2, bias=bias))
        self.conv2 = nn.Conv2d(96, 256, 5, stride=2, bias=bias)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1, bias=bias)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1, bias=bias)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1, bias=bias)
        self.fc6 = nn.Conv2d(256, fc6_features, (9, 1), bias=bias)
        if use_batchnorm:
            for i, feats in enumerate((96, 256, 384, 256, 256, fc6_features), 1):
                setattr(self, f"bn{i}", nn.BatchNorm2d(feats, eps=BN_EPS))
        self.fc7 = nn.Linear(fc6_features, fc7_features)
        self.prediction = nn.Linear(fc7_features, num_outputs)
        self.reset_parameters(generator)

    def convs(self):
        """(name, conv) in network order."""
        return [(n, getattr(self, n))
                for n in ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6")]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's scratch init, in place: ``lecun_normal`` (a normal
        truncated at 2 std, variance 1/fan_in) for conv and fc7 kernels,
        ``normal(head_init_scale)`` for the head, zero biases, BatchNorm
        scale 1, bias 0, running mean 0, running variance 1."""
        for layer in [conv for _, conv in self.convs()] + [self.fc7]:
            lecun_normal_(layer.weight, generator)
            if layer.bias is not None:
                layer.bias.zero_()
        self.prediction.weight.normal_(0.0, self.head_init_scale,
                                       generator=generator)
        self.prediction.bias.zero_()
        if self.use_batchnorm:
            for i in range(1, 7):
                getattr(self, f"bn{i}").reset_parameters()

    def _conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        conv = getattr(self, name)
        bias = None if conv.bias is None else conv.bias.to(self.dtype)
        if isinstance(conv, SpaceToDepthConv1):
            return space_to_depth_conv1(x, conv.weight.to(self.dtype), bias)
        return F.conv2d(x, conv.weight.to(self.dtype), bias, conv.stride,
                        conv.padding)

    def _bn_relu(self, x: torch.Tensor, i: int, train: bool,
                 bn_mask: Optional[torch.Tensor],
                 update: bool = True,
                 mesh: Optional[DataMesh] = None,
                 use_kernels: bool = True) -> torch.Tensor:
        if self.use_batchnorm:
            bn = getattr(self, f"bn{i}")
            if train:
                return batch_norm_train(x, bn, bn_mask, update, mesh,
                                        relu=True, use_kernels=use_kernels)
            # mixed-precision eval BN: statistics and affine in fp32,
            # result in the compute dtype (flax BatchNorm(dtype=bf16) does
            # the same)
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps)
        return F.relu(x, inplace=True)

    def _conv_bn_relu(self, x: torch.Tensor, i: int, name: str, train: bool,
                      bn_mask: Optional[torch.Tensor],
                      update: bool = True,
                      mesh: Optional[DataMesh] = None,
                      use_kernels: bool = True) -> torch.Tensor:
        return self._bn_relu(self._conv(x, name), i, train, bn_mask, update,
                             mesh, use_kernels)

    @staticmethod
    def _pool_3x3s2(x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        if not use_kernels:
            pool = max_pool_3x3s2
        elif torch.is_grad_enabled() and nhwc.requires_grad:
            pool = max_pool_3x3s2_train
        else:
            pool = max_pool_3x3s2_cuda
        return pool(nhwc).permute(0, 3, 1, 2)

    @staticmethod
    def _pool_5x3(x: torch.Tensor) -> torch.Tensor:
        """pool5: 5x3 max pool, stride (3, 2), VALID."""
        return F.max_pool2d(x, (5, 3), stride=(3, 2))

    def _pool6(self, x: torch.Tensor, valid_frames) -> torch.Tensor:
        """Masked temporal mean over the valid fc6 columns (replaces the
        reference's per-bucket poolSize surgery): [B, C, 1, T'] -> [B, C]
        fp32."""
        x = x.float()[:, :, 0, :]  # [B, C, T']
        t_out = x.shape[-1]
        if valid_frames is None:
            return x.mean(dim=-1)
        valid = temporal_valid_frames(
            torch.as_tensor(valid_frames, device=x.device))
        valid = valid.clamp(1, t_out)
        mask = (torch.arange(t_out, device=x.device)[None, :]
                < valid[:, None]).to(x.dtype)
        return (x * mask[:, None, :]).sum(dim=-1) / valid[:, None].to(x.dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                valid_frames: Optional[torch.Tensor] = None,
                return_embedding: bool = False,
                pad_mask: Optional[torch.Tensor] = None, *,
                use_kernels: bool = True,
                generator: Optional[torch.Generator] = None,
                remat_policy: Optional[str] = None,
                mesh: Optional[DataMesh] = None):
        """``train`` uses batch statistics (over the rows where
        ``pad_mask > 0``) and updates the running ones, and applies
        dropout drawn from ``generator``. ``use_kernels`` sends pool1/pool2
        through the K2 wrappers (kernels on the card, plain on the CPU) and
        lets the train-mode BatchNorms take their kernels on the card
        (``batch_norm_train``); False runs the plain pool and BatchNorm.
        ``remat_policy`` (one of ``REMAT_RUNS``, under grad) recomputes its
        runs of stages in the backward. Under ``mesh`` ``x`` is this rank's shard: the train-mode
        statistics and the dropout draws are the global batch's."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # [B, 1, F, T]
        x = x.contiguous(memory_format=torch.channels_last)
        drop = train and self.dropout_rate > 0
        bn = dict(train=train, bn_mask=pad_mask, mesh=mesh,
                  use_kernels=use_kernels)
        embedding: List[torch.Tensor] = []

        def pool(h, first):
            return self._pool_3x3s2(h, use_kernels)

        def pool5(h, first):
            for i in (3, 4, 5):
                h = self._conv_bn_relu(h, i, f"conv{i}", update=first, **bn)
            return self._pool_5x3(h)

        def fc7(h, first):
            h = F.relu(F.linear(self._pool6(h, valid_frames).to(self.dtype),
                                self.fc7.weight.to(self.dtype),
                                self.fc7.bias.to(self.dtype)))
            if first:
                embedding.append(h.float())  # before dropout, as in JAX
            return h

        def prediction(h, first):
            head = self.prediction  # fp32 whatever the parameters' dtype
            return F.linear(h.float(), head.weight.float(), head.bias.float())

        def drop_out(h, first):
            return dropout(h, self.dropout_rate, generator, mesh)

        stages = {
            "conv1": lambda h, first: self._conv(h, "conv1"),
            "relu1": lambda h, first: self._bn_relu(h, 1, update=first, **bn),
            "pool1": pool,
            "conv2": lambda h, first: self._conv(h, "conv2"),
            "relu2": lambda h, first: self._bn_relu(h, 2, update=first, **bn),
            "pool2": pool,
            "pool5": pool5,
            "dropout5": drop_out,
            "fc6": lambda h, first: self._conv_bn_relu(h, 6, "fc6",
                                                       update=first, **bn),
            "fc7": fc7,
            "dropout7": drop_out,
            "prediction": prediction,
        }
        if remat_policy is not None and not torch.is_grad_enabled():
            remat_policy = None  # nothing to recompute without a backward
        logits = _run_stages([(name, stages[name]) for name in _STAGES
                             if drop or name not in _RANDOM_STAGES],
                            x, remat_policy)
        if return_embedding:
            return logits, embedding[0]
        return logits
