"""Ablation timing of the student's distillation train step on the card.

Port of ``tools/profile_train_step.py``: the full step and the JAX tool's
component variants under its names, to say where the step's time goes:

- ``full train step``: the bench's headline step (``bench.
  train_step_setup``: the full student at float32 ``[128, 64384]``, K1's
  frontend, K2 at pools 1 and 2, hot-cross-ent at T=2, SGD without weight
  decay);
- ``frontend (spectrogram+instnorm)``: the pipeline's frontend alone (K1);
- ``train step, precomputed spec``: the bare student's step on the
  frontend's output;
- ``forward only (test mode)``: the bare student's eval forward, no grad
  (the index-free K2);
- ``value_and_grad (no SGD update)``: train-mode forward, loss and
  gradients, no update;
- ``train step, no batchnorm``: the bare student with ``use_batchnorm=
  False`` (conv biases instead), on the spectrogram: with the step on the
  spectrogram, the share of the BatchNorms' unmasked branch (the
  headline's);
- unless ``--quick``: ``train step, avg-pool for max-pool`` (every pool an
  average pool: K2 taken out, as the JAX tool takes its pool out) and
  ``conv1..convN (+pool/bn) fwd+bwd`` for N = 1, 2 (the student's own
  stages, train-mode BatchNorm, K2's train pool, the mean of the output).

Each row is ``bench._best_of`` over ``iters`` calls (best of 3 windows),
a host clock around work that ends in a synchronise::

    python -m mcncrossmodalemotions_torch.tools.profile_train_step [--quick] [--device cpu]

The last line is one JSON object: {row: ms} and the kernels' launches.
"""

from __future__ import annotations

import argparse
import json


def main(device="cuda", quick: bool = False, batch_size: int = 128,
         num_frames: int = 400, tiny: bool = False, iters: int = 20) -> dict:
    """{row name: ms, "launches": {...}}; a CPU rehearsal passes small
    sizes and ``tiny``."""
    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.bench import (
        _best_of,
        _sync,
        train_step_setup,
    )
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
    from mcncrossmodalemotions_torch.ops.spectrogram import (
        DEFAULT_SPEC,
        waveform_to_input,
    )
    from mcncrossmodalemotions_torch.tools import kernel_launches
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import student_loss_fn

    step, state, batch = train_step_setup(device, batch_size, num_frames,
                                          tiny)
    dev = batch["data"].device
    loss_fn = student_loss_fn("hot-cross-ent", temperature=2.0)
    widths = dict(fc6_features=64, fc7_features=32) if tiny else {}
    results: dict = {}

    def timeit(name, fn):
        sec = _best_of(fn, lambda: _sync(dev), iters=iters)
        results[name] = sec * 1000
        print(f"{name:40s} {sec * 1000:8.3f} ms   "
              f"({batch_size / sec:9.1f} utts/s)", flush=True)

    def bare(cls=VGGMStudent, **kw):
        return cls(generator=torch.Generator().manual_seed(0), **widths,
                   **kw).to(dev)

    def run_step(model, b):
        st = TrainState.create(model, torch.Generator(device=dev).manual_seed(1))
        train = make_train_step(loss_fn, SGDConfig(weight_decay=0.0))
        return lambda: train(st, b, 1e-4)

    timeit("full train step", lambda: step(state, batch, 1e-4))
    del step, state

    def frontend():
        with torch.no_grad():
            return waveform_to_input(batch["data"], DEFAULT_SPEC)

    timeit("frontend (spectrogram+instnorm)", frontend)
    batch_spec = dict(batch, data=frontend())
    timeit("train step, precomputed spec", run_step(bare(), batch_spec))

    model = bare()

    def forward():
        with torch.no_grad():
            return model(batch_spec["data"], train=False)

    timeit("forward only (test mode)", forward)
    params = list(model.parameters())

    def value_and_grad():
        loss, _ = loss_fn(model(batch_spec["data"], train=True), batch_spec)
        return loss, torch.autograd.grad(loss, params)

    timeit("value_and_grad (no SGD update)", value_and_grad)
    timeit("train step, no batchnorm",
           run_step(bare(use_batchnorm=False), batch_spec))

    if not quick:
        class AvgPoolStudent(VGGMStudent):
            """Every max pool an average pool of the same window."""

            @staticmethod
            def _pool_3x3s2(x, use_kernels):
                return F.avg_pool2d(x, 3, 2)

            @staticmethod
            def _pool_5x3(x):
                return F.avg_pool2d(x, (5, 3), stride=(3, 2))

        timeit("train step, avg-pool for max-pool",
               run_step(bare(AvgPoolStudent), batch_spec))

        x = batch_spec["data"].to(model.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)  # the student's own layout
        for n in (1, 2):
            names = [f"conv{i}" for i in range(1, n + 1)]
            grads_of = [p for i, name in enumerate(names, 1)
                        for p in (getattr(model, name).weight,
                                  getattr(model, f"bn{i}").weight,
                                  getattr(model, f"bn{i}").bias)]

            def stack(names=names, grads_of=grads_of):
                h = x
                for i, name in enumerate(names, 1):
                    h = model._conv(h, name)
                    h = model._bn_relu(h, i, train=True, bn_mask=None)
                    h = model._pool_3x3s2(h, use_kernels=True)
                return torch.autograd.grad(h.float().mean(), grads_of)

            timeit(f"conv1..conv{n} (+pool/bn) fwd+bwd", stack)

    print("\nsummary (ms):")
    for k, v in results.items():
        print(f"  {k}: {v:.3f}")
    results["launches"] = kernel_launches()
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device, args.quick)))
