"""The FER+ augmentation's double resample against one resample.

Port of ``tools/ablate_ferplus_resample.py``. Chain (a), the default:
the host warps each augmented image at its native 48x48 and the pipeline
resizes to ``input_size`` on the device (two resamplings). Chain (b), the
reference's composition (``FerPlusConfig.augment_at_target``): warp and
resize fused into one bilinear sample at ``input_size`` on the host.

First the host's augmentation ms a batch of 128 (``ops/warp.
augment_batch_np``, best of 5 calls) for the warp at 48, into 96 and into 224;
then the tiny teacher trained on the synthetic FER+ imdb (240 images)
under both chains for seeds 0, 1 and 2 (``exp/ferplus_baselines``: input
96, batch 24, no dropout, lr 0.01 for 6 epochs), each run's final val
accuracy, each chain's mean and std, and the difference (b) - (a). The
JAX tool is pinned to the CPU; this one runs on the card unless asked::

    python -m mcncrossmodalemotions_torch.tools.ablate_ferplus_resample [--device cpu]

The last line is one JSON object of the records.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

CHAIN_A = "a: warp@48 + device resize"
CHAIN_B = "b: single warp->input"
AUGMENT_SIZES = ((None, "warp@48 (a)"), (96, "warp->96"),
                 (224, "warp->224 (b)"))


def main(device="cuda", seeds=(0, 1, 2), num_images: int = 240,
         epochs: int = 6, batch_size: int = 24, input_size: int = 96,
         augment_reps: int = 5) -> dict:
    """``{"host_augment_ms": {tag: ms}, "accuracy": {chain: [acc a seed]},
    "mean", "std", "delta_b_minus_a"}``, the host ms the best of
    ``augment_reps``; a CPU rehearsal passes fewer seeds, images, epochs
    and repetitions."""
    from mcncrossmodalemotions_torch.data.ferplus import build_synthetic_ferplus
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        FerPlusConfig,
        ferplus_baselines,
    )
    from mcncrossmodalemotions_torch.ops.warp import augment_batch_np
    from mcncrossmodalemotions_torch.utils.device import resolve_device

    device = resolve_device(device, "ablate_ferplus_resample")
    out: dict = {"host_augment_ms": {}}
    batch = np.random.RandomState(0).randint(
        0, 255, (128, 48, 48, 1)).astype(np.uint8)
    for out_size, tag in AUGMENT_SIZES:
        t = []
        for k in range(augment_reps):
            t0 = time.monotonic()
            augment_batch_np(batch, np.random.RandomState(k), out_size=out_size)
            t.append(time.monotonic() - t0)
        ms = min(t) * 1000
        out["host_augment_ms"][tag] = ms
        print(f"host augment {tag:16s}: {ms:7.1f} ms/128-batch, "
              f"{(out_size or 48) ** 2 / 1024:6.1f} kB/img feed", flush=True)

    imdb = build_synthetic_ferplus(num_images, seed=0)
    out["accuracy"] = {}
    for chain, at_target in ((CHAIN_A, False), (CHAIN_B, True)):
        accs = []
        for seed in seeds:
            with tempfile.TemporaryDirectory() as root:
                cfg = FerPlusConfig(
                    tiny_model=True, input_size=input_size,
                    batch_size=batch_size, dropout=0.0, augment=True,
                    augment_at_target=at_target, lr_values=(0.01,),
                    lr_epochs=(epochs,), finetune_lr=1.0, seed=seed,
                    out_root=root)
                ferplus_baselines(cfg, imdb, mesh=None, device=device)
                _, stats = ferplus_baselines(cfg, imdb, evaluate_only="val",
                                             mesh=None, device=device)
            accs.append(float(stats["accuracy"]))
            print(f"  chain {chain!r} seed {seed}: val acc "
                  f"{stats['accuracy']:.4f}", flush=True)
        out["accuracy"][chain] = accs
        print(f"chain {chain!r}: mean {np.mean(accs):.4f} "
              f"+/- {np.std(accs):.4f}", flush=True)
    out["mean"] = {c: float(np.mean(a)) for c, a in out["accuracy"].items()}
    out["std"] = {c: float(np.std(a)) for c, a in out["accuracy"].items()}
    out["delta_b_minus_a"] = out["mean"][CHAIN_B] - out["mean"][CHAIN_A]
    print(f"\ndelta (b - a) = {out['delta_b_minus_a']:+.4f}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device)))
