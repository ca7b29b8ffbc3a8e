"""One remat policy on the full student train step: time and memory.

Port of ``tools/probe_remat.py``: the bench's headline step
(``bench.train_step_setup``: the full student at float32 ``[128, 64384]``,
hot-cross-ent at T=2, SGD without weight decay) under one remat policy
(``models/vggm.REMAT_RUNS``, or ``none``). One policy a process::

    for p in none drop_conv1 drop_through_pool1 save_pools dots nothing; do
      python -m mcncrossmodalemotions_torch.tools.probe_remat $p [--iters 20]
    done

Prints step ms (``bench._best_of``), utts/s, the peak memory of the timed
steps (``torch.cuda.max_memory_allocated`` after a reset) and the memory
the forward holds for the backward (allocated after the loss less before
the forward); ``n/a`` for memory on the CPU (``--device cpu``). The JAX
tool prints its compiled program's estimate instead. The last line is one
JSON object of the record.
"""

from __future__ import annotations

import argparse
import json

from mcncrossmodalemotions_torch.models.vggm import REMAT_RUNS

POLICIES = ("none",) + tuple(REMAT_RUNS)


def main(policy: str = "none", batch_size: int = 128, device="cuda",
         iters: int = 20, **step_kw) -> dict:
    """``{"policy", "batch_size", "ms", "utts_per_sec", "peak_gib",
    "held_gib", "launches"}`` (the memory None on the CPU); ``step_kw`` goes to
    ``bench.train_step_setup`` (a CPU rehearsal passes small sizes)."""
    import torch

    from mcncrossmodalemotions_torch.bench import (
        _best_of,
        _sync,
        train_step_setup,
    )
    from mcncrossmodalemotions_torch.tools import kernel_launches
    from mcncrossmodalemotions_torch.train.state import resolve_remat_policy

    step, state, batch = train_step_setup(
        device, batch_size, remat_policy=resolve_remat_policy(policy),
        **step_kw)
    dev = batch["data"].device
    cuda = dev.type == "cuda"
    step(state, batch, 1e-4)  # warm-up, before the peak is reset
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    sec = _best_of(lambda: step(state, batch, 1e-4), lambda: _sync(dev),
                   iters=iters)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    held = None
    if cuda:
        from mcncrossmodalemotions_torch.zoo import student_loss_fn

        before = torch.cuda.memory_allocated(dev)
        out = state.model(batch["data"], train=True,
                          remat_policy=resolve_remat_policy(policy))
        loss, _ = student_loss_fn("hot-cross-ent", temperature=2.0)(out, batch)
        _sync(dev)
        held = (torch.cuda.memory_allocated(dev) - before) / 2**30
        del out, loss
    mem = ("n/a" if peak is None
           else f"{peak:.3f} GiB peak, {held:.3f} GiB held for the backward")
    print(f"remat={policy} bs={batch_size}: {sec * 1000:.3f} ms "
          f"({batch_size / sec:.1f} utts/s) | memory: {mem}", flush=True)
    return {"policy": policy, "batch_size": batch_size,
            "ms": round(sec * 1000, 3),
            "utts_per_sec": round(batch_size / sec, 2),
            "peak_gib": peak, "held_gib": held,
            "launches": kernel_launches()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("policy", nargs="?", default="none", choices=POLICIES)
    ap.add_argument("batch_size", nargs="?", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.policy, args.batch_size, args.device,
                          args.iters)))
