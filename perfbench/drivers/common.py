"""What the drivers share: the benchmark's weights handed to the
program's modules, the program's state released before the reference
runs, the numbers compared, the training cells' variants."""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List

import torch

from perfbench.counts import peaks
from perfbench.harness.cli import Check, log
from perfbench.traffic import generate


def weights_seed(seed: int) -> int:
    """The seed of the weights' generator, drawn from the run's seed."""
    return generate.torch_seed(seed, "order") ^ 0x5EED


def card_peaks(run) -> dict:
    return peaks(torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "")


def release(run, ctx: dict, *keys: str) -> None:
    """Drop the program's objects ``keys`` from ``ctx`` and its cached
    device memory, so the reference runs in what they held."""
    for key in keys:
        ctx.pop(key, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 prefix: str = "") -> None:
    """Copy the benchmark's ``weights`` (names without ``prefix``) into
    ``module``'s state; every key must match, and only BatchNorm's
    ``num_batches_tracked`` counters may be left over."""
    mapped = {prefix + k: v for k, v in weights.items()}
    missing, unexpected = module.load_state_dict(mapped, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"the benchmark's weights do not fit the program's model: "
                       f"missing {missing[:5]}, unexpected {unexpected[:5]}")


def checks(run, variant, numbers: Dict[str, float]) -> List[Check]:
    """The numbers that the workload file gives a limit, each with it; all
    the numbers are logged and kept in the run's record by variant."""
    for name, value in numbers.items():
        log(f"reading {name} = {value!r}")
    run.record.setdefault("readings", {})[variant] = numbers
    limits = run.workload["limits"]
    return [Check(name, float(numbers[name]), float(limits[name])) for name in limits]


def training_check(run, ctx: dict, variant, reference: Callable, compare: Callable):
    """The training cells' check: the program's readings (``variant``
    None), the reference in float8 (``control``) or bfloat16 (``bf16``,
    a witness) or with a fault planted (``fault:<name>``), each against
    the float32 reference; ``reference(run, ctx, precision, fault)``."""
    release(run, ctx, "trainer", "state", "batcher", "batches")
    if "reference" not in ctx:
        ctx["reference"] = reference(run, ctx, "fp32", None)
    if variant is None:
        prog = ctx["program"]
    elif variant in ("control", "bf16"):
        prog = reference(run, ctx, "fp8" if variant == "control" else "bf16", None)
    elif variant.startswith("fault:"):
        prog = reference(run, ctx, "fp32", variant[len("fault:"):])
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return checks(run, variant, compare(prog, ctx["reference"]))


class DeviceTimer:
    """The device time of every call of ``module`` while it is entered:
    CUDA events recorded on the current stream by a forward pre-hook and a
    forward hook, summed by ``seconds()`` once the stream has drained. The
    interval opens after the input's copy and closes at the last kernel
    of the call, so the host's decode and the read of the answer stay out.
    Without a card (the CPU rehearsal) the host's clock stands in."""

    def __init__(self, module: torch.nn.Module, device: torch.device):
        self.module, self.cuda = module, device.type == "cuda"
        self.spans: list = []
        self.handles: list = []

    def _mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def __enter__(self) -> "DeviceTimer":
        self.handles = [
            self.module.register_forward_pre_hook(
                lambda *_: self.spans.append([self._mark(), None])),
            self.module.register_forward_hook(
                lambda *_: self.spans[-1].__setitem__(1, self._mark())),
        ]
        return self

    def __exit__(self, *exc) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def seconds(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.spans) / 1000.0
        return sum(b - a for a, b in self.spans)
