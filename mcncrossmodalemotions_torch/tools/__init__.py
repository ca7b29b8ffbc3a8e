"""The Mosaic lowering probes as Hopper probes.

``probe_mosaic`` (P1-P11) and ``probe_mosaic2`` (P4r, P4s, P4b, P12, P1r)
are the counterparts of ``tools/probe_mosaic.py`` and
``tools/probe_mosaic2.py``: the same probe names, shapes, dtypes, seeds and
numpy ``expect`` arrays, each probe run through one of the probe kernels of
``ops/probes.py``. Run them on the card with

    python -m mcncrossmodalemotions_torch.tools.probe_mosaic
    python -m mcncrossmodalemotions_torch.tools.probe_mosaic2

Each prints ``PROBE <name>: RUNS, match=<bool>`` or ``PROBE <name>: FAIL —
<msg>`` per probe, then a ``device:`` line, as the JAX tools do, and exits
non-zero unless every probe ran and matched.

The package's other tools are the counterparts of ``tools/run_demo.py``
(``run_demo``), ``tools/sweep_convergence.py`` (``sweep_convergence``) and
``tools/soak_dense_genesis.py`` (``soak_dense_genesis``), and of the step,
pool and FER+ studies of ``tools/`` under their names
(``profile_train_step``, ``probe_masked_bn``, ``ab_step_conv1``,
``probe_conv1_s2d``, ``probe_remat``, ``probe_pool_compose``,
``bench_pool_bwd``, ``ablate_ferplus_resample``), each ``main(device=
"cuda", ...)`` with its JAX sizes as defaults and printing its records as
the last line; ``step_variants`` times the bench's train step with and
without a pad mask and int16 rows; ``time_probes`` times the probe kernels
beside their bounds and the launch floor, alone or against another
checkout in turns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from mcncrossmodalemotions_torch.ops import _ffi, probes
from mcncrossmodalemotions_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: a probe kernel's wrapper and its plain version, the
    arguments both take (on the probe's device), numpy's answer, and the
    probe's output shape where it differs from the kernel's (reshapes)."""

    name: str
    kernel: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]
    args: tuple
    expect: np.ndarray
    shape: Optional[Tuple[int, ...]] = None

    def run(self, plain: bool = False) -> torch.Tensor:
        out = (self.plain if plain else self.kernel)(*self.args)
        return out if self.shape is None else out.view(self.shape)


def gather_probe(name: str, a: torch.Tensor, axis: int, idx,
                 expect: np.ndarray) -> Probe:
    """A probe whose data movement is the gather of ``a`` along ``axis`` by
    the integer array ``idx``."""
    index = probes.index_map(idx, a.shape[axis], a.device)
    return Probe(name, probes.probe_gather, probes.gather, (a, index, axis),
                 expect)


def run_probe(probe: Probe) -> Tuple[bool, bool]:
    """Run one probe through its kernel; print and return (ran, match)."""
    try:
        out = probe.run().cpu().numpy()  # the copy waits for the kernel
        ok = bool(out.shape == probe.expect.shape
                  and np.allclose(out, probe.expect))
        print(f"PROBE {probe.name}: RUNS, match={ok}", flush=True)
        return True, ok
    except Exception as exc:  # a probe reports its failure, as on the TPU
        msg = str(exc).replace("\n", " | ")[:300]
        print(f"PROBE {probe.name}: FAIL — {msg}", flush=True)
        return False, False


def run_all(make_probes: Callable[[torch.device], Iterable[Probe]],
            device: torch.device | str, who: str) -> Dict[str, Tuple[bool, bool]]:
    """Build the probes on ``device`` (the card unless the caller asks for
    the CPU), run each, print the ``device:`` line; {name: (ran, match)}."""
    device = resolve_device(device, who)
    results = {p.name: run_probe(p) for p in make_probes(device)}
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu", flush=True)
    return results


def exit_code(results: Dict[str, Tuple[bool, bool]]) -> int:
    """0 when every probe ran and matched, else 1."""
    return 0 if all(ran and ok for ran, ok in results.values()) else 1


K1_K2 = ("spectrogram", "max_pool_3x3s2", "max_pool_3x3s2_idx",
         "max_pool_3x3s2_bwd")
"""The K1 and K2 wrappers' names in the record of launches (``ops/_ffi``)."""


def kernel_launches() -> Dict[str, int]:
    """The K1 and K2 wrappers' launch counts in this process (each wrapper
    adds one where it launches its kernel), for a study's record."""
    return _ffi.launches(K1_K2)
